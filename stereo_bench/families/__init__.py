"""Model families: what the benchmark needs to know of one stereo architecture.

A configuration file's ``"model"`` key names its family module,
``families/<model, lower-cased>.py`` (``"ECMStereo"``: ``ecmstereo.py``),
which :func:`family` imports. The drivers, the calibration and the trace's
readers take everything model-specific from it and name no model, so a
configuration of a new architecture joins the benchmark by adding
``families/<model>.py``, its plain reference ``reference/<model>.py`` and
the configuration's file.

A family provides:

- ``build(cfg, device)``: the program's model of the configuration with
  uninitialised storage on ``device``, in eval mode; buildable on ``meta``.
  Its ``forward(left, right)`` takes channels-last ``[B, H, W, 3]`` images
  and returns a list whose last entry is the disparity ``[B, H, W]``.
- ``seeded_weights(cfg, template, seed, device)``: every entry of
  ``template`` (the model's state dict: names and shapes), made on
  ``device`` from ``seed``; the program and the reference both read them.
- ``check_sizes(model, cfg)``: asserts that ``model`` takes the file's sizes,
  those the counts and the reference take.
- The plain reference's entries, in float32 and importing nothing of the
  program: ``infer(params, cfg, left, right, precision)``, the eval
  disparities ``[B, H, W]``; ``train_steps(params, names, cfg, batches,
  precision)``, Adam steps from ``params`` (``names``: the parameters), one a
  batch, returning what ``compare.train_numbers`` reads; ``EXACT``, the
  precision that rounds nowhere, and ``FP8``, the control's;
  ``RUNNING``, the suffixes of the running statistics a train step folds in.
- ``eval_work(cfg, batch)`` and ``train_work(cfg)``: ``{"flops": ...,
  "port_bound_s": ...}`` of one request of ``batch`` pairs or one step: the
  benchmark's count of the network's FLOPs, and the sum of the bounds
  (``counts.bound_s``) of the forms the program runs through its own
  kernels.
- ``KERNELS``: the symbols of the program's own kernels on this family's
  paths; a device kernel whose name holds one counts as the program's, every
  other as a library's.

A family whose configurations only serve may leave out the training
entries (``train_steps``, ``RUNNING``, ``train_work``).
"""

from __future__ import annotations

import importlib
from types import ModuleType


def family(cfg: dict) -> ModuleType:
    """The family module that the configuration's ``model`` key names."""
    return importlib.import_module(f"{__name__}.{cfg['model'].lower()}")
