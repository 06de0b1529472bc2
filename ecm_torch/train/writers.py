"""Metric writers (port of ``ecm_tpu/train/writers.py``): TensorBoard
through ``torch.utils.tensorboard`` and JSONL.

TensorBoard is optional at run time: when its import fails, the writer says
so once and skips it; the JSONL file stays the authoritative record.
"""

from __future__ import annotations

import json
from typing import Any, Mapping


class MetricWriter:
    """TensorBoard scalars (when ``logdir`` is given and importable) and
    JSONL lines (when ``jsonl_path`` is given) of the same metrics."""

    def __init__(self, logdir: str | None = None, jsonl_path: str | None = None):
        self._tb = None
        self._jsonl = None
        if logdir:
            try:
                from torch.utils.tensorboard import SummaryWriter
            except ImportError as e:
                print(f"MetricWriter: TensorBoard unavailable ({e}); writing JSONL only", flush=True)
            else:
                self._tb = SummaryWriter(logdir)
        if jsonl_path:
            self._jsonl = open(jsonl_path, "a")

    def write(self, step: int, metrics: Mapping[str, Any]) -> None:
        scalars = {k: float(v) for k, v in metrics.items()}
        if self._tb is not None:
            for k, v in scalars.items():
                self._tb.add_scalar(k, v, step)
            self._tb.flush()
        if self._jsonl is not None:
            self._jsonl.write(json.dumps({"step": step, **scalars}) + "\n")
            self._jsonl.flush()

    def close(self) -> None:
        if self._tb is not None:
            self._tb.close()
        if self._jsonl is not None:
            self._jsonl.close()
