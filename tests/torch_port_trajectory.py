"""Train ``ecm_tpu`` and the port side by side on the CPU, from the same
initial variables on the same synthetic batches, at the configuration the
convergence gate trains: the check behind the gate that one step's gradient
parity cannot make (a script, not a test: it takes 40-60 minutes).

    JAX_PLATFORMS=cpu python tests/torch_port_trajectory.py overfit_gate_grouped

``benchmarks/overfit_gate.py`` and ``chip_smoke.py``'s ``overfit`` phase call
each package's train CLI with ``--config <preset>`` alone, so the preset is
resolved here by each package's own ``resolve_config``: the CLI's default
``--maxdisp`` 192 replaces the preset's max-disp, 4 fixed batches of
2x128x256, Adam at 1e-3, the preset's dtype. "auto" resolves to the grouped
layout on a TPU and on CUDA at 192 disparities, so both packages train it
here: JAX through its XLA banded chain, the port through ``gband_conv_s1``'s
plain version. JAX takes 12-16 s a step on 8 CPU threads, so both run the
first ``SIDE_BY_SIDE`` steps; the port then trains on alone to the gate's
600. Prints each step's loss and EPE, the mean EPE of each window of 50
steps, and the port's last step. Writes the initial variables as the port's
step-0 checkpoint into ``build/trajectory_init/<preset>/``, from which
``python -m ecm_torch.cli.train --config <preset> --loadmodel <that dir>``
trains on a card.
"""

from __future__ import annotations

import argparse
import os
import statistics
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

from ecm_torch.cli import common as torch_cli  # noqa: E402
from ecm_torch.train import checkpoint as ckpt_lib  # noqa: E402
from ecm_torch.train.loop import to_device  # noqa: E402
from ecm_torch.train.state import create_train_state, make_optimizer  # noqa: E402
from ecm_torch.train.steps import make_train_step  # noqa: E402
from ecm_torch.weights import load_flax  # noqa: E402
from ecm_tpu.cli import common as jax_cli  # noqa: E402
from ecm_tpu.data.pipeline import PipelineConfig, make_synthetic_pipeline  # noqa: E402
from ecm_tpu.train import state as jax_state  # noqa: E402
from ecm_tpu.train import steps as jax_steps  # noqa: E402

SIDE_BY_SIDE = 100
INIT_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "build", "trajectory_init")
WINDOW = 50


def main() -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("preset", choices=["overfit_gate", "overfit_gate_grouped"])
    preset = p.parse_args().preset
    jax.config.update("jax_platforms", "cpu")
    argv = ["--config", preset, "--agg-layout", "grouped"]
    jcfg = jax_cli.resolve_config(jax_cli.base_parser("").parse_args(argv), preset)
    tcfg = torch_cli.resolve_config(torch_cli.base_parser("").parse_args(argv), preset)
    assert jcfg.model.max_disp == tcfg.model.max_disp == 192, (jcfg.model, tcfg.model)
    h, w = jcfg.data.crop
    print(jcfg.model, jcfg.data, jcfg.train, sep="\n", flush=True)

    jm = jcfg.model.build()
    js = jax_state.create_train_state(
        jm, jax.random.PRNGKey(jcfg.data.seed), (h, w, 3), jax_state.make_optimizer(jcfg.train.lr))
    tm = load_flax(tcfg.model.build(device="cpu"), {
        "params": jax.device_get(js.params), "batch_stats": jax.device_get(js.batch_stats)})
    ts = create_train_state(tm, make_optimizer(tcfg.train.lr))
    ckpt_lib.save(ckpt_lib.make_manager(os.path.join(INIT_DIR, preset)), 0, ts)
    print(f"the initial variables: {os.path.join(INIT_DIR, preset)}", flush=True)
    jstep = jax_steps.make_train_step(jm, jcfg.model.max_disp)
    tstep = make_train_step(tm, tcfg.model.max_disp)
    batches = make_synthetic_pipeline(
        PipelineConfig(batch_size=jcfg.data.global_batch, crop=(h, w), seed=jcfg.data.seed, worker_count=0),
        h=h, w=w, max_disp=min(jcfg.model.max_disp * 0.8, 40.0), distinct=jcfg.data.synthetic_distinct)

    rows = []
    for step in range(1, jcfg.train.num_steps + 1):
        batch = next(batches)
        ts, tm_ = tstep(ts, to_device(batch, torch.device("cpu")))
        port = (float(tm_["loss"]), float(tm_["epe"]))
        if step <= SIDE_BY_SIDE:
            js, jm_ = jstep(js, {k: jax.numpy.asarray(np.asarray(batch[k])) for k in ("left", "right", "disparity")})
            rows.append((step, float(jm_["loss"]), float(jm_["epe"])) + port)
            print("step %d: jax loss %.5f epe %.4f | port loss %.5f epe %.4f" % rows[-1], flush=True)
        else:
            print("step %d: port loss %.5f epe %.4f" % ((step,) + port), flush=True)
    for start in range(0, len(rows), WINDOW):
        win = rows[start:start + WINDOW]
        print(f"steps {win[0][0]}-{win[-1][0]}: mean EPE jax {statistics.mean(r[2] for r in win):.4f} px, "
              f"port {statistics.mean(r[4] for r in win):.4f} px; port higher at {sum(r[4] > r[2] for r in win)} "
              f"of {len(win)} steps")
    print(f"port step {step}: loss {port[0]:.5f} epe {port[1]:.4f} px")


if __name__ == "__main__":
    main()
