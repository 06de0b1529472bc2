"""What every cell shares: the manifest and the files it names, the check
for a card, the result line and its checks.

A cell of ``BENCHMARK.json`` names a configuration (``configs/<name>.json``)
and a traffic mix (``mixes/<name>.json``); the mix names the driver module
(``drivers/<name>.py``) that runs it, and the configuration's ``model`` key
names its family module (``families/<model, lower-cased>.py``), which holds
all that is particular to one architecture. A per-layer metric is a file
``metrics/<name>.py`` with a ``UNIT`` and a ``read(windows)`` that returns a
number or None (nothing to read). Adding a cell, a mix or a metric is adding
files; no code here names one. Adding a configuration of a new model family
is adding ``families/<model>.py`` and its plain reference
``reference/<model>.py`` beside the configuration's file.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import math
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "ecm_tpu")


def manifest(root: Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def cell(name: str, man: dict) -> dict:
    """The workload ``name`` of the manifest with its configuration, its mix
    and the names of the metrics it reports."""
    by_name = {w["name"]: w for w in man["workloads"]}
    if name not in by_name:
        raise SystemExit(f"unknown workload {name!r}; the manifest has {sorted(by_name)}")
    work = by_name[name]
    conf = next(c for c in man["configs"] if c["name"] == work["config"])
    cfg = json.loads((ROOT / conf["file"]).read_text())
    mix = json.loads((HERE / "mixes" / f"{work['traffic']}.json").read_text())
    end_to_end = [m for m in man["end_to_end"] if name in m.get("workloads", [name])]
    reported = {m["name"] for m in end_to_end}
    per_layer = [m for m in man["per_layer"]
                 if (name in m["workloads"] if "workloads" in m else m["moves"] in reported)]
    return {"workload": work, "config": cfg, "mix": mix, "end_to_end": end_to_end, "per_layer": per_layer}


def driver(mix: dict):
    return importlib.import_module(f"stereo_bench.drivers.{mix['driver']}")


def metric_reader(name: str):
    """The module of ``metrics/<name>.py`` (a name may hold dots)."""
    path = HERE / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"stereo_bench.metrics.{name.replace('.', '_')}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def require_cards(count: int) -> None:
    """Exit non-zero, printing no result, unless ``count`` CUDA cards are
    visible: the benchmark never falls back to the CPU."""
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device: the benchmark measures the program on the GPU")
    if torch.cuda.device_count() < count:
        raise SystemExit(f"the cell needs {count} CUDA devices, {torch.cuda.device_count()} visible")


def forbidden_loaded() -> list[str]:
    """The modules of the JAX package or of JAX itself in this process,
    compared by whole top-level names."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN_MODULES))


def checks(numbers: dict[str, float], limits: dict[str, float]) -> dict[str, dict]:
    """Each compared number beside its limit, under its own short name."""
    return {k: {"value": numbers[k], "limit": limits[k]} for k in limits}


def passed(checked: dict[str, dict]) -> bool:
    return all(math.isfinite(c["value"]) and c["value"] <= c["limit"] for c in checked.values())


def result_line(spec: dict, out: dict, trace: bool, device: dict) -> dict:
    """The run's result line: ``correct``, ``attempted``, ``failed``, the
    metrics of the run's kind, ``device``, optionally ``breakdown``, and the
    numbers compared, each beside its limit, last."""
    metrics = {}
    if trace:
        for m in spec["per_layer"]:
            value = metric_reader(m["name"]).read(out["windows"])
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        for m in spec["end_to_end"]:
            metrics[m["name"]] = {"value": out["end_to_end"][m["name"]], "unit": m["unit"]}
    line = {"correct": out["correct"], "attempted": out["attempted"], "failed": out["failed"],
            "metrics": metrics, "device": device}
    if trace and out.get("breakdown"):
        line["breakdown"] = out["breakdown"]
    line["checked"] = out["checked"]
    return line
