"""The manifest and the files it names: every cell resolves its
configuration, mix, driver and metric files by name; names, units and
bounds keep to the manifest's rules; a run without a card prints no result."""

from __future__ import annotations

import json
import re
import subprocess
import sys

import pytest
import torch

from stereo_bench import harness
from stereo_bench.families import family

MAN = harness.manifest()
NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}")
UNIT = re.compile(r"[A-Za-z0-9_/%.\-]{1,16}")
CELLS = [w["name"] for w in MAN["workloads"]]


@pytest.mark.parametrize("name", CELLS)
def test_cell_resolves_by_name(name):
    spec = harness.cell(name, MAN)
    assert spec["config"]["name"] == spec["workload"]["config"]
    assert hasattr(harness.driver(spec["mix"]), "run")
    assert {m["name"] for m in spec["end_to_end"]} >= {"setup_s"} and len(spec["end_to_end"]) >= 2
    assert spec["per_layer"], "every cell reports a per-layer metric"
    for m in spec["per_layer"]:
        assert harness.metric_reader(m["name"]).UNIT == m["unit"]


def test_names_units_and_bounds():
    metrics = MAN["end_to_end"] + MAN["per_layer"]
    names = [m["name"] for m in metrics] + CELLS + [c["name"] for c in MAN["configs"]]
    assert len(names) == len(set(names))
    for n in names + [w["traffic"] for w in MAN["workloads"]]:
        assert NAME.fullmatch(n), n
    for m in metrics:
        assert UNIT.fullmatch(m["unit"]) and m["better"] in ("lower", "higher")
    reported = {m["name"] for m in MAN["end_to_end"]}
    for m in MAN["per_layer"]:
        assert m["moves"] in reported
    for m in MAN["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    assert sum(w["chips"] == 4 for w in MAN["workloads"]) <= max(1, len(CELLS) // 4)
    assert len(json.dumps(MAN)) <= 64 * 1024


@pytest.mark.parametrize("conf", MAN["configs"], ids=lambda c: c["name"])
def test_config_file_matches_manifest(conf):
    cfg = json.loads((harness.ROOT / conf["file"]).read_text())
    assert cfg["name"] == conf["name"] and cfg["source"] == conf["source"]
    assert cfg["reduced"] == conf["reduced"]
    assert cfg["limits"], "every configuration states the limits its numbers are held to"


@pytest.mark.parametrize("conf", MAN["configs"], ids=lambda c: c["name"])
def test_model_takes_the_file_sizes(conf):
    """The model is built at the file's sizes, those the counts and the
    reference take (for ECMStereo: its disparity range, width and dtype)."""
    cfg = json.loads((harness.ROOT / conf["file"]).read_text())
    fam = family(cfg)
    fam.check_sizes(fam.build(cfg, torch.device("meta")), cfg)


def test_run_without_a_card_prints_no_result():
    proc = subprocess.run([sys.executable, "-m", "stereo_bench.run", "--workload", CELLS[0], "--seed", "1",
                           "--seconds", "1", "--trace", "0"], cwd=harness.ROOT, capture_output=True, text=True,
                          timeout=300, env={"PATH": "/usr/bin:/bin", "CUDA_VISIBLE_DEVICES": ""})
    assert proc.returncode != 0
    assert "metrics" not in proc.stdout and "{" not in proc.stdout
    assert "CUDA" in proc.stderr
