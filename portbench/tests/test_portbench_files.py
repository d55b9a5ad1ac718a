"""BENCHMARK.json and the files it names: present, loadable, within the
format's limits; a new cell is new files only."""

import json
import re
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

from portbench import run

ROOT = run.ROOT
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@pytest.fixture(scope="module")
def bench():
    return run.load_json(ROOT / "BENCHMARK.json")


def test_top_level_keys(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert bench["paths"] == ["portbench"]
    assert 1 <= bench["run_seconds"] <= 51
    assert len(json.dumps(bench)) <= 64 * 1024


def test_configs_and_workloads_exist(bench):
    configs = {c["name"]: c for c in bench["configs"]}
    for c in bench["configs"]:
        assert NAME.match(c["name"])
        assert (ROOT / c["file"]).is_file()
        cfg = run.load_json(ROOT / c["file"])
        assert cfg["reduced"] == c["reduced"]
        assert (ROOT / cfg["weights_file"]).is_file()
    used = set()
    for w in bench["workloads"]:
        assert NAME.match(w["name"]) and w["chips"] in (1, 4) and len(w["why"]) <= 200
        wl = run.workload(w["name"])
        assert wl["config"] == w["config"] and w["config"] in configs
        assert wl["chips"] == w["chips"]
        assert (run.BENCH / "drivers" / f"{wl['driver']}.py").is_file()
        used.add(w["config"])
    assert used == set(configs)


def test_metrics(bench):
    names = [m["name"] for m in bench["end_to_end"] + bench["per_layer"]]
    assert len(names) == len(set(names))
    e2e = {m["name"] for m in bench["end_to_end"]}
    cells = {w["name"] for w in bench["workloads"]}
    assert "setup_s" in e2e
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["better"] in ("lower",
                                                                                   "higher")
        assert set(m.get("workloads", cells)) <= cells
    for m in bench["per_layer"]:
        assert m["moves"] in e2e
        assert (run.BENCH / "metrics" / f"{m['name']}.py").is_file()
    for cell in cells:  # setup_s, another end-to-end metric, a per-layer metric
        assert len(run.metric_specs(bench, cell, "end_to_end")) >= 2
        assert run.metric_specs(bench, cell, "per_layer")


def test_a_cell_is_files_only(tmp_path, bench):
    """A copy of the benchmark gains a cell by one new workload file and one
    new BENCHMARK.json entry, and runs it, with no file of it edited."""
    shutil.copytree(run.BENCH, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    for name in ("artifacts", "deep_active_inference_mc_torch"):
        (tmp_path / name).symlink_to(ROOT / name)
    extra = dict(run.workload("flagship-sweep-habit"), envs=3, chunk=2, episode=2,
                 check_chunks=1, check_envs=2)
    (tmp_path / "portbench" / "workloads" / "extra-habit.json").write_text(json.dumps(extra))
    b = dict(bench, workloads=bench["workloads"] + [
        {"name": "extra-habit", "config": "dsprites-flagship", "traffic": "extra",
         "chips": 1, "why": "a throwaway cell"}])
    for m in b["end_to_end"] + b["per_layer"]:
        if "flagship-sweep-habit" in m.get("workloads", []):
            m["workloads"] = m["workloads"] + ["extra-habit"]
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(b))
    code = ("import json, sys; from portbench import run; "
            "r = run.run_cell('extra-habit', 3, 0.0, False, device='cpu'); "
            "print(json.dumps(r))")
    out = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    r = json.loads(out.stdout.strip().splitlines()[-1])
    assert r["correct"] and "env_steps_per_s" in r["metrics"]
