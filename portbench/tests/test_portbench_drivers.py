"""Each driver end to end on the CPU at a tiny size: the reference accepts
the program's sound run and refuses it with the timed path broken
underneath; the device-metric path needs a card."""

import time

import pytest
import torch

from portbench import faults, run

TINY = {
    "flagship-sweep-ai": {"envs": 4, "chunk": 3, "episode": 6, "check_chunks": 2,
                          "check_envs": 4},
    "flagship-sweep-habit": {"envs": 4, "chunk": 3, "episode": 6, "check_chunks": 2,
                             "check_envs": 4},
    "flagship-train": {"batch": 8},
}


def _run(cell, seed=11, **kw):
    return run.run_cell(cell, seed, 0.0, False, device="cpu",
                        overrides=TINY[cell], t_start=time.perf_counter(), **kw)


@pytest.mark.parametrize("cell", sorted(TINY))
def test_sound_run_is_correct(cell):
    r = _run(cell, seed=2 ** 33 + 7)
    assert r["correct"], r["checks"]
    assert "units: " in r["detail"]
    assert r["attempted"] > 0 and r["failed"] == 0
    assert list(r)[-1] == "checks" and r["device"]["platform"] == "cpu"
    assert set(r["metrics"]) == {m["name"] for m in run.metric_specs(
        run.load_json(run.ROOT / "BENCHMARK.json"), cell, "end_to_end")}


CELL_FAULTS = [
    ("flagship-sweep-ai", "state_unchanged"), ("flagship-sweep-ai", "half_batch"),
    ("flagship-sweep-ai", "action_altered"),
    ("flagship-sweep-habit", "state_unchanged"), ("flagship-sweep-habit", "half_batch"),
    ("flagship-sweep-habit", "action_altered"),
    ("flagship-train", "no_update"), ("flagship-train", "half_batch_mean"),
    ("flagship-train", "update_doubled"),
]


@pytest.mark.parametrize("cell,fault", CELL_FAULTS)
def test_broken_run_is_not_correct(cell, fault):
    with faults.FAULTS[fault]():
        r = _run(cell)
    assert not r["correct"], r["checks"]
    if fault == "no_update":  # a state left unchanged reads 1 by the change's measure
        assert r["checks"]["change_gap"]["value"] >= 0.99


def test_device_metrics_need_a_card():
    """No card here: the traced run raises, and the command exits non-zero
    with no result line."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    with pytest.raises((RuntimeError, AssertionError)):
        run.run_cell("flagship-sweep-habit", 1, 0.0, True, device="cpu",
                     overrides=TINY["flagship-sweep-habit"], t_start=time.perf_counter())
    assert run.main(["--workload", "flagship-sweep-habit", "--seed", "1", "--seconds", "1"]) == 3


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")


@pytest.mark.cuda
@pytest.mark.parametrize("cell", sorted(TINY))
def test_control_is_not_correct_on_card(card, cell):
    """The control: the program's own bf16 compute dtype, at the cell's own
    size, a short window."""
    r = run.run_cell(cell, 20240611, 5.0, False, dtype="bfloat16",
                     t_start=time.perf_counter())
    assert not r["correct"], r["checks"]
