"""The benchmark's planner cell on the CPU: the plain reference of the search
(``portbench/reference/mcts.py``) against the port's planner on seeded
random weights, the cell end to end at a tiny size (a sound run is
correct, each planted fault of ``portbench/search_faults.py`` is not), and
the cell's four readers on synthetic spans and counters. The file imports
no JAX."""

import importlib.util
import time

import numpy as np
import pytest
import torch

from deep_active_inference_mc_torch.envs import dsprites, raster
from deep_active_inference_mc_torch.envs.dsprites import EnvState
from deep_active_inference_mc_torch.infer import efe
from deep_active_inference_mc_torch.infer.agent import ActiveInferenceAgent
from deep_active_inference_mc_torch.plan import mcts
from deep_active_inference_mc_torch.utils import convert
from deep_active_inference_mc_torch.utils.profiling import Span
from portbench import faults, run, search_faults
from portbench.reference import env as ref_env
from portbench.reference import mcts as ref
from portbench.reference import nets
from portbench.tracing import Records
from portbench.yardstick import flops, search, seeds, traffic

CPU = torch.device("cpu")
CELL = "flagship-mcts-256"
CFG = run.config(run.workload(CELL)["config"])
TINY = {"envs": 4, "episode": 2, "check_steps": 1, "check_envs": 2}
TINY_PLANNER = {"repeats": 8, "simulation_depth": 2}


@pytest.fixture(autouse=True, scope="module")
def few_torch_threads():
    """Two intra-op threads: the suite runs in several processes at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    """Seeded random weights of the flagship's shapes, as the reference
    reads them (``params/<path>``) and as the port loads them."""
    rng = np.random.default_rng(7)

    def leaf(name, shape):  # He-scaled kernels, small biases
        if name.endswith("bias"):
            return 0.1 * rng.standard_normal(shape)
        return rng.standard_normal(shape) * np.sqrt(2.0 / np.prod(shape[:-1]))

    with np.load(run.ROOT / CFG["weights_file"]) as z:
        tree = {k: leaf(k, z[k].shape).astype(np.float32) for k in z.files
                if k.startswith("params/")}
    path = tmp_path_factory.mktemp("weights") / "random.npz"
    np.savez(path, **tree)
    P = nets.Params(path, CPU)
    flat = tmp_path_factory.mktemp("weights") / "flat.npz"
    np.savez(flat, **{k[len("params/"):]: v for k, v in tree.items()})
    agent = ActiveInferenceAgent()
    agent.load_state_dict(convert.load_npz(flat))
    return P, agent.eval()


def _knobs(threshold):
    planner = dict(CFG["planner"], repeats=12, simulation_depth=2, threshold=threshold)
    return planner, mcts.MCTSParams(**planner), ref.Knobs.of(planner, CFG["dropout"], 4)


def _noise(B, depth, n_iters):
    g = seeds.generator(CPU, 2 ** 33 + 5, 2, 0)
    step = search.step_noise(g, B, CFG, 5, CPU)
    iters = [search.iteration_noise(g, B, CFG, depth, CPU) for _ in range(n_iters)]
    return step, iters


def _port_draws(step, iters):
    r = step["root"]

    def one(n):
        e, ro, t = n["expand"], n["rollout"], n["trajectory"]
        return mcts.IterationDraws(
            expand=efe.GDraws(e["masks1"], e["masks2"], e["eps_fixed"]),
            simulate=efe.SimulateDraws(efe.HabitRolloutDraws(ro["gumbel"], ro["masks"],
                                                             ro["eps"]),
                                       efe.TrajectoryDraws(t["masks"], t["eps"],
                                                           t["eps_fixed"])))

    return mcts.SearchDraws(efe.GDraws(r["masks1"], r["masks2"], r["eps_fixed"]),
                            [one(n) for n in iters], habit_gumbel=step["habit_gumbel"])


@torch.inference_mode()
def test_reference_search_matches_the_port_planner(weights):
    """4 envs, 12 repeats, simulation depth 2, the threshold between the
    envs' habit confidences so that phase A acts for some and not others:
    the same root visits, ``repeats_done``, actions and phase-A decisions;
    the expand G of the same states within float32's rounding."""
    P, agent = weights
    B = 4
    lat, score, last_r = traffic.episode_start(seeds.generator(CPU, 3, 1, 0), B, CPU)
    o = ref_env.render(ref_env.lut(CPU), lat, last_r)
    assert torch.equal(o, dsprites.render(raster.build_sprite_lut(CPU),
                                          EnvState(lat, score, last_r)))
    s0, _ = nets.encode(P, o)
    _, Qpi = nets.habit(P, s0)
    conf = np.sort((Qpi.max(-1).values - Qpi.mean(-1)).numpy())
    planner, p, kn = _knobs(float(conf[1] + conf[2]) / 2)
    step, iters = _noise(B, 2, 12)
    got = mcts.active_inference_mcts(agent, o, p, draws=_port_draws(step, iters),
                                     return_tree=True)
    idx = torch.arange(B)
    want = ref.search(P, s0, Qpi, step["root"], step["habit_gumbel"],
                      lambda i: ref.select_rows(iters[i], idx, 4), kn)
    assert want["short_circuit"].tolist() == (got.repeats_done == 0).tolist()
    assert 0 < want["short_circuit"].sum() < B
    np.testing.assert_array_equal(want["repeats"], got.repeats_done.numpy())
    np.testing.assert_array_equal(want["root_N"], got.root_N.numpy())
    first = torch.where(got.lengths > 0, got.actions[:, 0], got.root_N.argmax(-1))
    np.testing.assert_array_equal(want["action"], first.numpy())
    # The expand G of the same states under the same noise.
    s = got.tree.s[:, :5].reshape(-1, agent.s_dim)
    n = search.iteration_noise(seeds.generator(CPU, 9), s.shape[0], CFG, 2, CPU)["expand"]
    G_port, next_port = mcts._expand_G(agent, s, p, draws=efe.GDraws(**n))
    G_ref, next_ref = ref.expand(P, s, n, CFG["dropout"], 4)
    torch.testing.assert_close(G_port, G_ref, rtol=2e-5, atol=1e-3)
    torch.testing.assert_close(next_port, next_ref, rtol=1e-5, atol=1e-5)


@torch.inference_mode()
def test_reference_simulation_matches_the_port(weights):
    """The habit rollout and trajectory G of the same leaf states under the
    same noise, depth 3: the reference's G_sim within float32's rounding of
    the port's ``mcts_step_simulate``, and every rollout's draw margin
    positive."""
    P, agent = weights
    s = torch.randn((6, agent.s_dim), generator=torch.Generator().manual_seed(4))
    n = search.iteration_noise(seeds.generator(CPU, 2 ** 33 + 9), 6, CFG, 3, CPU)
    ro, t = n["rollout"], n["trajectory"]
    G_port, _, _ = efe.mcts_step_simulate(
        agent, s, 3, draws=efe.SimulateDraws(
            efe.HabitRolloutDraws(ro["gumbel"], ro["masks"], ro["eps"]),
            efe.TrajectoryDraws(t["masks"], t["eps"], t["eps_fixed"])))
    G_ref, margin = ref.simulate(P, s, ro, t, CFG["dropout"], 4)
    torch.testing.assert_close(G_port, G_ref, rtol=2e-5, atol=1e-3)
    assert (margin > 0).all()


def test_trim_keeps_the_references_bound():
    assert ref.trimmed([0, 1, 2], 4) == []  # a pair, then the last action unemitted
    assert ref.trimmed([2, 2, 0], 4) == [2, 2]
    assert ref.trimmed([3, 2, 0, 0], 4) == [0]
    assert ref.trimmed([1], 4) == []


def _run(monkeypatch, seed=2 ** 33 + 7, **over):
    """The cell at a tiny size: its workload through ``overrides``, its
    configuration with a small planner budget (and ``over``) through a
    configuration of the test's own."""
    cfg = dict(CFG, planner=dict(CFG["planner"], **TINY_PLANNER, **over))
    monkeypatch.setattr(run, "config", lambda name: cfg)
    return run.run_cell(CELL, seed, 0.0, False, device="cpu", overrides=TINY,
                        t_start=time.perf_counter())


def test_sound_run_is_correct(monkeypatch):
    r = _run(monkeypatch)
    assert r["correct"], r["checks"]
    assert r["attempted"] == 4 and r["failed"] == 0
    assert set(r["checks"]) == {"expand_gap", "choice_gap", "sim_gap", "habit_gap",
                                "mismatches", "end_state"}
    assert "2 searches replayed" in r["detail"] and "0 envs differ" in r["detail"]
    assert set(r["metrics"]) == {"env_steps_per_s", "setup_s"}


# The habit short-circuit never taken, at a threshold that most of the tiny
# batch's envs pass (the flagship's habit passes 0.5 for about 3 % of fresh
# envs, 0.02 for about 90 %).
FAULT_KNOBS = {"short_circuit_off": {"threshold": 0.02}}


@pytest.mark.parametrize("fault", sorted(search_faults.FAULTS))
def test_planted_fault_reads_over_its_limit(fault, monkeypatch):
    with search_faults.FAULTS[fault]():
        r = _run(monkeypatch, **FAULT_KNOBS.get(fault, {}))
    assert not r["correct"], (fault, r["checks"])
    if fault.startswith("sim_"):  # caught by the simulation's check alone
        limits = run.workload(CELL)["limits"]
        assert [k for k, v in r["checks"].items() if v["value"] > limits[k]] == ["sim_gap"]


def test_search_faults_extend_the_control(monkeypatch):
    seen = {}
    monkeypatch.setattr(faults, "FAULTS", dict(faults.FAULTS))
    monkeypatch.setattr("portbench.control.main", lambda argv: seen.update(
        names=set(faults.FAULTS)) or 0)
    assert search_faults.main(["--workload", CELL]) == 0
    assert set(search_faults.FAULTS) <= seen["names"]
    assert "state_unchanged" in seen["names"]


# ------------------------------------------------------------ the readers
T = 1_700_000_000
NS = 10 ** 9
TRACED = Records({}, {}, [("gemm", T + 10.0, T + 10.4), ("copy", T + 10.6, T + 11.0)],
                 (T + 10.0, T + 11.0))
EMPTY = Records({}, {}, [], None)


def reader(name):
    spec = importlib.util.spec_from_file_location(f"reader_{name}",
                                                  run.BENCH / "metrics" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def span(name, start_s, end_s, parent=None, thread=1):
    lo, hi = T * NS + round(start_s * NS), T * NS + round(end_s * NS)
    return Span(name, parent, lo, hi, hi - lo, thread)


def test_plan_iteration_ms_is_the_median_device_span():
    spans = [span("mcts.device", t, t + ms / 1e3, thread=None)
             for t, ms in ((2.0, 9.0), (5.0, 11.0), (9.0, 10.0))]
    spans.append(span("mcts.plan", 1.0, 4.0, parent="sweep.run"))
    assert reader("plan_iteration_ms.mcts")(TRACED, spans) == pytest.approx(10.0)
    assert reader("plan_iteration_ms.mcts")(EMPTY, spans) is None
    assert reader("plan_iteration_ms.mcts")(TRACED, spans[-1:]) is None


def test_plan_waste_is_the_share_of_decided_envs_iterations():
    rec = Records({"mcts.iterations": 600, "mcts.env_iterations": 256 * 150,
                   "mcts.envs": 256}, {}, [], None)
    assert reader("plan_waste_pct.mcts")(rec) == pytest.approx(75.0)
    for missing in ("mcts.iterations", "mcts.env_iterations", "mcts.envs"):
        c = dict(rec.counters)
        del c[missing]
        assert reader("plan_waste_pct.mcts")(Records(c, {}, [], None)) is None


def test_program_idle_and_mfu_of_the_planner_cell():
    spans = [span("mcts.plan", 10.5, 10.8, parent="sweep.run")]
    assert reader("program_idle_pct.mcts")(TRACED, spans) == pytest.approx(10.0)
    assert reader("program_idle_pct.mcts")(EMPTY, spans) is None
    rec = Records({"flops": 495e12 * 0.5, "window_s": 10.0}, {}, [], None)
    assert reader("mfu.mcts")(rec) == pytest.approx(5.0)
    assert reader("mfu.mcts")(EMPTY) is None


def test_plan_flops_counts_expand_rollout_and_trajectory():
    f = flops.per_row(CFG)
    expand = 4 * (2 * f["transition"] + 3 * f["decoder"] + f["encoder"])
    root = f["encoder"] + f["habit"]
    iteration = (expand + 3 * (f["habit"] + f["transition"])
                 + 3 * (f["transition"] + 3 * f["decoder"] + f["encoder"]))
    assert search.plan_flops(CFG, 2, 1, 0, 0, 3) == 2 * (root + expand)
    # 3 plans of 2 envs, one env short-circuited, 7 iterations searched in all
    assert search.plan_flops(CFG, 2, 3, 1, 7, 3) == 6 * root + 5 * expand + 7 * iteration
