"""PyTorch port: the compiled planner (``plan/mcts.py``'s ``make_jit_planner``,
the search loop replayed as a graph of one iteration, ``Graphs.while_loop``
of ``utils/graphs.py``).

On the CPU a graph's body runs op by op: ``EagerLoops`` below stands in for
``Graphs`` and runs ``while_loop`` through its twin ``eager_while_loop``, so
``graphed=True`` takes the graph's path (a device iteration counter, walks
of ``max_depth`` steps, each iteration's noise drawn ahead by
``draw_iteration``). These tests hold:

- that path equal to the eager iteration (a host counter, walks as deep as
  the tree, drawing as it goes), every result field, the tree and the
  paths bit for bit: unfused and fused, ``expand_k`` 1 and 4, ``crn``,
  sampled selection, ``use_habit``, the sampled estimator, bf16;
- ``draw_iteration``'s noise injected equal to the iteration drawing it;
- ``make_jit_planner(graphed=False)`` equal to ``active_inference_mcts``
  and, on the deterministic mock of tests/test_mcts.py, to the JAX
  package's ``make_jit_planner`` (``plan/mcts.py:1082``): integers equal,
  floats to ``FLOAT_TOL`` (tests/test_torch_mcts.py);
- the loop's stop rule, ``HostSlots``, and a graphed planner on the CPU
  raising;
- every entry point that plans (the sweep CLI and ``make_sweep``'s mcts,
  with and without ``--mcts_bucketed``, the demo, distillation's collect,
  the bench's MCTS keys) building its planner graphed by default, op by op
  when asked or under a mesh.

The compaction's graph path is held in tests/test_torch_mcts_compact.py.

``cuda``-marked tests hold each graphed planner against the same planner
op by op, bit for bit, the mcts sweeps' planners replaying their graphs
with the sweeps' defaults, and the flagship's compacting planner against
itself uncompacted, re-planned and op by op; without a card they skip. JAX and the JAX-side mocks
are imported only inside the tests that use them, so the card's machine
runs this file as
``python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_mcts_graphs.py``.
"""

import dataclasses
import gc
import inspect
import types
import weakref

import pytest
import torch

from deep_active_inference_mc_torch.envs import dsprites as tenv
from deep_active_inference_mc_torch.envs import raster as traster
from deep_active_inference_mc_torch.infer.agent import ActiveInferenceAgent
from deep_active_inference_mc_torch.plan import mcts as tmcts
from deep_active_inference_mc_torch.utils import graphs
from deep_active_inference_mc_torch.utils.device import seeded_generator

CPU = torch.device("cpu")
B = 4
RESULT_FIELDS = ("actions", "lengths", "repeats_done", "states_explored", "depth_capped",
                 "root_N", "root_Qpi")
BASE = dict(repeats=6, simulation_depth=2, max_depth=2, threshold=0.2)
# name: (MCTSParams fields over BASE, compute dtype)
VARIANTS = {
    "unfused": ({}, torch.float32),
    "depth_cap": (dict(max_depth=1, threshold=1.1), torch.float32),
    "fused": (dict(fused_eval=True), torch.float32),
    "expand_k4": (dict(expand_k=4, repeats=8), torch.float32),
    "fused_expand_k4": (dict(fused_eval=True, expand_k=4, repeats=8), torch.float32),
    "crn": (dict(crn=True), torch.float32),
    "sampled": (dict(deterministic_selection=False, deterministic_action=False),
                torch.float32),
    "use_habit": (dict(use_habit=True), torch.float32),
    "sampled_estimator": (dict(use_means=False, samples=2), torch.float32),
    "bf16": (dict(fused_eval=True), torch.bfloat16),
}


@pytest.fixture(autouse=True, scope="module")
def few_torch_threads():
    """Two intra-op threads: the suite runs in several processes at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


class EagerLoops:
    """``Graphs`` for any device: ``while_loop`` runs the body op by op."""

    def while_loop(self, body, carry, xs, n, stop, deps=tuple, key=(), until=bool):
        return graphs.eager_while_loop(body, carry, xs, n, stop, until)


def make_agent(dtype=torch.float32, device=CPU):
    agent = ActiveInferenceAgent(dtype=dtype)
    agent.init(seeded_generator(CPU, 0))
    return agent.to(device)


@pytest.fixture(scope="module")
def agents():
    return {dt: make_agent(dt) for dt in (torch.float32, torch.bfloat16)}


def frames_of(batch, device=CPU, seed=1):
    g = seeded_generator(device, seed)
    env = tenv.randomize(tenv.reset(g, batch, device), g)
    return tenv.render(traster.build_sprite_lut(device), env)


def params_of(agent, o, fields):
    p = tmcts.MCTSParams(**{**BASE, **fields})
    if p.use_habit:  # the median root confidence: phase A fires for some envs only
        with torch.inference_mode():
            _, q, _ = agent.habit(agent.encode(o)[0])
        p = dataclasses.replace(p, threshold=float(tmcts._calc_threshold(q).median()))
    return p


def assert_same(got, want, tree=False, paths=False):
    """Two MCTSResults bit for bit."""
    for f in RESULT_FIELDS:
        x, y = getattr(got, f), getattr(want, f)
        assert x.dtype == y.dtype and torch.equal(x, y), f
    if tree:
        for f in dataclasses.fields(tmcts._Tree):
            assert torch.equal(getattr(got.tree, f.name), getattr(want.tree, f.name)), f.name
    if paths:
        assert torch.equal(got.all_paths, want.all_paths)
        assert torch.equal(got.all_paths_G, want.all_paths_G)


def walk_lengths(monkeypatch):
    """Record the ``steps`` of every selection walk."""
    seen, real = [], tmcts._select

    def spy(*a, **kw):
        seen.append(kw.get("steps"))
        return real(*a, **kw)
    monkeypatch.setattr(tmcts, "_select", spy)
    return seen


# ------------------------------------------------------- the graph's body
@pytest.mark.parametrize("case", VARIANTS)
def test_graph_body_equals_the_eager_iteration(agents, monkeypatch, case):
    """A whole search (4 envs, 6 or 8 expansions, max_depth 2) through the
    graph's path, op by op, against the eager iterations from one seed:
    every result field, the tree and the collected paths bit for bit."""
    fields, dtype = VARIANTS[case]
    agent, o = agents[dtype], frames_of(B)
    p = params_of(agent, o, fields)
    collect = case != "crn"  # one variant without paths
    walks = walk_lengths(monkeypatch)
    want = tmcts.active_inference_mcts(agent, o, p, (3,), collect, return_tree=True,
                                       graphed=False)
    eager_walks = list(walks)
    monkeypatch.setattr(tmcts.graphs_lib, "Graphs", EagerLoops)
    walks.clear()
    got = tmcts.active_inference_mcts(agent, o, p, (3,), collect, return_tree=True,
                                      graphed=True)
    assert_same(got, want, tree=True, paths=collect)
    # The graph's walks are max_depth long; the eager ones grow with the tree.
    assert set(walks) == {p.max_depth} and min(eager_walks) == 1
    reps = want.repeats_done
    if case == "use_habit":
        assert 0 < int((reps == 0).sum()) < B  # phase A fired for some envs only
    if case == "unfused":
        assert int(reps.min()) < int(reps.max())  # some envs decide early
    if case == "depth_cap":
        assert int(want.depth_capped.sum()) > 0


@pytest.mark.parametrize("case", ["unfused", "fused_expand_k4", "crn", "sampled",
                                  "sampled_estimator"])
def test_draw_iteration_noise_equals_the_drawing_iteration(agents, case):
    """``draw_iteration`` from each iteration's generator, injected, gives
    the search that draws as it goes, bit for bit."""
    fields, dtype = VARIANTS[case]
    agent, o = agents[dtype], frames_of(B, seed=2)
    p = params_of(agent, o, fields)
    n_iters = tmcts._budget(p, agent.pi_dim)[0]
    iterations = [tmcts.draw_iteration(agent, p, B,
                                       seeded_generator(CPU, 5, tmcts._ITER_STREAM, i), CPU)
                  for i in range(n_iters)]
    want = tmcts.active_inference_mcts(agent, o, p, (5,), True, return_tree=True)
    got = tmcts.active_inference_mcts(agent, o, p, (5,), True, return_tree=True,
                                      draws=tmcts.SearchDraws(None, iterations))
    assert_same(got, want, tree=True, paths=True)


def test_a_graphed_search_takes_whole_draws(agents, monkeypatch):
    """The graph draws nothing itself: an iteration's draws without its
    simulation noise (or, sampled, its walks' Gumbel noise) raise."""
    agent, o = agents[torch.float32], frames_of(B)
    monkeypatch.setattr(tmcts.graphs_lib, "Graphs", EagerLoops)
    for fields, drop in (({}, "simulate"), (dict(deterministic_selection=False), "select")):
        p = params_of(agent, o, fields)
        d = tmcts.draw_iteration(agent, p, B, seeded_generator(CPU, 0), CPU)
        d = dataclasses.replace(d, **{drop: None})
        draws = tmcts.SearchDraws(None, [d] * p.repeats)
        with pytest.raises(ValueError, match="whole noise"):
            tmcts.active_inference_mcts(agent, o, p, (0,), draws=draws, graphed=True)


# ------------------------------------------------- make_jit_planner, JAX
@pytest.fixture
def mock_model(monkeypatch):
    """tests/test_torch_mcts.py's deterministic model in both packages."""
    from deep_active_inference_mc_tpu.plan import mcts as jmcts
    from test_mcts import mock_calculate_G_mean, mock_step_simulate
    from test_torch_mcts import t_mock_calculate_G_mean, t_mock_step_simulate

    monkeypatch.setattr(jmcts.efe, "calculate_G_mean", mock_calculate_G_mean)
    monkeypatch.setattr(jmcts.efe, "mcts_step_simulate", mock_step_simulate)
    monkeypatch.setattr(tmcts.efe, "calculate_G_mean", t_mock_calculate_G_mean)
    monkeypatch.setattr(tmcts.efe, "mcts_step_simulate", t_mock_step_simulate)


@pytest.mark.parametrize("case", ["prior1-seed0", "use_habit", "depth_cap", "expand_k4_ragged"])
def test_jit_planner_matches_the_jax_jit_planner(mock_model, case):
    """The same roots through the JAX ``make_jit_planner`` (jitted, paths
    collected) and the port's op by op, the phase-A draw injected: integers
    equal, floats to FLOAT_TOL; and the port's equal to
    ``active_inference_mcts`` bit for bit."""
    import jax
    import jax.numpy as jnp

    from deep_active_inference_mc_tpu.plan import mcts as jmcts
    from test_mcts import MockAgent
    from test_torch_losses import t
    from test_torch_mcts import MOCK_CASES, TMockAgent, assert_results_equal, mock_roots

    fields, batch, seed, peaked = MOCK_CASES[case]
    roots = mock_roots(batch, seed, peaked)
    key = jax.random.key(seed)
    want = jmcts.make_jit_planner(MockAgent(), jmcts.MCTSParams(**fields), collect_paths=True)(
        {}, key, jnp.asarray(roots))
    draws = tmcts.SearchDraws(None, None, t(jax.random.gumbel(jax.random.split(key, 4)[0],
                                                              (batch, 4))))
    p = tmcts.MCTSParams(**fields)
    plan = tmcts.make_jit_planner(TMockAgent(), p, collect_paths=True, graphed=False)
    got = plan(torch.from_numpy(roots), (seed,), draws=draws)
    assert_results_equal(got, want, paths=True)
    same = tmcts.active_inference_mcts(TMockAgent(), torch.from_numpy(roots), p, (seed,),
                                       collect_paths=True, draws=draws)
    assert_same(got, same, paths=True)
    assert plan.graphs.captures == 0 and got.tree is None


# ------------------------------------------------------------ the helper
def test_loop_stops_one_step_after_its_flag():
    """``stop`` is read one step late: a counter that should stop at 3
    runs one step more; ``n`` bounds the loop."""
    body = lambda c, x: c + x
    stop = lambda c: c >= 3
    ones = lambda: iter([torch.tensor(1)] * 10)
    carry, ran = graphs.eager_while_loop(body, torch.tensor(0), ones(), 10, stop)
    assert (int(carry), ran) == (4, 4)
    carry, ran = graphs.eager_while_loop(body, torch.tensor(0), ones(), 2, stop)
    assert (int(carry), ran) == (2, 2)
    carry, ran = graphs.eager_while_loop(body, torch.tensor(5), ones(), 10, stop)
    assert (int(carry), ran) == (6, 1)  # the first step runs unchecked


def test_graphed_planners_raise_on_the_cpu(agents):
    """``graphed=True`` on CPU tensors raises (no fallback); the default
    runs op by op there."""
    agent, o = agents[torch.float32], frames_of(2)
    p = tmcts.MCTSParams(repeats=2, max_depth=3)
    runs = (lambda: tmcts.make_jit_planner(agent, p, graphed=True)(o, (0,)),
            lambda: tmcts.active_inference_mcts(agent, o, p, (0,), graphed=True))
    for run in runs:
        with pytest.raises(ValueError, match="CUDA tensors only"):
            run()
    with pytest.raises(ValueError, match="CUDA tensors only"):
        graphs.Graphs().while_loop(lambda c, x: c, torch.zeros(2), iter([None]), 1,
                                   lambda c: c.all())
    plan = tmcts.make_jit_planner(agent, p)
    assert plan(o, (0,)).actions.shape == (2, 3) and plan.graphs.captures == 0


def test_host_slots_keep_each_copy_until_two_later():
    """``HostSlots`` hands back copy k until copy k + 2 is put, and takes a
    new shape."""
    slots = graphs.HostSlots()
    slots.put(0, torch.tensor([True, False]))
    slots.put(1, torch.tensor([False]))
    assert slots.get(0).tolist() == [True, False] and slots.get(1).tolist() == [False]
    slots.put(2, torch.tensor([False, True, True]))
    assert slots.get(2).tolist() == [False, True, True] and slots.get(1).tolist() == [False]


class _Built(Exception):
    """A planner was built: (kind, its ``graphed``)."""


def _cli_sweep(*flags, graphed=None):
    from deep_active_inference_mc_torch.apps import sweep as sweep_app

    argv = ["--method", "mcts", "--device", "cpu", "--envs", "2", "--macro", "1", *flags]
    return lambda agent, lut: sweep_app.main(argv, graphed=graphed)


def _make_sweep(**kw):
    from deep_active_inference_mc_torch.config import Config
    from deep_active_inference_mc_torch.train import sweep as sweep_lib

    return lambda agent, lut: sweep_lib.make_sweep(agent, Config(), lut, method="mcts", **kw)


def _demo(agent, lut):
    from deep_active_inference_mc_torch.apps import demo as demo_app

    demo_app.Demo(agent, demo_app.build_parser().parse_args(["--device", "cpu"]))


def _distiller(agent, lut):
    from deep_active_inference_mc_torch.config import Config
    from deep_active_inference_mc_torch.train.distill import Distiller

    Distiller(agent, Config(), lut)


def _bench(name, **kw):
    from deep_active_inference_mc_torch import bench

    return lambda agent, lut: getattr(bench, name)(agent, lut, **kw)


# entry point: (how it is called, the planner it must build and its ``graphed``).
# None: graphed on a card; False: op by op.
ENTRY_POINTS = {
    "sweep_cli_mcts": (_cli_sweep(), ("jit", None)),
    "sweep_cli_mcts_bucketed": (_cli_sweep("--mcts_bucketed"), ("jit", None)),
    "sweep_cli_mcts_op_by_op": (_cli_sweep(graphed=False), ("jit", False)),
    "sweep_cli_bucketed_op_by_op": (_cli_sweep("--mcts_bucketed", graphed=False),
                                    ("jit", False)),
    "make_sweep_mcts": (_make_sweep(), ("jit", None)),
    "make_sweep_mcts_mesh": (_make_sweep(mesh=object()), ("jit", False)),
    "demo": (_demo, ("jit", None)),
    "distiller": (_distiller, ("jit", None)),
    "bench_mcts_plans": (_bench("bench_mcts_plans", batch=2), ("jit", None)),
}


@pytest.mark.parametrize("case", ENTRY_POINTS)
def test_each_entry_point_builds_its_planner_graphed_by_default(agents, monkeypatch, case):
    """Every path that plans builds ``make_jit_planner`` with
    ``graphed=None`` (a graph on a card) unless it is asked for op by op or
    runs under a mesh (gloo cannot be captured): the sweep's mcts once set
    it to False by mistake."""
    def spy(kind, real):
        def build(*a, **kw):
            raise _Built(kind, inspect.signature(real).bind(*a, **kw).arguments.get("graphed"))
        return build

    monkeypatch.setattr(tmcts, "make_jit_planner", spy("jit", tmcts.make_jit_planner))
    run, want = ENTRY_POINTS[case]
    with pytest.raises(_Built) as built:
        run(agents[torch.float32], traster.build_sprite_lut(CPU))
    assert built.value.args == want


# ------------------------------------------------------------ on a card
@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: run `python -m pytest --noconftest -m cuda "
                    "tests/test_torch_mcts_graphs.py` on one")
    return torch.device("cuda")


@pytest.mark.cuda
def test_each_graphed_planner_replays_its_eager_search(cuda_device):
    """On a card, from one seed: ``make_jit_planner`` graphed against op by
    op in each variant (paths collected), every result field bit-equal; a
    second plan replays without a new capture. With cuDNN's defaults the
    decoder's transposed convolutions sum with atomics, so G differs eager
    against eager in the last bits; its deterministic algorithms leave
    nothing to differ by. A compacting plan graphed against op by op:
    ``test_the_flagship_planner_compacts_as_it_plans_uncompacted``."""
    saved = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        replay_each_planner(cuda_device)
    finally:
        torch.backends.cudnn.deterministic = saved


def replay_each_planner(dev):
    agents_ = {dt: make_agent(dt, dev) for dt in (torch.float32, torch.bfloat16)}
    o = frames_of(16, dev)
    for case, (fields, dtype) in VARIANTS.items():
        agent = agents_[dtype]
        p = params_of(agent, o, {**fields, "repeats": 12, "max_depth": 8})
        want = tmcts.make_jit_planner(agent, p, True, graphed=False)(o, (3,))
        plan = tmcts.make_jit_planner(agent, p, True)
        got = plan(o, (3,))
        assert_same(got, want, paths=True)
        assert_same(plan(o, (3,)), want, paths=True)
        assert plan.graphs.captures == 1, case


@pytest.mark.cuda
def test_the_mcts_sweeps_replay_their_planners(cuda_device, monkeypatch):
    """The sweep's ``mcts`` (``make_sweep``) and ``run_sweep_bucketed``,
    with their defaults on a card: the planner replays its graphs, and the
    scores equal the sweep's op by op."""
    from deep_active_inference_mc_torch.config import Config
    from deep_active_inference_mc_torch.train import sweep as sweep_lib

    saved = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        agent, cfg = make_agent(device=cuda_device), Config()
        lut = traster.build_sprite_lut(cuda_device)
        p = tmcts.MCTSParams(repeats=8, simulation_depth=2, max_depth=4)
        plain = {}
        for graphed in (False, None):
            g = seeded_generator(cuda_device, 1)
            env = tenv.randomize(tenv.reset(g, 16, cuda_device), g)
            run = sweep_lib.make_sweep(agent, cfg, lut, method="mcts", n_macro_steps=2,
                                       mcts_params=p, graphed=graphed)
            plain[graphed] = (run(seeded_generator(cuda_device, 2), env)["scores"],
                              run.planner.graphs.replays)
        assert plain[False][1] == 0 and plain[None][1] > 0
        assert torch.equal(plain[None][0], plain[False][0])
        planners, real = [], tmcts.make_jit_planner

        def keep(*a, **kw):
            planners.append(real(*a, **kw))
            return planners[-1]

        monkeypatch.setattr(tmcts, "make_jit_planner", keep)
        bucketed = {}
        for graphed in (False, None):
            out = sweep_lib.run_sweep_bucketed(agent, cfg, lut, n_envs=64, n_macro_steps=2,
                                               mcts_params=p, graphed=graphed)
            bucketed[graphed] = (out["scores"], planners[-1].graphs.replays)
        assert bucketed[False][1] == 0 and bucketed[None][1] > 0
        assert torch.equal(bucketed[None][0], bucketed[False][0])
    finally:
        torch.backends.cudnn.deterministic = saved


class LazyDraws:
    """Every iteration's whole-batch noise, ``draw_iteration``'s from the
    iteration's own generator, drawn when asked for."""

    def __init__(self, agent, p, B, device, seed):
        self.args, self.device, self.seed = (agent, p, B), device, seed

    def __getitem__(self, i):
        g = seeded_generator(self.device, self.seed, i)
        return tmcts.draw_iteration(*self.args, g, self.device)


@pytest.mark.cuda
def test_the_flagship_planner_compacts_as_it_plans_uncompacted(cuda_device, monkeypatch):
    """The committed flagship at 256 envs with the benchmark's planner (300
    repeats, the habit short-circuit), graphed, every iteration's noise
    handed in whole. Exact: a re-plan through ``active_inference_mcts`` with
    paths and tree, as the benchmark's check re-plans, equals the compacted
    plan bit for bit, and under cuDNN's deterministic algorithms the graphed
    compacting plan equals its op-by-op run, schedule and all. Against the
    plan with ``MIN_BUCKET`` at 256: cuBLAS's FP32 GEMMs and cuDNN's TF32
    convolutions pick their kernels by row count, so a bucket's G differs
    from the whole batch's in its last bits (within four TF32 roundings,
    4 x 2^-11, relative), and a near tie among the stragglers may fall the
    other way: at most 8 of the 256 envs differ in actions, lengths,
    ``repeats_done`` or root visits (PERF.md: 1-3 a plan)."""
    from pathlib import Path

    from deep_active_inference_mc_torch.apps import sweep as sweep_app
    from deep_active_inference_mc_torch.config import Config

    flagship = Path(__file__).resolve().parent.parent / "artifacts" / "run512" / "checkpoints"
    agent = sweep_app.build_agent(Config(), str(flagship), cuda_device).eval()
    p = tmcts.MCTSParams(repeats=300, threshold=0.5, simulation_depth=3, use_habit=True,
                         max_depth=16)
    o = frames_of(256, cuda_device, seed=4)
    draws = lambda: tmcts.SearchDraws(None, LazyDraws(agent, p, 256, cuda_device, 11))
    floor = tmcts.MIN_BUCKET

    def plan(smallest, graphed=None):
        monkeypatch.setattr(tmcts, "MIN_BUCKET", smallest)
        planner = tmcts.make_jit_planner(agent, p, graphed=graphed)
        return planner(o, (5,), draws=draws()), planner.schedule

    compacted, schedule = plan(floor)
    assert schedule and schedule[-1][1] < 256, schedule
    again = tmcts.active_inference_mcts(agent, o, p, (5,), collect_paths=True,
                                        return_tree=True, draws=draws(), graphed=None)
    assert_same(again, compacted)
    saved = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        graphed, graphed_schedule = plan(floor)
        eager, eager_schedule = plan(floor, graphed=False)
    finally:
        torch.backends.cudnn.deterministic = saved
    assert_same(graphed, eager)
    assert graphed_schedule == eager_schedule

    whole, none = plan(256)
    assert none == []
    differ = torch.zeros(256, dtype=torch.bool, device=cuda_device)
    for f in ("actions", "lengths", "repeats_done", "root_N"):
        x, y = getattr(compacted, f), getattr(whole, f)
        differ |= (x != y).reshape(256, -1).any(-1)
    assert int(differ.sum()) <= 8, torch.nonzero(differ).flatten().tolist()
    with torch.inference_mode():
        g = seeded_generator(cuda_device, 9)
        leaf = agent.encode(o)[0] + 0.3 * torch.randn((256, 10), generator=g, device=cuda_device)
        d = tmcts.draw_iteration(agent, p, 256, g, cuda_device)
        full = tmcts._evaluate(agent, leaf, p, None, d)
        for size in (128, 64, 32, 16):
            env = torch.randperm(256, generator=g, device=cuda_device)[:size].sort().values
            rows = tmcts._bucket_rows(env, 256, p, agent.pi_dim)
            part = tmcts._evaluate(agent, leaf[env], p, None, tmcts._gather_draws(d, rows))
            for name, x, y in (("G_leaf", part[0], full[0]), ("G_sim", part[2], full[2])):
                torch.testing.assert_close(x, y[env], rtol=4 * 2 ** -11, atol=0,
                                           msg=f"{name} at {size}")


@pytest.mark.cuda
def test_a_capture_runs_without_the_cyclic_collector(cuda_device):
    """Dead cycles are collected before a capture and none during it: a
    collection there could destroy a dead planner's graphs, which
    invalidates the capture. A body records the collector's state at the
    warm-up step and at the capture; a cycle dropped before the loop is
    gone by the capture."""
    class Cycle:
        pass

    dead = Cycle()
    dead.self = dead
    gone = weakref.finalize(dead, lambda: None)
    del dead
    seen = []

    def body(c, x):
        seen.append((gc.isenabled(), gone.alive))
        return c + x

    carry = torch.zeros((), device=cuda_device)
    ones = iter([torch.ones((), device=cuda_device)] * 3)
    out, ran = graphs.Graphs().while_loop(body, carry, ones, 3, lambda c: c > 5)
    assert ran == 3 and float(out) == 3.0
    assert seen[1] == (False, False) and gc.isenabled()
