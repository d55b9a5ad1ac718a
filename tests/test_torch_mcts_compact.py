"""PyTorch port: the plain planner's batch compaction (``plan/mcts.py``
``_run_compacted``) on the deterministic mock of tests/test_torch_mcts.py.

With ``MIN_BUCKET`` set low, the plain planner compacts these small batches.
The mock's evaluators here also read the noise they are given, row by row
(``NOISE`` times a sum of each row's draws), so an env that read another
env's rows after a compaction would grow another tree. In each case:

- the compacting planner equals itself with compaction off (``MIN_BUCKET``
  at the batch) bit for bit, with and without the noise: every result and
  tree field and ``all_paths``; ``all_paths_G`` wherever the path row is
  valid (a retired env's later rows are no longer computed);
- without the noise (the model of tests/test_mcts.py) it equals the JAX
  plain planner: integers equal, floats to ``FLOAT_TOL``;
- two calls compact at the same iterations, those that the envs'
  ``repeats_done`` give for a count read one iteration late.

The counters ``mcts.row_iterations`` and ``mcts.compactions`` are held to
the schedule, and the graph's path (a device iteration counter, whole-batch
draws gathered in the body) to the op-by-op search in every case, through a
stand-in for ``Graphs`` that runs its loops op by op. A gathered bucket
shares no storage with the batch it came from, and ``bucket_size`` gives
the smallest power-of-two bucket at or above ``MIN_BUCKET``.
"""

import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deep_active_inference_mc_tpu.plan import mcts as jmcts
from deep_active_inference_mc_torch.infer import efe as tefe
from deep_active_inference_mc_torch.plan import mcts as tmcts
from deep_active_inference_mc_torch.utils import graphs as graphs_lib
from deep_active_inference_mc_torch.utils import profiling
from deep_active_inference_mc_torch.utils.device import seeded_generator
from test_mcts import A, S_DIM, MockAgent, mock_calculate_G_mean, mock_step_simulate
from test_torch_losses import t
from test_torch_mcts import mock_model  # noqa: F401 (fixture)
from test_torch_mcts import (RESULT_FLOATS, RESULT_INTS, TMockAgent, assert_results_equal,
                             iterations, mock_roots, t_mock_calculate_G_mean,
                             t_mock_step_simulate)
from test_torch_models import few_torch_threads  # noqa: F401 (autouse fixture)

CPU = torch.device("cpu")
FLOOR = 2  # MIN_BUCKET while compacting
NOISE = 0.05  # the weight of the draws in the noisy model's G

# name: (MCTSParams fields, batch, root seed, peaked (env, action) pairs,
#        collect paths, injected draws, compared with the JAX planner)
CASES = {
    # Some envs decide quickly, others search the whole budget.
    "compaction": (dict(repeats=24, threshold=0.28, max_depth=16), 16, 3, (), False, False, True),
    # Five phase-A envs of eight start done: the first count read compacts.
    "phase_a": (dict(repeats=24, threshold=0.35, use_habit=True, max_depth=16),
                8, 3, ((0, 1), (1, 2), (3, 3), (4, 0), (6, 2)), False, False, True),
    # A batch that is no power of two.
    "odd_batch": (dict(repeats=24, threshold=0.28, max_depth=16), 11, 3, (), False, False, True),
    "expand_k2": (dict(repeats=24, threshold=0.2, max_depth=16, expand_k=2), 16, 3, (),
                  True, False, True),
    # The fused evaluator's row layout (its model: the unfused one's numbers).
    "fused": (dict(repeats=24, threshold=0.28, max_depth=16, fused_eval=True), 16, 3, (),
              False, False, True),
    # Every iteration's noise handed in, whole, as a caller's SearchDraws.
    "injected": (dict(repeats=24, threshold=0.28, max_depth=16), 16, 3, (), False, True, True),
    "paths_and_tree": (dict(repeats=24, threshold=0.28, max_depth=16), 16, 3, (), True, False,
                       True),
    # Sampled walks: the walks' Gumbel noise is gathered too (the JAX
    # planner draws its own).
    "sampled_walks": (dict(repeats=24, threshold=0.15, max_depth=16,
                           deterministic_selection=False), 16, 3, (), True, False, False),
}


class DrawingMock(TMockAgent):
    """The mock agent with what ``draw_iteration`` reads."""

    s_dim, dtype = S_DIM, torch.float32
    mid = types.SimpleNamespace(draw_masks=lambda rows, g, d: [
        torch.rand((rows, 3), generator=g, device=d) < 0.5 for _ in range(3)])


def _per_row(*xs):
    """Each row's sum of the first column of ``xs`` (tensors, or sequences
    of keep-masks)."""
    total = 0.0
    for x in xs:
        for y in (x if isinstance(x, (list, tuple)) else [x]):
            total = total + y[:, 0].to(torch.float32)
    return total


def noisy_model(weight):
    """The mock's evaluators, drawing as the real ones do where they are
    given no draws, and adding ``weight`` times each row's draws."""

    def G_mean(agent, s0, pi0, generator=None, draws=None):
        if draws is None:
            draws = tefe.draw_G(agent, s0.shape[0], generator, s0.device, sampled=False)
        G, _, ps_next, _ = t_mock_calculate_G_mean(agent, s0, pi0)
        if weight:
            G = G + weight * _per_row(draws.masks1, draws.masks2, draws.eps_fixed)
        return G, None, ps_next, None

    def simulate(agent, leaf_s, depth, use_means=False, generator=None, draws=None):
        rows = leaf_s.shape[0]
        if draws is None:
            draws = tefe.draw_simulate(agent, rows, depth, generator, leaf_s.device)
        G, _, qpi = t_mock_step_simulate(agent, leaf_s, depth)
        if weight:
            r, tr = draws.rollout, draws.trajectory
            steps = sum(_per_row(r.gumbel[d], r.eps[d], r.masks[d]) for d in range(depth))
            traj = _per_row(tr.masks, tr.eps, tr.eps_fixed).reshape(depth, rows).sum(0)
            G = G + weight * (steps + traj)
        return G, None, qpi

    def fused(agent, leaf_s, p, generator=None, draws=None):
        L, D = leaf_s.shape[0], p.simulation_depth
        if draws is None:
            draws = tmcts._draw_fused(agent, L, p, generator, leaf_s.device)
        G, _, ps_next, _ = t_mock_calculate_G_mean(
            agent, leaf_s.repeat_interleave(A, dim=0), agent.pi_one_hot.repeat(L, 1))
        G_sim, _, qpi = t_mock_step_simulate(agent, leaf_s, D)
        if weight:
            n1, m = L * A, draws.masks
            G = G + weight * (_per_row(draws.eps_rep1) + _per_row(m[0][:n1], m[1][n1:2 * n1]))
            r = draws.rollout
            traj = _per_row(draws.eps_traj, draws.eps_rep2, m[2][2 * n1:])
            G_sim = G_sim + weight * (traj.reshape(D, L).sum(0) + sum(
                _per_row(r.gumbel[d], r.eps[d], r.masks[d]) for d in range(D)))
        return G.reshape(L, A), ps_next.reshape(L, A, -1), G_sim, qpi

    return G_mean, simulate, fused


@pytest.fixture
def model(monkeypatch):
    """``set(weight)``: the noisy model in the port at that weight; the
    JAX package takes the mock of tests/test_mcts.py."""
    monkeypatch.setattr(jmcts.efe, "calculate_G_mean", mock_calculate_G_mean)
    monkeypatch.setattr(jmcts.efe, "mcts_step_simulate", mock_step_simulate)

    def set_weight(weight):
        G_mean, simulate, fused = noisy_model(weight)
        monkeypatch.setattr(tmcts.efe, "calculate_G_mean", G_mean)
        monkeypatch.setattr(tmcts.efe, "mcts_step_simulate", simulate)
        monkeypatch.setattr(tmcts, "_fused_expand_sim", fused)

    return set_weight


def search_draws(p, B, seed, habit_gumbel, injected):
    """The phase-A draw's noise and, where ``injected``, every
    iteration's and the root's, whole."""
    if not injected:
        return tmcts.SearchDraws(None, None, habit_gumbel)
    agent, n_iters = DrawingMock(), tmcts._budget(p, A)[0]
    g = lambda *k: seeded_generator(CPU, seed, 9, *k)
    root = tefe.draw_G(agent, B * A, g(0), CPU, sampled=False)
    iterations = [tmcts.draw_iteration(agent, p, B, g(1, i), CPU) for i in range(n_iters)]
    return tmcts.SearchDraws(root, iterations, habit_gumbel)


def plan(case, floor, monkeypatch, graphed=False):
    """One search of ``case`` with ``MIN_BUCKET`` at ``floor``:
    (``make_jit_planner``'s result with the tree, its schedule)."""
    fields, B, seed, peaked, paths, injected, _ = CASES[case]
    p = tmcts.MCTSParams(**fields)
    key = jax.random.key(seed)
    habit = t(jax.random.gumbel(jax.random.split(key, 4)[0], (B, A)))
    monkeypatch.setattr(tmcts, "MIN_BUCKET", floor)
    draws = search_draws(p, B, seed, habit, injected)
    roots = torch.from_numpy(mock_roots(B, seed, peaked))
    with torch.inference_mode():
        res, schedule = tmcts._search(DrawingMock(), roots, p, (seed,), paths, True, draws,
                                      LoopTwin() if graphed else None)
    return res, schedule


def valid_G(res):
    """``all_paths_G`` where the path row is valid, NaN elsewhere."""
    return torch.where(res.all_paths[..., 0] >= 0, res.all_paths_G, float("nan"))


def assert_bitwise(got, want, paths):
    for name in RESULT_INTS + RESULT_FLOATS:
        assert torch.equal(getattr(got, name), getattr(want, name)), name
    for f in dataclasses.fields(tmcts._Tree):
        assert torch.equal(getattr(got.tree, f.name), getattr(want.tree, f.name)), f.name
    if paths:
        assert torch.equal(got.all_paths, want.all_paths)
        assert np.array_equal(valid_G(got).numpy(), valid_G(want).numpy(), equal_nan=True)


def expected_schedule(res, p, B, floor):
    """The compactions that the envs' ``repeats_done`` give: the count
    still searching after iteration t is the envs with more than t
    iterations; the loop of a bucket of ``size`` stops before step k once
    the count after its (k - 1)th step is 0, or, above the floor, half the
    size or less."""
    n_iters = tmcts._budget(p, A)[0]
    reps = res.repeats_done.numpy()
    active = lambda it: int((reps > it * p.expand_k).sum())
    stops = lambda n, size: n == 0 or (size > floor and n <= size // 2)
    i, size, schedule = 0, B, []
    while True:
        k = next((k for k in range(1, n_iters - i) if stops(active(i + k - 1), size)), None)
        if k is None or active(i + k - 1) == 0:
            return schedule
        i += k
        size = max(floor, 1 << (active(i - 1) - 1).bit_length())
        schedule.append((i, size))


@pytest.mark.parametrize("case", CASES)
def test_compacted_search_equals_itself_uncompacted_and_jax(model, monkeypatch, case):
    fields, B, seed, peaked, paths, _, with_jax = CASES[case]
    p = tmcts.MCTSParams(**fields)
    for weight in (0.0, NOISE):
        model(weight)
        got, schedule = plan(case, FLOOR, monkeypatch)
        want, none = plan(case, B, monkeypatch)
        assert none == [] and schedule, schedule
        assert_bitwise(got, want, paths)
        again, schedule_again = plan(case, FLOOR, monkeypatch)
        assert schedule_again == schedule == expected_schedule(got, p, B, FLOOR)
        assert_bitwise(again, got, paths)
        if weight == 0.0 and with_jax:
            jax_fields = dict(fields, fused_eval=False)  # the fused model is the unfused's
            jwant = jmcts.active_inference_mcts(
                MockAgent(), {}, jax.random.key(seed),
                jnp.asarray(mock_roots(B, seed, peaked)), jmcts.MCTSParams(**jax_fields),
                collect_paths=paths, return_tree=True)
            assert_results_equal(got, jwant, tree=True)
            if paths:
                np.testing.assert_array_equal(got.all_paths.numpy(),
                                              np.asarray(jwant.all_paths))
                valid = got.all_paths.numpy()[..., 0] >= 0
                np.testing.assert_allclose(got.all_paths_G.numpy()[valid],
                                           np.asarray(jwant.all_paths_G)[valid],
                                           rtol=1e-6, atol=1e-6)
    reps = got.repeats_done.numpy()
    assert reps.min() < reps.max(), "the batch must be heterogeneous"
    if case == "phase_a":
        assert (reps[[b for b, _ in peaked]] == 0).all()


def test_counters_follow_the_schedule(model, monkeypatch):
    """On a case whose schedule the test derives (``expected_schedule``):
    ``mcts.row_iterations`` is each bucket's size times its iterations,
    ``mcts.compactions`` the schedule's length; the other counters keep
    their meaning."""
    model(NOISE)
    fields, B = CASES["compaction"][:2]
    p = tmcts.MCTSParams(**fields)
    profiling.reset()
    try:
        res, schedule = plan("compaction", FLOOR, monkeypatch)
        counts = profiling.counters()
    finally:
        profiling.reset()
    assert schedule == expected_schedule(res, p, B, FLOOR) and len(schedule) >= 2
    starts = [(0, B)] + schedule
    ends = [i for i, _ in schedule] + [counts["mcts.iterations"]]
    rows = sum(size * (end - i) for (i, size), end in zip(starts, ends))
    assert counts["mcts.row_iterations"] == rows < B * counts["mcts.iterations"]
    assert counts["mcts.compactions"] == len(schedule)
    assert counts["mcts.env_iterations"] == int(res.repeats_done.sum())
    assert counts["mcts.iterations"] == min(int(res.repeats_done.max()) + 1, p.repeats)


def test_a_batch_at_the_floor_never_compacts(model, monkeypatch):
    """``MIN_BUCKET`` at the batch or above: the loop stops only once every
    env has decided, and counts every row."""
    model(NOISE)
    fields, B = CASES["compaction"][:2]
    profiling.reset()
    try:
        res, schedule = plan("compaction", B, monkeypatch)
        counts = profiling.counters()
    finally:
        profiling.reset()
    assert schedule == [] and counts["mcts.compactions"] == 0
    assert counts["mcts.row_iterations"] == B * counts["mcts.iterations"]


class LoopTwin:
    """``Graphs`` for any device: ``while_loop`` runs the body op by op;
    ``warm_loop`` records the carries it was asked to capture."""

    def __init__(self):
        self.replays, self.loops, self.warmed = 0, [], []

    def while_loop(self, body, carry, xs, n, stop, deps=tuple, key=(), until=bool):
        self.loops.append(carry[1].done.shape[0])
        return graphs_lib.eager_while_loop(body, carry, xs, n, stop, until)

    def warm_loop(self, body, carry, x, stop, deps=tuple, key=()):
        self.warmed.append(carry[1].done.shape[0])
        return True


@pytest.mark.parametrize("case", CASES)
def test_the_graphs_path_compacts_alike(model, monkeypatch, case):
    """The graph's path, op by op (a device iteration counter, walks of
    max_depth steps, whole-batch draws gathered in the body), equals the
    op-by-op search bit for bit, compacted alike; the first compaction
    asks for every smaller bucket's graph."""
    model(NOISE)
    paths = CASES[case][4]
    want, schedule = plan(case, FLOOR, monkeypatch)
    twin = LoopTwin()
    monkeypatch.setattr(tmcts.graphs_lib, "Graphs", lambda: twin)
    fields, B, seed, peaked, _, injected, _ = CASES[case]
    p = tmcts.MCTSParams(**fields)
    habit = t(jax.random.gumbel(jax.random.split(jax.random.key(seed), 4)[0], (B, A)))
    got = tmcts.active_inference_mcts(DrawingMock(), torch.from_numpy(mock_roots(B, seed, peaked)),
                                      p, (seed,), collect_paths=paths, return_tree=True,
                                      draws=search_draws(p, B, seed, habit, injected),
                                      graphed=True)
    assert_bitwise(got, want, paths)
    sizes = [size for _, size in schedule]
    assert twin.loops == [B] + sizes
    first = sizes[0]
    assert twin.warmed == [first >> k for k in range(1, first.bit_length()) if first >> k >= FLOOR]


def test_bucket_rows_pick_each_envs_draws():
    """``_bucket_rows`` against rows counted out by hand: a whole batch of
    B = 3 envs, the bucket [2, 0], expand_k 2, A = 4 actions, simulation
    depth 2; and the sampled estimator's sample-major rows under ``crn``."""
    p = tmcts.MCTSParams(expand_k=2, simulation_depth=2, fused_eval=True)
    rows = tmcts._bucket_rows(torch.tensor([2, 0]), 3, p, A)
    # leaves j * 3 + b: [2, 0, 5, 3]; expand rows leaf * 4 + a
    leaf = [2, 0, 5, 3]
    assert rows.env.tolist() == [2, 0]
    assert rows.expand.tolist() == [l * 4 + a for l in leaf for a in range(4)]
    assert rows.rollout.tolist() == leaf
    assert rows.trajectory.tolist() == leaf + [6 + l for l in leaf]
    n1 = 6 * 4
    assert rows.fused_masks.tolist() == (rows.expand.tolist() + [n1 + r for r in rows.expand]
                                         + [2 * n1 + r for r in rows.trajectory.tolist()])
    sampled = tmcts._bucket_rows(torch.tensor([1]), 3, tmcts.MCTSParams(use_means=False,
                                                                        samples=2, crn=True), A)
    assert sampled.expand.tolist() == [1, 4] and sampled.fused_masks is None


@pytest.mark.parametrize("n, floor, want", [(0, 16, 16), (1, 16, 16), (16, 16, 16),
                                            (17, 16, 32), (200, 16, 256), (3, 2, 4)])
def test_bucket_size(monkeypatch, n, floor, want):
    """The smallest power of two that holds ``n`` envs, at least
    ``MIN_BUCKET``: a compacted search's bucket and the bucketed sweep's
    padding."""
    monkeypatch.setattr(tmcts, "MIN_BUCKET", floor)
    assert tmcts.bucket_size(n) == want


@pytest.mark.usefixtures("mock_model")
def test_gather_carry_copies():
    """Compaction must not alias the tree it gathers from: the search goes
    on writing the old rows in place."""
    p = tmcts.MCTSParams(repeats=6, threshold=10.0, max_depth=8)
    with torch.inference_mode():
        carry = tmcts._init_search(TMockAgent(), torch.from_numpy(mock_roots(4, 0)), p, (0,))
        tmcts._run_search(TMockAgent(), carry, p, iterations(2))
        idx = torch.tensor([2, 0, 2, 2])
        packed = tmcts._gather_carry(carry, idx)
        frozen = {f: getattr(packed.tree, f).clone() for f in ("W", "N", "children", "s")}
        assert packed.i == carry.i and packed.seed_path == carry.seed_path
        assert torch.equal(packed.tree.W, carry.tree.W[idx])
        tmcts._run_search(TMockAgent(), carry, p, iterations(2))  # writes the old tree only
        for f, x in frozen.items():
            assert torch.equal(getattr(packed.tree, f), x), f
        assert not torch.equal(packed.tree.N, carry.tree.N[idx])
        # The packed search goes on from the same iteration with the same
        # per-iteration seeds: its rows catch up with the old tree's.
        tmcts._run_search(TMockAgent(), packed, p, iterations(2))
        assert torch.equal(packed.tree.W, carry.tree.W[idx])
        assert torch.equal(packed.tree.children, carry.tree.children[idx])
