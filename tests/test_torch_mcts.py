"""PyTorch port: the MCTS planner (``plan/mcts.py``) against the JAX planner.

Planner mechanics (walks, slot bookkeeping, scatter-add backprop, phase A/B
freezes, virtual-loss expansion, trimming) are held tree for tree on a
deterministic mock of the model: integers equal, floats to 1e-6. The mock
replaces ``efe.calculate_G_mean`` and ``efe.mcts_step_simulate`` in both
packages (this file keeps its own torch copy of tests/test_mcts.py's).

The evaluators and one whole search run on the converted flagship with
the JAX functions' noise rebuilt from their keys (the helpers of
tests/test_torch_losses.py and ``jax_simulate_draws`` of
tests/test_torch_efe.py) and injected into the port; G holds to the G
tolerance of tests/test_torch_efe.py (rtol 1e-4 / atol 1e-2).
"""

import dataclasses
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deep_active_inference_mc_tpu.plan import mcts as jmcts
from deep_active_inference_mc_torch.infer import efe as tefe
from deep_active_inference_mc_torch.plan import mcts as tmcts
from test_mcts import (A, C_A, D_A, S_DIM, W_G, MockAgent, mock_calculate_G_mean,
                       mock_step_simulate)
from test_torch_efe import G_TOL, frames, jax_habit_rollout_draws, jax_simulate_draws
from test_torch_losses import jax_G_draws, jax_mid_draws, jax_normal, t
from test_torch_models import few_torch_threads  # noqa: F401 (autouse fixture)
from test_torch_models import jax_flagship, torch_agent

FLOAT_TOL = dict(rtol=1e-6, atol=1e-6)
RESULT_INTS = ("actions", "lengths", "repeats_done", "states_explored", "depth_capped")
RESULT_FLOATS = ("root_N", "root_Qpi")


# ---- the deterministic mock, torch copy -----------------------------------
def t_mock_calculate_G_mean(agent, s0, pi0, generator=None, draws=None):
    G = s0 @ torch.from_numpy(W_G) + pi0 @ torch.from_numpy(C_A)
    return G, None, s0 * 0.9 + pi0 @ torch.from_numpy(D_A), None


def _t_qpi(s):
    e = torch.exp(s[:, :A] - s[:, :A].max(dim=-1, keepdim=True).values)
    return e / e.sum(dim=-1, keepdim=True)


def t_mock_step_simulate(agent, leaf_s, depth, use_means=False, generator=None, draws=None):
    return leaf_s.sum(dim=-1) * 0.7, None, _t_qpi(leaf_s)


class TMockAgent:
    pi_dim = A
    pi_one_hot = torch.eye(A)

    def encode(self, frames):  # "frames" are already states in the mock
        return frames, None

    def habit(self, s):
        q = _t_qpi(s)
        return None, q, torch.log(q + 1e-20)


@pytest.fixture
def mock_model(monkeypatch):
    monkeypatch.setattr(jmcts.efe, "calculate_G_mean", mock_calculate_G_mean)
    monkeypatch.setattr(jmcts.efe, "mcts_step_simulate", mock_step_simulate)
    monkeypatch.setattr(tmcts.efe, "calculate_G_mean", t_mock_calculate_G_mean)
    monkeypatch.setattr(tmcts.efe, "mcts_step_simulate", t_mock_step_simulate)


def mock_roots(B, seed, peaked=()):
    roots = np.random.RandomState(seed).randn(B, S_DIM).astype(np.float32) * 0.5
    for b, a in peaked:  # a habit distribution peaked on action a: phase A fires
        roots[b, a] = 25.0
    return roots


def iterations(n):
    """``_run_search``'s ``until`` for ``n`` iterations: it is asked before
    every iteration but the first."""
    asked = itertools.count(1)
    return lambda active: next(asked) >= n


def none_active(active):
    """``_run_search``'s ``until`` for a search run until every env has
    decided."""
    return int(active) == 0


def assert_results_equal(got, want, tree=False, paths=False):
    """A port MCTSResult against a JAX one."""
    for name in RESULT_INTS:
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(want, name)), err_msg=name)
    for name in RESULT_FLOATS:
        np.testing.assert_allclose(getattr(got, name).numpy(), np.asarray(getattr(want, name)),
                                   err_msg=name, **FLOAT_TOL)
    if tree:
        for f in dataclasses.fields(tmcts._Tree):
            g, w = getattr(got.tree, f.name).numpy(), np.asarray(getattr(want.tree, f.name))
            if g.dtype.kind == "f":
                np.testing.assert_allclose(g, w, err_msg=f.name, **FLOAT_TOL)
            else:
                np.testing.assert_array_equal(g, w, err_msg=f.name)
    if paths:
        np.testing.assert_array_equal(got.all_paths.numpy(), np.asarray(want.all_paths))
        np.testing.assert_allclose(got.all_paths_G.numpy(), np.asarray(want.all_paths_G),
                                   **FLOAT_TOL)


# name: (MCTSParams fields, batch, root seed, peaked (env, action) pairs)
MOCK_CASES = {
    **{f"prior{int(u)}-seed{s}": (dict(repeats=12, threshold=0.2, max_depth=16,
                                       using_prior_for_exploration=u), 3, s, ())
       for u in (False, True) for s in (0, 1, 2)},
    # Phase A: envs 1 and 4 short-circuit on their habit action.
    "use_habit": (dict(repeats=12, threshold=0.4, use_habit=True, max_depth=16),
                  8, 7, ((1, 2), (4, 0))),
    # Walks hit the cap: capped expands must be no-ops.
    "depth_cap": (dict(repeats=14, threshold=1.1, C=0.01, max_depth=3), 4, 3, ()),
    # Every env decides long before the budget: the search stops early.
    "early_exit": (dict(repeats=50, threshold=0.05, max_depth=16), 4, 7, ()),
    **{f"expand_k{k}": (dict(repeats=12, threshold=10.0, max_depth=16, expand_k=k), 3, 1, ())
       for k in (1, 2, 4)},
    # A budget that expand_k does not divide, with early deciders.
    "expand_k4_ragged": (dict(repeats=10, threshold=0.1, max_depth=6, expand_k=4), 5, 5, ()),
}


@pytest.mark.parametrize("case", MOCK_CASES)
def test_planner_matches_jax_tree_for_tree(mock_model, case):
    fields, B, seed, peaked = MOCK_CASES[case]
    roots = mock_roots(B, seed, peaked)
    key = jax.random.key(seed)
    want = jmcts.active_inference_mcts(
        MockAgent(), {}, key, jnp.asarray(roots), jmcts.MCTSParams(**fields),
        collect_paths=True, return_tree=True)
    # The phase-A action is sampled: inject the JAX draw's Gumbel noise.
    k_habit = jax.random.split(key, 4)[0]
    draws = tmcts.SearchDraws(root=None, iterations=None,
                              habit_gumbel=t(jax.random.gumbel(k_habit, (B, A))))
    got = tmcts.active_inference_mcts(
        TMockAgent(), torch.from_numpy(roots), tmcts.MCTSParams(**fields), seed_path=(seed,),
        collect_paths=True, return_tree=True, draws=draws)
    assert_results_equal(got, want, tree=True, paths=True)
    reps = got.repeats_done.numpy()
    if case == "use_habit":
        assert (reps[[1, 4]] == 0).all() and (got.lengths.numpy()[[1, 4]] == 1).all()
        assert got.actions[1, 0] == 2 and got.actions[4, 0] == 0
    if case == "depth_cap":
        assert got.depth_capped.sum() > 0
    if case == "early_exit":
        assert reps.max() < fields["repeats"]
    if case == "expand_k4_ragged":
        assert reps.min() < reps.max()


def test_params_match_the_jax_dataclass():
    fields = lambda cls: [(f.name, f.type, f.default) for f in dataclasses.fields(cls)]
    assert fields(tmcts.MCTSParams) == fields(jmcts.MCTSParams)
    assert tmcts.MCTSResult._fields == jmcts.MCTSResult._fields
    assert ([f.name for f in dataclasses.fields(tmcts._Tree)]
            == [f.name for f in dataclasses.fields(jmcts._Tree)])
    for p in (tmcts.MCTSParams(), tmcts.MCTSParams(repeats=10, expand_k=4)):
        assert tmcts._budget(p, 4) == jmcts._budget(jmcts.MCTSParams(**dataclasses.asdict(p)), 4)


def test_walk_of_host_known_length_equals_full_walk(mock_model):
    """After n expansions a walk of n + 1 steps returns the same arrays as
    one of max_depth steps (the steps beyond are no-ops), for the selection
    walk and the final one, at every iteration of a search."""
    p = tmcts.MCTSParams(repeats=9, threshold=10.0, max_depth=8)
    with torch.inference_mode():
        carry = tmcts._init_search(TMockAgent(), torch.from_numpy(mock_roots(5, 4)), p, (0,))
        for n in range(p.repeats + 1):
            for bounded, full in zip(
                    tmcts._select(carry.tree, p.C, False, p.max_depth, steps=n + 1),
                    tmcts._select(carry.tree, p.C, False, p.max_depth)):
                assert torch.equal(bounded, full)
            for bounded, full in zip(
                    tmcts._action_selection(carry.tree, p.max_depth, A, steps=n + 1),
                    tmcts._action_selection(carry.tree, p.max_depth, A)):
                assert torch.equal(bounded, full)
            # One step fewer does fall short once the tree is that deep.
            tmcts._run_search(TMockAgent(), carry, p, iterations(1))
        assert carry.i == p.repeats
        short = tmcts._select(carry.tree, p.C, False, p.max_depth, steps=1)
        assert not torch.equal(short[2], tmcts._select(carry.tree, p.C, False, p.max_depth)[2])


def test_search_stops_one_iteration_after_the_last_decision(mock_model):
    """The all-done flag is read one iteration late: the search stops with
    ``i`` at most one past the slowest env's decision, and that extra
    iteration writes nothing."""
    p = tmcts.MCTSParams(repeats=50, threshold=0.05, max_depth=16)
    roots = torch.from_numpy(mock_roots(4, 7))
    with torch.inference_mode():
        carry = tmcts._init_search(TMockAgent(), roots, p, (0,))
        tmcts._run_search(TMockAgent(), carry, p, none_active)
        slowest = int(carry.tree.repeats_done.max())
        assert carry.i == slowest + 1 < p.repeats
        assert bool(carry.done.all())
        before = [x.clone() for x in (carry.tree.W, carry.tree.N, carry.tree.children)]
        tmcts._run_search(TMockAgent(), carry, p, none_active)  # resumes, runs one no-op, stops
        assert carry.i == slowest + 2
        for x, y in zip(before, (carry.tree.W, carry.tree.N, carry.tree.children)):
            assert torch.equal(x, y)


@pytest.mark.parametrize("pi_dim", [4, 3])
def test_trim_path_matches_jax(pi_dim):
    rng = np.random.default_rng(pi_dim)
    B, D = 64, 8
    length = rng.integers(0, D + 1, B)
    path = rng.integers(0, pi_dim, (B, D))
    path[np.arange(D)[None, :] >= length[:, None]] = -1
    want, want_n = jmcts._trim_path(jnp.asarray(path, jnp.int32), jnp.asarray(length), pi_dim, D)
    got, got_n = tmcts._trim_path(torch.from_numpy(path), torch.from_numpy(length), pi_dim, D)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(got_n.numpy(), np.asarray(want_n))
    assert 0 < got_n.sum() < length.sum()
    with pytest.raises(ValueError, match="pi_dim"):
        tmcts._trim_path(torch.from_numpy(path), torch.from_numpy(length), 5, D)


@pytest.mark.parametrize("use_prior", [False, True])
def test_probs_for_selection_matches_jax(use_prior):
    rng = np.random.default_rng(0)
    W = rng.standard_normal((32, 4)).astype(np.float32) * 50
    N = rng.integers(1, 9, (32, 4)).astype(np.float32)
    N[0] = 0.0  # an unexpanded node: the clamps keep it finite
    Qpi = rng.dirichlet(np.ones(4), 32).astype(np.float32)
    want = jmcts._probs_for_selection(jnp.asarray(W), jnp.asarray(N), jnp.asarray(Qpi), 1.5,
                                      use_prior)
    got = tmcts._probs_for_selection(torch.from_numpy(W), torch.from_numpy(N),
                                     torch.from_numpy(Qpi), 1.5, use_prior)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(
        tmcts._calc_threshold(got).numpy(), np.asarray(jmcts._calc_threshold(want)),
        rtol=1e-6, atol=1e-6)


def test_sampled_walks_run_and_vary(mock_model):
    """deterministic_selection / deterministic_action off: the walks draw
    by Gumbel-max, seeds repeat exactly and differ from one another."""
    p = tmcts.MCTSParams(repeats=10, threshold=1.1, max_depth=16,
                         deterministic_selection=False, deterministic_action=False)
    roots = torch.from_numpy(mock_roots(2, 1))
    runs = [tmcts.active_inference_mcts(TMockAgent(), roots, p, seed_path=(s,))
            for s in (0, 0, 1, 2, 3, 4, 5, 6)]
    assert torch.equal(runs[0].actions, runs[1].actions)
    assert torch.equal(runs[0].root_N, runs[1].root_N)
    acts = torch.stack([r.actions for r in runs])
    assert ((acts >= -1) & (acts < A)).all()
    assert len({tuple(r.root_N.flatten().tolist()) for r in runs}) > 1


# ---- the real agent --------------------------------------------------------
@pytest.fixture(scope="module")
def flagship():
    agent, params = jax_flagship()
    return agent, params, torch_agent(params)


def leaf_states(B, seed):
    return np.random.default_rng(seed).standard_normal((B, 10)).astype(np.float32) * 0.5


def close(tv, jv, **tol):
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), **(tol or G_TOL))


@pytest.mark.parametrize("mode", ["mean", "mean-crn", "sampled", "sampled-crn"])
def test_expand_G_matches_jax(flagship, mode):
    """``_expand_G`` with and without common random numbers, on transition
    means and (use_means off, 2 samples) on samples: G to the G tolerance,
    next states to 1e-4."""
    ja, jp, ta = flagship
    crn, use_means = mode.endswith("crn"), mode.startswith("mean")
    fields = dict(crn=crn, use_means=use_means, samples=2)
    B = 3
    s = leaf_states(B, 11)
    key = jax.random.key(12)
    G_j, ps_j = jax.jit(lambda prm, k, x: jmcts._expand_G(
        ja, prm, k, x, jmcts.MCTSParams(**fields)))(jp, key, jnp.asarray(s))
    rows = (B if crn else B * A) * (1 if use_means else 2)
    draws = jax_G_draws(ja, jp, key, rows, sampled=not use_means)
    with torch.inference_mode():
        G, ps = tmcts._expand_G(ta, torch.from_numpy(s), tmcts.MCTSParams(**fields),
                                draws=draws)
    assert G.shape == (B, A) and ps.shape == (B, A, 10)
    close(G, G_j)
    close(ps, ps_j, rtol=1e-4, atol=1e-4)


def jax_fused_draws(ja, jp, key, B, p):
    """FusedDraws of ``_fused_expand_sim`` under ``key`` (plan/mcts.py:198)."""
    k_roll, k_trans, k_rep1, k_rep2, _ = jax.random.split(key, 5)
    R, D = p.simulation_repeats, p.simulation_depth
    n1, n3 = B * A, D * B * R
    rollout = jax_habit_rollout_draws(ja, jp, k_roll, B * R, D)
    trans = jax_mid_draws(ja, jp, k_trans, 2 * n1 + n3)
    return tmcts.FusedDraws(rollout, trans.masks, trans.eps[2 * n1:], jax_normal(k_rep1, n1),
                            jax_normal(k_rep2, n3))


@pytest.mark.parametrize("R", [1, 2])
def test_fused_expand_sim_matches_jax(flagship, R):
    """All four outputs of the fused evaluator, whose row layout ([:n1],
    [n1:2*n1], [2*n1:] of the transition pass; six decoder segments)
    carries their meaning; and the expand half against the unfused
    ``_expand_G`` under the same theta draws, segment by segment."""
    ja, jp, ta = flagship
    B = 3
    p = dict(simulation_depth=2, simulation_repeats=R)
    s = leaf_states(B, 13)
    key = jax.random.key(14)
    want = jax.jit(lambda prm, k, x: jmcts._fused_expand_sim(
        ja, prm, k, x, jmcts.MCTSParams(**p)))(jp, key, jnp.asarray(s))
    tp = tmcts.MCTSParams(**p)
    draws = jax_fused_draws(ja, jp, key, B, tp)
    with torch.inference_mode():
        got = tmcts._fused_expand_sim(ta, torch.from_numpy(s), tp, draws=draws)
        n1 = B * A
        expand = tefe.GDraws([x[:n1] for x in draws.masks], [x[n1:2 * n1] for x in draws.masks],
                             draws.eps_rep1)
        G_unfused, ps_unfused = tmcts._expand_G(ta, torch.from_numpy(s), tp, draws=expand)
    for g, w, tol in zip(got, want, (G_TOL, dict(rtol=1e-4, atol=1e-4), G_TOL,
                                     dict(rtol=1e-5, atol=1e-6))):
        close(g, w, **tol)
    assert got[0].shape == (B, A) and got[2].shape == (B,) and got[3].shape == (B, A)
    torch.testing.assert_close(got[0], G_unfused, rtol=1e-4, atol=1e-2)
    torch.testing.assert_close(got[1], ps_unfused, rtol=1e-5, atol=1e-5)


def jax_search_draws(ja, jp, key, B, p):
    """SearchDraws of ``active_inference_mcts`` under ``key``
    (plan/mcts.py:489, 571-572), unfused or fused, expand_k 1."""
    _, k_root, k_loop, _ = jax.random.split(key, 4)
    iterations = []
    for i in range(p.repeats):
        k_exp, k_sim, _ = jax.random.split(jax.random.fold_in(k_loop, i), 3)
        if p.fused_eval:
            iterations.append(tmcts.IterationDraws(fused=jax_fused_draws(ja, jp, k_exp, B, p)))
        else:
            iterations.append(tmcts.IterationDraws(
                expand=jax_G_draws(ja, jp, k_exp, B * A, sampled=False),
                simulate=jax_simulate_draws(ja, jp, k_sim, B * p.simulation_repeats,
                                            p.simulation_depth)))
    return tmcts.SearchDraws(jax_G_draws(ja, jp, k_root, B * A, sampled=False), iterations)


PROB_MARGIN = 1e-2  # selection probabilities: Q is normalized to sum 1


@pytest.mark.parametrize("fused", [False, True])
def test_whole_search_matches_jax_tree(flagship, fused):
    """One whole search on the flagship, B = 4, 6 iterations, the JAX
    search's noise rebuilt from its key and injected: an exact replay, not
    a statistical comparison. An env's integers (children, visit counts,
    the plan) are compared only while every argmax its walks took had a
    top-two gap above PROB_MARGIN, which a G difference within tolerance
    cannot bridge; the test asserts that this holds for at least half of
    the envs, and W of those envs holds to the G tolerance summed over the
    iterations."""
    ja, jp, ta = flagship
    B = 4
    fields = dict(repeats=6, simulation_depth=2, max_depth=8, threshold=0.9, fused_eval=fused)
    o, jo = frames(B, seed=15)
    key = jax.random.key(16)
    want = jax.jit(lambda prm, k, x: jmcts.active_inference_mcts(
        ja, prm, k, x, jmcts.MCTSParams(**fields), return_tree=True))(jp, key, jo)
    p = tmcts.MCTSParams(**fields)
    draws = jax_search_draws(ja, jp, key, B, p)
    clear = torch.ones(B, dtype=torch.bool)
    bidx = torch.arange(B)
    with torch.inference_mode():
        carry = tmcts._init_search(ta, o, p, None, draws)
        for i in range(p.repeats):
            nodes, _, _, _ = tmcts._select(carry.tree, p.C, False, p.max_depth)
            for d in range(p.max_depth):
                at = nodes[:, d].clamp(min=0)
                top = tmcts._probs_for_selection(
                    carry.tree.W[bidx, at], carry.tree.N[bidx, at], carry.tree.Qpi[bidx, at],
                    p.C, False).topk(2).values
                clear &= (nodes[:, d] < 0) | (top[:, 0] - top[:, 1] > PROB_MARGIN)
            tmcts._run_search(ta, carry, p, iterations(1), draws=draws.iterations)
        got = tmcts._finalize_search(ta, carry, p)
    assert clear.sum() >= B // 2, clear
    rows = clear.numpy()
    tree = carry.tree
    np.testing.assert_array_equal(tree.children.numpy()[rows],
                                  np.asarray(want.tree.children)[rows])
    np.testing.assert_array_equal(tree.N.numpy()[rows], np.asarray(want.tree.N)[rows])
    np.testing.assert_allclose(tree.W.numpy()[rows], np.asarray(want.tree.W)[rows],
                               rtol=1e-4, atol=1e-2 * (p.repeats + 1))
    close(tree.s[clear], np.asarray(want.tree.s)[rows], rtol=1e-4, atol=1e-4)
    close(tree.Qpi[clear], np.asarray(want.tree.Qpi)[rows], rtol=1e-4, atol=1e-5)
    close(got.root_Qpi, want.root_Qpi, rtol=1e-4, atol=1e-5)
    for name in ("repeats_done", "states_explored", "depth_capped", "lengths", "actions"):
        np.testing.assert_array_equal(getattr(got, name).numpy()[rows],
                                      np.asarray(getattr(want, name))[rows], err_msg=name)
    assert (got.repeats_done[clear] == p.repeats).all()  # threshold 0.9: none decides early


def test_fused_and_crn_are_refused_together():
    with pytest.raises(ValueError, match="unfused"):
        tmcts.active_inference_mcts(TMockAgent(), torch.zeros(2, S_DIM),
                                    tmcts.MCTSParams(crn=True, fused_eval=True), (0,))
    with pytest.raises(ValueError, match="seed_path"):
        tmcts.active_inference_mcts(TMockAgent(), torch.zeros(2, S_DIM), tmcts.MCTSParams())
