"""PyTorch port: the bucketed (batch-compaction) planner.

On the deterministic mock of tests/test_torch_mcts.py an env's search does
not depend on the batch it sits in, so the port's bucketed planner must
equal its plain planner bit for bit however many compactions fire, and both
must equal the JAX bucketed planner (integers equal, floats to 1e-6) with
the same ``bucket_trace`` and ``schedule``: the retirement decisions read
the same done masks at the same iterations.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deep_active_inference_mc_tpu.plan import mcts as jmcts
from deep_active_inference_mc_torch.plan import mcts as tmcts
from test_mcts import A, MockAgent
from test_torch_losses import t
from test_torch_mcts import mock_model  # noqa: F401 (fixture)
from test_torch_mcts import (RESULT_FLOATS, RESULT_INTS, TMockAgent, assert_results_equal,
                             mock_roots)
from test_torch_models import few_torch_threads  # noqa: F401 (autouse fixture)

pytestmark = pytest.mark.usefixtures("mock_model")


def assert_bitwise(got, want):
    for name in RESULT_INTS + RESULT_FLOATS:
        assert torch.equal(getattr(got, name), getattr(want, name)), name


# name: (MCTSParams fields, batch, root seed, peaked envs, check_every, min_bucket)
CASES = {
    # Some envs decide quickly, others search the whole budget.
    "compaction": (dict(repeats=24, threshold=0.28, max_depth=16), 16, 3, (), 2, 2),
    # min_bucket == B: no compaction possible.
    "no_compaction": (dict(repeats=10, threshold=0.3, max_depth=16), 4, 5, (), 3, 4),
    # Phase-A envs start done and retire at the first check with their habit action.
    "phase_a": (dict(repeats=12, threshold=0.4, use_habit=True, max_depth=16),
                8, 7, ((1, 2), (4, 0)), 2, 2),
    # A batch that is no power of two, and the stride doubling between checks.
    "odd_batch": (dict(repeats=24, threshold=0.28, max_depth=16), 11, 3, (), 2, 2),
    "expand_k": (dict(repeats=24, threshold=0.2, max_depth=16, expand_k=2), 16, 3, (), 2, 2),
}


@pytest.mark.parametrize("case", CASES)
def test_bucketed_equals_plain_and_jax(case):
    fields, B, seed, peaked, check_every, min_bucket = CASES[case]
    roots = mock_roots(B, seed, peaked)
    key = jax.random.key(seed)
    p = tmcts.MCTSParams(**fields)
    # Phase A samples its action: both port planners draw it from the same
    # seed, so they agree with each other; the JAX one draws its own.
    plain = tmcts.active_inference_mcts(TMockAgent(), torch.from_numpy(roots), p, (seed,))
    plan = tmcts.make_bucketed_planner(TMockAgent(), p, check_every, min_bucket)
    got = plan(torch.from_numpy(roots), (seed,))
    assert_bitwise(got, plain)
    assert got.all_paths is None and got.tree is None

    jplan = jmcts.make_bucketed_planner(MockAgent(), jmcts.MCTSParams(**fields),
                                        check_every=check_every, min_bucket=min_bucket)
    want = jplan({}, key, jnp.asarray(roots))
    if case == "phase_a":
        # The habit envs' action is the JAX draw's, not the port's.
        k_habit = jax.random.split(key, 4)[0]
        draws = tmcts.SearchDraws(None, None, t(jax.random.gumbel(k_habit, (B, A))))
        with_jax_draw = tmcts.active_inference_mcts(TMockAgent(), torch.from_numpy(roots), p,
                                                    (seed,), draws=draws)
        assert_results_equal(with_jax_draw, want)
        habit = [b for b, _ in peaked]
        assert (got.repeats_done[habit] == 0).all() and (got.lengths[habit] == 1).all()
        keep = np.setdiff1d(np.arange(B), habit)
        for name in RESULT_INTS:
            np.testing.assert_array_equal(getattr(got, name).numpy()[keep],
                                          np.asarray(getattr(want, name))[keep])
    else:
        assert_results_equal(got, want)
    assert plan.bucket_trace == jplan.bucket_trace
    assert plan.schedule == jplan.schedule
    reps = got.repeats_done.numpy()
    if case == "no_compaction":
        assert plan.bucket_trace == [B]
    elif case != "phase_a":
        assert len(plan.bucket_trace) > 1 and plan.bucket_trace[-1] < B, plan.bucket_trace
        assert reps.min() < reps.max(), "the batch must be heterogeneous"


def test_bucketed_repeats_across_calls():
    """No state leaks from one call into the next."""
    p = tmcts.MCTSParams(repeats=16, threshold=0.25, max_depth=16)
    plan = tmcts.make_bucketed_planner(TMockAgent(), p, check_every=2, min_bucket=2)
    roots = torch.from_numpy(mock_roots(8, 1))
    a = plan(roots, (4,))
    trace = list(plan.bucket_trace)
    other = plan(torch.from_numpy(mock_roots(8, 2)), (5,))
    b = plan(roots, (4,))
    assert_bitwise(a, b)
    assert plan.bucket_trace == trace
    assert not torch.equal(a.root_N, other.root_N)


def test_gather_carry_copies():
    """Compaction must not alias the tree it gathers from: the search goes
    on writing the old rows in place."""
    p = tmcts.MCTSParams(repeats=6, threshold=10.0, max_depth=8)
    with torch.inference_mode():
        carry = tmcts._init_search(TMockAgent(), torch.from_numpy(mock_roots(4, 0)), p, (0,))
        tmcts._run_search(TMockAgent(), carry, p, 2)
        idx = torch.tensor([2, 0, 2, 2])
        packed = tmcts._gather_carry(carry, idx)
        frozen = {f: getattr(packed.tree, f).clone() for f in ("W", "N", "children", "s")}
        assert packed.i == carry.i and packed.seed_path == carry.seed_path
        assert torch.equal(packed.tree.W, carry.tree.W[idx])
        tmcts._run_search(TMockAgent(), carry, p, 4)  # writes the old tree only
        for f, x in frozen.items():
            assert torch.equal(getattr(packed.tree, f), x), f
        assert not torch.equal(packed.tree.N, carry.tree.N[idx])
        # The packed search goes on from the same iteration with the same
        # per-iteration seeds: its rows catch up with the old tree's.
        tmcts._run_search(TMockAgent(), packed, p, 4)
        assert torch.equal(packed.tree.W, carry.tree.W[idx])
        assert torch.equal(packed.tree.children, carry.tree.children[idx])
