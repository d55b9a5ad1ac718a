"""Array-based batched MCTS planner (value = -G, priors = habit network).

Port of ``deep_active_inference_mc_tpu/plan/mcts.py``. The tree is a
fixed-budget structure of arrays, so hundreds of environments plan at once:

  - node slots are preallocated: every expansion takes the next ``pi_dim``
    slots, so slot ids are known on the host (root children 1..4,
    expansion n's children 5+4n..8+4n);
  - selection walks are batched gathers;
  - backpropagation is one masked scatter-add along the recorded path;
  - the early stops are masked freezes: phase A (habit short-circuit) and
    phase B (visit threshold) mark an environment done and freeze its tree,
    so the final action selection reads the tree of decision time;
  - the final visit-max walk and the opposite-action pair trimming are
    fixed-shape array postprocesses.

Where this differs from the JAX module, with the same results:

  - The JAX walks are ``while_loop``s that run while any env still has
    children under its cursor. Here a walk takes a number of steps the host
    knows: after ``n`` expansions no path from the root is longer than
    ``n + 1``, and a step in which no env walks changes nothing, so
    ``min(max_depth, n + 1)`` steps give the same arrays with no sync.
  - The JAX search loop stops when every env is done. Here the count of
    envs still searching is read one iteration late, from a pinned buffer
    whose copy was enqueued before that iteration, so the card always has
    an iteration queued. An iteration in which every env is done writes
    nothing, so only ``SearchCarry.i`` can differ.
  - The JAX loop computes every env's rows until the last env decides.
    Here the search compacts its batch (``_run_compacted``): once the count
    read is half the bucket or less, and the bucket is above
    ``MIN_BUCKET``, the bucket's rows go back into the whole batch's state
    by env, and the envs not known to have decided, padded with decided
    ones, move into the smallest power-of-two bucket that holds them. The
    search goes on at the same iteration, and each env reads the rows of
    the whole batch's noise it reads without compaction, so a compacted
    search gives the same results wherever an env's evaluation does not
    depend on the other rows of its batch. The schedule depends on the done
    masks alone, so a search planned again compacts alike. A decided env's
    tree is frozen, so retiring it late is exact; its ``all_paths_G`` rows
    after it left the batch are not computed.
  - The tree is updated in place. A done env's rows are frozen and ``done``
    only grows, so a caller may finalize a retired env any number of
    iterations later; ``_gather_carry`` copies.
  - Iteration ``i`` draws from ``seeded_generator(device, *seed_path, 0, i)``
    (the counterpart of ``fold_in(k_loop, i)``), so a compacted search
    replays the same stream of seeds. All noise can be injected instead
    (``SearchDraws``).

The compiled planner (``make_jit_planner``, the counterpart of the JAX
package's): on a card the search loop, the JAX module's ``lax.while_loop``,
is one captured CUDA graph of one iteration per bucket size, replayed until
every env has decided (``utils/graphs.py``, ``Graphs.while_loop``); the first
compaction of a search captures every smaller bucket's graph at once, so a
later search replays whatever buckets it meets. The graph's body is
the eager iteration with a device iteration counter: the slots and the path
rows come from index arithmetic on it, and the walks take ``max_depth``
steps (the steps beyond a path's end change nothing). Each iteration's
noise is drawn ahead by ``draw_iteration`` from the iteration's own
generator, in the order the eager iteration draws it, so a graphed search
gives the eager search's numbers; a bucket's graph gathers its envs' rows
of the whole batch's noise. A planner keeps its graphs in one memory pool;
initialization and the final walk run eagerly. ``graphed=False`` runs the
iterations op by op, each drawing as it goes, its walks as long as the
tree is deep.

Everything runs under ``torch.inference_mode()``.

Spans and counters (``utils/profiling.py``): every search is a span
``mcts.plan``; it counts the iterations its batch ran
(``mcts.iterations``), the rows those iterations computed, each
iteration's bucket size summed on the host (``mcts.row_iterations``), its
compactions (``mcts.compactions``), the sum of its envs' ``repeats_done``
(``mcts.env_iterations``) and its phase-A short-circuits
(``mcts.short_circuits``), the last two summed on the device. A graphed
``make_jit_planner`` records a pair of CUDA events around the search step
inside its whole batch's graph (not a bucket's) and keeps the last replay's
time of each plan as the device span ``mcts.device`` once the host has
synced (``profiling.settle``).
"""

from __future__ import annotations

import dataclasses
from typing import List, NamedTuple, Optional, Sequence, Tuple, Union

import torch

from deep_active_inference_mc_torch.infer import efe
from deep_active_inference_mc_torch.infer.agent import ActiveInferenceAgent
from deep_active_inference_mc_torch.models.networks import reparameterize
from deep_active_inference_mc_torch.ops import math as m
from deep_active_inference_mc_torch.utils import graphs as graphs_lib
from deep_active_inference_mc_torch.utils import profiling
from deep_active_inference_mc_torch.utils import random as rnd
from deep_active_inference_mc_torch.utils.device import seeded_generator

# Streams under a search's seed path.
_ITER_STREAM, _INIT_STREAM, _FINAL_STREAM = 0, 1, 2

# The smallest bucket of a compacted search (module docstring): on an H100 a
# halving below it saves less than a tenth of an iteration's time (PERF.md).
MIN_BUCKET = 16


@dataclasses.dataclass(frozen=True)
class MCTSParams:
    """Planner knobs (the reference's defaults)."""

    C: float = 1.0
    threshold: float = 0.5
    repeats: int = 300
    simulation_repeats: int = 1
    simulation_depth: int = 3
    use_habit: bool = False
    use_means: bool = True
    using_prior_for_exploration: bool = False
    samples: int = 1  # MC samples in expand when use_means=False
    max_depth: int = 32  # selection-walk bound (trees this deep are degenerate)
    # Sampled (not argmax) walks in select / action selection.
    deterministic_selection: bool = True
    deterministic_action: bool = True
    # Every expand + simulate network forward of an iteration in one
    # transition, one decoder and one encoder pass. Same estimators; the
    # noise's row layout differs from the unfused path.
    fused_eval: bool = False
    # Virtual-loss parallel expansion: ``expand_k`` leaves per sequential
    # iteration, evaluated in one k*B batch; ceil(repeats / expand_k)
    # iterations keep the expansion budget. 1 is the reference's search; >1
    # is an approximation (walks of one iteration do not see each other's G).
    expand_k: int = 1
    # Common random numbers across the actions of each expansion's G
    # (unfused evaluator only).
    crn: bool = False


class MCTSResult(NamedTuple):
    actions: torch.Tensor  # (B, max_depth) trimmed action path, -1 padded
    lengths: torch.Tensor  # (B,) path lengths (0 possible: reference quirk)
    repeats_done: torch.Tensor  # (B,) iterations until decision
    states_explored: torch.Tensor  # (B,) simulated states
    depth_capped: torch.Tensor  # (B,) iterations whose walk hit max_depth (no-op expands)
    root_N: torch.Tensor  # (B, A) root visit counts
    root_Qpi: torch.Tensor  # (B, A) habit prior at the root
    all_paths: Optional[torch.Tensor]  # (R, B, max_depth) selection paths or None
    all_paths_G: Optional[torch.Tensor]  # (R, B) simulation G per expansion
    tree: Optional["_Tree"] = None  # final tree arrays (return_tree=True)


@dataclasses.dataclass
class _Tree:
    s: torch.Tensor  # (B, N, s_dim) node states
    W: torch.Tensor  # (B, N, A) summed -G per edge
    N: torch.Tensor  # (B, N, A) visit counts, float32
    Qpi: torch.Tensor  # (B, N, A) habit prior per node
    children: torch.Tensor  # (B, N, A) child slot or -1
    done: torch.Tensor  # (B,) decision frozen
    repeats_done: torch.Tensor  # (B,)
    states_explored: torch.Tensor  # (B,)
    depth_capped: torch.Tensor  # (B,) no-op expands from the max_depth cap


@dataclasses.dataclass
class FusedDraws:
    """Noise of one ``_fused_expand_sim`` over B leaves (n1 = B*A expand
    rows, n3 = depth*B*R trajectory rows): the habit rollout's; the
    keep-masks of the one transition pass (2*n1 + n3 rows) and the draw of
    its trajectory rows' sample (n3); the fixed-theta draws of the expand
    (n1) and the trajectory (n3) rows."""

    rollout: efe.HabitRolloutDraws
    masks: Sequence[torch.Tensor]
    eps_traj: torch.Tensor
    eps_rep1: torch.Tensor
    eps_rep2: torch.Tensor


@dataclasses.dataclass
class IterationDraws:
    """Injected noise of one iteration: ``expand`` and ``simulate``
    (unfused) or ``fused``; ``select`` is the walks' Gumbel noise
    (expand_k, max_depth, B, A) when selection is sampled. A graphed
    search takes it whole, as ``draw_iteration`` gives it."""

    expand: Optional[efe.GDraws] = None
    simulate: Optional[efe.SimulateDraws] = None
    fused: Optional[FusedDraws] = None
    select: Optional[torch.Tensor] = None


@dataclasses.dataclass
class SearchDraws:
    """Injected noise of a whole search: the root expand's, one
    IterationDraws per iteration, the phase-A action draw's Gumbel noise
    (B, A) and the final walk's (max_depth, B, A) when those are sampled."""

    root: Optional[efe.GDraws]
    iterations: Sequence[IterationDraws]
    habit_gumbel: Optional[torch.Tensor] = None
    final_gumbel: Optional[torch.Tensor] = None


def _probs_for_selection(W, N, Qpi, C, use_prior):
    """Normalized Q + exploration bonus. Expanded nodes have N >= 1 on
    every edge."""
    n = torch.clamp(N, min=1e-12)
    Q = W / n
    Q = Q - Q.min(dim=-1, keepdim=True).values
    Q = Q / torch.clamp(Q.sum(dim=-1, keepdim=True), min=1e-12)
    if use_prior:
        return Q + C * Qpi / n
    return Q + C / n


def _calc_threshold(P):
    """Decision confidence: max - mean."""
    return P.max(dim=-1).values - P.mean(dim=-1)


def _expand_G(agent: ActiveInferenceAgent, s: torch.Tensor, p: MCTSParams,
              generator: Optional[torch.Generator] = None,
              draws: Optional[efe.GDraws] = None):
    """G for every action of each state: (B, A) G and (B, A, s_dim) next
    states. With ``p.crn`` every action column shares one set of draws."""
    B, A = s.shape[0], agent.pi_dim

    def evaluate(s_rows, pi_rows, d):
        if p.use_means:
            G, _, ps_next, _ = efe.calculate_G_mean(agent, s_rows, pi_rows,
                                                    generator=generator, draws=d)
        else:
            G, _, ps_next, _, _ = efe.calculate_G(agent, s_rows, pi_rows, samples=p.samples,
                                                  generator=generator, draws=d)
        return G, ps_next

    if p.crn:
        if draws is None:
            rows = B if p.use_means else p.samples * B
            draws = efe.draw_G(agent, rows, generator, s.device, sampled=not p.use_means)
        cols = [evaluate(s, agent.pi_one_hot[a].expand(B, A), draws) for a in range(A)]
        return (torch.stack([c[0] for c in cols], dim=1),
                torch.stack([c[1] for c in cols], dim=1))
    G, ps_next = evaluate(s.repeat_interleave(A, dim=0), agent.pi_one_hot.repeat(B, 1), draws)
    return G.reshape(B, A), ps_next.reshape(B, A, -1)


def _draw_fused(agent, B: int, p: MCTSParams, generator, device) -> FusedDraws:
    n1 = B * agent.pi_dim
    n3 = p.simulation_depth * B * p.simulation_repeats
    rollout = efe.draw_habit_rollout(agent, B * p.simulation_repeats, p.simulation_depth,
                                     generator, device)
    masks = agent.mid.draw_masks(2 * n1 + n3, generator, device)
    normal = lambda rows: torch.randn((rows, agent.s_dim), generator=generator, device=device)
    return FusedDraws(rollout, masks, normal(n3), normal(n1), normal(n3))


def draw_iteration(agent, p: MCTSParams, B: int, generator: torch.Generator,
                   device) -> IterationDraws:
    """All the noise one iteration over B envs consumes, drawn from
    ``generator`` in the order the iteration draws it: the walks' Gumbel
    noise, then the fused evaluator's, or the expand's (``crn``: one row set
    for every action) and the simulation's, over expand_k * B leaves."""
    rows, A = B * p.expand_k, agent.pi_dim
    select = None
    if not p.deterministic_selection:
        select = rnd.gumbel((p.expand_k, p.max_depth, B, A), generator, device)
    if p.fused_eval and p.use_means:
        return IterationDraws(fused=_draw_fused(agent, rows, p, generator, device),
                              select=select)
    g_rows = (rows if p.crn else rows * A) * (1 if p.use_means else p.samples)
    expand = efe.draw_G(agent, g_rows, generator, device, sampled=not p.use_means)
    simulate = efe.draw_simulate(agent, rows * p.simulation_repeats, p.simulation_depth,
                                 generator, device)
    return IterationDraws(expand=expand, simulate=simulate, select=select)


def _check_whole(d: IterationDraws, p: MCTSParams) -> IterationDraws:
    """``d`` if it holds all of an iteration's noise, else raise: a graphed
    iteration draws nothing itself."""
    fused = p.fused_eval and p.use_means
    whole = d.fused is not None if fused else d.expand is not None and d.simulate is not None
    if not whole or (not p.deterministic_selection and d.select is None):
        raise ValueError("a graphed search takes each iteration's whole noise "
                         "(draw_iteration's IterationDraws)")
    return d


def _fused_expand_sim(agent: ActiveInferenceAgent, leaf_s: torch.Tensor, p: MCTSParams,
                      generator: Optional[torch.Generator] = None,
                      draws: Optional[FusedDraws] = None):
    """One iteration's whole G workload, expand (``calculate_G_mean`` over
    all actions) and simulate (habit rollout + trajectory G), with every
    network forward concatenated into one transition, one decoder and one
    encoder pass. Formulas and estimators are the unfused path's; only the
    noise's row layout differs.

    Returns (G_leaf (B, A), ps_next (B, A, s_dim), G_sim (B,),
    Qpi_leaf (B, A))."""
    B, s_dim = leaf_s.shape
    A, R, D = agent.pi_dim, p.simulation_repeats, p.simulation_depth
    if draws is None:
        draws = _draw_fused(agent, B, p, generator, leaf_s.device)

    # Habit rollout (sequential by nature; small MLP batches).
    s0_tr, ps1_tr, mean_tr, logvar_tr, pi_tr, q_pi0 = efe.habit_rollout(
        agent, leaf_s.repeat_interleave(R, dim=0), draws.rollout)
    flat = lambda x: x.flatten(0, 1)
    n1 = B * A  # expand rows
    n3 = D * B * R  # trajectory rows

    # One transition pass: expand pass 1 + pass 2 + trajectory.
    s_r = leaf_s.repeat_interleave(A, dim=0)
    pi_r = agent.pi_one_hot.repeat(B, 1)
    mean_c, logvar_c = agent.transition(torch.cat([pi_r, pi_r, flat(pi_tr)]),
                                        torch.cat([s_r, s_r, flat(s0_tr)]), draws.masks)
    ps1_mean, ps1_logvar = mean_c[:n1], logvar_c[:n1]  # expand theta draw 1
    mean_b = mean_c[n1:2 * n1]  # expand theta draw 2 (term2_1 decodes the MEAN)
    ps1_b_traj = reparameterize(mean_c[2 * n1:], logvar_c[2 * n1:],
                                eps=draws.eps_traj)  # trajectory theta draw (the SAMPLE)

    # One decoder pass.
    dec = agent.decode(torch.cat([
        ps1_mean,  # expand po1
        mean_b,  # expand term2_1
        reparameterize(ps1_mean, ps1_logvar, eps=draws.eps_rep1),  # expand term2_2
        flat(ps1_tr),  # trajectory po1
        ps1_b_traj,  # trajectory term2_1
        reparameterize(flat(mean_tr), flat(logvar_tr), eps=draws.eps_rep2),  # t. term2_2
    ]))
    po1_e, t21_e, t22_e = dec[:n1], dec[n1:2 * n1], dec[2 * n1:3 * n1]
    po1_t = dec[3 * n1:3 * n1 + n3]
    t21_t = dec[3 * n1 + n3:3 * n1 + 2 * n3]
    t22_t = dec[3 * n1 + 2 * n3:]

    # One encoder pass.
    _, q_logvar = agent.encode(torch.cat([po1_e, po1_t]))
    qlv_e, qlv_t = q_logvar[:n1], q_logvar[n1:]

    def G_terms(po1, ps_logvar, qs_logvar, t21, t22):
        # Scored in float32 under a bf16 agent too: G sums ~4096 pixel
        # entropies to O(1e2-1e3) nats, where bf16's ~3 significant digits
        # would alias nearby actions.
        po1, ps_logvar, qs_logvar, t21, t22 = (
            x.to(torch.float32) for x in (po1, ps_logvar, qs_logvar, t21, t22))
        term0 = agent.check_reward(po1)
        term1 = -torch.sum(m.entropy_normal_from_logvar(ps_logvar)
                           + m.entropy_normal_from_logvar(qs_logvar), dim=-1)
        term2 = (torch.sum(m.entropy_bernoulli(t21), dim=(-3, -2, -1))
                 - torch.sum(m.entropy_bernoulli(t22), dim=(-3, -2, -1)))
        return -term0 + term1 + term2

    G_leaf = G_terms(po1_e, ps1_logvar, qlv_e, t21_e, t22_e).reshape(B, A)
    ps_next = ps1_mean.reshape(B, A, s_dim)
    G_rows = G_terms(po1_t, flat(logvar_tr), qlv_t, t21_t, t22_t)
    G_sim = G_rows.reshape(D, B * R).mean(dim=0).reshape(B, R).mean(dim=-1)
    Qpi_leaf = q_pi0.reshape(B, R, A)[:, 0]
    return G_leaf, ps_next, G_sim, Qpi_leaf


def _select(tree: _Tree, C: float, use_prior: bool, max_depth: int,
            steps: Optional[int] = None, gumbel: Optional[torch.Tensor] = None):
    """Batched selection walk: from the root, follow probs_for_selection
    (argmax, or a draw with the Gumbel noise ``gumbel`` (max_depth, B, A))
    into children until a node without children. ``steps`` bounds the walk
    where the caller knows no path is longer. Returns (path_nodes,
    path_actions, path_len, leaf_idx); the path records (node,
    action-taken) pairs root..parent-of-leaf."""
    B = tree.W.shape[0]
    dev = tree.W.device
    bidx = torch.arange(B, device=dev)
    cur = torch.zeros((B,), dtype=torch.long, device=dev)
    nodes = torch.full((B, max_depth), -1, dtype=torch.long, device=dev)
    acts = torch.full((B, max_depth), -1, dtype=torch.long, device=dev)
    lens = torch.zeros((B,), dtype=torch.long, device=dev)
    for depth in range(max_depth if steps is None else min(steps, max_depth)):
        probs = _probs_for_selection(tree.W[bidx, cur], tree.N[bidx, cur],
                                     tree.Qpi[bidx, cur], C, use_prior)
        if gumbel is None:
            a = torch.argmax(probs, dim=-1)
        else:
            a = rnd.categorical(torch.log(torch.clamp(probs, min=1e-30)),
                                noise=gumbel[depth])
        child = tree.children[bidx, cur, a]
        walking = child >= 0  # the node had children: step into one
        nodes[:, depth] = torch.where(walking, cur, -1)
        acts[:, depth] = torch.where(walking, a, -1)
        lens = lens + walking
        cur = torch.where(walking, child, cur)
    return nodes, acts, lens, cur


def _trim_path(path: torch.Tensor, length: torch.Tensor, pi_dim: int, max_depth: int):
    """Opposite-action pair trimming with the reference's exact semantics,
    its ``while i < len - 1`` bound included: the final action is examined
    only as the second element of a pair."""
    if pi_dim == 4:
        def opposite(a, b):
            return (((a == 0) & (b == 1)) | ((a == 1) & (b == 0))
                    | ((a == 2) & (b == 3)) | ((a == 3) & (b == 2)))
    elif pi_dim == 3:
        def opposite(a, b):
            return ((a == 1) & (b == 2)) | ((a == 2) & (b == 1))
    else:
        raise ValueError(f"Unknown pi_dim {pi_dim}")

    B = path.shape[0]
    dev = path.device
    out = torch.full((B, max_depth), -1, dtype=path.dtype, device=dev)
    out_len = torch.zeros((B,), dtype=torch.long, device=dev)
    skip = torch.zeros((B,), dtype=torch.bool, device=dev)
    cols = torch.arange(max_depth, device=dev)[None, :]
    for i in range(max_depth):
        a = path[:, i]
        b = path[:, i + 1] if i + 1 < max_depth else torch.full_like(a, -1)
        in_range = i < length - 1  # reference bound: the last action is never emitted
        is_pair = opposite(a, b) & in_range & ~skip
        emit = in_range & ~skip & ~is_pair
        out = torch.where(emit[:, None] & (cols == out_len[:, None]), a[:, None], out)
        out_len = out_len + emit
        skip = is_pair  # the next position is the pair's second half
    return out, out_len


def _action_selection(tree: _Tree, max_depth: int, pi_dim: int,
                      steps: Optional[int] = None, gumbel: Optional[torch.Tensor] = None):
    """Final visit-count walk + pair trim. Argmax by default; with
    ``gumbel`` (max_depth, B, A) a draw proportional to the visit counts."""
    B = tree.N.shape[0]
    dev = tree.N.device
    bidx = torch.arange(B, device=dev)
    cur = torch.zeros((B,), dtype=torch.long, device=dev)
    acts = torch.full((B, max_depth), -1, dtype=torch.long, device=dev)
    lens = torch.zeros((B,), dtype=torch.long, device=dev)
    for depth in range(max_depth if steps is None else min(steps, max_depth)):
        n = tree.N[bidx, cur]
        if gumbel is None:
            a = torch.argmax(n, dim=-1)
        else:
            a = rnd.categorical(torch.log(torch.clamp(n, min=1e-30)), noise=gumbel[depth])
        child = tree.children[bidx, cur, a]
        walking = child >= 0
        acts[:, depth] = torch.where(walking, a, -1)
        lens = lens + walking
        cur = torch.where(walking, child, cur)
    return _trim_path(acts, lens, pi_dim, max_depth)


@dataclasses.dataclass
class SearchCarry:
    """Resumable search state: everything live between planner iterations.

    ``_init_search`` -> ``_run_search`` (once per bucket) ->
    ``_finalize_search`` lets ``_run_compacted`` pause the search at an
    iteration boundary, gather the envs still searching into a smaller
    batch (``_gather_carry``) and write the bucket's rows back
    (``_scatter_carry``). Every tensor has leading batch dim B; ``i`` and
    ``seed_path`` are host values shared across the batch, so a compacted
    search goes on drawing iteration i's noise from the same seed."""

    i: int  # sequential iterations enqueued
    tree: _Tree
    done: torch.Tensor  # (B,) decision frozen (phase A/B)
    habit_done: torch.Tensor  # (B,) phase-A short-circuit fired
    habit_action: torch.Tensor  # (B,) phase-A habit action
    root_Qpi: torch.Tensor  # (B, A) habit prior at the root
    seed_path: Optional[Tuple[int, ...]]  # None: every draw is injected
    paths_buf: Optional[torch.Tensor] = None  # (R, B, max_depth) selection paths
    paths_G_buf: Optional[torch.Tensor] = None  # (R, B) simulation G per expansion


def _budget(p: MCTSParams, A: int) -> Tuple[int, int, int]:
    """(sequential iterations, total expansions, node-slot budget).
    ceil(repeats / expand_k) iterations of expand_k expansions each keep
    the reference's expansion budget; the last slot is the pad row that
    masked backprop entries add 0 to."""
    n_iters = -(-p.repeats // p.expand_k)
    n_expansions = n_iters * p.expand_k
    N_max = A * (n_expansions + 1) + 2  # root + children per expansion + pad
    return n_iters, n_expansions, N_max


def _phase_b_done(tree: _Tree, p: MCTSParams) -> torch.Tensor:
    """Phase B check: normalized root visits confident."""
    N_root = tree.N[:, 0]
    N_norm = N_root / torch.clamp(N_root.sum(dim=-1, keepdim=True), min=1e-12)
    return tree.done | (_calc_threshold(N_norm) > p.threshold)


def _generator(seed_path, device, *stream):
    """The generator of one stream of a search; None when noise is injected."""
    return None if seed_path is None else seeded_generator(device, *seed_path, *stream)


def _init_search(agent: ActiveInferenceAgent, frames: torch.Tensor, p: MCTSParams,
                 seed_path: Optional[Sequence[int]],
                 draws: Optional[SearchDraws] = None) -> SearchCarry:
    """Search setup: root encode (posterior mean), habit prior, phase-A
    short-circuit, root expand. Phase-A-decided envs start ``done``: they
    skip the search, like the reference's immediate return."""
    B, A = frames.shape[0], agent.pi_dim
    dev = frames.device
    if p.crn and p.fused_eval:
        raise ValueError("MCTSParams.crn requires the unfused evaluator "
                         "(fused_eval concatenates rows with per-row noise)")
    if seed_path is None and draws is None:
        raise ValueError("a search needs a seed_path or injected draws")
    seed_path = None if seed_path is None else tuple(int(x) for x in seed_path)
    _, _, N_max = _budget(p, A)
    gen = _generator(seed_path, dev, _INIT_STREAM)

    qs0_mean, _ = agent.encode(frames)
    _, root_Qpi, _ = agent.habit(qs0_mean)
    s_dim = qs0_mean.shape[-1]
    zeros = lambda *shape: torch.zeros(shape, device=dev)
    counts = lambda: torch.zeros((B,), dtype=torch.long, device=dev)
    tree = _Tree(
        s=zeros(B, N_max, s_dim), W=zeros(B, N_max, A), N=zeros(B, N_max, A),
        Qpi=zeros(B, N_max, A),
        children=torch.full((B, N_max, A), -1, dtype=torch.long, device=dev),
        done=torch.zeros((B,), dtype=torch.bool, device=dev),
        repeats_done=counts(), states_explored=counts(), depth_capped=counts(),
    )
    tree.s[:, 0] = qs0_mean
    tree.Qpi[:, 0] = root_Qpi

    # Phase A: habit short-circuit.
    if p.use_habit:
        habit_done = _calc_threshold(root_Qpi) > p.threshold
        noise = None if draws is None else draws.habit_gumbel
        habit_action = rnd.categorical(torch.log(root_Qpi + 1e-20), gen, noise)
    else:
        habit_done = torch.zeros((B,), dtype=torch.bool, device=dev)
        habit_action = counts()

    # Root expand.
    G_root, ps_next = _expand_G(agent, qs0_mean, p, gen, None if draws is None else draws.root)
    tree.W[:, 0] = -G_root
    tree.N[:, 0] = 1.0
    tree.children[:, 0] = torch.arange(1, A + 1, device=dev)
    tree.s[:, 1:A + 1] = ps_next
    tree.done = _phase_b_done(tree, p) | habit_done
    return SearchCarry(i=0, tree=tree, done=tree.done, habit_done=habit_done,
                       habit_action=habit_action, root_Qpi=root_Qpi, seed_path=seed_path)


def _evaluate(agent, leaf_s, p: MCTSParams, gen, d: Optional[IterationDraws]):
    """Expand and simulate ``leaf_s`` (rows, s_dim): (G_leaf (rows, A),
    ps_next (rows, A, s_dim), G_sim (rows,), Qpi_leaf (rows, A))."""
    rows, A, R = leaf_s.shape[0], agent.pi_dim, p.simulation_repeats
    if p.fused_eval and p.use_means:
        return _fused_expand_sim(agent, leaf_s, p, gen, None if d is None else d.fused)
    G_leaf, ps_next = _expand_G(agent, leaf_s, p, gen, None if d is None else d.expand)
    # Habit rollouts from the leaf, averaged over simulation_repeats
    # (folded into the batch).
    G_sim_r, _, Qpi_r = efe.mcts_step_simulate(
        agent, leaf_s.repeat_interleave(R, dim=0), p.simulation_depth, use_means=False,
        generator=gen, draws=None if d is None else d.simulate)
    return (G_leaf, ps_next, G_sim_r.reshape(rows, R).mean(dim=-1),
            Qpi_r.reshape(rows, R, A)[:, 0])


def _select_gumbel(p: MCTSParams, B: int, A: int, gen, dev, d: Optional[IterationDraws]):
    """(expand_k, max_depth, B, A) Gumbel noise of an iteration's walks, or
    None when selection is the argmax."""
    if p.deterministic_selection:
        return None
    if d is not None and d.select is not None:
        return d.select
    return rnd.gumbel((p.expand_k, p.max_depth, B, A), gen, dev)


def _backprop_targets(nodes, acts, active, pad_row: int):
    """Scatter targets of a walk's path: padded and inactive entries point
    at the pad row's action 0, where they add 0."""
    valid = (nodes >= 0) & active[:, None]
    b_t = torch.arange(nodes.shape[0], device=nodes.device)[:, None].expand_as(nodes)
    return valid, (b_t, torch.where(valid, nodes, pad_row), torch.where(valid, acts, 0))


Step = Union[int, torch.Tensor]  # an iteration: a host int, or 0-d int64 on the device


def _span(start: Step, n: int, device) -> torch.Tensor:
    """The indices start .. start + n - 1 on ``device``."""
    if isinstance(start, torch.Tensor):
        return start + torch.arange(n, device=device)
    return torch.arange(start, start + n, device=device)


def _walk_steps(p: MCTSParams, i: Step) -> int:
    """Steps of iteration ``i``'s walks: after i * expand_k expansions no
    path is longer than i * expand_k + 1; a device ``i`` walks max_depth
    (the steps beyond a path's end change nothing)."""
    if isinstance(i, torch.Tensor):
        return p.max_depth
    return min(p.max_depth, i * p.expand_k + 1)


def _put_row(buf: torch.Tensor, row: Step, x: torch.Tensor) -> None:
    """``buf[row] = x``."""
    buf.index_copy_(0, _span(row, 1, buf.device), x.unsqueeze(0))


def _row(buf: torch.Tensor, row: Step) -> torch.Tensor:
    return buf.index_select(0, _span(row, 1, buf.device))[0]


def _seed_leaf(tree: _Tree, leaf, mask, base: Step, G_leaf, ps_next, Qpi_leaf):
    """Expand ``leaf`` where ``mask``: seed W = -G and N = 1 on its edges,
    give it the child slots base..base+A-1 and their states, set its prior."""
    B, _, A = tree.W.shape
    bidx = torch.arange(B, device=leaf.device)
    slots = _span(base, A, leaf.device)
    tree.W[bidx, leaf] -= torch.where(mask, G_leaf, 0.0)
    tree.N[bidx, leaf] += mask.to(tree.N.dtype)
    tree.children[bidx, leaf] = torch.where(mask, slots.expand(B, A),
                                            tree.children[bidx, leaf])
    tree.Qpi[bidx, leaf] = torch.where(mask, Qpi_leaf, tree.Qpi[bidx, leaf])
    tree.s.index_copy_(1, slots, torch.where(mask[:, :, None], ps_next,
                                             tree.s.index_select(1, slots)))


def _iteration(agent, tree: _Tree, p: MCTSParams, i: Step, gen, d, paths_buf, paths_G_buf):
    """One sequential iteration: select, expand, simulate, backpropagate.
    Every write is masked by ``~tree.done``."""
    B, N_max, A = tree.W.shape
    dev = tree.W.device
    bidx = torch.arange(B, device=dev)
    active = ~tree.done
    gumbel = _select_gumbel(p, B, A, gen, dev, d)

    nodes, acts, _, leaf = _select(
        tree, p.C, p.using_prior_for_exploration, p.max_depth, steps=_walk_steps(p, i),
        gumbel=None if gumbel is None else gumbel[0])

    # A walk that hit the max_depth cap returns an internal node; expanding
    # it would orphan its subtree and count its seed visit twice, so the
    # expand is a no-op there.
    G_leaf, ps_next, G_sim, Qpi_leaf = _evaluate(agent, tree.s[bidx, leaf], p, gen, d)
    is_true_leaf = tree.children[bidx, leaf, 0] < 0
    _seed_leaf(tree, leaf, (active & is_true_leaf)[:, None], A + 1 + A * i,
               G_leaf, ps_next, Qpi_leaf)

    # Backpropagate along [root .. parent-of-leaf]: one masked scatter-add.
    # Within an env a path never repeats a node and every padded entry adds
    # 0 to the pad row, so the order of the atomics does not matter.
    valid, target = _backprop_targets(nodes, acts, active, N_max - 1)
    tree.W.index_put_(target, torch.where(valid, -G_sim[:, None], 0.0), accumulate=True)
    tree.N.index_put_(target, valid.to(tree.N.dtype), accumulate=True)

    tree.repeats_done = tree.repeats_done + active
    tree.states_explored = (tree.states_explored
                            + active * (p.simulation_depth * p.simulation_repeats))
    tree.depth_capped = tree.depth_capped + (active & ~is_true_leaf)
    if paths_buf is not None:
        _put_row(paths_buf, i, torch.where(active[:, None], acts, -1))
        # The JAX loop never runs an iteration with every env done.
        _put_row(paths_G_buf, i, torch.where(active.any(), G_sim, _row(paths_G_buf, i)))
    tree.done = _phase_b_done(tree, p)


def _iteration_k(agent, tree: _Tree, p: MCTSParams, i: Step, gen, d, paths_buf, paths_G_buf):
    """expand_k > 1: k virtual-loss selection walks, one k*B-batch G
    evaluation, k seed + backprop scatters. The dN half of backprop is
    applied at select time (the virtual visit) so that successive walks
    diverge; the dG half lands after evaluation."""
    B, N_max, A = tree.W.shape
    dev = tree.W.device
    bidx = torch.arange(B, device=dev)
    kx = p.expand_k
    active = ~tree.done
    gumbel = _select_gumbel(p, B, A, gen, dev, d)

    walks = []
    for j in range(kx):
        nodes, acts, _, leaf = _select(
            tree, p.C, p.using_prior_for_exploration, p.max_depth, steps=_walk_steps(p, i),
            gumbel=None if gumbel is None else gumbel[j])
        valid, target = _backprop_targets(nodes, acts, active, N_max - 1)
        tree.N.index_put_(target, valid.to(tree.N.dtype), accumulate=True)
        # No walk of this iteration has added children yet.
        walks.append((acts, leaf, valid, target, tree.children[bidx, leaf, 0] < 0))

    leaves = torch.stack([w[1] for w in walks])  # (k, B)
    G_leaf_a, ps_next_a, G_sim_a, Qpi_a = _evaluate(
        agent, tree.s[bidx[None], leaves].reshape(kx * B, -1), p, gen, d)
    G_leaf_a = G_leaf_a.reshape(kx, B, A)
    ps_next_a = ps_next_a.reshape(kx, B, A, -1)
    G_sim_a = G_sim_a.reshape(kx, B)
    Qpi_a = Qpi_a.reshape(kx, B, A)

    capped = torch.zeros((B,), dtype=torch.long, device=dev)
    for j, (acts, leaf, valid, target, is_true_leaf) in enumerate(walks):
        dup = torch.zeros((B,), dtype=torch.bool, device=dev)
        for jj in range(j):  # the same leaf picked twice: expand once
            dup = dup | (walks[jj][1] == leaf)
        _seed_leaf(tree, leaf, (active & is_true_leaf & ~dup)[:, None],
                   A + 1 + A * (i * kx + j), G_leaf_a[j], ps_next_a[j], Qpi_a[j])
        # dG half of backprop (dN was the virtual visit above).
        tree.W.index_put_(target, torch.where(valid, -G_sim_a[j][:, None], 0.0),
                          accumulate=True)
        capped = capped + (active & ~is_true_leaf)
        if paths_buf is not None:
            row = i * kx + j
            _put_row(paths_buf, row, torch.where(active[:, None], acts, -1))
            _put_row(paths_G_buf, row, torch.where(active.any(), G_sim_a[j],
                                                   _row(paths_G_buf, row)))

    tree.repeats_done = tree.repeats_done + kx * active
    tree.states_explored = (tree.states_explored
                            + active * (kx * p.simulation_depth * p.simulation_repeats))
    tree.depth_capped = tree.depth_capped + capped
    tree.done = _phase_b_done(tree, p)


@dataclasses.dataclass
class _BucketRows:
    """Where a bucket's envs sit in an iteration's draws over the whole
    batch of ``batch`` envs (``draw_iteration``'s layouts): the envs (the
    walks' Gumbel noise), the expand's G rows, the habit rollout's rows, the
    trajectory's depth-major rows and, for the fused evaluator, the rows of
    its one transition pass (expand pass 1, pass 2, trajectory)."""

    batch: int
    env: torch.Tensor
    expand: torch.Tensor
    rollout: torch.Tensor
    trajectory: torch.Tensor
    fused_masks: Optional[torch.Tensor]


def _bucket_rows(env: torch.Tensor, B: int, p: MCTSParams, A: int) -> _BucketRows:
    """``_BucketRows`` of the envs ``env`` of a batch of B. A row of
    expand_k * B leaves is walk-major (j * B + b); an expand's G rows are
    (leaf, action), action fastest (one row a leaf under ``crn``), sample-major
    under the sampled estimator; a rollout's are (leaf, repeat)."""
    dev = env.device
    L, R = p.expand_k * B, p.simulation_repeats
    per_leaf = 1 if p.crn else A

    def blocks(idx, n, stride):  # idx + c * stride for c < n, c slowest
        return (torch.arange(n, device=dev)[:, None] * stride + idx).flatten()

    def spread(idx, n):  # idx * n + c for c < n, c fastest
        return (idx[:, None] * n + torch.arange(n, device=dev)).flatten()

    leaf = blocks(env, p.expand_k, B)
    g_rows = spread(leaf, per_leaf)
    rollout = spread(leaf, R)
    trajectory = blocks(rollout, p.simulation_depth, L * R)
    fused = None
    if p.fused_eval and p.use_means:  # no crn: (leaf, action) rows
        fused = torch.cat([g_rows, L * A + g_rows, 2 * L * A + trajectory])
    return _BucketRows(B, env, blocks(g_rows, 1 if p.use_means else p.samples, L * per_leaf),
                       rollout, trajectory, fused)


def _gather_draws(d: IterationDraws, rows: _BucketRows) -> IterationDraws:
    """A bucket's share of ``d``, an iteration's whole-batch draws: each env
    gets the noise it gets in the whole batch."""
    def take(x, idx, dim=0):
        if x is None or isinstance(x, torch.Tensor):
            return None if x is None else x.index_select(dim, idx)
        return type(x)(take(v, idx, dim) for v in x)  # keep-masks: sequences

    def rollout(r: efe.HabitRolloutDraws):
        return efe.HabitRolloutDraws(take(r.gumbel, rows.rollout, 1), take(r.masks, rows.rollout),
                                     take(r.eps, rows.rollout, 1))

    out = IterationDraws(select=take(d.select, rows.env, 2))
    if d.fused is not None:
        f, traj = d.fused, rows.trajectory
        out.fused = FusedDraws(rollout(f.rollout), take(f.masks, rows.fused_masks),
                               take(f.eps_traj, traj), take(f.eps_rep1, rows.expand),
                               take(f.eps_rep2, traj))
    if d.expand is not None:
        out.expand = efe.GDraws(*(take(getattr(d.expand, f.name), rows.expand)
                                  for f in dataclasses.fields(efe.GDraws)))
    if d.simulate is not None:
        t = d.simulate.trajectory
        out.simulate = efe.SimulateDraws(
            rollout(d.simulate.rollout),
            efe.TrajectoryDraws(*(take(x, rows.trajectory) for x in (t.masks, t.eps, t.eps_fixed))))
    return out


def _search_step(agent, p: MCTSParams, events=None):
    """The search loop's body: ((i, tree, paths_buf, paths_G_buf, rows),
    (generator, IterationDraws)) -> the state after iteration i, the tree
    updated in place. ``rows``: None over the whole batch; a bucket's
    ``_BucketRows``, which pick its envs' noise out of the whole batch's.
    ``events``: a pair of CUDA events recorded around the iteration while a
    graph captures it."""
    step = _iteration_k if p.expand_k > 1 else _iteration

    def body(state, x):
        i, tree, paths_buf, paths_G_buf, rows = state
        gen, d = x
        if rows is not None:
            d = _gather_draws(d, rows)
        timed = events is not None and torch.cuda.is_current_stream_capturing()
        if timed:
            events[0].record()
        step(agent, tree, p, i, gen, d, paths_buf, paths_G_buf)
        if timed:
            events[1].record()
        return i + 1, tree, paths_buf, paths_G_buf, rows

    return body


def _active(state) -> torch.Tensor:
    """The envs still searching: the loop's stop value, read one iteration
    late."""
    return (~state[1].done).sum()


def _iteration_inputs(agent, carry: SearchCarry, p: MCTSParams,
                      draws: Optional[Sequence[IterationDraws]], graphed: bool,
                      rows: Optional[_BucketRows]):
    """The loop's input of iteration i, (generator, IterationDraws): op by op
    over the whole batch the generator (the iteration draws as it goes) and
    ``draws[i]``; otherwise the whole batch's draws, ``draw_iteration``'s or
    the injected ``draws[i]``, whole."""
    dev = carry.tree.W.device
    batch = carry.done.shape[0] if rows is None else rows.batch

    def inputs(i):
        gen = _generator(carry.seed_path, dev, _ITER_STREAM, i)
        d = None if draws is None else draws[i]
        if not graphed and rows is None:
            return gen, d
        return None, draw_iteration(agent, p, batch, gen, dev) if d is None else _check_whole(d, p)

    return inputs


def _loop_state(carry: SearchCarry, rows: Optional[_BucketRows], graphed: bool):
    """The loop's state; a graph's iteration counter lives on the device."""
    i = carry.i
    if graphed:
        i = torch.full((), i, dtype=torch.long, device=carry.tree.W.device)
    return i, carry.tree, carry.paths_buf, carry.paths_G_buf, rows


def _loop_options(agent, p: MCTSParams, events) -> dict:
    """A graphed loop's ``deps`` and ``key``: the timed graph is its own."""
    return dict(deps=lambda: graphs_lib.module_deps(agent),
                key=(p, agent.dtype, events is not None))


def _run_search(agent: ActiveInferenceAgent, carry: SearchCarry, p: MCTSParams, until,
                draws: Optional[Sequence[IterationDraws]] = None,
                graphs: Optional[graphs_lib.Graphs] = None, events=None,
                rows: Optional[_BucketRows] = None, first=None) -> SearchCarry:
    """Advance the search until the end of the repeat budget or until
    ``until`` of the count of envs still searching, read one iteration late
    (module docstring), says stop. ``until`` is asked before every
    iteration but the first, so a stop once every env has decided runs at
    most one no-op iteration after the last decision. ``graphs``: replay
    one captured iteration per iteration, each fed ``draw_iteration``'s
    noise (or the injected ``draws[i]``, whole); the tree then lives in the
    graph's buffers, which ``carry`` points at. None: op by op, the tree
    updated in place. ``events``: ``_search_step``'s. ``rows``: ``carry``
    is a bucket of a batch, these its rows (``_run_compacted``); ``first``:
    the first iteration's input, made already. Returns ``carry``."""
    A = carry.tree.W.shape[-1]
    n_iters, _, _ = _budget(p, A)
    start = carry.i
    n = max(n_iters - start, 0)
    inputs = _iteration_inputs(agent, carry, p, draws, graphs is not None, rows)
    xs = (first if i == start and first is not None else inputs(i)
          for i in range(start, start + n))
    body = _search_step(agent, p, events)
    state = _loop_state(carry, rows, graphs is not None)
    if graphs is None:
        state, ran = graphs_lib.eager_while_loop(body, state, xs, n, _active, until)
    else:
        state, ran = graphs.while_loop(body, state, xs, n, _active, until=until,
                                       **_loop_options(agent, p, events))
    _, carry.tree, carry.paths_buf, carry.paths_G_buf, _ = state
    carry.i = start + ran
    carry.done = carry.tree.done
    return carry


def bucket_size(n: int) -> int:
    """The smallest power-of-two bucket, at least ``MIN_BUCKET``, that holds
    ``n`` envs: a compacted search's, and the sweep's padding of the envs
    that need a plan (``train/sweep.py``)."""
    return max(MIN_BUCKET, 1 << max(n - 1, 0).bit_length())


def _gather_carry(carry: SearchCarry, idx: torch.Tensor) -> SearchCarry:
    """Re-pack per-env search state onto the rows in ``idx`` (compaction),
    the paths along their env axis. Copies: the result shares no storage
    with ``carry``."""
    take = lambda x, dim=0: None if x is None else x.index_select(dim, idx)
    tree = _Tree(**{f.name: take(getattr(carry.tree, f.name))
                    for f in dataclasses.fields(_Tree)})
    return dataclasses.replace(
        carry, tree=tree, done=tree.done, habit_done=take(carry.habit_done),
        habit_action=take(carry.habit_action), root_Qpi=take(carry.root_Qpi),
        paths_buf=take(carry.paths_buf, 1), paths_G_buf=take(carry.paths_G_buf, 1))


def _scatter_carry(dst: SearchCarry, src: SearchCarry, env: torch.Tensor) -> None:
    """Write what the search changes of a bucket ``src`` (its tree and
    paths) into the batch ``dst`` at its envs' rows ``env``."""
    for f in dataclasses.fields(_Tree):
        getattr(dst.tree, f.name).index_copy_(0, env, getattr(src.tree, f.name))
    for d, s in ((dst.paths_buf, src.paths_buf), (dst.paths_G_buf, src.paths_G_buf)):
        if d is not None:
            d.index_copy_(1, env, s)


def _run_compacted(agent: ActiveInferenceAgent, carry: SearchCarry, p: MCTSParams,
                   draws: Optional[Sequence[IterationDraws]],
                   graphs: Optional[graphs_lib.Graphs], events) -> List[Tuple[int, int]]:
    """Run ``carry``'s search to its end, compacting its batch (module
    docstring): once the count of envs still searching, read one iteration
    late, is half the bucket or less and the bucket is above
    ``MIN_BUCKET``, the bucket's rows go back into ``carry`` and the envs
    not known to have decided, padded with decided ones, into the smallest
    bucket that holds them; the search goes on there at the same
    iteration. The first compaction of a graphed search captures every
    smaller bucket's graph too. Counts ``mcts.row_iterations`` and
    ``mcts.compactions``; keeps ``mcts.device`` (``events``: the whole
    batch's graph's). Returns the (first iteration, size) of each bucket."""
    B, A = carry.done.shape[0], carry.tree.W.shape[-1]
    n_iters, _, _ = _budget(p, A)
    bucket, rows, first, schedule, row_iterations = carry, None, None, [], 0
    while True:
        size, read = bucket.done.shape[0], []

        def until(active, size=size, read=read):
            n = int(active)
            if n == 0 or (size > MIN_BUCKET and n <= size // 2):
                read.append(n)
                return True
            return False

        start, replays = bucket.i, graphs.replays if events else 0
        _run_search(agent, bucket, p, until, draws, graphs,
                    events if rows is None else None, rows, first)
        row_iterations += size * (bucket.i - start)
        carry.i = bucket.i
        if rows is not None:
            _scatter_carry(carry, bucket, rows.env)
        elif events and graphs.replays > replays:
            profiling.record_device_events("mcts.device", *events)
        if not read or not read[0] or bucket.i >= n_iters:
            break
        size = bucket_size(read[0])
        order = torch.argsort(carry.tree.done.to(torch.int32), stable=True)  # searching first
        rows = _bucket_rows(order[:size], B, p, A)
        bucket = _gather_carry(carry, rows.env)
        schedule.append((bucket.i, size))
        first = None
        if graphs is not None and len(schedule) == 1:
            first = _iteration_inputs(agent, carry, p, draws, True, rows)(bucket.i)
            body = _search_step(agent, p)
            smaller = size // 2
            while smaller >= MIN_BUCKET:
                spare_rows = _bucket_rows(order[:smaller], B, p, A)
                spare = _gather_carry(carry, spare_rows.env)
                graphs.warm_loop(body, _loop_state(spare, spare_rows, True), first, _active,
                                 **_loop_options(agent, p, None))
                smaller //= 2
    carry.done = carry.tree.done
    profiling.count("mcts.row_iterations", row_iterations)
    profiling.count("mcts.compactions", len(schedule))
    return schedule


def _finalize_search(agent: ActiveInferenceAgent, carry: SearchCarry, p: MCTSParams,
                     final_gumbel: Optional[torch.Tensor] = None) -> MCTSResult:
    """Final visit-count action path + trim (phase C), with the phase-A
    overrides (single habit action, zero search). Reads the tree only."""
    tree = carry.tree
    B, _, A = tree.N.shape
    if not p.deterministic_action and final_gumbel is None:
        final_gumbel = rnd.gumbel((p.max_depth, B, A),
                                  _generator(carry.seed_path, tree.N.device, _FINAL_STREAM),
                                  tree.N.device)
    actions, lengths = _action_selection(
        tree, p.max_depth, A, steps=carry.i * p.expand_k + 1,
        gumbel=None if p.deterministic_action else final_gumbel)
    # Copies: the tree may live in a graph's buffers, which the next search
    # overwrites.
    repeats_done = tree.repeats_done.clone()
    states_explored = tree.states_explored.clone()
    if p.use_habit:
        habit_path = torch.full_like(actions, -1)
        habit_path[:, 0] = carry.habit_action
        actions = torch.where(carry.habit_done[:, None], habit_path, actions)
        lengths = torch.where(carry.habit_done, 1, lengths)
        repeats_done = torch.where(carry.habit_done, 0, repeats_done)
        states_explored = torch.where(carry.habit_done, 0, states_explored)
    return MCTSResult(
        actions=actions, lengths=lengths, repeats_done=repeats_done,
        states_explored=states_explored, depth_capped=tree.depth_capped.clone(),
        root_N=tree.N[:, 0].clone(), root_Qpi=carry.root_Qpi,
        all_paths=None, all_paths_G=None, tree=None,
    )


@profiling.spanned("mcts.plan")
def _search(agent, frames: torch.Tensor, p: MCTSParams, seed_path, collect_paths: bool,
            return_tree: bool, draws: Optional[SearchDraws],
            graphs: Optional[graphs_lib.Graphs],
            events=None) -> Tuple[MCTSResult, List[Tuple[int, int]]]:
    """One search, compacted (``_run_compacted``): (its result, its bucket
    schedule)."""
    B, A = frames.shape[0], agent.pi_dim
    _, n_expansions, _ = _budget(p, A)
    carry = _init_search(agent, frames, p, seed_path, draws)
    if collect_paths:
        carry.paths_buf = torch.full((n_expansions, B, p.max_depth), -1, dtype=torch.long,
                                     device=frames.device)
        carry.paths_G_buf = torch.zeros((n_expansions, B), device=frames.device)
    schedule = _run_compacted(agent, carry, p, None if draws is None else draws.iterations,
                              graphs, events)
    res = _finalize_search(agent, carry, p, None if draws is None else draws.final_gumbel)
    profiling.count("mcts.iterations", carry.i)
    profiling.count("mcts.env_iterations", res.repeats_done)
    profiling.count("mcts.short_circuits", carry.habit_done)
    # Copies, as in _finalize_search.
    tree_out = None
    if return_tree:
        tree_out = _Tree(**{f.name: getattr(carry.tree, f.name).clone()
                            for f in dataclasses.fields(_Tree)})
        tree_out.repeats_done, tree_out.states_explored = res.repeats_done, res.states_explored
    paths = [None if x is None else x.clone() for x in (carry.paths_buf, carry.paths_G_buf)]
    return res._replace(all_paths=paths[0], all_paths_G=paths[1], tree=tree_out), schedule


@torch.inference_mode()
def active_inference_mcts(agent: ActiveInferenceAgent, frames: torch.Tensor, p: MCTSParams,
                          seed_path: Optional[Sequence[int]] = None,
                          collect_paths: bool = False, return_tree: bool = False,
                          draws: Optional[SearchDraws] = None,
                          graphed: Optional[bool] = False) -> MCTSResult:
    """Batched planner entry point.

    Args:
      frames: (B, C, H, W) current observations.
      seed_path: integers that seed the search's noise (module docstring);
        ``draws`` injects the noise instead.
      collect_paths: also return per-expansion selection paths + G (the
        demo's visit-density input; memory ~ R*B*max_depth).
      return_tree: also return the final tree arrays (tests, debugging).
      graphed: False (the default): op by op. None (on a card) or True:
        the search loop replays one captured iteration, in graphs of this
        call's own, captured anew on every call; a caller that plans more
        than once builds ``make_jit_planner``, which keeps its graphs across
        calls. True on the CPU raises.
    """
    graphs = graphs_lib.Graphs() if graphs_lib.use_graphs(graphed, frames) else None
    return _search(agent, frames, p, seed_path, collect_paths, return_tree, draws, graphs)[0]


def make_jit_planner(agent: ActiveInferenceAgent, p: MCTSParams, collect_paths: bool = False,
                     graphed: Optional[bool] = None):
    """The planner for one agent and ``p``, the counterpart of the JAX
    package's ``make_jit_planner``: ``plan(frames, seed_path=None,
    draws=None) -> MCTSResult`` is ``active_inference_mcts`` with
    ``collect_paths``, its search loop replayed from graphs it keeps across
    calls (``plan.graphs``: one per batch size; module docstring).
    ``graphed``: None, on a card; True raises on the CPU; False runs op by
    op (a mesh's planner: gloo cannot be captured). The weights are read
    where they live, so in-place updates need no new capture. ``plan.last``
    is the last call's result and ``plan.schedule`` its compactions, the
    (first iteration, size) of each bucket; a graphed plan times its whole
    batch's search step (``mcts.device``, module docstring)."""
    graphs = graphs_lib.Graphs()
    events = []  # the timing pair, made at the first graphed plan

    @torch.inference_mode()
    def plan(frames: torch.Tensor, seed_path: Optional[Sequence[int]] = None,
             draws: Optional[SearchDraws] = None) -> MCTSResult:
        g = graphs if graphs_lib.use_graphs(graphed, frames) else None
        if g is not None and frames.is_cuda and not events:
            events.extend(torch.cuda.Event(enable_timing=True, external=True)
                          for _ in range(2))
        plan.last, plan.schedule = _search(agent, frames, p, seed_path, collect_paths, False,
                                           draws, g, events if g is not None and events else None)
        return plan.last

    plan.graphs = graphs
    plan.last, plan.schedule = None, []
    return plan
