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
  - The JAX search loop stops when every env is done. Here the all-done
    flag is read one iteration late, from a pinned buffer whose copy was
    enqueued before that iteration, so the card always has an iteration
    queued. An iteration in which every env is done writes nothing, so only
    ``SearchCarry.i`` can differ.
  - The tree is updated in place. A done env's rows are frozen and ``done``
    only grows, so a caller may finalize a retired env any number of
    iterations later; ``_gather_carry`` copies.
  - Iteration ``i`` draws from ``seeded_generator(device, *seed_path, 0, i)``
    (the counterpart of ``fold_in(k_loop, i)``), so a compacted search
    replays the same stream of seeds. All noise can be injected instead
    (``SearchDraws``).
  - There is no ``make_jit_planner``: nothing is compiled, so
    ``active_inference_mcts`` is the planner to call.

Everything runs under ``torch.inference_mode()``.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from deep_active_inference_mc_torch.infer import efe
from deep_active_inference_mc_torch.infer.agent import ActiveInferenceAgent
from deep_active_inference_mc_torch.models.networks import reparameterize
from deep_active_inference_mc_torch.ops import math as m
from deep_active_inference_mc_torch.utils import random as rnd
from deep_active_inference_mc_torch.utils.device import seeded_generator

# Streams under a search's seed path.
_ITER_STREAM, _INIT_STREAM, _FINAL_STREAM = 0, 1, 2


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
    (expand_k, max_depth, B, A) when selection is sampled."""

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

    ``_init_search`` -> ``_run_search`` (any number of times) ->
    ``_finalize_search`` lets a host-side loop pause the search at
    iteration boundaries, retire decided environments and re-pack the
    stragglers into a smaller batch (``make_bucketed_planner``). Every
    tensor has leading batch dim B; ``i`` and ``seed_path`` are host values
    shared across the batch, so a compacted search goes on drawing
    iteration i's noise from the same seed."""

    i: int  # sequential iterations enqueued
    tree: _Tree
    done: torch.Tensor  # (B,) decision frozen (phase A/B)
    habit_done: torch.Tensor  # (B,) phase-A short-circuit fired
    habit_action: torch.Tensor  # (B,) phase-A habit action
    root_Qpi: torch.Tensor  # (B, A) habit prior at the root
    seed_path: Optional[Tuple[int, ...]]  # None: every draw is injected


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


class _HostCopy:
    """A tensor on its way to the host. On a card the copy is enqueued now,
    into pinned memory, and ``read`` waits for it alone: work enqueued after
    it does not hold the reader up."""

    def __init__(self, x: torch.Tensor):
        self._event = None
        if x.is_cuda:
            self._host = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
            self._host.copy_(x, non_blocking=True)
            self._event = torch.cuda.Event()
            self._event.record()
        else:
            self._host = x.clone()

    def read(self) -> torch.Tensor:
        if self._event is not None:
            self._event.synchronize()
        return self._host


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


def _seed_leaf(tree: _Tree, leaf, mask, base: int, G_leaf, ps_next, Qpi_leaf):
    """Expand ``leaf`` where ``mask``: seed W = -G and N = 1 on its edges,
    give it the child slots base..base+A-1 and their states, set its prior."""
    B, _, A = tree.W.shape
    bidx = torch.arange(B, device=leaf.device)
    tree.W[bidx, leaf] -= torch.where(mask, G_leaf, 0.0)
    tree.N[bidx, leaf] += mask.to(tree.N.dtype)
    child_ids = torch.arange(base, base + A, device=leaf.device).expand(B, A)
    tree.children[bidx, leaf] = torch.where(mask, child_ids, tree.children[bidx, leaf])
    tree.Qpi[bidx, leaf] = torch.where(mask, Qpi_leaf, tree.Qpi[bidx, leaf])
    slots = tree.s[:, base:base + A]
    tree.s[:, base:base + A] = torch.where(mask[:, :, None], ps_next, slots)


def _iteration(agent, tree: _Tree, p: MCTSParams, i: int, gen, d, paths_buf, paths_G_buf):
    """One sequential iteration: select, expand, simulate, backpropagate.
    Every write is masked by ``~tree.done``."""
    B, N_max, A = tree.W.shape
    dev = tree.W.device
    bidx = torch.arange(B, device=dev)
    active = ~tree.done
    gumbel = _select_gumbel(p, B, A, gen, dev, d)

    # After i expansions no path is longer than i + 1.
    nodes, acts, _, leaf = _select(
        tree, p.C, p.using_prior_for_exploration, p.max_depth, steps=i + 1,
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
        paths_buf[i] = torch.where(active[:, None], acts, -1)
        # The JAX loop never runs an iteration with every env done.
        paths_G_buf[i] = torch.where(active.any(), G_sim, paths_G_buf[i])
    tree.done = _phase_b_done(tree, p)


def _iteration_k(agent, tree: _Tree, p: MCTSParams, i: int, gen, d, paths_buf, paths_G_buf):
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
            tree, p.C, p.using_prior_for_exploration, p.max_depth, steps=i * kx + 1,
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
            paths_buf[i * kx + j] = torch.where(active[:, None], acts, -1)
            paths_G_buf[i * kx + j] = torch.where(active.any(), G_sim_a[j],
                                                  paths_G_buf[i * kx + j])

    tree.repeats_done = tree.repeats_done + kx * active
    tree.states_explored = (tree.states_explored
                            + active * (kx * p.simulation_depth * p.simulation_repeats))
    tree.depth_capped = tree.depth_capped + capped
    tree.done = _phase_b_done(tree, p)


def _run_search(agent: ActiveInferenceAgent, carry: SearchCarry, p: MCTSParams, i_end: int,
                paths_buf: Optional[torch.Tensor] = None,
                paths_G_buf: Optional[torch.Tensor] = None,
                draws: Optional[Sequence[IterationDraws]] = None) -> SearchCarry:
    """Advance the search, in place, until iteration ``i_end`` (clamped to
    the repeat budget) or until every env has decided. The all-done flag
    is read one iteration late (module docstring), so at most one no-op
    iteration runs after the last decision. Returns ``carry``."""
    tree = carry.tree
    n_iters, _, _ = _budget(p, tree.W.shape[-1])
    step = _iteration_k if p.expand_k > 1 else _iteration
    start = carry.i
    flags = {}
    for i in range(start, min(int(i_end), n_iters)):
        if i > start and bool(flags.pop(i - 1).read()):
            break
        flags[i] = _HostCopy(tree.done.all())  # every env done before iteration i?
        gen = _generator(carry.seed_path, tree.W.device, _ITER_STREAM, i)
        step(agent, tree, p, i, gen, None if draws is None else draws[i],
             paths_buf, paths_G_buf)
        carry.i = i + 1
    carry.done = tree.done
    return carry


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
    repeats_done = tree.repeats_done
    states_explored = tree.states_explored
    if p.use_habit:
        habit_path = torch.full_like(actions, -1)
        habit_path[:, 0] = carry.habit_action
        actions = torch.where(carry.habit_done[:, None], habit_path, actions)
        lengths = torch.where(carry.habit_done, 1, lengths)
        repeats_done = torch.where(carry.habit_done, 0, repeats_done)
        states_explored = torch.where(carry.habit_done, 0, states_explored)
    return MCTSResult(
        actions=actions, lengths=lengths, repeats_done=repeats_done,
        states_explored=states_explored, depth_capped=tree.depth_capped,
        root_N=tree.N[:, 0].clone(), root_Qpi=carry.root_Qpi,
        all_paths=None, all_paths_G=None, tree=None,
    )


@torch.inference_mode()
def active_inference_mcts(agent: ActiveInferenceAgent, frames: torch.Tensor, p: MCTSParams,
                          seed_path: Optional[Sequence[int]] = None,
                          collect_paths: bool = False, return_tree: bool = False,
                          draws: Optional[SearchDraws] = None) -> MCTSResult:
    """Batched planner entry point.

    Args:
      frames: (B, C, H, W) current observations.
      seed_path: integers that seed the search's noise (module docstring);
        ``draws`` injects the noise instead.
      collect_paths: also return per-expansion selection paths + G (the
        demo's visit-density input; memory ~ R*B*max_depth).
      return_tree: also return the final tree arrays (tests, debugging).
    """
    B, A = frames.shape[0], agent.pi_dim
    n_iters, n_expansions, _ = _budget(p, A)
    carry = _init_search(agent, frames, p, seed_path, draws)
    paths_buf = paths_G_buf = None
    if collect_paths:
        paths_buf = torch.full((n_expansions, B, p.max_depth), -1, dtype=torch.long,
                               device=frames.device)
        paths_G_buf = torch.zeros((n_expansions, B), device=frames.device)
    carry = _run_search(agent, carry, p, n_iters, paths_buf, paths_G_buf,
                        None if draws is None else draws.iterations)
    res = _finalize_search(agent, carry, p, None if draws is None else draws.final_gumbel)
    tree_out = None
    if return_tree:
        tree_out = dataclasses.replace(carry.tree, repeats_done=res.repeats_done,
                                       states_explored=res.states_explored)
    return res._replace(all_paths=paths_buf, all_paths_G=paths_G_buf, tree=tree_out)


def _gather_carry(carry: SearchCarry, idx: torch.Tensor) -> SearchCarry:
    """Re-pack per-env search state onto the rows in ``idx`` (compaction).
    Copies: the result shares no storage with ``carry``."""
    take = lambda x: x.index_select(0, idx)
    tree = _Tree(**{f.name: take(getattr(carry.tree, f.name))
                    for f in dataclasses.fields(_Tree)})
    return dataclasses.replace(
        carry, tree=tree, done=tree.done, habit_done=take(carry.habit_done),
        habit_action=take(carry.habit_action), root_Qpi=take(carry.root_Qpi))


_OUT_FIELDS = ("actions", "lengths", "repeats_done", "states_explored", "depth_capped",
               "root_N", "root_Qpi")


def make_bucketed_planner(agent: ActiveInferenceAgent, p: MCTSParams,
                          check_every: int = 16, min_bucket: int = 32):
    """Host-driven planner with batch compaction.

    The plain planner runs until the slowest env of the batch decides, and
    every decided env keeps paying full (masked) G-network compute while it
    rides along. This planner pauses the search every ``check_every``
    iterations, retires decided envs (their trees are frozen, so finalizing
    early is exact) and gathers the stragglers into the smallest
    power-of-two bucket >= max(active, ``min_bucket``). Iteration cost then
    follows the active env count.

    Per-env search semantics are ``active_inference_mcts``'s (same tree
    updates, same per-iteration seeds); only the row layout of the noise
    differs after a compaction, as with ``fused_eval``. With no compaction
    (e.g. B == min_bucket) the results equal the plain planner's bit for bit.
    ``collect_paths``, ``return_tree`` and injected draws are not supported.

    The check cadence adapts within one call and keeps no state across
    calls: check every ``check_every`` iterations; after 2 checks in a row
    with no compaction, double the stride; reset it to ``check_every``
    whenever a compaction fires.

    The loop is pipelined: the next chunk is enqueued before the host
    waits for the previous chunk's done mask, whose copy was enqueued ahead
    of that chunk. Retirement therefore runs one chunk stale, which is
    valid because ``done`` only grows and a done env's tree is frozen; the
    mask that decides it is the snapshot, not the live ``carry.done``.

    Returns ``plan(frames, seed_path) -> MCTSResult``; after a call
    ``plan.bucket_trace`` lists its bucket sizes and ``plan.schedule`` the
    iterations at which it compacted.
    """
    n_iters, _, _ = _budget(p, agent.pi_dim)

    @torch.inference_mode()
    def plan(frames: torch.Tensor, seed_path: Sequence[int]) -> MCTSResult:
        B0, A = frames.shape[0], agent.pi_dim
        dev = frames.device
        plan.bucket_trace = [B0]
        gidx = np.arange(B0)  # bucket row -> original env row (-1 = pad)
        recorded = []
        at_floor = B0 <= min_bucket
        stride = check_every
        dry = 0  # checks in a row with no compaction at the current stride

        def next_stop(i):
            # At min_bucket no further compaction is possible: run the rest
            # of the budget as one chunk (it still stops once all decide).
            if at_floor:
                return n_iters
            return min(i + stride, n_iters)

        stash = []  # (MCTSResult on the device, bucket rows, original env rows)
        i_host = next_stop(0)
        carry = _run_search(agent, _init_search(agent, frames, p, seed_path), p, i_host)
        pending_done = _HostCopy(carry.done)
        while True:
            ran_next = i_host < n_iters
            i_next = next_stop(i_host) if ran_next else i_host
            if ran_next:
                carry = _run_search(agent, carry, p, i_next)
            done = pending_done.read().numpy()  # waits for the previous chunk only
            if not ran_next or done.all():
                # Budget exhausted, or everything decided (a chunk enqueued
                # above was then a no-op).
                stash.append((_finalize_search(agent, carry, p),
                              np.arange(done.shape[0]), gidx))
                break
            cur_B = done.shape[0]
            n_active = int((~done).sum())
            new_B = cur_B
            while new_B // 2 >= max(min_bucket, n_active):
                new_B //= 2
            if new_B == cur_B:
                dry += 1
                if dry >= 2:
                    stride = min(stride * 2, n_iters)
                    dry = 0
            else:
                stride = check_every
                dry = 0
                # Retire the envs known done as of the snapshot (frozen
                # since), reading their results from the tree as it is now.
                stash.append((_finalize_search(agent, carry, p), np.where(done)[0], gidx))
                keep = np.where(~done)[0]
                pad = new_B - keep.shape[0]
                idx = np.concatenate([keep, np.full(pad, keep[0], np.int64)])
                carry = _gather_carry(carry, torch.as_tensor(idx, device=dev))
                if pad:
                    carry.done[keep.shape[0]:] = True  # the gather's own copy
                gidx = np.concatenate([gidx[keep], np.full(pad, -1, np.int64)])
                plan.bucket_trace.append(new_B)
                recorded.append(i_host)
                if new_B <= min_bucket:
                    at_floor = True
            i_host = i_next
            pending_done = _HostCopy(carry.done)

        plan.schedule = recorded  # this call's compaction iterations

        out = {}
        for res, rows, gmap in stash:
            dst = gmap[rows]
            rows, dst = rows[dst >= 0], dst[dst >= 0]
            if rows.size == 0:
                continue
            rows, dst = torch.as_tensor(rows, device=dev), torch.as_tensor(dst, device=dev)
            for name in _OUT_FIELDS:
                x = getattr(res, name)
                if name not in out:
                    fill = -1 if name == "actions" else 0
                    out[name] = torch.full((B0,) + tuple(x.shape[1:]), fill, dtype=x.dtype,
                                           device=dev)
                out[name][dst] = x[rows]
        return MCTSResult(**out, all_paths=None, all_paths_G=None, tree=None)

    return plan
