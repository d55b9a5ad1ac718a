"""The paper's MCTS planner, plain, and its replay of a program's search.

Fountas et al. 2020 (arXiv:2006.04176, section 3) with the planner of
zfountas/deep-active-inference-mc. One decision of one env:

1. The root: the encoder mean s0 of the frame and the habit's prior
   Q(pi | s0).
2. Phase A: where max Q - mean Q exceeds ``threshold``, the habit acts (a
   draw from Q by Gumbel-max) and there is no search.
3. The root's expansion: G of every action from s0 (``efe.G_mean``, the
   one-step mean estimator); each edge gets W = -G and N = 1, each child
   the transition's mean as its state.
4. Up to ``repeats`` iterations, each: the walk from the root into
   children, at each node the argmax of Q' + C / N (Q = W / N shifted to a
   minimum of 0 and scaled to a sum of 1; with the prior, C Q(pi) / N), to a
   node with no children; its expansion as the root's; the simulation from
   it, a habit rollout of the simulation's depth (actions drawn from
   Q(pi | s) by Gumbel-max, states sampled from the dropout transition)
   scored by the trajectory's G averaged over its steps; the backup of
   -G_sim and one visit along the walk's edges; phase B: stop once max -
   mean of the root's normalised visits exceeds ``threshold``.
5. The action: the visit-max walk from the root with its opposite-action
   pairs trimmed under the reference's bound (the last action is emitted
   only as the second of a pair); its first action, or the root's visit-max
   action where the trimmed walk is empty.

Departures from the reference, each the port's too: a walk takes at most
``max_depth`` steps, and one that ends on a node with children expands
nothing (the reference's walk has no bound); a tie goes to the first of the
tied values; the noise is given, not drawn; children are numbered as the
port numbers its slots (the root 0, its children 1..A, the children of
iteration i's leaf A + 1 + A i onwards), so that the replay can read the
program's tree. Here the statistics W and N are kept on the host in
float64 (the port: float32 on the device) and the networks run in float32
with TF32 off.

``search`` runs the planner itself. ``replay`` walks a program's recorded
search (its paths, its simulation G and its final tree) and reads how far
the program lies from the reference: the expand G and child states on the
program's own leaf states (``expand_gap``), each of the walk's choices
against the UCB of the program's own W and N as the reference computes it
(``choice_gap``), the simulation's G, the reference's habit rollout and
trajectory G from the program's own leaf under the same noise, against the
value the program backed up (``sim_gap``), and whether the root's visits,
the stop iteration and the final action follow from the program's walks
(``mismatches``). Walking on
the program's W and N, rather than on its own, keeps the choices apart from
G's rounding: the normalisation of Q scales a near tie of four Q values up
to the whole range, where a TF32 rounding of G reorders them; the margin
of the reference's own W and N is reported besides (``own_choice_gap``)."""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from portbench.reference import efe, nets

Noise = Dict  # one iteration's noise of the envs searched (row j: env j)
# A rollout whose habit draw had its two best scores within TIE of each other
# is left out of ``sim_gap``: a rounding of the habit's output may take either
# action there, and the rest of the rollout differs with it.
TIE = 1e-3


@dataclasses.dataclass(frozen=True)
class Knobs:
    C: float
    threshold: float
    repeats: int
    use_habit: bool
    use_prior: bool
    max_depth: int
    rate: float  # the transition's dropout
    pi_dim: int

    @classmethod
    def of(cls, planner: Dict, dropout: float, pi_dim: int) -> "Knobs":
        return cls(planner["C"], planner["threshold"], planner["repeats"], planner["use_habit"],
                   planner["using_prior_for_exploration"], planner["max_depth"], dropout,
                   pi_dim)


def confidence(p: np.ndarray) -> float:
    return float(p.max() - p.mean())


def ucb(W: np.ndarray, N: np.ndarray, Qpi: np.ndarray, C: float, use_prior: bool):
    n = np.maximum(N, 1e-12)
    Q = W / n
    Q = Q - Q.min()
    Q = Q / max(Q.sum(), 1e-12)
    return Q + (C * Qpi / n if use_prior else C / n)


def expand(P, s: torch.Tensor, noise: Dict, rate: float, A: int):
    """G (J, A) of every action from states s (J, s_dim) and the children's
    states (J, A, s_dim); ``noise``: ``g_noise`` rows (env, action)."""
    J = s.shape[0]
    pi = torch.eye(A, device=s.device).repeat(J, 1)
    G, mean1 = efe.G_mean(P, s.repeat_interleave(A, dim=0), pi, noise["masks1"],
                          noise["masks2"], noise["eps_fixed"], rate)
    return G.reshape(J, A), mean1.reshape(J, A, -1)


def simulate(P, s: torch.Tensor, rollout: Dict, trajectory: Dict, rate: float, A: int):
    """G_sim (J,) of a habit rollout from states s (J, s_dim): rollout rows
    (step, env), trajectory rows depth-major; and each rollout's narrowest
    margin (J,) between the best and second-best score of its habit draws."""
    eye = torch.eye(A, device=s.device)
    rows = []
    margin = torch.full((s.shape[0],), float("inf"), device=s.device)
    for t in range(rollout["gumbel"].shape[0]):
        _, q = nets.habit(P, s)
        score = torch.log(q + 1e-20) + rollout["gumbel"][t]
        top2 = score.topk(2, dim=-1).values
        margin = torch.minimum(margin, top2[:, 0] - top2[:, 1])
        pi = eye[torch.argmax(score, dim=-1)]
        mean, logvar = nets.transition(P, pi, s, rollout["masks"][t], rate)
        sample = mean + torch.exp(0.5 * logvar) * rollout["eps"][t]
        rows.append((s, sample, mean, logvar, pi))
        s = sample
    s0, s1, mean, logvar, pi = (torch.cat(x) for x in zip(*rows))
    po1 = nets.decode(P, s1)
    _, q_logvar = nets.encode(P, po1)
    term0 = efe.reward_term(po1)
    term1 = -(efe.entropy_normal(logvar) + efe.entropy_normal(q_logvar)).sum(-1)
    mean_b, logvar_b = nets.transition(P, pi, s0, trajectory["masks"], rate)
    t21 = efe.entropy_bernoulli(nets.decode(
        P, mean_b + torch.exp(0.5 * logvar_b) * trajectory["eps"])).sum(dim=(-3, -2, -1))
    t22 = efe.entropy_bernoulli(nets.decode(
        P, mean + torch.exp(0.5 * logvar) * trajectory["eps_fixed"])).sum(dim=(-3, -2, -1))
    G = -term0 + term1 + (t21 - t22)
    return G.reshape(len(rows), -1).mean(dim=0), margin


def phase_a(Qpi: torch.Tensor, gumbel: torch.Tensor, threshold: float):
    """(short-circuits (J,) bool, the habit's actions (J,), its scores (J, A))."""
    conf = Qpi.max(dim=-1).values - Qpi.mean(dim=-1)
    score = torch.log(Qpi + 1e-20) + gumbel
    return conf > threshold, score.argmax(dim=-1), score, conf


def opposite(a: int, b: int, A: int) -> bool:
    if A == 4:
        return {a, b} in ({0, 1}, {2, 3})
    return {a, b} == {1, 2}


def trimmed(path: List[int], A: int) -> List[int]:
    out, i = [], 0
    while i < len(path) - 1:
        if opposite(path[i], path[i + 1], A):
            i += 2
        else:
            out.append(path[i])
            i += 1
    return out


@dataclasses.dataclass
class _Tree:
    """One env's statistics: edges of the slots, float64 on the host."""

    W: np.ndarray
    N: np.ndarray
    Qpi: np.ndarray
    children: np.ndarray

    @classmethod
    def empty(cls, slots: int, A: int) -> "_Tree":
        return cls(np.zeros((slots, A)), np.zeros((slots, A)), np.zeros((slots, A)),
                   np.full((slots, A), -1, np.int64))

    def final_action(self, A: int, max_depth: int) -> int:
        node, path = 0, []
        for _ in range(max_depth):
            a = int(np.argmax(self.N[node]))
            if self.children[node, a] < 0:
                break
            path.append(a)
            node = self.children[node, a]
        t = trimmed(path, A)
        return t[0] if t else int(np.argmax(self.N[0]))


@dataclasses.dataclass
class Program:
    """A program's recorded search of J envs, on the host: ``paths`` (R, J,
    max_depth) walk actions (-1 padded; -1 rows once an env is done),
    ``sim_G`` (R, J), the final tree's ``W``, ``N`` (J, slots, A),
    ``children`` (J, slots, A) and states ``s`` (J, slots, s_dim, on the
    device), and ``repeats_done``, ``root_N``, ``action`` (J,)."""

    paths: np.ndarray
    sim_G: np.ndarray
    W: np.ndarray
    N: np.ndarray
    children: np.ndarray
    s: torch.Tensor
    repeats_done: np.ndarray
    root_N: np.ndarray
    action: np.ndarray


def _program_sums(prog: Program, j: int):
    """Per edge of env j's program tree: the -G_sim its walks backed up and
    their count, so that W and N at the edge's creation are the final tree's
    less these."""
    sums = np.zeros(prog.W.shape[1:])
    counts = np.zeros(prog.W.shape[1:])
    for r in range(int(prog.repeats_done[j])):
        node = 0
        for a in prog.paths[r, j]:
            if a < 0:
                break
            sums[node, a] -= float(prog.sim_G[r, j])
            counts[node, a] += 1
            node = prog.children[j, node, a]
    return sums, counts


def g_rows(n: Dict, envs: torch.Tensor, A: int) -> Dict:
    """The (env, action) rows of envs ``envs`` (row j: env ``envs[j]``) of a
    G evaluation's noise."""
    rows = (envs[:, None] * A + torch.arange(A, device=envs.device)).reshape(-1)
    return {"masks1": [m[rows] for m in n["masks1"]], "masks2": [m[rows] for m in n["masks2"]],
            "eps_fixed": n["eps_fixed"][rows]}


def select_rows(n: Noise, envs: torch.Tensor, A: int) -> Noise:
    """The rows of envs ``envs`` of one iteration's noise (the expand's
    (env, action) rows, the rollout's env column, the trajectory's
    depth-major rows)."""
    D, B = n["rollout"]["gumbel"].shape[:2]
    t_rows = (torch.arange(D, device=envs.device)[:, None] * B + envs).reshape(-1)
    r, t = n["rollout"], n["trajectory"]
    return {"expand": g_rows(n["expand"], envs, A),
            "rollout": {"gumbel": r["gumbel"][:, envs], "eps": r["eps"][:, envs],
                        "masks": [[m[envs] for m in ms] for ms in r["masks"]]},
            "trajectory": {"masks": [m[t_rows] for m in t["masks"]],
                           "eps": t["eps"][t_rows], "eps_fixed": t["eps_fixed"][t_rows]}}


def _rel(a, b, floor: float) -> float:
    return float(np.max(np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64))
                        / np.maximum(np.abs(np.asarray(b, np.float64)), floor)))


def _run(P, s0: torch.Tensor, Qpi0: torch.Tensor, root_noise: Dict,
         noise_of: Callable[[int], Noise], kn: Knobs, prog: Optional[Program],
         G_floor: float, s_floor: float, skip: Optional[np.ndarray] = None):
    J, A = s0.shape[0], kn.pi_dim
    slots = A * (kn.repeats + 1) + 1
    trees = [_Tree.empty(slots, A) for _ in range(J)]
    states = torch.zeros((J, slots, s0.shape[1]), device=s0.device)
    Qpi0_h = Qpi0.double().cpu().numpy()
    out = {"G_gap": 0.0, "state_gap": 0.0, "choice_gap": 0.0, "own_choice_gap": 0.0,
           "sim_gaps": [], "sim_ties": 0, "mismatches": []}
    G, means = expand(P, s0, root_noise, kn.rate, A)
    G_h = G.double().cpu().numpy()
    prog_W, prog_N = [], []
    for j, t in enumerate(trees):
        t.W[0], t.N[0], t.Qpi[0] = -G_h[j], 1.0, Qpi0_h[j]
        t.children[0] = np.arange(1, A + 1)
        if prog is not None:
            sums, counts = _program_sums(prog, j)
            W0, N0 = prog.W[j] - sums, prog.N[j] - counts  # each edge as created
            prog_W.append(W0.copy())
            prog_N.append(N0.copy())
            out["G_gap"] = max(out["G_gap"], _rel(-W0[0], G_h[j], G_floor))
    states[:, 0] = s0
    states[:, 1:A + 1] = means
    if prog is not None:
        out["state_gap"] = _rel(prog.s[:, 1:A + 1].cpu(), means.cpu(), s_floor)
        states = prog.s  # read only: the replay expands the program's own states
    limit = (prog.repeats_done.astype(int) if prog is not None else np.full(J, kn.repeats))
    done = np.array([confidence(t.N[0] / t.N[0].sum()) > kn.threshold for t in trees])
    if skip is not None:
        done |= skip
    repeats = np.zeros(J, np.int64)
    stop = np.full(J, -1)  # the iteration count at which phase B fired
    for r in range(int(limit.max(initial=0))):
        live = [j for j in range(J) if r < limit[j] and (prog is not None or not done[j])]
        if not live:
            break
        noise = noise_of(r)
        walks = {}
        for j in live:
            t, node, path = trees[j], 0, []
            for step in range(kn.max_depth):
                if t.children[node, 0] < 0:
                    break
                u = ucb(t.W[node], t.N[node], t.Qpi[node], kn.C, kn.use_prior)
                if prog is None:
                    a = int(np.argmax(u))
                else:
                    a = int(prog.paths[r, j, step])
                    if a < 0:  # the program stopped above a node with children
                        out["mismatches"].append((j, r, "walk ended early"))
                        break
                    v = ucb(prog_W[j][node], prog_N[j][node], t.Qpi[node], kn.C, kn.use_prior)
                    out["choice_gap"] = max(out["choice_gap"], float(v.max() - v[a]))
                    out["own_choice_gap"] = max(out["own_choice_gap"], float(u.max() - u[a]))
                path.append((node, a))
                node = t.children[node, a]
            if (prog is not None and len(path) < kn.max_depth
                    and prog.paths[r, j, len(path)] >= 0):
                out["mismatches"].append((j, r, "walk went past a leaf"))
            walks[j] = (path, node)
        idx = torch.as_tensor(live, device=s0.device)
        leaf = torch.as_tensor([walks[j][1] for j in live], device=s0.device)
        s_leaf = states[idx, leaf]
        n = select_rows(noise, idx, A)
        G, means = expand(P, s_leaf, n["expand"], kn.rate, A)
        G_sim, margin = simulate(P, s_leaf, n["rollout"], n["trajectory"], kn.rate, A)
        _, Qpi = nets.habit(P, s_leaf)
        G_h, G_sim_h, Qpi_h, margin_h = (x.double().cpu().numpy()
                                         for x in (G, G_sim, Qpi, margin))
        for k, j in enumerate(live):
            t, (path, node) = trees[j], walks[j]
            if t.children[node, 0] < 0:
                base = A + 1 + A * r
                t.W[node], t.N[node], t.Qpi[node] = -G_h[k], 1.0, Qpi_h[k]
                t.children[node] = np.arange(base, base + A)
                if prog is None:
                    states[j, base:base + A] = means[k]
                else:
                    out["G_gap"] = max(out["G_gap"], _rel(-prog_W[j][node], G_h[k], G_floor))
                    out["state_gap"] = max(out["state_gap"],
                                           _rel(prog.s[j, base:base + A].cpu(), means[k].cpu(),
                                                s_floor))
            x_own = -G_sim_h[k]
            if prog is not None and margin_h[k] >= TIE:
                out["sim_gaps"].append(_rel(prog.sim_G[r, j], G_sim_h[k], G_floor))
            elif prog is not None:
                out["sim_ties"] += 1
            for n, a in path:
                t.W[n, a] += x_own
                t.N[n, a] += 1.0
                if prog is not None:
                    prog_W[j][n, a] -= float(prog.sim_G[r, j])
                    prog_N[j][n, a] += 1.0
            repeats[j] += 1
            if stop[j] < 0 and confidence(t.N[0] / t.N[0].sum()) > kn.threshold:
                stop[j] = repeats[j]
                done[j] = True
    out["repeats"] = repeats
    out["root_N"] = np.stack([t.N[0] for t in trees])
    out["action"] = np.array([t.final_action(A, kn.max_depth) for t in trees])
    if prog is not None:
        for j in range(J):
            want = stop[j] if stop[j] >= 0 else kn.repeats
            if want != prog.repeats_done[j]:
                out["mismatches"].append((j, want, "stop iteration"))
            if not np.array_equal(out["root_N"][j], prog.root_N[j]):
                out["mismatches"].append((j, -1, "root visits"))
            if out["action"][j] != prog.action[j]:
                out["mismatches"].append((j, -1, "final action"))
    return out


def search(P, s0: torch.Tensor, Qpi0: torch.Tensor, root_noise: Dict, habit_gumbel,
           noise_of: Callable[[int], Noise], kn: Knobs) -> Dict:
    """The planner on J envs: ``repeats`` (J,) (0 where phase A acted),
    ``root_N`` (J, A), ``action`` (J,) and ``short_circuit`` (J,).
    ``noise_of(i)``: iteration i's noise (``yardstick/search.py``'s layout,
    row j env j)."""
    sc_h = np.zeros(s0.shape[0], bool)
    if kn.use_habit:
        sc, habit_action, _, _ = phase_a(Qpi0, habit_gumbel, kn.threshold)
        sc_h = sc.cpu().numpy()
    out = _run(P, s0, Qpi0, root_noise, noise_of, kn, None, 1.0, 1.0, skip=sc_h)
    if kn.use_habit:
        out["action"] = np.where(sc_h, habit_action.cpu().numpy(), out["action"])
    out["short_circuit"] = sc_h
    return out


def replay(P, prog: Program, s0_ref: torch.Tensor, Qpi0: torch.Tensor, root_noise: Dict,
           noise_of: Callable[[int], Noise], kn: Knobs, G_floor: float,
           s_floor: float) -> Dict:
    """Walk the program's search of J envs that it did not short-circuit
    (``s0_ref``: the reference's own encoder means of their frames, held
    against the program's root states). Returns the readings of the module
    docstring: ``expand_gap``, the largest of ``G_gap`` (the expand G,
    relative, at least ``G_floor`` below), ``state_gap`` (the children's
    states) and ``root_gap`` (the root's state against the reference's own
    encoding), both relative to at least ``s_floor``; ``choice_gap``,
    ``own_choice_gap``, ``mismatches`` (a list of (env, iteration, what)),
    ``sim_gaps`` (each replayed iteration's relative gap of the simulation's
    G, at least ``G_floor`` below, but for rollouts with a near tie:
    ``TIE``) and ``sim_ties`` (the rollouts left out)."""
    out = _run(P, prog.s[:, 0], Qpi0, root_noise, noise_of, kn, prog, G_floor, s_floor)
    out["root_gap"] = _rel(prog.s[:, 0].cpu(), s0_ref.cpu(), s_floor)
    out["expand_gap"] = max(out["G_gap"], out["state_gap"], out["root_gap"])
    return out
