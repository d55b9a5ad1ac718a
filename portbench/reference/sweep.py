"""A sweep chunk replayed by the reference, env by env, from the program's
chunk-start state, with the same noise.

Each macro step the controller scores the four actions (``ai``: -G / T of
the one-step mean G; ``habit``: log Q(pi | encoder mean)), adds the step's
Gumbel noise and takes the best; the env then runs the action ``jumps``
times. The program computes the scores in another precision (cuDNN's TF32
convolutions), so where two actions score within its rounding it may take
the other one, and from there its env follows another path. So the
reference reproduces the program's end state allowing such flips, and
reads what they cost: an env's reading is the least, over sets of at most
``max_flips`` flips that reproduce the program's end state exactly, of the
largest margin by which a flipped action lies below the reference's best
(0 when no flip is needed; infinite when no such set is found). The search
tries, after the last flip of a path, the ``branch`` cheapest flips, and
follows at most ``per_env`` paths of an env at a time, the cheapest. A chunk's
reading is the largest over its envs: the widest gap by which a decision
of the program lies below the reference's."""

from __future__ import annotations

import math
from typing import Callable, Dict, List

import torch

from portbench.reference import efe, env, nets

Noise = Dict[str, torch.Tensor]  # one macro step's noise of the sampled envs


def scores(P, table, lat, score, last_r, noise: Noise, rows: torch.Tensor, method: str,
           temperature: float, rate: float, pi_dim: int) -> torch.Tensor:
    """(J, A) Gumbel-perturbed action scores of the jobs in state (lat,
    score, last_r); ``rows`` are their envs' rows of ``noise``."""
    o = env.render(table, lat, last_r)
    qs_mean, _ = nets.encode(P, o)
    if method == "habit":
        _, q = nets.habit(P, qs_mean)
        logits = torch.log(q + 1e-20)
    elif method == "ai":
        A, J = pi_dim, rows.shape[0]
        g_rows = (rows[:, None] * A + torch.arange(A, device=rows.device)).reshape(-1)
        take = lambda ms: [m[g_rows] for m in ms]
        s0 = qs_mean.repeat_interleave(A, dim=0)
        pi = torch.eye(A, device=lat.device).repeat(J, 1)
        G = efe.G_mean(P, s0, pi, take(noise["masks1"]), take(noise["masks2"]),
                       noise["eps_fixed"][g_rows], rate)[0].reshape(J, A)
        logits = -G / temperature
    else:
        raise ValueError(f"no reference for method {method!r}")
    return logits + noise["gumbel"][rows]


def flip_gap(P, table, start, end, noise_of: Callable[[int], Noise], n_steps: int,
             method: str, temperature: float, rate: float, pi_dim: int,
             max_flips: int = 3, branch: int = 8, per_env: int = 64) -> List[float]:
    """Per sampled env, the reading described in the module docstring.
    ``start`` / ``end``: (latents, score, last_r) of the S sampled envs at
    the chunk's start and the program's state at its end; ``noise_of(t)``:
    step t's noise of those envs (row j is env j)."""
    S = start[0].shape[0]
    dev = start[0].device
    noise = [noise_of(t) for t in range(n_steps)]
    best = [math.inf] * S
    # A job: (env, forced {step: action}, its cost, first step it computes,
    # the state it starts from there).
    jobs = [(j, {}, 0.0, 0, tuple(x[j] for x in start)) for j in range(S)]
    for _ in range(max_flips + 1):
        if not jobs:
            break
        J = len(jobs)
        envs = torch.tensor([jb[0] for jb in jobs], device=dev)
        first = torch.tensor([jb[3] for jb in jobs], device=dev)
        lat = torch.stack([jb[4][0] for jb in jobs])
        score = torch.stack([jb[4][1] for jb in jobs])
        last_r = torch.stack([jb[4][2] for jb in jobs])
        forced = torch.full((J, n_steps), -1, dtype=torch.long, device=dev)
        for k, jb in enumerate(jobs):
            for t, a in jb[1].items():
                forced[k, t] = a
        costs = torch.full((J, n_steps, pi_dim), math.inf, device=dev)
        states = []  # per step: (lat, score, last_r) of every job before acting
        for t in range(n_steps):
            states.append((lat, score, last_r))
            live = torch.nonzero(first <= t).flatten()
            if live.numel() == 0:
                continue
            s = scores(P, table, lat[live], score[live], last_r[live], noise[t], envs[live],
                       method, temperature, rate, pi_dim)
            top = s.argmax(-1)
            f = forced[live, t]
            act = torch.where(f >= 0, f, top)
            gap = s.gather(1, top[:, None]) - s
            gap = torch.where(torch.arange(pi_dim, device=dev) == top[:, None], math.inf, gap)
            costs[live, t] = torch.where((f >= 0)[:, None], math.inf, gap)
            respawns = noise[t]["respawns"][:, envs[live]]
            nl, ns, nr = env.step_repeated(lat[live], score[live], last_r[live], act, respawns)
            lat, score, last_r = lat.clone(), score.clone(), last_r.clone()
            lat[live], score[live], last_r[live] = nl, ns, nr
        match = ((lat == end[0][envs]).all(-1) & (score == end[1][envs])
                 & (last_r == end[2][envs])).tolist()
        children = []
        for k, jb in enumerate(jobs):
            j, fmap, cost = jb[0], jb[1], jb[2]
            if match[k]:
                best[j] = min(best[j], cost)
                continue
            if len(fmap) >= max_flips:
                continue
            after = max(fmap) + 1 if fmap else 0
            c = costs[k, after:].reshape(-1)
            n = min(branch, int(torch.isfinite(c).sum()))
            if n == 0:
                continue
            vals, idx = torch.topk(c, n, largest=False)
            for v, i in zip(vals.tolist(), idx.tolist()):
                t, a = after + i // pi_dim, i % pi_dim
                if max(cost, v) >= best[j]:
                    continue
                st = tuple(x[k] for x in states[t])
                children.append((j, {**fmap, t: a}, max(cost, v), t, st))
        children = sorted((jb for jb in children if jb[2] < best[jb[0]]), key=lambda jb: jb[2])
        kept = {}
        jobs = [jb for jb in children if kept.setdefault(jb[0], []).append(jb) is None
                and len(kept[jb[0]]) <= per_env]
    return best

