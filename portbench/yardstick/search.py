"""The planner's inputs and work, as the benchmark counts them: the noise of
one MCTS macro step, drawn from the step's own generator, and the FLOPs of
the searches' needed work.

The noise follows the port's row layouts (``plan/mcts.py``,
``infer/efe.py``), drawn from the distributions of ``traffic.py`` in an
order that is the benchmark's own: at the step's start the respawn latents
of each jump, the root expand's G noise over (env, action) rows (action
fastest) and the phase-A Gumbel noise; then, as the search asks for them,
each iteration's: the leaf expand's G noise over (env, action) rows, the
habit rollout's Gumbel noise, keep-masks and normal draws (depth, env), and
the trajectory G's keep-masks and normal draws over (depth, env) rows,
depth-major. The same generator state gives the same tensors, so the
reference draws a step again after the window."""

from __future__ import annotations

from typing import Dict

import torch

from portbench.yardstick import flops, traffic


def step_noise(g: torch.Generator, envs: int, c: Dict, jumps: int, device) -> dict:
    """What a macro step draws before its search: ``respawns`` (jumps, envs,
    6), ``root`` (``traffic.g_noise`` over envs x pi_dim rows) and
    ``habit_gumbel`` (envs, pi_dim)."""
    A = c["pi_dim"]
    respawns = traffic.latents(g, (jumps, envs), device)
    root = traffic.g_noise(g, envs * A, c["s_dim"], c["transition_hidden"], c["dropout"],
                           device)
    return {"respawns": respawns, "root": root,
            "habit_gumbel": traffic.gumbel(g, (envs, A), device)}


def iteration_noise(g: torch.Generator, envs: int, c: Dict, depth: int, device) -> dict:
    """One search iteration's noise over ``envs`` leaves: ``expand``
    (``traffic.g_noise`` over envs x pi_dim rows), ``rollout`` (``gumbel``
    (depth, envs, pi_dim), ``masks``: depth lists of the three keep-masks
    (envs, hidden), ``eps`` (depth, envs, s_dim)) and ``trajectory``
    (``masks``, ``eps``, ``eps_fixed`` over depth x envs rows)."""
    A, s, h, rate = c["pi_dim"], c["s_dim"], c["transition_hidden"], c["dropout"]
    expand = traffic.g_noise(g, envs * A, s, h, rate, device)
    rollout = {"gumbel": traffic.gumbel(g, (depth, envs, A), device),
               "masks": [traffic.keep_masks(g, envs, (h,) * 3, rate, device)
                         for _ in range(depth)],
               "eps": torch.randn((depth, envs, s), generator=g, device=device)}
    rows = depth * envs
    trajectory = {"masks": traffic.keep_masks(g, rows, (h,) * 3, rate, device),
                  "eps": torch.randn((rows, s), generator=g, device=device),
                  "eps_fixed": torch.randn((rows, s), generator=g, device=device)}
    return {"expand": expand, "rollout": rollout, "trajectory": trajectory}


def plan_flops(c: Dict, envs: int, plans: int, short_circuits: int, env_iterations: int,
               depth: int) -> int:
    """FLOPs of the work that ``plans`` searches over ``envs`` envs each
    need: every env's root encode and habit net; the root's expand over
    (env, action) rows for each env that phase A left to the search (all
    but ``short_circuits``); and, for each of the ``env_iterations`` that
    envs searched before they decided (their ``repeats_done``, summed), the
    leaf expand over the env's action rows, each two transition passes,
    three decodes and a re-encode (as ``flops.macro_step`` counts ``ai``),
    the habit rollout, ``depth`` habit and transition passes, and the
    trajectory's G over ``depth`` rows, each a transition pass, three decodes
    and a re-encode. The rows a batch computes for envs that have decided
    are masked work, and not counted."""
    f, A = flops.per_row(c), c["pi_dim"]
    expand = A * (2 * f["transition"] + 3 * f["decoder"] + f["encoder"])
    rollout = depth * (f["habit"] + f["transition"])
    trajectory = depth * (f["transition"] + 3 * f["decoder"] + f["encoder"])
    roots = plans * envs
    return (roots * (f["encoder"] + f["habit"]) + (roots - short_circuits) * expand
            + env_iterations * (expand + rollout + trajectory))
