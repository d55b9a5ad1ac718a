"""Inputs the benchmark makes from ``--seed`` and hands to both the program
and the reference: initial environments and the noise of every macro step and round.

Frozen copies of the distributions the program draws from
(``envs/dsprites.py`` ``sample_latents`` / ``randomize``, the transition's
dropout keep-masks, ``utils/random.py`` ``gumbel``), drawn in an order that is
the benchmark's own. The same generator state gives the same tensors, so the
reference regenerates a chunk's noise after the window instead of holding it.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import torch

# dSprites latent grid sizes: colour, shape, scale, orientation, posX, posY.
LATENT_SIZES = (1, 3, 6, 40, 32, 32)


def latents(g: torch.Generator, shape, device) -> torch.Tensor:
    """Uniform latents over the grid: ``shape + (6,)`` int64."""
    shape = (shape,) if isinstance(shape, int) else tuple(shape)
    cols = [torch.randint(0, n, shape, generator=g, device=device) for n in LATENT_SIZES]
    return torch.stack(cols, dim=-1)


def episode_start(g: torch.Generator, batch: int, device
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(latents, score, last_r) of fresh envs: uniform latents, a zero score
    and a reward strip ~ U(-1, 1), as the sweep CLI starts its envs."""
    lat = latents(g, batch, device)
    last_r = torch.rand((batch,), generator=g, device=device) * 2.0 - 1.0
    return lat, torch.zeros((batch,), device=device), last_r


def gumbel(g: torch.Generator, shape, device) -> torch.Tensor:
    u = torch.rand(tuple(shape), generator=g, device=device)
    u = u.clamp_(min=torch.finfo(torch.float32).tiny)
    return -torch.log(-torch.log(u))


def keep_masks(g: torch.Generator, rows: int, widths: Sequence[int], rate: float,
               device) -> List[torch.Tensor]:
    return [torch.rand((rows, w), generator=g, device=device) < 1.0 - rate for w in widths]


def macro_noise(g: torch.Generator, method: str, batch: int, pi_dim: int, s_dim: int,
                hidden: int, dropout: float, jumps: int, device) -> dict:
    """One macro step's noise over ``batch`` envs. ``ai`` (one-step mean G,
    rows (env, action), action fastest): the two passes' transition
    keep-masks and the fixed-theta normal draw; every method: the action's
    Gumbel noise (batch, pi_dim) and each jump's respawn latents
    (jumps, batch, 6)."""
    out = {}
    if method == "ai":
        out.update(g_noise(g, batch * pi_dim, s_dim, hidden, dropout, device))
    out["gumbel"] = gumbel(g, (batch, pi_dim), device)
    out["respawns"] = latents(g, (jumps, batch), device)
    return out


def g_noise(g: torch.Generator, rows: int, s_dim: int, hidden: int, dropout: float,
            device) -> dict:
    """One mean-G evaluation's noise over ``rows`` (state, action) rows."""
    return {"masks1": keep_masks(g, rows, (hidden,) * 3, dropout, device),
            "masks2": keep_masks(g, rows, (hidden,) * 3, dropout, device),
            "eps_fixed": torch.randn((rows, s_dim), generator=g, device=device)}


def round_noise(g: torch.Generator, batch: int, pi_dim: int, s_dim: int, hidden: int,
                dropout: float, repeats: int, device) -> dict:
    """One training round's noise over ``batch`` envs (the generator with
    common random numbers over the actions, the mean estimator, the edge
    curriculum; then the three losses): fresh envs (latents, score ~
    U(-10, 10), reward strip ~ U(-1, 1)); the edge draws (uniform, posY in
    28..31); the G estimate's noise, one row per env; the action's Gumbel
    noise; each repeat's respawns; the s0 sample's normal draw; F_mid's
    keep-masks and normal draw; F_down's normal draw."""
    out = {"latents": latents(g, batch, device),
           "score": torch.rand((batch,), generator=g, device=device) * 20.0 - 10.0,
           "last_r": torch.rand((batch,), generator=g, device=device) * 2.0 - 1.0,
           "edge_u": torch.rand((batch,), generator=g, device=device),
           "edge_posy": torch.randint(28, 32, (batch,), generator=g, device=device),
           "G": g_noise(g, batch, s_dim, hidden, dropout, device),
           "gumbel": gumbel(g, (batch, pi_dim), device),
           "respawns": latents(g, (repeats, batch), device),
           "eps_s0": torch.randn((batch, s_dim), generator=g, device=device),
           "mid_masks": keep_masks(g, batch, (hidden,) * 3, dropout, device),
           "mid_eps": torch.randn((batch, s_dim), generator=g, device=device),
           "down_eps": torch.randn((batch, s_dim), generator=g, device=device)}
    return out
