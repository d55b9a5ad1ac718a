"""The first rounds of phase-3 training, plain, and their comparison with
the program's.

A round (the JAX package's ``train/loop.py``): fresh envs, a fraction of
them pinned near the scoring edge; the frame's encoder mean; G of every
action by the one-step mean estimator with the same noise in every action
column; the prior softmax(-G / T) and its log as the reference computes it
(the unscaled shifted score less the log-sum of the scaled ones); the
executed action drawn from the prior mixed with a uniform floor and with
the habit; ``repeats`` steps; then three losses, each on its own layer,
from the pre-update networks: F_top = KL[Q(pi | s0) || P(pi)] (s0 a sample
of the encoder), omega = a (1 - sigmoid((F_top - b) / c)) + d, F_mid the
omega-weighted KL of the re-encoded posterior against the dropout
transition, F_down the displaced Bernoulli NLL of the decode of a sample
of the posterior plus the gamma-gated KL mixture; Adam (0.9, 0.999, 1e-8)
per layer, the habit's withheld under ``freeze_top``."""

from __future__ import annotations

import statistics
from typing import Dict, List

import numpy as np
import torch

from portbench.reference import efe, env, nets

LAYERS = ("top", "mid", "down")


def flax_key(name: str) -> str:
    """The Flax leaf of a port parameter name (``mid.fc.0.weight`` ->
    ``mid/Dense_0/kernel``)."""
    *path, i, kind = name.split(".")
    layer = {"fc": "Dense", "conv": "Conv", "deconv": "ConvTranspose"}[path[-1]]
    return "/".join(path[:-1] + [f"{layer}_{i}", "kernel" if kind == "weight" else "bias"])


def _kl_prec(mu1, logvar1, mu2, logvar2, omega):
    return (0.5 * (logvar2 - torch.log(omega) - logvar1)
            + (torch.exp(logvar1) + torch.square(mu1 - mu2)) / (2.0 * torch.exp(logvar2) / omega)
            - 0.5)


def _batch(P, table, f, n, rate):
    """The generator's (o0, o1, pi0, log_Ppi)."""
    A = f["pi_dim"]
    lat = n["latents"].clone()
    lat[:, 5] = torch.where(n["edge_u"] < f["edge_frac"], n["edge_posy"], lat[:, 5])
    o0 = env.render(table, lat, n["last_r"])
    s0, _ = nets.encode(P, o0)
    eye = torch.eye(A, device=o0.device)
    g = n["G"]
    G = torch.stack([efe.G_mean(P, s0, eye[a].expand(s0.shape[0], A), g["masks1"], g["masks2"],
                                g["eps_fixed"], rate)[0] for a in range(A)], dim=1)
    x = -G - (-G).max(dim=1, keepdim=True).values
    e = torch.exp(x / f["temperature"])
    ppi = e / e.sum(dim=1, keepdim=True)
    log_ppi = x - torch.log(e.sum(dim=1, keepdim=True) + 1e-20)
    p_act = (1.0 - f["explore_eps"]) * ppi + f["explore_eps"] / A
    _, q = nets.habit(P, s0)
    p_act = (1.0 - f["gen_habit_mix"]) * p_act + f["gen_habit_mix"] * q
    act = torch.argmax(torch.log(p_act + 1e-20) + n["gumbel"], dim=-1)
    lat1, _, r1 = env.step_repeated(lat, n["score"], n["last_r"], act, n["respawns"])
    return o0, env.render(table, lat1, r1), eye[act], log_ppi


def _losses(P, o0, o1, pi0, log_ppi, n, prec, f, rate):
    """(F_top, F_mid, F_down) per row, each differentiable in its layer only."""
    with torch.no_grad():
        m0, lv0 = nets.encode(P, o0)
        qs0 = n["eps_s0"] * torch.exp(0.5 * lv0) + m0
        q1m, q1lv = nets.encode(P, o1)
    _, q = nets.habit(P, qs0)
    F_top = (q * (torch.log(q + 1e-20) - log_ppi)).sum(-1)
    omega = (f["var_a"] * (1.0 - torch.sigmoid((F_top.detach() - f["var_b"]) / f["var_c"]))
             + f["var_d"]).reshape(-1, 1)
    pm, plv = nets.transition(P, pi0, qs0, n["mid_masks"], rate)
    F_mid = _kl_prec(q1m, q1lv, pm, plv, omega).sum(-1)
    m1, lv1 = nets.encode(P, o1)
    po1 = nets.decode(P, n["down_eps"] * torch.exp(0.5 * lv1) + m1)
    ll = (o1 * torch.log(1e-5 + po1) + (1.0 - o1) * torch.log(1e-5 + 1.0 - po1)).sum((-3, -2, -1))
    zero = torch.zeros((), device=o1.device)
    naive = _kl_prec(m1, lv1, zero, zero, omega).sum(-1)
    kl_s = _kl_prec(m1, lv1, pm.detach(), plv.detach(), omega).sum(-1)
    gamma = prec["gamma"]
    mix = naive if gamma <= 0.05 else kl_s if gamma >= 0.95 else gamma * kl_s + (1 - gamma) * naive
    F_down = -prec["beta_o"] * ll + prec["beta_s"] * mix
    return F_top, F_mid, F_down


def _rel(a: float, b: float, floor: float) -> float:
    return abs(a - b) / max(abs(b), floor)


def follow(weights_file, table, flags: Dict, noise: List[Dict], prog_losses: List[Dict],
           prog_grads: Dict[str, float], prog_changes: Dict[str, float], rate: float,
           device):
    """Run ``len(noise)`` rounds from the export's weights and compare. A
    leaf's gap is the gap between the program's and the reference's norms
    of its first gradient (or of its change over the rounds) over the
    larger of the reference's norm and the median leaf's. ``loss_gap``: the
    first round's largest relative loss gap (later rounds drift with Adam's
    first steps, which move every weight by about its rate whatever the
    sign of a gradient at rounding level); ``grad_gap``: the median leaf's
    gap (one row of the batch that takes the other of two tied actions moves
    a leaf's gradient by about 1 / sqrt(batch)); ``change_gap``: the worst
    leaf's (leaves whose reference gradient is under a thousandth of the
    median leaf's left out). Also a line with every round's loss gap and
    the worst leaves."""
    f = dict(flags, pi_dim=4)
    P = nets.Params(weights_file, device)
    with np.load(weights_file) as z:
        prec = {k: float(z[f"precision/{k}"]) for k in ("gamma", "beta_s", "beta_o")}
    theta0 = {k: v.clone() for k, v in P.t.items()}
    lr = {"top": f["l_rate_top"], "mid": f["l_rate_mid"], "down": f["l_rate_down"]}
    moments = {k: (torch.zeros_like(v), torch.zeros_like(v)) for k, v in P.t.items()}
    first, losses = {}, []
    with nets.exact_float32():
        for step, n in enumerate(noise, start=1):
            with torch.no_grad():
                o0, o1, pi0, log_ppi = _batch(P, table, f, n, rate)
            for v in P.t.values():
                v.requires_grad_(True)
            Fs = _losses(P, o0, o1, pi0, log_ppi, n, prec, f, rate)
            losses.append({k: float(F.detach().mean()) for k, F in zip(("F_top", "F_mid", "F_down"), Fs)})
            updates = {}
            for layer, F in zip(LAYERS, Fs):
                keys = [k for k in P.t if k.startswith(layer + "/")]
                grads = torch.autograd.grad(F.mean(), [P.t[k] for k in keys])
                if layer == "top" and f["freeze_top"]:
                    continue
                for k, g in zip(keys, grads):
                    if step == 1:
                        first[k] = float(torch.linalg.vector_norm(g))
                    updates[k] = (g, lr[layer])
            with torch.no_grad():
                for k, v in P.t.items():
                    v.requires_grad_(False)
                for k, (g, rate_k) in updates.items():
                    m, v2 = moments[k]
                    m.mul_(0.9).add_(g, alpha=0.1)
                    v2.mul_(0.999).addcmul_(g, g, value=0.001)
                    denom = (v2.sqrt() / (1 - 0.999 ** step) ** 0.5).add_(1e-8)
                    P.t[k].addcdiv_(m, denom, value=-rate_k / (1 - 0.9 ** step))
    change = {k: float(torch.linalg.vector_norm(P.t[k] - theta0[k])) for k in P.t}
    loss_gaps = [max(_rel(p[k], r[k], 1e-6) for k in r) for p, r in zip(prog_losses, losses)]
    med_g = statistics.median(first.values())
    grad_gaps = {name: _rel(prog_grads[name], first[flax_key(name)], med_g)
                 for name in prog_grads if flax_key(name) in first}
    moved = {name: flax_key(name) for name in prog_changes
             if first.get(flax_key(name), 0.0) >= 1e-3 * med_g}
    med_c = statistics.median(change[k] for k in moved.values())
    change_gaps = {name: _rel(prog_changes[name], change[k], med_c) for name, k in moved.items()}
    worst = lambda gaps: ", ".join(f"{k} {v:.4g}" for k, v in sorted(
        gaps.items(), key=lambda kv: -kv[1])[:3])
    detail = (f"reference: loss gap by round {', '.join(f'{g:.4g}' for g in loss_gaps)}"
              f" | worst grads {worst(grad_gaps)} | worst changes {worst(change_gaps)}"
              f" | median grad {med_g:.4g}, change {med_c:.4g}")
    return {"loss_gap": loss_gaps[0], "grad_gap": statistics.median(grad_gaps.values()),
            "change_gap": max(change_gaps.values())}, detail
