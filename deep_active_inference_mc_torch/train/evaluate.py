"""Per-epoch quantitative evaluation, on the device.

Port of ``deep_active_inference_mc_tpu/train/evaluate.py``: a fresh
random-policy batch scored by all three losses with fixed omega = a/2 + d,
ground-truth factors for the disentanglement metrics, the reward-transition
imagination probe and the scoring-edge discrimination probe. Everything
runs under ``torch.no_grad()``; one pass renders 5 times (kernel K1 on a
card: 4 frames batches of ``test_size`` and the probe's 96).

``jnp.std`` is the population std and ``jnp.median`` of an even count
averages the two middle values; ``correction=0`` and ``torch.quantile``
keep both conventions. The forwards compute in the agent's dtype (bf16
under ``--bf16``); every head, and so every loss and metric, is float32.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional

import torch

from deep_active_inference_mc_torch.config import Config
from deep_active_inference_mc_torch.envs import data as data_lib
from deep_active_inference_mc_torch.envs import dsprites as env_lib
from deep_active_inference_mc_torch.infer import efe
from deep_active_inference_mc_torch.infer.agent import ActiveInferenceAgent
from deep_active_inference_mc_torch.infer.precision import OmegaParams, PrecisionState
from deep_active_inference_mc_torch.train import losses

N_PLOT = 7  # frames per reconstruction strip


@torch.no_grad()
def eval_losses(agent: ActiveInferenceAgent, cfg: Config, precision: PrecisionState,
                o0: torch.Tensor, o1: torch.Tensor, pi0: torch.Tensor,
                generator: Optional[torch.Generator] = None,
                draws: Optional[losses.StagedDraws] = None) -> Dict[str, torch.Tensor]:
    """All three losses on an eval batch with fixed omega = a/2 + d;
    log_Ppi is the log of the one-hot action."""
    vae_do = bool(cfg.vae_train_dropout)
    if draws is None:
        draws = losses.draw_staged(agent, o0.shape[0], generator, o0.device, vae_do)
    omega_params = OmegaParams(cfg.var_a, cfg.var_b, cfg.var_c, cfg.var_d)
    omega = torch.tensor(omega_params.eval_omega, dtype=torch.float32, device=o0.device)
    log_Ppi = torch.log(pi0 + 1e-15)

    s0, _, _ = agent.encode_with_sample(o0, eps=draws.eps_s0, masks=draws.enc0_masks)
    F_top, (kl_div_pi, kl_div_pi_anal, _) = losses.compute_loss_top(agent, s0, log_Ppi)
    qs1_mean, qs1_logvar = agent.encode(o1, draws.enc1_masks)
    F_mid, (_, _, ps1_mean, ps1_logvar) = losses.compute_loss_mid(
        agent, s0, pi0, qs1_mean, qs1_logvar, omega, draws=draws.mid)
    F_down, (down_terms, po1, qs1) = losses.compute_loss_down(
        agent, o1, ps1_mean, ps1_logvar, omega, precision, vae_dropout=vae_do,
        draws=draws.down)
    # Dropout-free reconstruction NLL, reported beside the (possibly
    # dropout-inflated) loss term for a fair read of the VAE's quality.
    qs1_mean_c, _ = agent.encode(o1)
    po1_clean = agent.decode(qs1_mean_c)
    nll_clean = -torch.sum(
        o1 * torch.log(1e-5 + po1_clean) + (1.0 - o1) * torch.log(1e-5 + 1.0 - po1_clean),
        dim=(-3, -2, -1))
    return {
        "mse_o_clean": nll_clean.mean(),
        "F": (F_down + F_mid + F_top).mean(),
        "F_top": F_top.mean(),
        "F_mid": F_mid.mean(),
        "F_down": F_down.mean(),
        "mse_o": down_terms[0].mean(),  # pixel NLL (nats)
        "kl_div_s": down_terms[1].mean(),
        "kl_div_s_anal": down_terms[2].mean(0),
        "kl_div_s_naive": down_terms[3].mean(),
        "kl_div_s_naive_anal": down_terms[4].mean(0),
        "kl_div_pi": kl_div_pi.mean(),
        "kl_div_pi_min": kl_div_pi.min(),
        "kl_div_pi_max": kl_div_pi.max(),
        "kl_div_pi_med": torch.quantile(kl_div_pi, 0.5),
        "kl_div_pi_std": kl_div_pi.std(correction=0),
        "kl_div_pi_anal": kl_div_pi_anal.mean(0),
        "s0": s0,
        "po1": po1,
        "qs1": qs1,
    }


@dataclasses.dataclass
class ProbeDraws:
    """Noise of the reward-transition probe: the randomized envs and the
    respawns of its batch, and the imagination's encoder draw, transition
    keep-masks and transition draw."""

    env: env_lib.EnvDraws
    respawns: torch.Tensor
    eps_enc: torch.Tensor
    masks: losses.Masks
    eps_trans: torch.Tensor


@dataclasses.dataclass
class EvalDraws:
    """Noise of one eval pass, for injection."""

    batch: data_lib.RandomDraws
    staged: losses.StagedDraws
    probe: ProbeDraws
    edge: efe.RolloutDraws


@torch.no_grad()
def reward_transition_probe(agent: ActiveInferenceAgent, cfg: Config, lut: torch.Tensor,
                            size: int, generator: Optional[torch.Generator] = None,
                            draws: Optional[ProbeDraws] = None):
    """Does imagination predict the reward consequence of a scoring move?
    Returns (mse_r, deep_mse, o0, o1, po1); deep_mse is the full-frame
    imagination MSE."""
    d = draws
    o0, o1, pi0 = data_lib.make_batch_random_reward_transitions(
        cfg, lut, size, generator, None if d is None else d.env,
        None if d is None else d.respawns)
    if d is None:
        po1 = agent.imagine_future_from_o(o0, pi0, generator)
    else:
        po1 = agent.imagine_future_from_o(o0, pi0, eps_enc=d.eps_enc, masks=d.masks,
                                          eps_trans=d.eps_trans)
    return data_lib.compare_reward(o1, po1), torch.mean(torch.square(o1 - po1)), o0, o1, po1


def edge_probe_latents(device) -> torch.Tensor:
    """Latents of every (shape, posX) combination at posY=31, one 'up' from
    scoring: (96, 6), shape-major."""
    SH, PX = torch.meshgrid(torch.arange(3, device=device),
                            torch.arange(32, device=device), indexing="ij")
    return torch.stack([
        torch.zeros_like(SH),  # color
        SH,  # shape
        torch.full_like(SH, 3),  # scale (mid)
        torch.zeros_like(SH),  # orientation
        PX,  # posX
        torch.full_like(SH, 31),  # posY: the scoring edge
    ], dim=-1).reshape(-1, 6)


def edge_probe_frames(cfg: Config, lut: torch.Tensor) -> torch.Tensor:
    """Frames of ``edge_probe_latents`` with no reward shown: (96, C, H, W)."""
    lat = edge_probe_latents(lut.device)
    zeros = torch.zeros((lat.shape[0],), dtype=torch.float32, device=lut.device)
    env = env_lib.EnvState(latents=lat, score=zeros, last_r=zeros.clone())
    return env_lib.render_obs(lut, env, cfg.resolution, cfg.colour_channels)


@torch.no_grad()
def edge_discrimination_probe(agent: ActiveInferenceAgent, cfg: Config, lut: torch.Tensor,
                              generator: Optional[torch.Generator] = None,
                              draws: Optional[efe.RolloutDraws] = None
                              ) -> Dict[str, torch.Tensor]:
    """Shape->side discrimination at the scoring edge: how much probability
    the habit net, and the softmax(-G/T) data policy behind the training
    targets, put on 'up' where it is the correct side (squares left, others
    right) against the wrong side. The G gaps are in nats (temperature-free);
    true discrimination needs both per-class gaps positive, since a
    side-agnostic push can fake a positive combined gap. ``draws`` injects
    the G estimate's noise (one mean-estimator step over 96 x 4 rows)."""
    o = edge_probe_frames(cfg, lut)

    def split_correct_wrong(p_up):
        p = p_up.reshape(3, 32)
        correct = (p[0, :16].mean() + p[1:, 16:].mean()) / 2.0
        wrong = (p[0, 16:].mean() + p[1:, :16].mean()) / 2.0
        return correct, wrong

    h_corr, h_wrong = split_correct_wrong(agent.habitual_net(o)[:, 0])
    G, _, _ = efe.calculate_G_4_repeated(agent, o, generator, steps=1, calc_mean=True,
                                         samples=1, draws=draws)
    g_corr, g_wrong = split_correct_wrong(torch.softmax(-G / cfg.temperature, dim=-1)[:, 0])
    gup_corr, gup_wrong = split_correct_wrong(G[:, 0])
    Gup = G[:, 0].reshape(3, 32)
    return {
        "edge_habit_correct": h_corr,
        "edge_habit_wrong": h_wrong,
        "edge_g_correct": g_corr,
        "edge_g_wrong": g_wrong,
        "edge_g_gap_nats": gup_wrong - gup_corr,
        "edge_g_sq_gap_nats": Gup[0, 16:].mean() - Gup[0, :16].mean(),  # >0: sq prefers left
        "edge_g_oth_gap_nats": Gup[1:, :16].mean() - Gup[1:, 16:].mean(),  # >0: oth prefers right
    }


def make_eval(agent: ActiveInferenceAgent, cfg: Config, lut: torch.Tensor
              ) -> Callable[[PrecisionState, torch.Generator], Dict[str, torch.Tensor]]:
    """``evaluate(precision, generator, draws=None)``: one eval pass
    (``draws`` injects its noise) returning the full
    epoch stats payload, tensors on the device (the caller transfers the
    series it keeps), and the first ``N_PLOT`` frames of the eval batch
    (``o0``, ``o1``, ``po1``) and of the reward probe (``*_probe``) for the
    figures."""

    @torch.no_grad()
    def evaluate(precision: PrecisionState, generator: Optional[torch.Generator] = None,
                 draws: Optional[EvalDraws] = None):
        d = draws
        if d is None:
            env = env_lib.reset(generator, cfg.test_size, lut.device)
        else:  # the batch's randomize replaces every field
            env = env_lib.EnvState(*d.batch.env)
        _, o0, o1, pi0, _, S0_real, _ = data_lib.make_batch_random(
            cfg, env, lut, generator, None if d is None else d.batch)
        metrics = eval_losses(agent, cfg, precision, o0, o1, pi0, generator,
                              None if d is None else d.staged)
        mse_r, deep_mse, o0p, o1p, po1p = reward_transition_probe(
            agent, cfg, lut, cfg.test_size, generator, None if d is None else d.probe)
        metrics["mse_r"] = mse_r
        metrics["deep_mse_o"] = deep_mse
        metrics.update(edge_discrimination_probe(agent, cfg, lut, generator,
                                                 None if d is None else d.edge))
        metrics["S0_real"] = S0_real
        # Frames for the 7-sample reconstruction strips only, sliced on the
        # device so the host copy stays small: the eval batch's o0, o1 and
        # decoded o1, and the reward-imagination probe's real pre/post
        # scoring frames beside the imagined one.
        metrics["o0"], metrics["o1"] = o0[:N_PLOT], o1[:N_PLOT]
        metrics["po1"] = metrics["po1"][:N_PLOT]
        metrics["o0_probe"], metrics["o1_probe"] = o0p[:N_PLOT], o1p[:N_PLOT]
        metrics["po1_probe"] = po1p[:N_PLOT]
        return metrics

    return evaluate
