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

The JAX pass is one jitted function; here, on a card, it is one captured
CUDA graph (``utils/graphs.py``'s ``Graphs.call``), its noise drawn
eagerly (``draw_eval``, the order in which the pass draws as it goes) and
copied into the graph's buffers; its outputs are copied out. On the CPU,
or with ``graphed=False``, the same pass runs op by op.
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
from deep_active_inference_mc_torch.utils import graphs as graphs_lib

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
    omega = torch.full((), omega_params.eval_omega, dtype=torch.float32, device=o0.device)
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


EDGE_POLICY_POSX = (4, 6, 8, 23, 25, 27)  # deep in the left half, then the right


@torch.no_grad()
def habit_edge_policy(agent: ActiveInferenceAgent, lut: torch.Tensor):
    """The habit net's P(up) at the scoring edge (posY=31) per class
    (square, ellipse, heart) of a 64x64 grey agent, averaged over the 6
    scales and three posX deep in each half: ``(left, right)``, each a (3,)
    float32 tensor on the CPU. A trained agent sorts squares left and the
    others right, so a square's left P(up) exceeds its right one and the
    others' the other way round (the contrast contracts of the committed
    checkpoints)."""
    device = lut.device
    SH, SC, PX = torch.meshgrid(torch.arange(3, device=device), torch.arange(6, device=device),
                                torch.tensor(EDGE_POLICY_POSX, device=device), indexing="ij")
    lat = torch.stack([
        torch.zeros_like(SH),  # color
        SH,  # shape
        SC,  # scale
        torch.zeros_like(SH),  # orientation
        PX,  # posX
        torch.full_like(SH, 31),  # posY: the scoring edge
    ], dim=-1).reshape(-1, 6)
    zeros = torch.zeros((lat.shape[0],), dtype=torch.float32, device=device)
    o = env_lib.render(lut, env_lib.EnvState(latents=lat, score=zeros, last_r=zeros.clone()))
    p_up = agent.habitual_net(o).reshape(3, 6, 6, -1)[..., 0].cpu()
    return p_up[:, :, :3].mean((1, 2)), p_up[:, :, 3:].mean((1, 2))


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


def draw_eval(agent: ActiveInferenceAgent, cfg: Config, generator: torch.Generator,
              device) -> EvalDraws:
    """The noise of one eval pass over ``test_size`` envs, drawn in the
    order ``eval_pass`` draws it as it goes: the envs' reset (which the
    batch's randomize replaces), the batch, the three losses, the reward
    probe (its envs, respawns, encoder draw, transition keep-masks and
    transition draw) and the edge probe's G estimate."""
    n = cfg.test_size
    env_lib.reset(generator, n, device)
    batch = data_lib.draw_random(cfg, n, generator, device)
    staged = losses.draw_staged(agent, n, generator, device, bool(cfg.vae_train_dropout))
    normal = lambda: torch.randn((n, agent.s_dim), generator=generator, device=device)
    probe_env = env_lib.draw_randomize(generator, n, device)
    respawns = env_lib.sample_latents(generator, (cfg.repeats, n), device)
    eps_enc = normal()
    masks = agent.mid.draw_masks(n, generator, device)
    probe = ProbeDraws(probe_env, respawns, eps_enc, masks, normal())
    rows = edge_probe_latents(device).shape[0]
    edge = efe.draw_rollout(agent, rows, rows * agent.pi_dim, generator, device, steps=1,
                            calc_mean=True, samples=1, mean_estimator=True)
    return EvalDraws(batch, staged, probe, edge)


@torch.no_grad()
def eval_pass(agent: ActiveInferenceAgent, cfg: Config, lut: torch.Tensor,
              precision: PrecisionState, generator: Optional[torch.Generator] = None,
              draws: Optional[EvalDraws] = None) -> Dict[str, torch.Tensor]:
    """One eval pass, drawing from ``generator`` as it goes unless
    ``draws`` injects its noise: the full epoch stats payload, tensors on
    the device (the caller transfers the series it keeps), and the first
    ``N_PLOT`` frames of the eval batch (``o0``, ``o1``, ``po1``) and of
    the reward probe (``*_probe``) for the figures."""
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


def make_eval(agent: ActiveInferenceAgent, cfg: Config, lut: torch.Tensor,
              graphed: Optional[bool] = None
              ) -> Callable[..., Dict[str, torch.Tensor]]:
    """``evaluate(precision, generator=None, draws=None)``: one
    ``eval_pass`` on ``draws``, or on ``draw_eval``'s from ``generator``.
    ``graphed`` (default: on a card) replays the pass as one captured CUDA
    graph and returns fresh copies of its outputs; False runs it op by op.
    A graphed eval on the CPU raises."""
    graphed = graphs_lib.use_graphs(graphed, lut)
    graphs = graphs_lib.Graphs()
    deps = lambda: graphs_lib.module_deps(agent) + [lut]
    body = lambda precision, d: eval_pass(agent, cfg, lut, precision, draws=d)

    def evaluate(precision: PrecisionState, generator: Optional[torch.Generator] = None,
                 draws: Optional[EvalDraws] = None):
        if draws is None:
            draws = draw_eval(agent, cfg, generator, lut.device)
        if not graphed:
            return body(precision, draws)
        return graphs.call(body, (precision, draws), deps=deps)

    evaluate.graphs = graphs
    return evaluate
