"""The act -> plan -> step -> train round, on the device end to end.

Port of ``deep_active_inference_mc_tpu/train/loop.py``. One round:

  1. randomize all envs, render o0 (kernel K1 on a card)
  2. EFE over all 4 actions -> softmax(-G, T) -> sample actions
  3. step all envs with action-repeat, render o1 (K1 again)
  4. staged update: top -> omega -> mid -> down, one Adam per layer, with
     ``detach`` at every layer boundary

The JAX round is functional: everything is computed from the pre-update
params and three updates are applied at the end. Here the optimizers step
in place, and the order of the code keeps the same dataflow: qs0 and qs1
come from the pre-update encoder (the down layer steps last), the omega
input ``kl_pi`` and the down loss's prior ``ps1_mean/logvar`` are outputs of
forwards that ran before their layer's step.

The JAX epoch is one ``lax.scan``; here it is a Python loop whose metrics
stay on the device (one stack and one transfer per epoch, no host sync
inside a round).

Under a mesh (``parallel/mesh.py``; the counterpart of
``make_sharded_train_round``) every rank draws the global batch's noise and
keeps its rows, each loss is a mean over the rank's shard, each gradient is
averaged over the data group before its Adam step, the gradient norm (and
the clip) counts split parameters over the model group, and the round's
means are all-reduced (``omega_std`` from the sum of squares). On gloo,
a collective on a card's tensors stages them through the host.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch

from deep_active_inference_mc_torch.config import Config
from deep_active_inference_mc_torch.envs import data as data_lib
from deep_active_inference_mc_torch.envs import dsprites as env_lib
from deep_active_inference_mc_torch.infer import efe
from deep_active_inference_mc_torch.infer.agent import ActiveInferenceAgent
from deep_active_inference_mc_torch.infer.precision import OmegaParams, PrecisionState
from deep_active_inference_mc_torch.parallel import mesh as mesh_lib
from deep_active_inference_mc_torch.train import losses

LAYERS = ("top", "mid", "down")
METRIC_KEYS = ("F_top", "F_mid", "F_down", "nll_o", "omega", "omega_std", "kl_pi",
               "score", "gnorm_top", "gnorm_mid", "gnorm_down")
# Worst-round series of an epoch: a spike inside the epoch is invisible in
# the last round's metrics; these bound it.
EPOCH_MAX_KEYS = ("gnorm_top", "gnorm_mid", "gnorm_down", "F_down")


@dataclasses.dataclass
class TrainState:
    """Everything a round mutates: the agent's weights, the three
    optimizers' states (both updated in place), the precision scalars and
    the environments."""

    agent: ActiveInferenceAgent
    opts: Dict[str, torch.optim.Optimizer]
    precision: PrecisionState
    env: env_lib.EnvState


@dataclasses.dataclass
class RoundDraws:
    """Noise of one training round, for injection: the generator's draws
    and the three losses' draws."""

    data: data_lib.GeneratorDraws
    staged: losses.StagedDraws


def draw_round(agent: ActiveInferenceAgent, cfg: Config, batch: int,
               generator: torch.Generator, device) -> RoundDraws:
    return RoundDraws(
        data=data_lib.draw_generator(agent, cfg, batch, generator, device),
        staged=losses.draw_staged(agent, batch, generator, device,
                                  bool(cfg.vae_train_dropout)),
    )


def shard_round_draws(draws: RoundDraws, cfg: Config, pi_dim: int, batch: int,
                      mesh: mesh_lib.Mesh) -> RoundDraws:
    """This data rank's rows of a ``batch``-env round's draws. The G
    rollout's rows are (env, action) with the action fastest unless
    ``cfg.crn``; the respawns are (repeats, batch, 6)."""
    rows = mesh.data_slice(batch)
    take = lambda t, inner=1: mesh_lib.take_rows(t, rows, batch, inner)
    d = draws.data
    data = dataclasses.replace(
        d, env=take(d.env), edge=take(d.edge), gumbel=take(d.gumbel),
        rollout=efe.RolloutDraws(take(d.rollout.eps0),
                                 take(d.rollout.steps, 1 if cfg.crn else pi_dim)),
        respawns=d.respawns[:, rows])
    return RoundDraws(data, take(draws.staged))


def make_optimizers(cfg: Config, agent: ActiveInferenceAgent) -> Dict[str, torch.optim.Adam]:
    """One Adam per layer (b1 0.9, b2 0.999, eps 1e-8: optax's defaults and
    torch's). The optional global-norm clip (``cfg.clip_grad``) is applied
    by the round, before the step (``clip_by_global_norm_``)."""
    rates = {"top": cfg.l_rate_top, "mid": cfg.l_rate_mid, "down": cfg.l_rate_down}
    return {k: torch.optim.Adam(getattr(agent, k).parameters(), lr=rates[k]) for k in LAYERS}


def create_train_state(cfg: Config, agent: ActiveInferenceAgent,
                       generator: torch.Generator, device) -> TrainState:
    """Seeded init of the agent on ``device`` (``generator`` lives there),
    fresh optimizers, the config's precisions and ``cfg.batch`` fresh envs."""
    agent.to(device).init(generator)
    return TrainState(
        agent=agent,
        opts=make_optimizers(cfg, agent),
        precision=PrecisionState.create(cfg.gamma, cfg.beta_s, cfg.beta_o, device),
        env=env_lib.reset(generator, cfg.batch, device),
    )


def global_norm(grads: Sequence[torch.Tensor]) -> torch.Tensor:
    """sqrt(sum of squares) over all tensors, a 0-d tensor on the device."""
    return torch.linalg.vector_norm(torch.stack([torch.linalg.vector_norm(g) for g in grads]))


def clip_by_global_norm_(grads: Sequence[torch.Tensor], max_norm: float,
                         norm: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Scale ``grads`` in place by ``max_norm / max(norm, max_norm)`` and
    return the pre-clip norm (``global_norm`` unless given): optax's
    ``clip_by_global_norm``. (``torch.nn.utils.clip_grad_norm_`` adds 1e-6
    to the norm.)"""
    if norm is None:
        norm = global_norm(grads)
    scale = max_norm / torch.clamp(norm, min=max_norm)
    for g in grads:
        g.mul_(scale)
    return norm


def _step(opt: torch.optim.Optimizer, loss: torch.Tensor, clip_grad: float,
          apply: bool = True, mesh: Optional[mesh_lib.Mesh] = None) -> torch.Tensor:
    """Gradients of ``loss`` for ``opt``'s params (averaged over the data
    group under a mesh), the optional clip, one optimizer step (withheld,
    state and all, when ``apply`` is false). Returns the pre-clip gradient
    global norm."""
    params = [p for group in opt.param_groups for p in group["params"]]
    grads = torch.autograd.grad(loss, params)
    if mesh is None:
        norm = global_norm(grads)
    else:
        grads = mesh_lib.mean_grads(grads, mesh)
        norm = mesh_lib.global_norm(grads, params, mesh)
    if clip_grad and clip_grad > 0.0:
        clip_by_global_norm_(grads, clip_grad, norm)
    if apply:
        for p, g in zip(params, grads):
            p.grad = g
        opt.step()
        opt.zero_grad(set_to_none=True)
    return norm


def train_round(cfg: Config, omega_params: OmegaParams, state: TrainState,
                lut: torch.Tensor,
                generator: Optional[torch.Generator] = None,
                draws: Optional[RoundDraws] = None,
                mesh: Optional[mesh_lib.Mesh] = None
                ) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
    """One full training round (data generation + 3 staged updates). The
    state's agent and optimizers are updated in place; the metrics are 0-d
    tensors on the device. Under a mesh, ``state`` is this rank's shard
    and ``draws`` (drawn here unless given) are the global batch's."""
    agent = state.agent
    batch = state.env.batch * (mesh.n_data if mesh else 1)  # the global batch
    if draws is None:
        draws = draw_round(agent, cfg, batch, generator, lut.device)
    if mesh is not None:
        draws = shard_round_draws(draws, cfg, agent.pi_dim, batch, mesh)
    vae_do = bool(cfg.vae_train_dropout)

    env, o0, o1, pi0, log_Ppi = data_lib.make_batch_active_inference(
        agent, cfg, state.env, lut, draws=draws.data)

    # -- TOP: F_top on qs0 ~ Q(s|o0), gradients only into the habit net.
    noise = draws.staged
    with torch.no_grad():
        qs0, _, _ = agent.encode_with_sample(o0, eps=noise.eps_s0, masks=noise.enc0_masks)
        # qs1 from the pre-update encoder too (the down layer steps last).
        qs1_mean, qs1_logvar = agent.encode(o1, noise.enc1_masks)
    F_top, (kl_pi, _, _) = losses.compute_loss_top(agent, qs0, log_Ppi)
    # freeze_top: kl_pi (the omega input below) is still the live
    # habit-vs-prior KL; only the update and the Adam state are withheld.
    gnorm_top = _step(state.opts["top"], F_top.mean(), cfg.clip_grad,
                      apply=not cfg.freeze_top, mesh=mesh)

    # -- omega from the pre-update top KL.
    omega = omega_params(kl_pi.detach()).reshape(-1, 1)

    # -- MID: F_mid with omega-weighted KL to the re-encoded posterior.
    F_mid, (_, _, ps1_mean, ps1_logvar) = losses.compute_loss_mid(
        agent, qs0, pi0, qs1_mean, qs1_logvar, omega, draws=noise.mid)
    gnorm_mid = _step(state.opts["mid"], F_mid.mean(), cfg.clip_grad, mesh=mesh)

    # -- DOWN: F_down with the pre-update mid prior.
    F_down, (down_terms, _, _) = losses.compute_loss_down(
        agent, o1, ps1_mean.detach(), ps1_logvar.detach(), omega, state.precision,
        vae_dropout=vae_do, draws=noise.down)
    gnorm_down = _step(state.opts["down"], F_down.mean(), cfg.clip_grad, mesh=mesh)

    state.env = env
    with torch.no_grad():
        metrics = {
            "F_top": F_top.mean(),
            "F_mid": F_mid.mean(),
            "F_down": F_down.mean(),
            "nll_o": down_terms[0].mean(),
            "omega": omega.mean(),
            "omega_std": omega.std(correction=0),
            "kl_pi": kl_pi.mean(),
            "score": env.score.mean(),
            # Per-round gradient global norms, before the clip.
            "gnorm_top": gnorm_top,
            "gnorm_mid": gnorm_mid,
            "gnorm_down": gnorm_down,
        }
        if mesh is not None and mesh.n_data > 1:
            metrics.update(_data_means(metrics, omega, mesh))
    return state, metrics


_MEAN_KEYS = ("F_top", "F_mid", "F_down", "nll_o", "omega", "kl_pi", "score")


def _data_means(metrics: Dict[str, torch.Tensor], omega: torch.Tensor,
                mesh: mesh_lib.Mesh) -> Dict[str, torch.Tensor]:
    """The shard means of ``_MEAN_KEYS`` and omega's population std over
    the global batch: one all-reduce of the shard means and of omega's
    mean square (equal shards)."""
    local = torch.stack([metrics[k] for k in _MEAN_KEYS] + [omega.square().mean()])
    means = mesh.sum_data_(local) / mesh.n_data
    out = dict(zip(_MEAN_KEYS, means[:-1]))
    out["omega_std"] = torch.sqrt(torch.clamp(means[-1] - out["omega"].square(), min=0.0))
    return out


RoundFn = Callable[..., Tuple[TrainState, Dict[str, torch.Tensor]]]


def make_round_fn(cfg: Config, lut: torch.Tensor,
                  mesh: Optional[mesh_lib.Mesh] = None) -> RoundFn:
    """The ``(state, generator=None, draws=None) -> (state, metrics)`` round
    closure (on ``mesh``'s shard of the state, when given)."""
    omega_params = OmegaParams(cfg.var_a, cfg.var_b, cfg.var_c, cfg.var_d)

    def step(state, generator=None, draws=None):
        return train_round(cfg, omega_params, state, lut, generator, draws, mesh)

    return step


def make_epoch_fn(cfg: Config, lut: torch.Tensor, rounds: int,
                  mesh: Optional[mesh_lib.Mesh] = None):
    """Whole-epoch closure ``(state, generator) -> (state, metrics)``:
    ``rounds`` training rounds, returning the last round's metrics plus the
    worst-round maxima ``<key>_max`` of ``EPOCH_MAX_KEYS`` as floats. The
    epoch's one host sync is the transfer of the stacked metrics."""
    round_fn = make_round_fn(cfg, lut, mesh)

    def epoch(state, generator):
        rows: List[torch.Tensor] = []
        for _ in range(rounds):
            state, metrics = round_fn(state, generator)
            rows.append(torch.stack([metrics[k] for k in METRIC_KEYS]))
        table = torch.stack(rows).cpu()
        out = dict(zip(METRIC_KEYS, table[-1].tolist()))
        worst = dict(zip(METRIC_KEYS, table.max(dim=0).values.tolist()))
        for k in EPOCH_MAX_KEYS:
            out[k + "_max"] = worst[k]
        return state, out

    return epoch
