"""Dynamic-dSprites sorting environment on batched tensors.

Port of ``deep_active_inference_mc_tpu/envs/dsprites.py``. Every rule is
branchless tensor arithmetic over the batch:

  - actions: 0=up (posY+1), 1=down (posY-1, floor 0), 2=left (posX+1,
    cap 31), 3=right (posX-1, floor 0) -- the left/right naming is
    swapped on purpose, as in the original game.
  - every action decays last_r *= 0.95.
  - crossing the top edge (posY reaching 32) scores: squares earn
    (16-posX)/16 left of centre and (15-posX)/16 (negative) right of it;
    ellipses/hearts the mirror image. The reward adds to the score,
    becomes last_r, and a fresh random object spawns keeping the score.
  - action-repeat freezes an env once it has scored.

Randomness comes from an explicit ``torch.Generator``; each drawing
function also takes its draws ready-made (``respawn``, ``noise``, ...).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from deep_active_inference_mc_torch.envs import raster
from deep_active_inference_mc_torch.ops.cuda import render as k_render
from deep_active_inference_mc_torch.utils import random as rnd

LATENT_SIZES = (1, 3, 6, 40, 32, 32)  # color, shape, scale, orient, posX, posY
NUM_ACTIONS = 4
REWARD_DECAY = 0.95


@dataclasses.dataclass
class EnvState:
    """Batched environment state; every tensor has leading batch dim B."""

    latents: torch.Tensor  # (B, 6) int64 dSprites latent indices
    score: torch.Tensor  # (B,) float32 cumulative score
    last_r: torch.Tensor  # (B,) float32 last reward, painted into the frame

    @property
    def batch(self) -> int:
        return self.latents.shape[0]

    @property
    def device(self) -> torch.device:
        return self.latents.device

    def replace(self, **changes) -> "EnvState":
        return dataclasses.replace(self, **changes)

    def select(self, rows) -> "EnvState":
        return EnvState(self.latents[rows], self.score[rows], self.last_r[rows])


def sample_latents(generator: torch.Generator, shape, device) -> torch.Tensor:
    """Uniform latents over the dSprites grid: ``shape + (6,)`` int64."""
    shape = (shape,) if isinstance(shape, int) else tuple(shape)
    cols = [
        torch.randint(0, n, shape, generator=generator, device=device)
        for n in LATENT_SIZES
    ]
    return torch.stack(cols, dim=-1)


def reset(generator: torch.Generator, batch: int, device) -> EnvState:
    """Fresh envs with zero score and zero last reward."""
    return EnvState(
        latents=sample_latents(generator, batch, device),
        score=torch.zeros((batch,), dtype=torch.float32, device=device),
        last_r=torch.zeros((batch,), dtype=torch.float32, device=device),
    )


EnvDraws = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]  # latents, score, last_r


def draw_randomize(generator: torch.Generator, batch: int, device) -> EnvDraws:
    """The draws of ``randomize``: latents, score ~ U(-10, 10) and
    last_r ~ U(-1, 1)."""
    return (
        sample_latents(generator, batch, device),
        torch.rand((batch,), generator=generator, device=device) * 20.0 - 10.0,
        torch.rand((batch,), generator=generator, device=device) * 2.0 - 1.0,
    )


def randomize(state: EnvState, generator: Optional[torch.Generator] = None,
              draws: Optional[EnvDraws] = None) -> EnvState:
    """Random latents, score and last_r. ``draws`` injects (latents, score,
    last_r); else they come from ``generator`` (``draw_randomize``)."""
    if draws is None:
        draws = draw_randomize(generator, state.batch, state.device)
    latents, score, last_r = draws
    return EnvState(latents=latents, score=score, last_r=last_r)


def _scoring_reward(shape_idx: torch.Tensor, pos_x: torch.Tensor) -> torch.Tensor:
    px = pos_x.to(torch.float32)
    square_r = torch.where(px > 15.0, (15.0 - px) / 16.0, (16.0 - px) / 16.0)
    return torch.where(shape_idx == 0, square_r, -square_r)


def step(state: EnvState, action: torch.Tensor,
         generator: Optional[torch.Generator] = None,
         respawn: Optional[torch.Tensor] = None) -> Tuple[EnvState, torch.Tensor]:
    """One step of every env. ``action``: (B,) in [0, 4). ``respawn``
    (B, 6) injects the fresh objects of envs that score (else drawn from
    ``generator``). Returns (new_state, scored) with scored a (B,) bool."""
    latents = state.latents
    pos_x = latents[..., 4]
    pos_y = latents[..., 5]
    shape_idx = latents[..., 1]

    is_up = action == 0
    is_down = action == 1
    is_left = action == 2
    is_right = action == 3

    last_r = state.last_r * REWARD_DECAY

    scored = is_up & (pos_y + 1 >= raster.N_POSY)
    reward = _scoring_reward(shape_idx, pos_x)

    new_pos_y = torch.where(is_up & ~scored, pos_y + 1, pos_y)
    new_pos_y = torch.where(is_down, torch.clamp(pos_y - 1, min=0), new_pos_y)
    new_pos_x = torch.where(is_left, torch.clamp(pos_x + 1, max=raster.N_POSX - 1), pos_x)
    new_pos_x = torch.where(is_right, torch.clamp(pos_x - 1, min=0), new_pos_x)

    moved = torch.cat([latents[..., :4], new_pos_x[..., None], new_pos_y[..., None]], dim=-1)
    if respawn is None:
        respawn = sample_latents(generator, state.batch, state.device)
    new_latents = torch.where(scored[..., None], respawn.to(latents.dtype), moved)

    new_last_r = torch.where(scored, reward, last_r)
    new_score = torch.where(scored, state.score + reward, state.score)
    return EnvState(new_latents, new_score, new_last_r), scored


def step_repeated(state: EnvState, action: torch.Tensor, repeats: int,
                  generator: Optional[torch.Generator] = None,
                  respawns: Optional[torch.Tensor] = None
                  ) -> Tuple[EnvState, torch.Tensor]:
    """Repeat ``action`` ``repeats`` times per env, freezing an env once it
    scores. ``respawns`` (repeats, B, 6) injects each repeat's respawns.
    Returns (state, done) with done the (B,) mask of envs that scored."""
    if respawns is None:
        respawns = sample_latents(generator, (repeats, state.batch), state.device)
    done = torch.zeros((state.batch,), dtype=torch.bool, device=state.device)
    for r in range(repeats):
        new, scored = step(state, action, respawn=respawns[r])
        state = EnvState(
            latents=torch.where(done[:, None], state.latents, new.latents),
            score=torch.where(done, state.score, new.score),
            last_r=torch.where(done, state.last_r, new.last_r),
        )
        done = done | scored
    return state, done


def render(lut: torch.Tensor, state: EnvState) -> torch.Tensor:
    """(B, 1, 64, 64) float32 frames: sprite + reward strip. On a card this
    always launches kernel K1, once, on the latents as they are; on the CPU
    it runs K1's plain version."""
    return k_render.render_frames(lut, state.latents, state.last_r)


def to_env_actions(actions: torch.Tensor, pi_dim: int = 4) -> torch.Tensor:
    """Map agent-space action indices to env moves for variant action sets:
    the 3-action agent's {0, 1, 2} are the env's {0, 2, 3} (up, left, right),
    computed on the device (no host tensor: the map runs under capture)."""
    if pi_dim == 4:
        return actions
    if pi_dim == 3:
        actions = actions.long()
        return torch.where(actions == 0, actions, actions + 1)
    raise ValueError(f"Unknown pi_dim {pi_dim}")


def render_obs(lut: torch.Tensor, state: EnvState, resolution: int = 64,
               channels: int = 1) -> torch.Tensor:
    """Observations (B, channels, resolution, resolution). 64: the frame of
    ``render``. 32: 2x2 max-pool of the binary sprite frame with the strip
    painted at 32-res. channels=3 repeats the grey frame as RGB."""
    if resolution == 64:
        o = render(lut, state)
    elif resolution == 32:
        frames = raster.render_sprites_slice(lut, state.latents)
        B = frames.shape[0]
        pooled = frames.reshape(B, 1, 32, 2, 32, 2).amax(dim=(3, 5))
        o = raster.paint_reward_strip(pooled, state.last_r)
    else:
        raise ValueError(f"Unknown resolution {resolution}")
    if channels == 1:
        return o
    return o.expand(o.shape[0], channels, *o.shape[2:])


def ground_truth_factors(state: EnvState) -> torch.Tensor:
    """(B, 6) [shape, scale, orientation, posX, posY, last_r]."""
    return torch.cat(
        [state.latents[..., 1:6].to(torch.float32), state.last_r[..., None]], dim=-1
    )


def expert_policy(state: EnvState, randomness: float = 0.4) -> torch.Tensor:
    """Ground-truth expert action distribution (B, 4): squares want
    up+right, ellipses/hearts want up+left."""
    right = 0.5 * (1.0 - randomness / 2.0)
    wrong = 0.5 * randomness / 2.0
    # Built on the device (no host copy, so the policy runs under capture):
    # squares favour actions 0 and 3, the others 0 and 2.
    a = torch.arange(NUM_ACTIONS, device=state.device)
    square = torch.where((a == 0) | (a == 3), right, wrong)
    other = torch.where((a == 0) | (a == 2), right, wrong)
    is_square = (state.latents[..., 1] == 0)[..., None]
    return torch.where(is_square, square, other)


def auto_play(state: EnvState, generator: Optional[torch.Generator] = None,
              randomness: float = 0.4, noise: Optional[torch.Tensor] = None,
              respawn: Optional[torch.Tensor] = None) -> Tuple[EnvState, torch.Tensor]:
    """Sample actions from the expert policy (``noise``: injected Gumbel
    draws) and step once. Returns (new_state, actions)."""
    ppi = expert_policy(state, randomness)
    actions = rnd.categorical(torch.log(ppi + 1e-20), generator, noise)
    new_state, _ = step(state, actions, generator, respawn)
    return new_state, actions
