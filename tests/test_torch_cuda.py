"""PyTorch port: the hand-written CUDA kernels against their plain PyTorch
versions on a card. Marked ``cuda``; without a card they skip. The file
imports no JAX, so it also runs where JAX is absent:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from deep_active_inference_mc_torch.envs import dsprites as tenv
from deep_active_inference_mc_torch.envs import raster as traster
from deep_active_inference_mc_torch.ops.cuda import LAUNCHES
from deep_active_inference_mc_torch.ops.cuda import render as k_render

LAST_R = np.asarray([-1.0, -0.3, 0.0, 0.4], np.float32)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: run `python -m pytest --noconftest -m cuda "
                    "tests/test_torch_cuda.py` on one")
    return torch.device("cuda")


def make_latents(B, seed):
    """Uniform latents with posX/posY pinned to 0 and 31 on the first envs."""
    rng = np.random.default_rng(seed)
    lat = np.stack([rng.integers(0, n, B) for n in tenv.LATENT_SIZES], -1)
    edges = np.asarray([[0, 0], [31, 31], [0, 31], [31, 0]])[:B]
    lat[: len(edges), 4:] = edges
    return lat, LAST_R[np.arange(B) % len(LAST_R)]


@pytest.mark.cuda
@pytest.mark.parametrize("B", [1, 33, 1024])
def test_render_kernel_matches_plain(cuda_device, B):
    lat, last_r = make_latents(B, seed=B)
    args = k_render.frame_inputs(torch.from_numpy(lat).to(cuda_device),
                                 torch.from_numpy(last_r).to(cuda_device))
    lut = traster.build_sprite_lut(cuda_device)
    before = LAUNCHES["render"]
    got = k_render.render_frames(lut, *args)
    torch.cuda.synchronize()
    assert LAUNCHES["render"] == before + 1
    assert torch.equal(got, k_render.render_frames_plain(lut, *args))
    cpu = k_render.render_frames_plain(traster.build_sprite_lut("cpu"), *(a.cpu() for a in args))
    assert torch.equal(got.cpu(), cpu)


@pytest.mark.cuda
def test_env_render_on_card_launches_the_kernel(cuda_device):
    """``envs.dsprites.render`` on CUDA tensors always goes through K1."""
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    state = tenv.randomize(tenv.reset(gen, 64, cuda_device), gen)
    lut = traster.build_sprite_lut(cuda_device)
    before = LAUNCHES["render"]
    frames = tenv.render(lut, state)
    torch.cuda.synchronize()
    assert LAUNCHES["render"] == before + 1
    assert frames.shape == (64, 1, 64, 64) and frames.is_cuda
