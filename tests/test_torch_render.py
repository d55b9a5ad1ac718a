"""PyTorch port: sprite LUT and frame render (kernel K1's plain version)
against the JAX package, bit for bit. K1 itself is held against its
plain version in tests/test_torch_cuda.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deep_active_inference_mc_tpu.envs import dsprites as jenv
from deep_active_inference_mc_tpu.envs import raster as jraster
from deep_active_inference_mc_tpu.ops.pallas import render as prender
from deep_active_inference_mc_torch.envs import dsprites as tenv
from deep_active_inference_mc_torch.envs import raster as traster
from deep_active_inference_mc_torch.ops.cuda import LAUNCHES
from deep_active_inference_mc_torch.ops.cuda import render as k_render

LAST_R = np.asarray([-1.0, -0.3, 0.0, 0.4], np.float32)


@pytest.fixture(scope="module")
def jlut():
    return jraster.build_sprite_lut()


@pytest.fixture(scope="module")
def tlut():
    return traster.build_sprite_lut("cpu")


def make_latents(B, seed):
    """Uniform latents with posX/posY pinned to 0 and 31 on the first envs."""
    rng = np.random.default_rng(seed)
    lat = np.stack([rng.integers(0, n, B) for n in tenv.LATENT_SIZES], -1)
    edges = np.asarray([[0, 0], [31, 31], [0, 31], [31, 0]])[:B]
    lat[: len(edges), 4:] = edges
    last_r = LAST_R[np.arange(B) % len(LAST_R)]
    return lat.astype(np.int32), last_r


def test_lut_bit_exact(jlut, tlut):
    np.testing.assert_array_equal(tlut.numpy(), np.asarray(jlut))


@pytest.mark.parametrize("B", [1, 7, 64])
def test_plain_render_matches_jax(jlut, tlut, B):
    lat, last_r = make_latents(B, seed=B)
    want = np.asarray(jraster.paint_reward_strip(
        jraster.render_sprites_slice(jlut, jnp.asarray(lat)), jnp.asarray(last_r)))
    args = k_render.frame_inputs(torch.from_numpy(lat), torch.from_numpy(last_r))
    got = k_render.render_frames_plain(tlut, *args)
    assert got.shape == (B, 1, 64, 64)
    # (B, 1, 64, 64) NCHW and (B, 64, 64, 1) NHWC share one memory layout.
    np.testing.assert_array_equal(got.numpy().reshape(want.shape), want)
    # Dispatcher on the CPU: the plain version, no kernel launch.
    before = LAUNCHES["render"]
    state = tenv.EnvState(torch.from_numpy(lat).long(), torch.zeros(B),
                          torch.from_numpy(last_r))
    np.testing.assert_array_equal(tenv.render(tlut, state).numpy(), got.numpy())
    assert LAUNCHES["render"] == before
    jstate = jenv.EnvState(latents=jnp.asarray(lat), score=jnp.zeros(B),
                           last_r=jnp.asarray(last_r))
    np.testing.assert_array_equal(
        got.numpy().reshape(want.shape), np.asarray(jenv.render(jlut, jstate)))


def test_plain_render_matches_pallas_kernel(tlut):
    """Against the TPU kernel itself, under the Pallas interpreter (as the
    JAX package's own tests run it on the CPU)."""
    B = prender.BLK * 2
    lat, last_r = make_latents(B, seed=5)
    with prender.interpret_mode():
        want = np.asarray(prender.render_frames(jnp.asarray(lat), jnp.asarray(last_r)))
    got = k_render.render_frames_plain(
        tlut, *k_render.frame_inputs(torch.from_numpy(lat), torch.from_numpy(last_r)))
    np.testing.assert_array_equal(got.numpy().reshape(want.shape), want)


@pytest.mark.parametrize("resolution,channels", [(32, 1), (32, 3), (64, 3)])
def test_render_obs_matches_jax(jlut, tlut, resolution, channels):
    B = 7
    lat, last_r = make_latents(B, seed=11)
    jstate = jenv.EnvState(latents=jnp.asarray(lat), score=jnp.zeros(B),
                           last_r=jnp.asarray(last_r))
    want = np.asarray(jenv.render_obs(jlut, jstate, resolution, channels))
    state = tenv.EnvState(torch.from_numpy(lat).long(), torch.zeros(B),
                          torch.from_numpy(last_r))
    got = tenv.render_obs(tlut, state, resolution, channels)
    assert got.shape == (B, channels, resolution, resolution)
    np.testing.assert_array_equal(got.permute(0, 2, 3, 1).numpy(), want)


def test_kernel_wrapper_refuses_cpu_tensors(tlut):
    args = k_render.frame_inputs(torch.zeros((2, 6), dtype=torch.long), torch.zeros(2))
    with pytest.raises(ValueError, match="CUDA"):
        k_render.render_frames_cuda(tlut, *args)
