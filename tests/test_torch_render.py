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
    got = k_render.render_frames_plain(tlut, torch.from_numpy(lat).long(),
                                       torch.from_numpy(last_r))
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
    got = k_render.render_frames_plain(tlut, torch.from_numpy(lat).long(),
                                       torch.from_numpy(last_r))
    np.testing.assert_array_equal(got.numpy().reshape(want.shape), want)


def out_of_range_latents():
    """Latents off the dSprites grid: posX/posY beyond 31 (and below 0),
    shape beyond 2 (and below 0). XLA counts a negative gather index or
    slice start once from the end of its axis, then clamps it."""
    lat = np.asarray([
        [0, 3, 5, 39, 40, 45],  # sprite 959 > 719; offsets -8 and -13
        [0, 2, 5, 39, -3, -7],  # offsets 35 and 39 > 32
        [0, 5, 0, 0, 33, 32],  # offsets -1 and 0
        [0, 1, 2, 3, 96, 97],  # offsets -64 and -65
        [0, 0, 1, 2, 128, 129],  # offsets -96 and -97
        [0, -1, 0, 0, 31, 0],  # sprite -240
        [0, -4, 0, 0, 0, 31],  # sprite -960 < -720
        [0, 4, 9, 99, 100, -100],  # sprite 1419; offsets -68 and 132
    ], np.int32)
    last_r = LAST_R[np.arange(len(lat)) % len(LAST_R)]
    return lat, last_r


def test_out_of_range_latents_match_jax_clamps(jlut, tlut):
    """The plain version's clamps against the JAX package's XLA render."""
    lat, last_r = out_of_range_latents()
    want = np.asarray(jraster.paint_reward_strip(
        jraster.render_sprites_slice(jlut, jnp.asarray(lat)), jnp.asarray(last_r)))
    got = k_render.render_frames_plain(tlut, torch.from_numpy(lat).long(),
                                       torch.from_numpy(last_r))
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
    with pytest.raises(ValueError, match="CUDA"):
        k_render.render_frames_cuda(tlut, torch.zeros((2, 6), dtype=torch.long), torch.zeros(2))


@pytest.mark.parametrize("case", ["int32 latents", "latents (B, 5)", "latents (B,)",
                                  "strided latents", "float64 last_r", "last_r (B, 1)",
                                  "strided last_r", "float64 lut", "lut (720, 96, 95)",
                                  "strided lut"])
def test_kernel_wrapper_refuses_what_the_kernel_does_not_take(tlut, case):
    """The wrapper checks type, shape and contiguity before the device, so
    each refusal shows on the CPU too."""
    latents, last_r, lut = torch.zeros((4, 6), dtype=torch.long), torch.zeros(4), tlut
    if case == "int32 latents":
        latents, match = latents.int(), "int32"
    elif case == "latents (B, 5)":
        latents, match = latents[:, :5].contiguous(), r"\(4, 5\)"
    elif case == "latents (B,)":
        latents, match = latents[:, 0].contiguous(), r"\(4,\)"
    elif case == "strided latents":
        latents, match = torch.zeros((4, 12), dtype=torch.long)[:, ::2], "not contiguous"
    elif case == "float64 last_r":
        last_r, match = last_r.double(), "float64"
    elif case == "last_r (B, 1)":
        last_r, match = last_r[:, None], r"\(4, 1\)"
    elif case == "strided last_r":
        last_r, match = torch.zeros(8)[::2], "last_r is not contiguous"
    elif case == "float64 lut":
        lut, match = tlut.double(), "float64"
    elif case == "lut (720, 96, 95)":
        lut, match = tlut[:, :, :95].contiguous(), r"\(720, 96, 95\)"
    else:
        lut, match = tlut.transpose(1, 2), "lut is not contiguous"
    with pytest.raises(ValueError, match=match):
        k_render.render_frames_cuda(lut, latents, last_r)
