"""PyTorch port: the per-epoch evaluation (``train/evaluate.py``) against
the JAX package's own functions on the converted flagship, with the noise
rebuilt from the JAX key and injected (``test_torch_losses`` helpers).
Losses hold to rtol 1e-4 / atol 1e-3, G-derived numbers to the G tolerance
(rtol 1e-4 / atol 1e-2), probabilities to atol 1e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deep_active_inference_mc_tpu import config as jconfig
from deep_active_inference_mc_tpu.envs import raster as jraster
from deep_active_inference_mc_tpu.infer import precision as jprecision
from deep_active_inference_mc_tpu.train import evaluate as jeval
from deep_active_inference_mc_torch import config as tconfig
from deep_active_inference_mc_torch.envs import data as tdata
from deep_active_inference_mc_torch.envs import raster as traster
from deep_active_inference_mc_torch.infer import precision as tprecision
from deep_active_inference_mc_torch.train import evaluate as teval
from test_torch_data import env_draws, respawn_draws, tstate
from test_torch_efe import G_TOL
from test_torch_losses import (LOSS_TOL, jax_down_draws, jax_mid_draws, jax_normal,
                               jax_rollout_draws, t)
from test_torch_models import few_torch_threads  # noqa: F401 (autouse fixture)
from test_torch_models import jax_flagship, torch_agent

TEST_SIZE = 16  # even, so the median averages the two middle values


@pytest.fixture(scope="module")
def flagship():
    agent, params = jax_flagship()
    return agent, params, torch_agent(params)


@pytest.fixture(scope="module")
def luts():
    return jraster.build_sprite_lut(), traster.build_sprite_lut("cpu")


def nhwc(o):
    return jnp.asarray(o.permute(0, 2, 3, 1).numpy())


def test_eval_losses_match_jax(flagship, luts):
    ja, jp, ta = flagship
    jcfg, tcfg = jconfig.Config(), tconfig.Config()
    _, o0, o1, pi0, *_ = tdata.make_batch_random(
        tcfg, tstate(TEST_SIZE), luts[1], torch.Generator().manual_seed(3))
    key = jax.random.key(31)
    k_s0, _, k_mid, k_down = jax.random.split(key, 4)
    want = jax.jit(lambda p, prec, k, a, b, c: jeval.eval_losses(ja, jcfg, p, prec, k, a, b, c))(
        jp, jprecision.PrecisionState.create(gamma=0.3), key, nhwc(o0), nhwc(o1),
        jnp.asarray(pi0.numpy()))
    got = teval.eval_losses(
        ta, tcfg, tprecision.PrecisionState.create(gamma=0.3), o0, o1, pi0,
        draws=teval.losses.StagedDraws(
            eps_s0=jax_normal(jax.random.split(k_s0)[1], TEST_SIZE),
            mid=jax_mid_draws(ja, jp, k_mid, TEST_SIZE),
            down=jax_down_draws(k_down, TEST_SIZE)))
    assert set(got) == set(want)
    for k, w in want.items():
        g = got[k].permute(0, 2, 3, 1) if k == "po1" else got[k]
        np.testing.assert_allclose(g.numpy(), np.asarray(w), err_msg=k, **LOSS_TOL)
    # jnp's conventions: the median of an even count averages the middle
    # pair (torch.median would return the lower one), std is the population's.
    with torch.no_grad():
        kl = teval.losses.compute_loss_top(ta, got["s0"], torch.log(pi0 + 1e-15))[0]
    np.testing.assert_allclose(float(got["kl_div_pi_med"]), np.median(kl.numpy()), rtol=1e-6)
    assert float(got["kl_div_pi_med"]) > float(torch.median(kl))
    np.testing.assert_allclose(float(got["kl_div_pi_std"]), kl.numpy().std(), rtol=1e-5)


def test_edge_probe_seven_numbers_match_jax(flagship, luts):
    ja, jp, ta = flagship
    jlut, tlut = luts
    jcfg, tcfg = jconfig.Config(), tconfig.Config()
    key = jax.random.key(32)
    want = jax.jit(lambda p, k: jeval.edge_discrimination_probe(ja, jcfg, p, k, jlut))(jp, key)
    got = teval.edge_discrimination_probe(
        ta, tcfg, tlut, draws=jax_rollout_draws(ja, jp, key, 96 * 4, 1, sampled=False))
    assert set(got) == set(want) and len(got) == 7
    for k, w in want.items():
        tol = G_TOL if k.endswith("nats") else dict(rtol=0, atol=1e-4)
        np.testing.assert_allclose(float(got[k]), float(w), err_msg=k, **tol)
    # The trained flagship prefers the correct side in its G estimate.
    assert float(got["edge_g_gap_nats"]) > 0
    frames = teval.edge_probe_frames(tcfg, tlut)
    assert frames.shape == (96, 1, 64, 64) and not frames[:, :, :3].any()


def test_eval_pass_fills_every_series(flagship, luts):
    """The whole pass on its own generator (tests/test_train_loop.py:166)."""
    _, _, ta = flagship
    cfg = tconfig.Config(test_size=TEST_SIZE)
    ev = teval.make_eval(ta, cfg, luts[1])(tprecision.PrecisionState.create(),
                                          torch.Generator().manual_seed(2))
    for k in ("F", "F_top", "F_mid", "F_down", "mse_o", "mse_o_clean", "kl_div_pi", "mse_r",
              "deep_mse_o", "edge_habit_correct", "edge_g_oth_gap_nats"):
        assert ev[k].ndim == 0 and torch.isfinite(ev[k]), k
    assert ev["kl_div_s_anal"].shape == (cfg.s_dim,)
    assert ev["s0"].shape == ev["qs1"].shape == (TEST_SIZE, cfg.s_dim)
    assert ev["S0_real"].shape == (TEST_SIZE, 6)
    assert 0.0 <= float(ev["mse_r"]) <= 1.0
    # The flagship reconstructs well below an untrained net's ~2000 nats.
    assert float(ev["mse_o_clean"]) < 200.0
    assert not any(v.requires_grad for v in ev.values())


def jax_eval_draws(ja, jp, key, cfg):
    """EvalDraws of ``make_jit_eval``'s pass under ``key`` (evaluate.py:199)."""
    n = cfg.test_size
    _, k_batch, k_loss, k_probe, k_edge = jax.random.split(key, 5)
    k_rand, k_ppi, k_act, k_step = jax.random.split(k_batch, 4)
    k_s0, _, k_mid, k_down = jax.random.split(k_loss, 4)
    k_pb, k_im = jax.random.split(k_probe)
    k_penv, k_pstep = jax.random.split(k_pb)
    k_enc, k_trans = jax.random.split(k_im)
    trans = jax_mid_draws(ja, jp, k_trans, n)
    return teval.EvalDraws(
        batch=tdata.RandomDraws(env_draws(k_rand, n), t(jax.random.uniform(k_ppi, (n, 4))),
                                t(jax.random.gumbel(k_act, (n, 4))),
                                respawn_draws(k_step, n, cfg.repeats)),
        staged=teval.losses.StagedDraws(
            eps_s0=jax_normal(jax.random.split(k_s0)[1], n),
            mid=jax_mid_draws(ja, jp, k_mid, n), down=jax_down_draws(k_down, n)),
        probe=teval.ProbeDraws(env_draws(k_penv, n), respawn_draws(k_pstep, n, cfg.repeats),
                               jax_normal(jax.random.split(k_enc)[1], n), trans.masks,
                               trans.eps),
        edge=jax_rollout_draws(ja, jp, k_edge, 96 * 4, 1, sampled=False))


def test_eval_pass_frames_match_jax(flagship, luts):
    """The frames the figures draw: the eval batch's first 7 o0, o1 and
    decoded o1, and the reward probe's real and imagined frames, against
    ``make_jit_eval``'s under the same noise (sprite frames bit for bit,
    decoded ones to 1e-4); and the reward probe's two errors, which read
    those frames, to the loss tolerance."""
    ja, jp, ta = flagship
    jlut, tlut = luts
    jcfg, tcfg = jconfig.Config(test_size=TEST_SIZE), tconfig.Config(test_size=TEST_SIZE)
    key = jax.random.key(33)
    want = jeval.make_jit_eval(ja, jcfg, jlut)(jp, jprecision.PrecisionState.create(), key)
    got = teval.make_eval(ta, tcfg, tlut)(tprecision.PrecisionState.create(),
                                          draws=jax_eval_draws(ja, jp, key, tcfg))
    for k in ("o0", "o1", "o0_probe", "o1_probe"):
        assert got[k].shape == (teval.N_PLOT, 1, 64, 64), k
        np.testing.assert_array_equal(nhwc(got[k]), np.asarray(want[k]), err_msg=k)
    for k in ("po1", "po1_probe"):
        assert got[k].shape == (teval.N_PLOT, 1, 64, 64), k
        np.testing.assert_allclose(nhwc(got[k]), np.asarray(want[k]), rtol=1e-4, atol=1e-4,
                                   err_msg=k)
    for k in ("mse_r", "deep_mse_o"):
        np.testing.assert_allclose(float(got[k]), float(want[k]), err_msg=k, **LOSS_TOL)
    assert set(want) <= set(got)
