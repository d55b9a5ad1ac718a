"""PyTorch port: the batch makers (``envs/data.py``) against the JAX
package's own functions on the converted flagship.

Each JAX function draws from a PRNG key; the tests rebuild those draws from
the same key (``test_torch_losses`` helpers for the G noise; the env, policy,
Gumbel and respawn draws with the ``jax.random`` call the function makes) and
inject them into the port. Frames, actions and env states must then be
bit-equal; ``log_Ppi`` (unscaled G minus a log-sum-exp) holds to the G
tolerance, rtol 1e-4 / atol 1e-2.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deep_active_inference_mc_tpu import config as jconfig
from deep_active_inference_mc_tpu.envs import data as jdata
from deep_active_inference_mc_tpu.envs import dsprites as jenv
from deep_active_inference_mc_tpu.envs import raster as jraster
from deep_active_inference_mc_torch import config as tconfig
from deep_active_inference_mc_torch.envs import data as tdata
from deep_active_inference_mc_torch.envs import dsprites as tenv
from deep_active_inference_mc_torch.envs import raster as traster
from test_torch_efe import G_TOL
from test_torch_losses import jax_rollout_draws, t
from test_torch_models import few_torch_threads  # noqa: F401 (autouse fixture)
from test_torch_models import jax_flagship, torch_agent

FLAGSHIP_GEN = dict(crn=True, gen_mean=True, explore_eps=0.1, edge_frac=0.3,
                    gen_habit_mix=0.5)


@pytest.fixture(scope="module")
def flagship():
    agent, params = jax_flagship()
    return agent, params, torch_agent(params)


@pytest.fixture(scope="module")
def luts():
    return jraster.build_sprite_lut(), traster.build_sprite_lut("cpu")


def env_draws(key, batch):
    """The draws of ``randomize(key, .)`` as the port takes them."""
    r = jenv.randomize(key, jenv.reset(key, batch))
    return t(r.latents).long(), t(r.score), t(r.last_r)


def edge_draws(key, batch):
    """(uniform, posY) of ``pin_edge_fraction(key, .)`` (data.py:43-45)."""
    k_sel, k_posy = jax.random.split(jax.random.fold_in(key, 1))
    return (t(jax.random.uniform(k_sel, (batch,))),
            t(jax.random.randint(k_posy, (batch,), 28, 32)).long())


def respawn_draws(key, batch, repeats):
    """Each repeat's respawn latents of ``step_repeated(key, ...)``."""
    return torch.stack([t(jenv.sample_latents(k, batch)).long()
                        for k in jax.random.split(key, repeats)])


def tstate(B):
    z = torch.zeros(B)
    return tenv.EnvState(torch.zeros(B, 6, dtype=torch.long), z, z.clone())


def frames_equal(to, jo):
    """NCHW port frames against NHWC JAX frames, bit for bit."""
    np.testing.assert_array_equal(to.permute(0, 2, 3, 1).numpy(), np.asarray(jo))


def assert_same_env(te, je):
    np.testing.assert_array_equal(te.latents.numpy(), np.asarray(je.latents))
    np.testing.assert_allclose(te.score.numpy(), np.asarray(je.score), rtol=0, atol=1e-6)
    np.testing.assert_allclose(te.last_r.numpy(), np.asarray(je.last_r), rtol=0, atol=1e-6)


def generator_draws(ja, jp, cfg, key, B):
    """GeneratorDraws of ``make_batch_active_inference(key)`` (data.py:64)."""
    k_rand, k_G, k_act, k_step = jax.random.split(key, 4)
    rows = B if cfg.crn else B * 4
    return tdata.GeneratorDraws(
        env=env_draws(k_rand, B),
        edge=edge_draws(k_rand, B) if cfg.edge_frac > 0 else None,
        rollout=jax_rollout_draws(ja, jp, k_G, rows, cfg.deepness, sampled=not cfg.gen_mean),
        gumbel=t(jax.random.gumbel(k_act, (B, 4))),
        respawns=respawn_draws(k_step, B, cfg.repeats),
    )


@pytest.mark.parametrize("flags", [{}, FLAGSHIP_GEN], ids=["tiled-sampled", "crn-flagship"])
def test_generator_matches_jax(flagship, luts, flags):
    """Both G branches: the reference defaults (tiled rows, sampled
    estimator) and the flagship's generator flags (CRN, mean estimator,
    exploration floor, edge curriculum, habit mixing)."""
    ja, jp, ta = flagship
    jlut, tlut = luts
    B = 8
    jcfg, tcfg = jconfig.Config(batch=B, **flags), tconfig.Config(batch=B, **flags)
    key = jax.random.key(5)
    env_j, o0_j, o1_j, pi0_j, logp_j = jax.jit(
        lambda p, k, e: jdata.make_batch_active_inference(ja, jcfg, p, k, e, jlut)
    )(jp, key, jenv.reset(jax.random.key(1), B))
    env_t, o0, o1, pi0, log_Ppi = tdata.make_batch_active_inference(
        ta, tcfg, tstate(B), tlut, draws=generator_draws(ja, jp, tcfg, key, B))
    frames_equal(o0, o0_j)
    np.testing.assert_allclose(log_Ppi.numpy(), np.asarray(logp_j), **G_TOL)
    np.testing.assert_array_equal(pi0.numpy(), np.asarray(pi0_j))
    frames_equal(o1, o1_j)
    assert_same_env(env_t, env_j)
    assert not any(x.requires_grad for x in (o0, o1, pi0, log_Ppi))
    assert not o0.is_inference()  # no_grad, not inference mode: o0 feeds the losses


def test_behaviour_flags_change_actions_not_target(flagship, luts):
    """explore_eps and gen_habit_mix reshape the executed-action
    distribution while the top-loss target log_Ppi stays the pure
    softmax(-G) prior (tests/test_train_loop.py:118)."""
    ja, jp, ta = flagship
    _, tlut = luts
    B = 32
    draws = generator_draws(ja, jp, tconfig.Config(crn=True, gen_mean=True),
                            jax.random.key(3), B)

    def run(**kw):
        cfg = tconfig.Config(batch=B, crn=True, gen_mean=True, **kw)
        return tdata.make_batch_active_inference(ta, cfg, tstate(B), tlut, draws=draws)

    _, o0_a, _, pi0_a, logp_a = run()
    for kw in (dict(gen_habit_mix=1.0), dict(explore_eps=1.0)):
        _, o0_b, _, pi0_b, logp_b = run(**kw)
        assert torch.equal(o0_a, o0_b)
        assert torch.equal(logp_a, logp_b)
        assert (pi0_a - pi0_b).abs().max() > 0, kw
    # explore_eps=1 is the uniform policy: Gumbel-max over equal logits.
    assert torch.equal(pi0_b.argmax(-1), draws.gumbel.argmax(-1))


@pytest.mark.parametrize("frac", [0.0, 0.3, 1.0])
def test_pin_edge_fraction_matches_jax(frac):
    B = 64
    key = jax.random.key(8)
    je = jenv.randomize(jax.random.key(9), jenv.reset(jax.random.key(9), B))
    te = tenv.EnvState(t(je.latents).long(), t(je.score), t(je.last_r))
    want = jdata.pin_edge_fraction(key, je, frac)
    got = tdata.pin_edge_fraction(te, frac, draws=edge_draws(key, B))
    assert_same_env(got, want)
    assert torch.equal(te.latents, t(je.latents).long())  # the input is not written
    pinned = (got.latents[:, 5] != te.latents[:, 5])
    if frac == 0.0:
        assert not pinned.any()
    if frac == 1.0:
        assert (got.latents[:, 5] >= 28).all()
    own = tdata.pin_edge_fraction(te, 1.0, generator=torch.Generator().manual_seed(0))
    assert (own.latents[:, 5] >= 28).all() and (own.latents[:, 5] <= 31).all()


def test_make_batch_random_matches_jax(luts):
    jlut, tlut = luts
    B = 16
    jcfg, tcfg = jconfig.Config(), tconfig.Config()
    key = jax.random.key(21)
    k_rand, k_ppi, k_act, k_step = jax.random.split(key, 4)
    want = jdata.make_batch_random(jcfg, key, jenv.reset(jax.random.key(0), B), jlut)
    got = tdata.make_batch_random(tcfg, tstate(B), tlut, draws=tdata.RandomDraws(
        env_draws(k_rand, B), t(jax.random.uniform(k_ppi, (B, 4))),
        t(jax.random.gumbel(k_act, (B, 4))), respawn_draws(k_step, B, tcfg.repeats)))
    assert_same_env(got[0], want[0])
    frames_equal(got[1], want[1])
    frames_equal(got[2], want[2])
    np.testing.assert_array_equal(got[3].numpy(), np.asarray(want[3]))
    for g, w in zip(got[4:], want[4:]):  # log_Ppi, S0_real, S1_real
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6, atol=1e-6)
    own = tdata.make_batch_random(tcfg, tstate(B), tlut, torch.Generator().manual_seed(1))
    assert own[1].shape == (B, 1, 64, 64) and own[5].shape == (B, 6)
    assert torch.allclose(own[4].exp().sum(-1), torch.ones(B), atol=1e-5)


def test_reward_transition_probe_batch_matches_jax(luts):
    jlut, tlut = luts
    size = 12
    jcfg, tcfg = jconfig.Config(), tconfig.Config()
    key = jax.random.key(22)
    k_env, k_step = jax.random.split(key)
    o0_j, o1_j, pi0_j = jdata.make_batch_random_reward_transitions(jcfg, key, jlut, size)
    o0, o1, pi0 = tdata.make_batch_random_reward_transitions(
        tcfg, tlut, size, env_draws=env_draws(k_env, size),
        respawns=respawn_draws(k_step, size, tcfg.repeats))
    frames_equal(o0, o0_j)
    frames_equal(o1, o1_j)
    np.testing.assert_array_equal(pi0.numpy(), np.asarray(pi0_j))
    # Every env scores: pinned at the edge and pushed up, the strip changes.
    assert (o0[:, :, :3] != o1[:, :, :3]).flatten(1).any(1).all()


@pytest.mark.parametrize("channels", [1, 3])
def test_compare_reward_reads_the_strip_rows(channels):
    """Frames are NCHW in the port: the strip is rows 0-2 of axis 2, not the
    first three channels."""
    rng = np.random.default_rng(0)
    a = rng.random((5, 64, 64, channels)).astype(np.float32)  # NHWC
    strip, below = a.copy(), a.copy()
    strip[:, 0:3] += 0.25
    below[:, 3:] += 0.25
    nchw = lambda x: torch.from_numpy(x).permute(0, 3, 1, 2)
    for other in (strip, below):
        want = float(jdata.compare_reward(jnp.asarray(a), jnp.asarray(other)))
        got = float(tdata.compare_reward(nchw(a), nchw(other)))
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-9)
    np.testing.assert_allclose(float(tdata.compare_reward(nchw(a), nchw(strip))), 0.0625,
                               rtol=1e-5)
    assert float(tdata.compare_reward(nchw(a), nchw(below))) == 0.0
