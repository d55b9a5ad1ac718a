"""PyTorch port: the three staged losses, the precision state and the
omega sigmoid against the JAX package's own functions.

The JAX losses draw their noise from a PRNG key. The helpers here rebuild
that noise from the same key (the normal draws with ``jax.random.normal`` on
the key the function splits off; the transition's dropout keep-masks by
running the Flax module, weights replaced by ones, under the same dropout
key) and inject it into the port, so both packages compute on the same
numbers. Tolerance: rtol 1e-4 / atol 1e-3 on per-row losses of O(10..1e4)
(f32 sums over 4096 pixels), the G tolerance of tests/test_torch_efe.py
where G is involved.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deep_active_inference_mc_tpu.infer import precision as jprecision
from deep_active_inference_mc_tpu.train import losses as jlosses
from deep_active_inference_mc_torch.infer import efe as tefe
from deep_active_inference_mc_torch.infer import precision as tprecision
from deep_active_inference_mc_torch.train import losses as tlosses
from test_torch_models import few_torch_threads  # noqa: F401 (autouse fixture)
from test_torch_models import _inputs, jax_flagship, nchw, torch_agent

LOSS_TOL = dict(rtol=1e-4, atol=1e-3)
S_DIM = 10


@pytest.fixture(scope="module")
def flagship():
    agent, params = jax_flagship()
    return agent, params, torch_agent(params)


def t(x):
    return torch.from_numpy(np.array(x))


def close(tv, jv, **tol):
    np.testing.assert_allclose(tv.detach().numpy(), np.asarray(jv), **(tol or LOSS_TOL))


# ------------------------------------------------- noise rebuilt from JAX keys
def jax_normal(key, rows):
    return t(jax.random.normal(key, (rows, S_DIM), jnp.float32))


def flax_transition_masks(ja, jp, k_drop, rows):
    """The keep-masks Flax's three Dropout layers draw under ``k_drop`` for
    ``rows`` rows. A dropout mask depends on the key and the shape only, so
    the net runs with zero kernels and unit biases (every hidden unit is 1)
    and the mask is read off the Dropout outputs."""
    ones = jax.tree.map(lambda x: jnp.zeros_like(x) if x.ndim == 2 else jnp.ones_like(x),
                        jp["mid"])
    _, state = ja.mid.apply(
        {"params": ones}, jnp.zeros((rows, ja.pi_dim)), jnp.zeros((rows, S_DIM)), True,
        rngs={"dropout": k_drop}, capture_intermediates=True, mutable=["intermediates"])
    inter = state["intermediates"]
    return [t(inter[f"Dropout_{i}"]["__call__"][0] != 0) for i in range(3)]


def jax_mid_draws(ja, jp, key, rows):
    """The port's MidDraws equal to what ``compute_loss_mid`` (and
    ``transition_with_sample``) draws from ``key``."""
    k_drop, k_samp = jax.random.split(key)
    return tlosses.MidDraws(flax_transition_masks(ja, jp, k_drop, rows),
                            jax_normal(k_samp, rows))


def flax_vae_masks(ja, jp, k_drop, rows, part):
    """The keep-masks the Flax ``part`` ("encoder": 3 Dropout layers,
    "decoder": 4) draws under ``k_drop`` for ``rows`` rows, read as
    ``flax_transition_masks`` reads them. The decoder's fourth mask is in
    the NHWC order of the (16, 16, 64) reshape, which is the order of the
    port's converted dense layer too."""
    ones = jax.tree.map(lambda x: jnp.zeros_like(x) if x.ndim > 1 else jnp.ones_like(x),
                        jp["down"])
    if part == "encoder":
        x, method, n = jnp.zeros((rows, 64, 64, 1)), type(ja.down).encode, 3
    else:
        x, method, n = jnp.zeros((rows, S_DIM)), type(ja.down).decode, 4
    _, state = ja.down.apply(
        {"params": ones}, x, True, method=method, rngs={"dropout": k_drop},
        capture_intermediates=True, mutable=["intermediates"])
    inter = state["intermediates"][part]
    return [t(inter[f"Dropout_{i}"]["__call__"][0] != 0) for i in range(n)]


def jax_down_draws(key, rows, ja=None, jp=None, vae_dropout=False):
    """DownDraws of ``compute_loss_down`` under ``key`` (losses.py:103)."""
    k_enc, k_samp, k_dec = jax.random.split(key, 3)
    if not vae_dropout:
        return tlosses.DownDraws(jax_normal(k_samp, rows))
    return tlosses.DownDraws(jax_normal(k_samp, rows),
                             flax_vae_masks(ja, jp, k_enc, rows, "encoder"),
                             flax_vae_masks(ja, jp, k_dec, rows, "decoder"))


def jax_G_draws(ja, jp, key, rows, sampled):
    """GDraws of one ``calculate_G`` (sampled) / ``calculate_G_mean`` step
    under its key (efe.py:72,129)."""
    k1, _, k3, k4 = jax.random.split(key, 4)
    d1, d2 = jax_mid_draws(ja, jp, k1, rows), jax_mid_draws(ja, jp, k3, rows)
    return tefe.GDraws(d1.masks, d2.masks, jax_normal(k4, rows),
                       d1.eps if sampled else None, d2.eps if sampled else None)


def jax_rollout_draws(ja, jp, key, rows, steps, sampled):
    """RolloutDraws of ``calculate_G_repeated`` / ``calculate_G_4_repeated``
    with ``calc_mean=True`` under ``key`` (efe.py:177,196)."""
    _, k_scan = jax.random.split(key)
    return tefe.RolloutDraws(None, [jax_G_draws(ja, jp, k, rows, sampled)
                                    for k in jax.random.split(k_scan, steps)])


# ------------------------------------------------------------------- inputs
def loss_inputs(B, seed):
    rng = np.random.default_rng(seed)
    o, s, pi = _inputs(B, seed=seed)
    log_Ppi = np.log(np.asarray(jax.nn.softmax(rng.standard_normal((B, 4)) * 3, -1)),
                     dtype=np.float32)
    mean, logvar = (rng.standard_normal((B, S_DIM)).astype(np.float32) for _ in range(2))
    omega = rng.uniform(1.5, 2.5, (B, 1)).astype(np.float32)
    return o, s, pi, log_Ppi, mean, logvar * 0.5, omega


# -------------------------------------------------------------------- tests
def test_loss_top_matches_jax(flagship):
    ja, jp, ta = flagship
    _, s, _, log_Ppi, *_ = loss_inputs(6, seed=0)
    F_j, (kl_j, anal_j, q_j) = jlosses.compute_loss_top(ja, jp["top"], s, log_Ppi)
    F_t, (kl_t, anal_t, q_t) = tlosses.compute_loss_top(ta, t(s), t(log_Ppi))
    for tv, jv in ((F_t, F_j), (kl_t, kl_j), (anal_t, anal_j), (q_t, q_j)):
        close(tv, jv, rtol=1e-4, atol=1e-5)


def test_loss_mid_matches_jax(flagship):
    ja, jp, ta = flagship
    B = 6
    _, s, pi, _, mean, logvar, omega = loss_inputs(B, seed=1)
    key = jax.random.key(11)
    F_j, ((kl_j, anal_j), ps1_j, m_j, lv_j) = jlosses.compute_loss_mid(
        ja, jp["mid"], key, s, pi, mean, logvar, omega)
    F_t, ((kl_t, anal_t), ps1_t, m_t, lv_t) = tlosses.compute_loss_mid(
        ta, t(s), t(pi), t(mean), t(logvar), t(omega), draws=jax_mid_draws(ja, jp, key, B))
    close(F_t, F_j)
    close(anal_t, anal_j)
    for tv, jv in ((ps1_t, ps1_j), (m_t, m_j), (lv_t, lv_j)):
        close(tv, jv, rtol=1e-4, atol=1e-4)
    # The dropout is live: without masks the loss differs.
    F_nodrop, _ = tlosses.compute_loss_mid(
        ta, t(s), t(pi), t(mean), t(logvar), t(omega),
        draws=tlosses.MidDraws(None, jax_normal(key, B)))
    assert not torch.allclose(F_nodrop, F_t, rtol=1e-2)


@pytest.mark.parametrize("gamma", [0.0, 0.05, 0.5, 0.95, 1.0])
def test_loss_down_and_gamma_gate_match_jax(flagship, gamma):
    ja, jp, ta = flagship
    B = 4
    o, _, _, _, mean, logvar, omega = loss_inputs(B, seed=2)
    key = jax.random.key(12)
    F_j, (terms_j, po1_j, qs1_j) = jlosses.compute_loss_down(
        ja, jp["down"], key, o, mean, logvar, omega,
        jprecision.PrecisionState.create(gamma=gamma, beta_s=0.7, beta_o=1.3),
        vae_dropout=False)
    F_t, (terms_t, po1_t, qs1_t) = tlosses.compute_loss_down(
        ta, nchw(o), t(mean), t(logvar), t(omega),
        tprecision.PrecisionState.create(gamma=gamma, beta_s=0.7, beta_o=1.3),
        vae_dropout=False, draws=jax_down_draws(key, B))
    close(F_t, F_j)
    for tv, jv in zip(terms_t, terms_j):
        close(tv, jv)
    close(qs1_t, qs1_j, rtol=1e-4, atol=1e-4)
    close(po1_t.permute(0, 2, 3, 1), po1_j, rtol=1e-4, atol=1e-4)
    # gamma <= 0.05 uses the naive KL; gamma >= 0.95 the transition KL; the
    # middle a convex mixture (as tests/test_train_loop.py:38).
    nll, kl_s, _, kl_naive, _ = terms_t
    mix = (kl_naive if gamma <= 0.05 else kl_s if gamma >= 0.95
           else gamma * kl_s + (1 - gamma) * kl_naive)
    torch.testing.assert_close(F_t, 1.3 * nll + 0.7 * mix, rtol=1e-5, atol=1e-3)


def test_loss_down_with_vae_dropout_matches_jax(flagship):
    """``vae_dropout=True``: the encoder's and decoder's keep-masks rebuilt
    from the JAX key, so layer, order and the 1/(1-p) scale are Flax's."""
    ja, jp, ta = flagship
    B = 3
    o, _, _, _, mean, logvar, omega = loss_inputs(B, seed=3)
    key = jax.random.key(13)
    F_j, (terms_j, po1_j, qs1_j) = jlosses.compute_loss_down(
        ja, jp["down"], key, o, mean, logvar, omega,
        jprecision.PrecisionState.create(gamma=0.5), vae_dropout=True)
    d = jax_down_draws(key, B, ja, jp, vae_dropout=True)
    args = (ta, nchw(o), t(mean), t(logvar), t(omega),
            tprecision.PrecisionState.create(gamma=0.5))
    F_t, (terms_t, po1_t, qs1_t) = tlosses.compute_loss_down(*args, draws=d)
    close(F_t, F_j)
    for tv, jv in zip(terms_t, terms_j):
        close(tv, jv)
    close(qs1_t, qs1_j, rtol=1e-4, atol=1e-4)
    # Four doublings of the kept units widen the decoder's pre-sigmoid range:
    # 1 pixel of 12288 differs by 1.3e-4 in f32; a wrong mask moves them by O(1).
    close(po1_t.permute(0, 2, 3, 1), po1_j, rtol=1e-4, atol=5e-4)
    # The masks are live, and the port's own draw has their shapes and rate.
    F_clean, _ = tlosses.compute_loss_down(*args, vae_dropout=False,
                                           draws=tlosses.DownDraws(d.eps))
    assert not torch.allclose(F_clean, F_t, rtol=1e-3)
    own = tlosses.draw_down(ta, B, torch.Generator().manual_seed(0), "cpu", vae_dropout=True)
    for got, want in ((own.enc_masks, d.enc_masks), (own.dec_masks, d.dec_masks)):
        assert [(mk.shape, mk.dtype) for mk in got] == [(mk.shape, mk.dtype) for mk in want]
    assert 0.4 < float(own.dec_masks[3].float().mean()) < 0.6


def test_kl_div_pi_matches_jax(flagship):
    """``compute_kl_div_pi``: the encoder's dropout is live (losses.py:46)."""
    ja, jp, ta = flagship
    B = 5
    o, _, _, log_Ppi, *_ = loss_inputs(B, seed=5)
    key = jax.random.key(14)
    kl_j = jlosses.compute_kl_div_pi(ja, jp, key, o, log_Ppi)
    k_drop, k_samp = jax.random.split(key)
    masks = flax_vae_masks(ja, jp, k_drop, B, "encoder")
    kl_t = tlosses.compute_kl_div_pi(ta, nchw(o), t(log_Ppi), masks=masks,
                                     eps=jax_normal(k_samp, B))
    close(kl_t, kl_j, rtol=1e-4, atol=1e-5)
    # Drawn from a generator it is still a KL of the right shape.
    kl = tlosses.compute_kl_div_pi(ta, nchw(o), t(log_Ppi),
                                   generator=torch.Generator().manual_seed(0))
    assert kl.shape == (B,) and torch.isfinite(kl).all() and (kl > -1e-5).all()
    assert not torch.allclose(kl, kl_t, rtol=1e-3)


def test_precision_state_and_anneal_match_jax():
    """The schedule of tests/test_train_loop.py:148, against the JAX one."""
    jp_, tp_ = jprecision.PrecisionState.create(), tprecision.PrecisionState.create()
    for epoch in (10, 30, 31, 32, 100):
        jp_ = jprecision.anneal_gamma(jp_, epoch)
        tp_ = tprecision.anneal_gamma(tp_, epoch)
        assert tp_.gamma.ndim == 0 and tp_.gamma.dtype == torch.float32
        np.testing.assert_allclose(float(tp_.gamma), float(jp_.gamma), rtol=1e-6)
    np.testing.assert_allclose(float(tp_.gamma), 0.03, rtol=1e-5)
    tp_ = tprecision.anneal_gamma(tp_.replace(gamma=torch.tensor(0.799)), epoch=100)
    np.testing.assert_allclose(float(tp_.gamma), 0.8, rtol=1e-6)
    assert tprecision.OmegaParams(1.0, 25.0, 5.0, 1.5).eval_omega == 2.0
    kl = np.linspace(0, 60, 13, dtype=np.float32)
    close(tprecision.OmegaParams(1.2, 20.0, 4.0, 1.1)(t(kl)),
          jprecision.OmegaParams(1.2, 20.0, 4.0, 1.1)(jnp.asarray(kl)), rtol=1e-6, atol=1e-6)
