"""PyTorch port: the EFE (G) estimators against the JAX package.

The port's estimators take their noise injected (dropout keep-masks and
normal draws, made here with numpy). The JAX side is an oracle rebuilt
from the JAX package's public parts with the same noise: the transition
net from its ``params["mid"]`` Dense kernels (``jax_transition``), and
``agent.decode``, ``agent.encode``, ``agent.check_reward`` and ``ops.math``.
Tolerance rtol 1e-4 / atol 1e-2, as in tests/test_efe.py (G sums ~4k
Bernoulli entropies, so f32 reduction order moves it by ~1e-3). Without
injection, the two packages' own random draws agree in distribution.
The planner's two functions (``calculate_G_given_trajectory``,
``mcts_step_simulate``) run against the JAX functions themselves, their
noise rebuilt from the key with the helpers of tests/test_torch_losses.py.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deep_active_inference_mc_tpu.infer import efe as jefe
from deep_active_inference_mc_tpu.ops import math as jm
from deep_active_inference_mc_torch.envs import dsprites as tenv
from deep_active_inference_mc_torch.envs import raster as traster
from deep_active_inference_mc_torch.infer import efe as tefe
from deep_active_inference_mc_torch.utils.device import seeded_generator
from test_torch_losses import jax_mid_draws, jax_normal, t
from test_torch_models import few_torch_threads  # noqa: F401 (autouse fixture)
from test_torch_models import jax_flagship, jax_transition, torch_agent

G_TOL = dict(rtol=1e-4, atol=1e-2)
HIDDEN, S_DIM = 512, 10


@pytest.fixture(scope="module")
def flagship():
    agent, params = jax_flagship()
    return agent, params, torch_agent(params)


def frames(B, seed):
    """(torch NCHW, jax NHWC) env frames of random latents and rewards."""
    gen = seeded_generator("cpu", seed)
    state = tenv.randomize(tenv.reset(gen, B, "cpu"), gen)
    o = tenv.render(traster.build_sprite_lut("cpu"), state)
    return o, jnp.asarray(o.numpy().reshape(B, 64, 64, 1))


def draws(rows, seed, sampled):
    """Numpy noise of one G evaluation: (masks1, masks2, eps_fixed, eps1, eps2)."""
    rng = np.random.default_rng(seed)
    masks = lambda: [rng.random((rows, HIDDEN)) < 0.5 for _ in range(3)]
    normal = lambda: rng.standard_normal((rows, S_DIM)).astype(np.float32)
    m1, m2, eps_fixed = masks(), masks(), normal()
    return (m1, m2, eps_fixed) + ((normal(), normal()) if sampled else (None, None))


def to_torch(d):
    m1, m2, eps_fixed, eps1, eps2 = d
    t = lambda x: None if x is None else torch.from_numpy(x)
    return tefe.GDraws([t(m) for m in m1], [t(m) for m in m2], t(eps_fixed), t(eps1), t(eps2))


# ------------------------------------------------------------- JAX oracle
def _sum_H(po):
    return jnp.sum(jm.entropy_bernoulli(po), axis=(-3, -2, -1))


def _state_H(lv1, qlv):
    return jnp.sum(jm.entropy_normal_from_logvar(lv1) + jm.entropy_normal_from_logvar(qlv), -1)


@functools.partial(jax.jit, static_argnums=0)
def oracle_G_mean(ja, jp, s0, pi, masks1, masks2, eps_fixed):
    """calculate_G_mean (efe.py:119-152) with explicit masks and draw."""
    m1, lv1 = jax_transition(jp, pi, s0, masks1)
    po1 = ja.decode(jp, m1)
    _, qlv = ja.encode(jp, po1)
    term0 = ja.check_reward(po1)
    term1 = -_state_H(lv1, qlv)
    mb, _ = jax_transition(jp, pi, s0, masks2)
    term2 = _sum_H(ja.decode(jp, mb)) - _sum_H(ja.decode(jp, eps_fixed * jnp.exp(lv1 * 0.5) + m1))
    return -term0 + term1 + term2, (term0, term1, term2), m1


@functools.partial(jax.jit, static_argnums=(0, 4))
def oracle_G(ja, jp, s0, pi, S, masks1, masks2, eps_fixed, eps1, eps2):
    """calculate_G (efe.py:52-116) with explicit masks and draws: S samples
    folded sample-major; only the last sample's tensors thread on."""
    B = s0.shape[0]
    s_r, pi_r = jnp.tile(s0, (S, 1)), jnp.tile(pi, (S, 1))
    mean_s = lambda x: x.reshape(S, B).mean(0)
    m1, lv1 = jax_transition(jp, pi_r, s_r, masks1)
    ps1 = eps1 * jnp.exp(lv1 * 0.5) + m1
    po1 = ja.decode(jp, ps1)
    _, qlv = ja.encode(jp, po1)
    term0 = mean_s(ja.check_reward(po1))
    term1 = mean_s(-_state_H(lv1, qlv))
    m_last, lv_last = m1[-B:], lv1[-B:]
    m2, lv2 = jax_transition(jp, pi_r, s_r, masks2)
    t21 = mean_s(_sum_H(ja.decode(jp, eps2 * jnp.exp(lv2 * 0.5) + m2)))
    s_fixed = eps_fixed * jnp.exp(jnp.tile(lv_last, (S, 1)) * 0.5) + jnp.tile(m_last, (S, 1))
    term2 = t21 - mean_s(_sum_H(ja.decode(jp, s_fixed)))
    return -term0 + term1 + term2, (term0, term1, term2), ps1[-B:], m_last


def close(t, j, **tol):
    np.testing.assert_allclose(t.numpy(), np.asarray(j), **(tol or G_TOL))


# ------------------------------------------------------------------ tests
def test_transition_oracle_is_flax_dropout(flagship):
    """The oracle's transition equals the JAX agent's: without masks against
    ``transition(dropout=False)``, and with the keep-masks read back from a
    real Flax dropout pass against that pass."""
    ja, jp, _ = flagship
    rng = np.random.default_rng(0)
    B = 6
    s0 = jnp.asarray(rng.standard_normal((B, S_DIM)), jnp.float32)
    pi = jnp.asarray(np.eye(4, dtype=np.float32)[rng.integers(0, 4, B)])
    for o, j in zip(jax_transition(jp, pi, s0), ja.transition(jp, pi, s0, dropout=False)):
        np.testing.assert_allclose(np.asarray(o), np.asarray(j), rtol=1e-6, atol=1e-6)
    out, state = ja.mid.apply({"params": jp["mid"]}, pi, s0, True,
                              rngs={"dropout": jax.random.key(1)},
                              capture_intermediates=True, mutable=["intermediates"])
    inter = state["intermediates"]
    masks = [inter[f"Dropout_{i}"]["__call__"][0] != 0 for i in range(3)]
    assert 0.05 < float(jnp.mean(masks[0])) < 0.5  # relu zeros + rate 0.5
    for o, j in zip(jax_transition(jp, pi, s0, masks), out):
        np.testing.assert_allclose(np.asarray(o), np.asarray(j), rtol=1e-5, atol=1e-5)


def test_G_mean_matches_oracle(flagship):
    ja, jp, ta = flagship
    B = 8
    rng = np.random.default_rng(1)
    s0 = rng.standard_normal((B, S_DIM)).astype(np.float32)
    pi = np.eye(4, dtype=np.float32)[rng.integers(0, 4, B)]
    d = draws(B, seed=2, sampled=False)
    G_o, terms_o, m1_o = oracle_G_mean(ja, jp, s0, pi, *d[:3])
    with torch.inference_mode():
        G, terms, ps1_mean, po1 = tefe.calculate_G_mean(
            ta, torch.from_numpy(s0), torch.from_numpy(pi), draws=to_torch(d))
    close(G, G_o)
    for t, j in zip(terms, terms_o):
        close(t, j)
    close(ps1_mean, m1_o, rtol=1e-4, atol=1e-4)
    assert po1.shape == (B, 1, 64, 64)
    torch.testing.assert_close(G, -terms[0] + terms[1] + terms[2], rtol=1e-5, atol=1e-4)


def test_G_sampled_matches_oracle(flagship):
    ja, jp, ta = flagship
    B, S = 4, 3
    rng = np.random.default_rng(3)
    s0 = rng.standard_normal((B, S_DIM)).astype(np.float32)
    pi = np.eye(4, dtype=np.float32)[rng.integers(0, 4, B)]
    d = draws(S * B, seed=4, sampled=True)
    G_o, terms_o, ps1_o, m_o = oracle_G(ja, jp, s0, pi, S, *d)
    with torch.inference_mode():
        G, terms, ps1, ps1_mean, po1 = tefe.calculate_G(
            ta, torch.from_numpy(s0), torch.from_numpy(pi), samples=S, draws=to_torch(d))
    close(G, G_o)
    for t, j in zip(terms, terms_o):
        close(t, j)
    close(ps1, ps1_o, rtol=1e-4, atol=1e-4)
    close(ps1_mean, m_o, rtol=1e-4, atol=1e-4)
    assert ps1.shape == (B, S_DIM) and po1.shape == (B, 1, 64, 64)


def _oracle_rows(x, A):
    """Explicit nested-loop (b, a) tiling, action fastest."""
    return np.stack([x[b] for b in range(x.shape[0]) for _ in range(A)])


@pytest.mark.parametrize("calc_mean", [True, False])
def test_G4_rows_are_b_a_and_match_oracle(flagship, calc_mean):
    """calculate_G_4_repeated (steps 2) against the JAX oracle replayed on
    explicitly tiled (b, a) rows, with an anti-test that an (a, b)
    assignment does not match."""
    ja, jp, ta = flagship
    B, A, S, steps = 3, 4, 2, 2
    o, jo = frames(B, seed=5)
    rows = B * A if calc_mean else S * B * A
    step_draws = [draws(rows, seed=10 + k, sampled=not calc_mean) for k in range(steps)]
    eps0 = None if calc_mean else np.random.default_rng(6).standard_normal(
        (B, S_DIM)).astype(np.float32)
    rollout = tefe.RolloutDraws(None if eps0 is None else torch.from_numpy(eps0),
                                [to_torch(d) for d in step_draws])
    with torch.inference_mode():
        G, terms, po1 = tefe.calculate_G_4_repeated(
            ta, o, steps=steps, calc_mean=calc_mean, samples=S, draws=rollout)
    assert G.shape == (B, A) and all(t.shape == (B, A) for t in terms)

    mean, logvar = ja.encode(jp, jo)
    s = mean if calc_mean else eps0 * jnp.exp(logvar * 0.5) + mean
    s = jnp.asarray(_oracle_rows(np.asarray(s), A))
    pi = jnp.asarray([np.eye(A, dtype=np.float32)[a] for _ in range(B) for a in range(A)])
    G_o = 0.0
    terms_o = [0.0, 0.0, 0.0]
    for d in step_draws:
        if calc_mean:
            G_k, t_k, s = oracle_G_mean(ja, jp, s, pi, *d[:3])
        else:
            G_k, t_k, s, _ = oracle_G(ja, jp, s, pi, S, *d)
        G_o = G_o + G_k
        terms_o = [a + b for a, b in zip(terms_o, t_k)]
    close(G, np.asarray(G_o).reshape(B, A))
    for t, j in zip(terms, terms_o):
        close(t, np.asarray(j).reshape(B, A))
    scrambled = np.asarray(G_o).reshape(A, B).T
    assert np.abs(G.numpy() - scrambled).max() > 1.0


def test_crn_columns_equal_single_action_path(flagship):
    """Each CRN column equals calculate_G_repeated with that action under the
    same draws (tests/test_efe.py:285), and column 0 matches the JAX oracle."""
    ja, jp, ta = flagship
    B, steps = 3, 2
    o, jo = frames(B, seed=7)
    step_draws = [draws(B, seed=20 + k, sampled=False) for k in range(steps)]
    rollout = tefe.RolloutDraws(None, [to_torch(d) for d in step_draws])
    with torch.inference_mode():
        G_crn, terms_crn, po1 = tefe.calculate_G_4_repeated_crn(
            ta, o, steps=steps, calc_mean=True, samples=1, mean_estimator=True,
            draws=rollout)
        assert G_crn.shape == (B, 4) and po1.shape == (B * 4, 1, 64, 64)
        for a in range(4):
            pi = ta.pi_one_hot[a].expand(B, 4)
            G_a, terms_a, _ = tefe.calculate_G_repeated(
                ta, o, pi, steps=steps, calc_mean=True, samples=1,
                mean_estimator=True, draws=rollout)
            torch.testing.assert_close(G_crn[:, a], G_a, rtol=0, atol=0)
            for t_crn, t in zip(terms_crn, terms_a):
                torch.testing.assert_close(t_crn[:, a], t, rtol=0, atol=0)
    s, _ = ja.encode(jp, jo)
    pi = jnp.tile(jnp.eye(4)[0], (B, 1))
    G_o = 0.0
    for d in step_draws:
        G_k, _, s = oracle_G_mean(ja, jp, s, pi, *d[:3])
        G_o = G_o + G_k
    close(G_crn[:, 0], G_o)


@pytest.mark.parametrize("calc_mean", [True, False])
def test_G4_mc_means_agree_with_jax(flagship, calc_mean):
    """Each package's own random draws: over 64 independent replicas per
    (env, action) cell, the mean of G agrees within 4 standard errors."""
    ja, jp, ta = flagship
    B, A, R = 1, 4, 64
    o, jo = frames(B, seed=8)
    o_rep = o.repeat(R, 1, 1, 1)  # replica-major: independent rows
    with torch.inference_mode():
        G_t, _, _ = tefe.calculate_G_4_repeated(
            ta, o_rep, seeded_generator("cpu", 9), steps=1, calc_mean=calc_mean, samples=1)
    G_j, _, _ = jax.jit(functools.partial(
        jefe.calculate_G_4_repeated, ja, steps=1, calc_mean=calc_mean, samples=1))(
            jp, jax.random.key(9), jnp.tile(jo, (R, 1, 1, 1)))
    G_t = G_t.numpy().reshape(R, B, A)
    G_j = np.asarray(G_j).reshape(R, B, A)
    se = np.sqrt(G_t.var(0, ddof=1) / R + G_j.var(0, ddof=1) / R)
    z = np.abs(G_t.mean(0) - G_j.mean(0)) / se
    assert (z < 4.0).all(), z
    assert (G_t.std(0) > 0).all()


# ------------------------------------------- the planner's simulation and G
def jax_habit_rollout_draws(ja, jp, k_scan, rows, depth):
    """HabitRolloutDraws of the rollout scan under ``k_scan`` (efe.py:356-368)."""
    steps = []
    for k in jax.random.split(k_scan, depth):
        k_pi, k_trans = jax.random.split(k)
        steps.append((t(jax.random.gumbel(k_pi, (rows, 4))), jax_mid_draws(ja, jp, k_trans, rows)))
    return tefe.HabitRolloutDraws(torch.stack([g for g, _ in steps]),
                                  [d.masks for _, d in steps],
                                  torch.stack([d.eps for _, d in steps]))


def jax_trajectory_draws(ja, jp, key, rows):
    """TrajectoryDraws of ``calculate_G_given_trajectory(key)`` (efe.py:312)."""
    _, k2, _, k4 = jax.random.split(key, 4)
    fresh = jax_mid_draws(ja, jp, k2, rows)
    return tefe.TrajectoryDraws(fresh.masks, fresh.eps, jax_normal(k4, rows))


def jax_simulate_draws(ja, jp, key, rows, depth):
    """SimulateDraws of ``mcts_step_simulate(key)`` (efe.py:354)."""
    k_scan, k_G = jax.random.split(key)
    return tefe.SimulateDraws(jax_habit_rollout_draws(ja, jp, k_scan, rows, depth),
                              jax_trajectory_draws(ja, jp, k_G, depth * rows))


def test_G_given_trajectory_matches_jax(flagship):
    """Row by row on a random trajectory of 12 rows; and term2_1 decodes
    the transition sample: zeroing that draw (the mean) moves G."""
    ja, jp, ta = flagship
    N = 12
    rng = np.random.default_rng(30)
    s0, ps1, mean, logvar = (rng.standard_normal((N, S_DIM)).astype(np.float32) * 0.5
                             for _ in range(4))
    pi = np.eye(4, dtype=np.float32)[rng.integers(0, 4, N)]
    key = jax.random.key(31)
    want = jax.jit(functools.partial(jefe.calculate_G_given_trajectory, ja))(
        jp, key, s0, ps1, mean, logvar, pi)
    draws = jax_trajectory_draws(ja, jp, key, N)
    args = [torch.from_numpy(x) for x in (s0, ps1, mean, logvar, pi)]
    with torch.inference_mode():
        got = tefe.calculate_G_given_trajectory(ta, *args, draws=draws)
        of_mean = tefe.calculate_G_given_trajectory(ta, *args, draws=tefe.TrajectoryDraws(
            draws.masks, torch.zeros_like(draws.eps), draws.eps_fixed))
    assert got.shape == (N,)
    close(got, want)
    assert (got - of_mean).abs().max() > 0.1


@pytest.mark.parametrize("use_means", [False, True])
def test_mcts_step_simulate_matches_jax(flagship, use_means):
    """G (the mean over depth of depth-major rows), the one-hot trajectory
    (equal) and Qpi_root (the habit output of the first step). The rollout
    threads the transition sample unless ``use_means``."""
    ja, jp, ta = flagship
    B, depth = 5, 3
    s = np.random.default_rng(32).standard_normal((B, S_DIM)).astype(np.float32) * 0.5
    key = jax.random.key(33)
    G_j, pi_j, q_j = jax.jit(functools.partial(
        jefe.mcts_step_simulate, ja, depth=depth, use_means=use_means))(jp, key, s)
    draws = jax_simulate_draws(ja, jp, key, B, depth)
    with torch.inference_mode():
        G, pi_tr, q = tefe.mcts_step_simulate(ta, torch.from_numpy(s), depth,
                                              use_means=use_means, draws=draws)
        _, q_first, _ = ta.habit(torch.from_numpy(s))
    assert G.shape == (B,) and pi_tr.shape == (depth, B, 4)
    close(G, G_j)
    np.testing.assert_array_equal(pi_tr.numpy(), np.asarray(pi_j))
    close(q, q_j, rtol=1e-5, atol=1e-6)
    assert torch.equal(q, q_first)


def test_mcts_step_simulate_own_draws_agree_with_jax(flagship):
    """Each package's own random draws: over 64 replicas of one leaf the
    mean of G agrees within 4 standard errors."""
    ja, jp, ta = flagship
    R = 64
    s = np.tile(np.random.default_rng(34).standard_normal((1, S_DIM)).astype(np.float32) * 0.5,
                (R, 1))
    with torch.inference_mode():
        G_t, _, _ = tefe.mcts_step_simulate(ta, torch.from_numpy(s), 3,
                                            generator=seeded_generator("cpu", 35))
    G_j, _, _ = jax.jit(functools.partial(jefe.mcts_step_simulate, ja, depth=3))(
        jp, jax.random.key(35), s)
    G_t, G_j = G_t.numpy(), np.asarray(G_j)
    se = np.sqrt(G_t.var(ddof=1) / R + G_j.var(ddof=1) / R)
    assert abs(G_t.mean() - G_j.mean()) / se < 4.0
    assert G_t.std() > 0
