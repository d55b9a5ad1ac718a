"""PyTorch port: dynamic-dSprites env rules against the JAX package,
exactly, with the JAX side's random draws (respawns, Gumbel noise)
injected into the port (mirrors tests/test_env.py)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deep_active_inference_mc_tpu.envs import dsprites as jenv
from deep_active_inference_mc_torch.envs import dsprites as tenv
from deep_active_inference_mc_torch.utils.device import resolve_device, seeded_generator


def jstate(lat, score, last_r):
    return jenv.EnvState(latents=jnp.asarray(lat, jnp.int32),
                         score=jnp.asarray(score, jnp.float32),
                         last_r=jnp.asarray(last_r, jnp.float32))


def tstate(lat, score, last_r):
    return tenv.EnvState(torch.as_tensor(np.asarray(lat), dtype=torch.long),
                         torch.as_tensor(np.asarray(score, np.float32)),
                         torch.as_tensor(np.asarray(last_r, np.float32)))


def assert_same(t, j):
    np.testing.assert_array_equal(t.latents.numpy(), np.asarray(j.latents))
    np.testing.assert_array_equal(t.score.numpy(), np.asarray(j.score))
    np.testing.assert_array_equal(t.last_r.numpy(), np.asarray(j.last_r))


def random_batch(B, seed):
    """Latents with many envs at the edges (posY 30/31, posX 0/15/16/31)."""
    rng = np.random.default_rng(seed)
    lat = np.stack([rng.integers(0, n, B) for n in tenv.LATENT_SIZES], -1)
    lat[: B // 2, 5] = rng.choice([0, 30, 31], B // 2)
    lat[: B // 2, 4] = rng.choice([0, 15, 16, 31], B // 2)
    score = rng.uniform(-10, 10, B).astype(np.float32)
    last_r = rng.uniform(-1, 1, B).astype(np.float32)
    return lat, score, last_r


# (latents kwargs, action): the cases of tests/test_env.py:35-135.
CASES = [
    (dict(pos_x=10, pos_y=20), a) for a in range(4)
] + [
    (dict(pos_x=31, pos_y=0), 2), (dict(pos_x=31, pos_y=0), 1), (dict(pos_x=0), 3),
    (dict(last_r=1.0), 0), (dict(shape=0, pos_x=4, pos_y=31, score=1.0), 0),
    (dict(shape=0, pos_x=20, pos_y=31), 0), (dict(shape=1, pos_x=20, pos_y=31), 0),
    (dict(shape=2, pos_x=4, pos_y=31), 0), (dict(pos_y=30), 0),
    (dict(shape=0, scale=5, orient=39, pos_x=4, pos_y=31, score=2.0), 0),
]


def case_state(shape=0, scale=3, orient=5, pos_x=10, pos_y=20, score=0.0, last_r=0.0):
    return [[0, shape, scale, orient, pos_x, pos_y]], [score], [last_r]


@pytest.mark.parametrize("kw,action", CASES)
def test_step_cases_match_jax(kw, action):
    lat, score, last_r = case_state(**kw)
    key = jax.random.key(3)
    jnew, jscored = jenv.step(key, jstate(lat, score, last_r), jnp.asarray([action]))
    respawn = torch.from_numpy(np.array(jenv.sample_latents(key, 1)))
    tnew, tscored = tenv.step(tstate(lat, score, last_r), torch.tensor([action]),
                              respawn=respawn)
    assert_same(tnew, jnew)
    assert bool(tscored[0]) == bool(jscored[0])


def test_step_batch_matches_jax():
    B = 64
    lat, score, last_r = random_batch(B, seed=0)
    actions = np.random.default_rng(1).integers(0, 4, B)
    key = jax.random.key(7)
    jnew, jscored = jenv.step(key, jstate(lat, score, last_r), jnp.asarray(actions))
    respawn = torch.from_numpy(np.array(jenv.sample_latents(key, B)))
    tnew, tscored = tenv.step(tstate(lat, score, last_r), torch.from_numpy(actions),
                              respawn=respawn)
    assert_same(tnew, jnew)
    np.testing.assert_array_equal(tscored.numpy(), np.asarray(jscored))
    assert tscored.any() and not tscored.all()


@pytest.mark.parametrize("kw,action", [
    (dict(pos_x=0, pos_y=29, last_r=1.0), 0),  # scores on the 3rd repeat
    (dict(pos_x=10, pos_y=0, last_r=1.0), 2),  # never scores
])
def test_step_repeated_cases_match_jax(kw, action):
    lat, score, last_r = case_state(**kw)
    key = jax.random.key(4)
    jnew, jdone = jenv.step_repeated(key, jstate(lat, score, last_r),
                                     jnp.asarray([action]), repeats=5)
    respawns = np.stack([np.asarray(jenv.sample_latents(k, 1))
                         for k in jax.random.split(key, 5)])
    tnew, tdone = tenv.step_repeated(tstate(lat, score, last_r), torch.tensor([action]),
                                     5, respawns=torch.from_numpy(respawns))
    assert_same(tnew, jnew)
    assert bool(tdone[0]) == bool(jdone[0])


def test_step_repeated_batch_matches_jax():
    B = 64
    lat, score, last_r = random_batch(B, seed=2)
    actions = np.random.default_rng(3).integers(0, 4, B)
    key = jax.random.key(9)
    jnew, jdone = jenv.step_repeated(key, jstate(lat, score, last_r),
                                     jnp.asarray(actions), repeats=5)
    respawns = np.stack([np.asarray(jenv.sample_latents(k, B))
                         for k in jax.random.split(key, 5)])
    tnew, tdone = tenv.step_repeated(tstate(lat, score, last_r), torch.from_numpy(actions),
                                     5, respawns=torch.from_numpy(respawns))
    assert_same(tnew, jnew)
    np.testing.assert_array_equal(tdone.numpy(), np.asarray(jdone))


def test_randomize_matches_jax_and_ranges():
    key = jax.random.key(1)
    j = jenv.randomize(key, jenv.reset(jax.random.key(0), 512))
    t = tenv.randomize(tstate(*random_batch(512, 0)),
                       draws=tuple(torch.from_numpy(np.array(x)) for x in
                                   (j.latents, j.score, j.last_r)))
    np.testing.assert_array_equal(t.latents.numpy(), np.asarray(j.latents))
    # The port's own draws (tests/test_env.py::test_randomize_ranges).
    gen = seeded_generator("cpu", 0)
    state = tenv.randomize(tenv.reset(gen, 512, "cpu"), gen)
    score, last_r, lat = state.score.numpy(), state.last_r.numpy(), state.latents.numpy()
    assert score.min() >= -10 and score.max() <= 10 and score.std() > 3
    assert last_r.min() >= -1 and last_r.max() <= 1 and last_r.std() > 0.3
    for i, n in enumerate(tenv.LATENT_SIZES):
        assert lat[:, i].min() >= 0 and lat[:, i].max() == n - 1


def test_expert_policy_autoplay_and_factors_match_jax():
    B = 32
    lat, score, last_r = random_batch(B, seed=4)
    js, ts = jstate(lat, score, last_r), tstate(lat, score, last_r)
    np.testing.assert_array_equal(tenv.expert_policy(ts).numpy(),
                                  np.asarray(jenv.expert_policy(js)))
    np.testing.assert_array_equal(tenv.ground_truth_factors(ts).numpy(),
                                  np.asarray(jenv.ground_truth_factors(js)))
    key = jax.random.key(5)
    jnew, ja = jenv.auto_play(key, js)
    k_pi, k_step = jax.random.split(key)
    tnew, ta = tenv.auto_play(
        ts, noise=torch.from_numpy(np.array(jax.random.gumbel(k_pi, (B, 4)))),
        respawn=torch.from_numpy(np.array(jenv.sample_latents(k_step, B))))
    np.testing.assert_array_equal(ta.numpy(), np.asarray(ja))
    assert_same(tnew, jnew)
    a = jnp.asarray([0, 1, 2, 1])
    np.testing.assert_array_equal(tenv.to_env_actions(torch.tensor([0, 1, 2, 1]), 3).numpy(),
                                  np.asarray(jenv.to_env_actions(a, 3)))


def test_expert_autoplay_improves_score():
    gen = seeded_generator("cpu", 1)
    state = tenv.reset(gen, 256, "cpu")
    for _ in range(300):
        state, _ = tenv.auto_play(state, gen)
    assert float(state.score.mean()) > 1.0


def test_cuda_request_raises_without_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="cuda"):
        resolve_device("cuda")
    resolve_device("cpu")
