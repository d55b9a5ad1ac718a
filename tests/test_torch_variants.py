"""PyTorch port: the agent-configuration variants of tests/test_variants.py
(the 3-action Animal-AI action set, 32x32 frames, 3 colour channels)
against the JAX package's functions on a seeded init, with the JAX noise
rebuilt from its key and injected (``test_torch_efe`` /
``test_torch_losses`` helpers). G holds to rtol 1e-4 / atol 1e-2, decoded
frames and habit outputs to 1e-4. The two end-to-end training tests are
``slow``, as the JAX file marks them; the round, the eval pass and a sweep
macro step are held per variant in tests/test_torch_{loop,evaluate,sweep}.py.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deep_active_inference_mc_tpu.infer import efe as jefe
from deep_active_inference_mc_torch.config import Config
from deep_active_inference_mc_torch.envs import dsprites as tenv
from deep_active_inference_mc_torch.envs import raster as traster
from deep_active_inference_mc_torch.infer import efe as tefe
from deep_active_inference_mc_torch.infer.precision import PrecisionState
from deep_active_inference_mc_torch.train import evaluate as teval
from deep_active_inference_mc_torch.train import loop as tloop
from deep_active_inference_mc_torch.train import sweep as tsweep
from deep_active_inference_mc_torch.utils.device import seeded_generator
from test_torch_efe import G_TOL, close, jax_simulate_draws
from test_torch_losses import jax_rollout_draws
from test_torch_models import few_torch_threads  # noqa: F401 (autouse fixture)
from test_torch_models import nchw, seeded_variant


def test_three_action_agent_efe():
    """tests/test_variants.py::test_three_action_agent_efe on both packages:
    G of the 3 actions at 32x32, the imagined frames, and the 32-res reward
    check, which prefers the template."""
    ja, jp, ta = seeded_variant(pi_dim=3, resolution=32)
    o = jax.random.uniform(jax.random.key(1), (4, 32, 32, 1))
    key = jax.random.key(2)
    G_j, _, po1_j = jefe.calculate_G_4_repeated(ja, jp, key, o, steps=1, calc_mean=True)
    with torch.inference_mode():
        G, _, po1 = tefe.calculate_G_4_repeated(
            ta, nchw(o), steps=1, calc_mean=True, samples=1,
            draws=jax_rollout_draws(ja, jp, key, 4 * 3, 1, sampled=False))
    assert G.shape == (4, 3) and po1.shape == (4 * 3, 1, 32, 32)
    assert bool(torch.isfinite(G).all())
    close(G, G_j)
    close(po1.permute(0, 2, 3, 1), po1_j, rtol=1e-4, atol=1e-4)

    good = np.zeros((1, 32, 32, 1), np.float32)
    good[:, 0:3, 0:16] = 1.0
    bad = np.zeros((1, 32, 32, 1), np.float32)
    bad[:, 0:3, 16:32] = 1.0
    with torch.inference_mode():
        r_good, r_bad = ta.check_reward(nchw(good)), ta.check_reward(nchw(bad))
    assert float(r_good[0]) > float(r_bad[0])
    close(r_good, ja.check_reward(jnp.asarray(good)), rtol=1e-5, atol=1e-5)
    close(r_bad, ja.check_reward(jnp.asarray(bad)), rtol=1e-5, atol=1e-5)


def test_three_action_habit_and_sim():
    """tests/test_variants.py::test_three_action_habit_and_sim on both
    packages: the habit rollout over 3 actions, scored by trajectory G."""
    ja, jp, ta = seeded_variant(pi_dim=3, resolution=32)
    s = jax.random.normal(jax.random.key(1), (2, 10))
    key = jax.random.key(2)
    G_j, pi_j, q_j = jax.jit(functools.partial(jefe.mcts_step_simulate, ja, depth=2))(
        jp, key, s)
    with torch.inference_mode():
        G, pi_tr, q_root = tefe.mcts_step_simulate(
            ta, torch.from_numpy(np.array(s)), 2, draws=jax_simulate_draws(ja, jp, key, 2, 2))
    assert pi_tr.shape == (2, 2, 3) and q_root.shape == (2, 3)
    np.testing.assert_allclose(q_root.sum(-1).numpy(), 1.0, rtol=1e-5)
    close(G, G_j)
    np.testing.assert_array_equal(pi_tr.numpy(), np.asarray(pi_j))
    close(q_root, q_j, rtol=1e-5, atol=1e-6)


def finite(tag, tree):
    for k, v in tree.items():
        if isinstance(v, torch.Tensor):
            assert bool(torch.isfinite(v).all()), (tag, k)
        elif isinstance(v, float):
            assert np.isfinite(v), (tag, k)


@pytest.mark.slow
def test_three_action_32res_smoke_training():
    """tests/test_variants.py::test_three_action_32res_smoke_training on the
    port: two tiny epochs of the training round at resolution 32 / pi_dim
    3, the eval pass and a 3-action ai sweep, finite everywhere."""
    cfg = Config(resolution=32, pi_dim=3, batch=4, rounds=2, test_size=8, samples=1, repeats=2)
    _, _, agent = seeded_variant(pi_dim=3, resolution=32)
    lut = traster.build_sprite_lut("cpu")
    gen = seeded_generator("cpu", 0)
    state = tloop.create_train_state(cfg, agent, gen, "cpu")
    epoch_fn = tloop.make_epoch_fn(cfg, lut, cfg.rounds)
    for _ in range(2):
        state, metrics = epoch_fn(state, gen)
    finite("epoch", metrics)

    ev = teval.make_eval(agent, cfg, lut)(state.precision, gen)
    assert ev["o0"].shape[1:] == (1, 32, 32)
    assert np.isfinite(float(ev["F"])) and np.isfinite(float(ev["mse_r"]))

    sweep = tsweep.make_sweep(agent, cfg, lut, method="ai", n_macro_steps=3, jumps=2)
    g = seeded_generator("cpu", 4)
    env = tenv.randomize(tenv.reset(g, 8, "cpu"), g)
    out = sweep(seeded_generator("cpu", 5), env)
    assert np.isfinite(out["score_mean"])


@pytest.mark.slow
def test_colour_channels_end_to_end(tmp_path):
    """tests/test_variants.py::test_colour_channels_end_to_end on the port:
    3-channel frames from the env, one training epoch, the eval pass and
    the colour reconstruction strip, at colour_channels 3."""
    from deep_active_inference_mc_torch.viz.reconstructions_plot import reconstructions_plot

    cfg = Config(resolution=32, colour_channels=3, batch=4, rounds=2, test_size=8, samples=1,
                 repeats=2)
    _, _, agent = seeded_variant(resolution=32, colour_channels=3)
    lut = traster.build_sprite_lut("cpu")
    g = seeded_generator("cpu", 0)
    env = tenv.randomize(tenv.reset(g, 4, "cpu"), g)
    assert tenv.render_obs(lut, env, cfg.resolution, cfg.colour_channels).shape == (4, 3, 32, 32)

    gen = seeded_generator("cpu", 1)
    state = tloop.create_train_state(cfg, agent, gen, "cpu")
    state, metrics = tloop.make_epoch_fn(cfg, lut, cfg.rounds)(state, gen)
    finite("epoch", metrics)

    ev = teval.make_eval(agent, cfg, lut)(PrecisionState.create(), gen)
    assert ev["o0"].shape[1:] == (3, 32, 32) and ev["po1"].shape[1] == 3
    assert np.isfinite(float(ev["F"]))
    for k in ("edge_habit_correct", "edge_g_correct"):
        assert np.isfinite(float(ev[k]))
    out = tmp_path / "recon_colour.png"
    nhwc = lambda x: x.permute(0, 2, 3, 1).cpu().numpy()
    reconstructions_plot(nhwc(ev["o0"]), nhwc(ev["o1"]), nhwc(ev["po1"]), filename=out,
                         colour=True)
    assert out.exists() and out.stat().st_size > 0
