"""PyTorch port: the controller sweep (the slice as a whole) against a
replay of the JAX macro step (train/sweep.py:287-295) built from the JAX
package's functions, on the converted flagship, with the same Gumbel
noise, respawns and G noise injected on both sides; and the sweep CLI."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deep_active_inference_mc_tpu.envs import dsprites as jenv
from deep_active_inference_mc_tpu.envs import raster as jraster
from deep_active_inference_mc_torch.apps import sweep as tsweep_app
from deep_active_inference_mc_torch.config import Config
from deep_active_inference_mc_torch.envs import dsprites as tenv
from deep_active_inference_mc_torch.envs import raster as traster
from deep_active_inference_mc_torch.infer import efe as tefe
from deep_active_inference_mc_torch.train import sweep as tsweep
from deep_active_inference_mc_torch.utils.device import seeded_generator
from test_torch_efe import G_TOL, draws, oracle_G_mean, to_torch
from test_torch_models import few_torch_threads  # noqa: F401 (autouse fixture)
from test_torch_models import jax_flagship, torch_agent

JUMPS = 5
_render = jax.jit(jenv.render)
_step_repeated = jax.jit(jenv.step_repeated, static_argnames="repeats")


@pytest.fixture(scope="module")
def flagship():
    agent, params = jax_flagship()
    return agent, params, torch_agent(params)


@pytest.fixture(scope="module")
def luts():
    return jraster.build_sprite_lut(), traster.build_sprite_lut("cpu")


def start(B, seed):
    """The same random envs in both packages, scores zeroed as the sweep
    zeroes them (sweep.py:284-285)."""
    gen = seeded_generator("cpu", seed)
    t = tenv.randomize(tenv.reset(gen, B, "cpu"), gen)
    t = t.replace(score=torch.zeros(B))
    j = jenv.EnvState(latents=jnp.asarray(t.latents.numpy(), jnp.int32),
                      score=jnp.zeros(B, jnp.float32), last_r=jnp.asarray(t.last_r.numpy()))
    return t, j


def jax_step(key, state, logits, gumbel):
    """Sample by Gumbel-max with the injected noise (jax.random.categorical's
    construction), then step with action-repeat; returns the step's
    respawns as the port takes them."""
    a = jenv.to_env_actions(jnp.argmax(logits + gumbel, axis=-1), 4)
    state, scored = _step_repeated(key, state, a, repeats=JUMPS)
    B = state.batch
    respawns = np.stack([np.asarray(jenv.sample_latents(k, B))
                         for k in jax.random.split(key, JUMPS)])
    return state, scored, torch.from_numpy(respawns)


def assert_same_env(t, j):
    np.testing.assert_array_equal(t.latents.numpy(), np.asarray(j.latents))
    np.testing.assert_allclose(t.score.numpy(), np.asarray(j.score), rtol=0, atol=1e-6)
    np.testing.assert_allclose(t.last_r.numpy(), np.asarray(j.last_r), rtol=0, atol=1e-6)


def test_habit_sweep_matches_jax_replay(flagship, luts):
    ja, jp, ta = flagship
    jlut, tlut = luts
    B, T = 16, 8
    tstate, jstate = start(B, seed=0)
    gumbels = np.random.default_rng(1).gumbel(size=(T, B, 4)).astype(np.float32)
    habit = jax.jit(ja.habitual_net)
    macro_draws, events = [], 0
    for t, key in enumerate(jax.random.split(jax.random.key(2), T)):
        q_pi = habit(jp, _render(jlut, jstate))
        jstate, scored, respawns = jax_step(key, jstate, jnp.log(q_pi + 1e-20), gumbels[t])
        events += int(scored.sum())
        macro_draws.append(tsweep.MacroDraws(torch.from_numpy(gumbels[t]), respawns))
    run = tsweep.make_sweep(ta, Config(), tlut, method="habit", n_macro_steps=T, jumps=JUMPS)
    out = run(None, tstate, draws=macro_draws)
    assert_same_env(out["env"], jstate)
    assert out["scoring_events"] == events > 0
    np.testing.assert_allclose(out["score_mean"], float(jstate.score.mean()), atol=1e-6)


def test_ai_macro_step_matches_jax_replay(flagship, luts):
    ja, jp, ta = flagship
    jlut, tlut = luts
    B, A = 16, 4
    tstate, jstate = start(B, seed=3)
    gumbel = np.random.default_rng(4).gumbel(size=(B, A)).astype(np.float32)
    d = draws(B * A, seed=5, sampled=False)
    rollout = tefe.RolloutDraws(None, [to_torch(d)])

    jo = jenv.render(jlut, jstate)
    s, _ = ja.encode(jp, jo)
    G_o, _, _ = oracle_G_mean(ja, jp, jnp.repeat(s, A, axis=0),
                              jnp.tile(jnp.eye(A), (B, 1)), *d[:3])
    G_o = G_o.reshape(B, A)
    with torch.inference_mode():
        o = tenv.render(tlut, tstate)
        np.testing.assert_array_equal(o.numpy().reshape(jo.shape), np.asarray(jo))
        G, _, _ = tefe.calculate_G_4_repeated(ta, o, steps=1, calc_mean=True,
                                              samples=1, draws=rollout)
    np.testing.assert_allclose(G.numpy(), np.asarray(G_o), **G_TOL)

    jstate, scored, respawns = jax_step(jax.random.key(6), jstate, -G_o / 1.0, gumbel)
    run = tsweep.make_sweep(ta, Config(), tlut, method="ai", n_macro_steps=1, jumps=JUMPS,
                            steps=1, samples=1, temperature=1.0, calc_mean=True)
    out = run(None, tstate, draws=[tsweep.MacroDraws(torch.from_numpy(gumbel), respawns,
                                                     rollout)])
    assert_same_env(out["env"], jstate)
    assert out["scoring_events"] == int(scored.sum())


def test_sweep_cli_prints_its_row(capsys):
    out = tsweep_app.main(["--device", "cpu", "--envs", "8", "--macro", "3"])
    row = capsys.readouterr().out.strip().splitlines()[-1]
    assert row.startswith("method=ai ckpt=untrained seed=0 envs=8 macro=3 score: ")
    assert "scoring_events=" in row and "env_steps/s=" in row
    assert out["scores"].shape == (8,) and torch.isfinite(out["scores"]).all()


def test_sweep_cli_refuses_cuda_without_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="cuda"):
        tsweep_app.main(["--envs", "8", "--macro", "1"])


@pytest.mark.parametrize("method", ["t1", "t12", "random", "expert"])
def test_other_controllers_and_plan_queue_run(method):
    """Every ported controller runs, with chunking, env groups and (for the
    EFE controllers) the plan queue; seeded runs repeat exactly."""
    agent = tsweep_app.build_agent(Config(), "", torch.device("cpu"))
    lut = traster.build_sprite_lut("cpu")
    kw = dict(seed=1, n_envs=4, n_macro_steps=3, chunk=2, env_chunk=2, method=method,
              steps=2, plan_queue=True, queue_cap=1, crn=method == "t12")
    out = tsweep.run_sweep(agent, Config(), lut, **kw)
    assert out["scores"].shape == (4,) and torch.isfinite(out["scores"]).all()
    again = tsweep.run_sweep(agent, Config(), lut, **kw)
    assert torch.equal(out["env"].latents, again["env"].latents)
