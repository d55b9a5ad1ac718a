"""PyTorch port: the controller sweep (the slice as a whole) against a
replay of the JAX macro step (train/sweep.py:287-295) built from the JAX
package's functions, on the converted flagship, with the same Gumbel
noise, respawns and G noise injected on both sides; the plan queue and the
mcts controller's plumbing on a stubbed planner (the planner itself is held
in tests/test_torch_mcts.py); the bucketed sweep; and the sweep CLI."""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deep_active_inference_mc_tpu.envs import dsprites as jenv
from deep_active_inference_mc_tpu.envs import raster as jraster
from deep_active_inference_mc_tpu.plan import mcts as jmcts
from deep_active_inference_mc_tpu.train import sweep as jsweep
from deep_active_inference_mc_torch.apps import sweep as tsweep_app
from deep_active_inference_mc_torch.config import Config
from deep_active_inference_mc_torch.envs import dsprites as tenv
from deep_active_inference_mc_torch.envs import raster as traster
from deep_active_inference_mc_torch.infer import efe as tefe
from deep_active_inference_mc_torch.plan import mcts as tmcts
from deep_active_inference_mc_torch.train import sweep as tsweep
from deep_active_inference_mc_torch.utils.device import seeded_generator
from test_torch_efe import G_TOL, draws, oracle_G_mean, to_torch
from test_torch_models import few_torch_threads  # noqa: F401 (autouse fixture)
from test_torch_models import VARIANTS, jax_flagship, seeded_variant, torch_agent

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
    a = jenv.to_env_actions(jnp.argmax(logits + gumbel, axis=-1), logits.shape[-1])
    state, scored = _step_repeated(key, state, a, repeats=JUMPS)
    B = state.batch
    respawns = np.stack([np.asarray(jenv.sample_latents(k, B))
                         for k in jax.random.split(key, JUMPS)])
    return state, scored, torch.from_numpy(respawns)


def assert_same_env(t, j):
    np.testing.assert_array_equal(t.latents.numpy(), np.asarray(j.latents))
    np.testing.assert_allclose(t.score.numpy(), np.asarray(j.score), rtol=0, atol=1e-6)
    np.testing.assert_allclose(t.last_r.numpy(), np.asarray(j.last_r), rtol=0, atol=1e-6)


def habit_replay(flagship, luts, B, T):
    """T habit macro steps of the JAX package from ``start(B, 0)``: the
    port's start state and injected draws, and the JAX end state, event
    count and fleet-mean score after each macro step."""
    ja, jp, _ = flagship
    jlut, _ = luts
    tstate, jstate = start(B, seed=0)
    gumbels = np.random.default_rng(1).gumbel(size=(T, B, 4)).astype(np.float32)
    habit = jax.jit(ja.habitual_net)
    macro_draws, events, traj = [], 0, []
    for t, key in enumerate(jax.random.split(jax.random.key(2), T)):
        q_pi = habit(jp, _render(jlut, jstate))
        jstate, scored, respawns = jax_step(key, jstate, jnp.log(q_pi + 1e-20), gumbels[t])
        events += int(scored.sum())
        traj.append(float(jstate.score.mean()))
        macro_draws.append(tsweep.MacroDraws(torch.from_numpy(gumbels[t]), respawns))
    return tstate, macro_draws, jstate, events, traj


def test_habit_sweep_matches_jax_replay(flagship, luts):
    B, T = 16, 8
    tstate, macro_draws, jstate, events, _ = habit_replay(flagship, luts, B, T)
    run = tsweep.make_sweep(flagship[2], Config(), luts[1], method="habit", n_macro_steps=T,
                            jumps=JUMPS)
    out = run(None, tstate, draws=macro_draws)
    assert_same_env(out["env"], jstate)
    assert out["scoring_events"] == events > 0
    np.testing.assert_allclose(out["score_mean"], float(jstate.score.mean()), atol=1e-6)
    assert "score_traj" not in out


def test_score_traj_matches_jax_replay(flagship, luts):
    """``record_traj``: the fleet-mean score after each macro step, against
    the JAX replay's (the sixth tally, train/sweep.py:227-231)."""
    B, T = 16, 8
    tstate, macro_draws, jstate, _, traj = habit_replay(flagship, luts, B, T)
    run = tsweep.make_sweep(flagship[2], Config(), luts[1], method="habit", n_macro_steps=T,
                            jumps=JUMPS, record_traj=True)
    out = run(None, tstate, draws=macro_draws)
    assert out["score_traj"].shape == (T,)
    np.testing.assert_allclose(out["score_traj"].numpy(), traj, rtol=0, atol=1e-6)
    np.testing.assert_allclose(out["score_traj"][-1], out["score_mean"], atol=1e-6)
    assert len(set(traj)) > 1


@pytest.mark.parametrize("env_chunk", [None, 16])
def test_score_traj_spans_chunks_and_env_groups(env_chunk):
    """run_sweep concatenates the chunks' trajectories and averages the env
    groups' (tests/test_sweep.py:139-161)."""
    agent = tsweep_app.build_agent(Config(), "", torch.device("cpu"))
    out = tsweep.run_sweep(agent, Config(), traster.build_sprite_lut("cpu"), seed=5, n_envs=32,
                           method="random", n_macro_steps=12, chunk=5, jumps=5,
                           record_traj=True, env_chunk=env_chunk)
    assert out["score_traj"].shape == (12,)
    np.testing.assert_allclose(out["score_traj"][-1], out["score_mean"], rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("variant", ["flagship", *VARIANTS])
def test_ai_macro_step_matches_jax_replay(flagship, luts, variant):
    """One ai macro step against the JAX package's functions: on the
    flagship, and on a seeded init in each variant configuration (the
    frames at its resolution and channels, G over its actions, the env
    actions of its action set)."""
    dims = VARIANTS.get(variant, {})
    ja, jp, ta = seeded_variant(**dims) if dims else flagship
    cfg = Config(**dims)
    jlut, tlut = luts
    B, A = 16, cfg.pi_dim
    tstate, jstate = start(B, seed=3)
    gumbel = np.random.default_rng(4).gumbel(size=(B, A)).astype(np.float32)
    d = draws(B * A, seed=5, sampled=False)
    rollout = tefe.RolloutDraws(None, [to_torch(d)])

    jo = jenv.render_obs(jlut, jstate, cfg.resolution, cfg.colour_channels)
    s, _ = ja.encode(jp, jo)
    G_o, _, _ = oracle_G_mean(ja, jp, jnp.repeat(s, A, axis=0),
                              jnp.tile(jnp.eye(A), (B, 1)), *d[:3])
    G_o = G_o.reshape(B, A)
    with torch.inference_mode():
        o = tenv.render_obs(tlut, tstate, cfg.resolution, cfg.colour_channels)
        np.testing.assert_array_equal(o.permute(0, 2, 3, 1).numpy(), np.asarray(jo))
        G, _, _ = tefe.calculate_G_4_repeated(ta, o, steps=1, calc_mean=True,
                                              samples=1, draws=rollout)
    np.testing.assert_allclose(G.numpy(), np.asarray(G_o), **G_TOL)

    jstate, scored, respawns = jax_step(jax.random.key(6), jstate, -G_o / 1.0, gumbel)
    run = tsweep.make_sweep(ta, cfg, tlut, method="ai", n_macro_steps=1, jumps=JUMPS,
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


# ------------------------------------------------- the mcts controller
def fake_result(B, lengths, max_depth=5, seed=0):
    """A planner result, as numpy, with the given path lengths."""
    rng = np.random.default_rng(seed)
    actions = rng.integers(0, 4, (B, max_depth))
    actions[np.arange(max_depth)[None, :] >= np.asarray(lengths)[:, None]] = -1
    root_N = rng.integers(1, 9, (B, 4)).astype(np.float32)
    root_N[1] = 3.0  # a tie: the first maximum wins in both packages
    zeros = np.zeros(B, np.int32)
    return dict(actions=actions, lengths=np.asarray(lengths), repeats_done=zeros,
                states_explored=zeros, depth_capped=zeros, root_N=root_N,
                root_Qpi=np.full((B, 4), 0.25, np.float32), all_paths=None, all_paths_G=None)


def test_mcts_decision_matches_jax(monkeypatch):
    """The first action of the trimmed path, the visit-max root action for
    an empty path, and the plan handed to the queue, against the JAX
    sweep's two mcts branches (train/sweep.py:63-71, 108-115) on the same
    planner result."""
    B = 6
    res = fake_result(B, [3, 0, 1, 0, 5, 2])
    as_j = {k: None if v is None else jnp.asarray(v, jnp.int32 if v.dtype.kind == "i" else None)
            for k, v in res.items()}
    as_t = {k: None if v is None else torch.from_numpy(v) for k, v in res.items()}
    monkeypatch.setattr(jsweep.mcts_lib, "active_inference_mcts",
                        lambda *a, **kw: jmcts.MCTSResult(**as_j))
    # The port's sweep plans with the planner it built (make_jit_planner's plan).
    planner = lambda *a, **kw: tmcts.MCTSResult(**as_t)
    o = torch.zeros(B, 1, 64, 64)
    a_j = jsweep._controller_actions(None, None, None, None, None, "mcts", 1, 1, 1.0, None, True)
    q_j, len_j = jsweep._controller_plan(None, None, None, None, "mcts", 1, 1, 1.0, None, True)
    a_t = tsweep._controller_actions(None, None, o, None, "mcts", 1, 1, 1.0, planner, True)
    q_t, len_t = tsweep._controller_plan(None, None, o, None, "mcts", 1, 1, 1.0, planner, True)
    np.testing.assert_array_equal(a_t.numpy(), np.asarray(a_j))
    np.testing.assert_array_equal(q_t.numpy(), np.asarray(q_j))
    np.testing.assert_array_equal(len_t.numpy(), np.asarray(len_j))
    assert a_t[1] == 0 and (len_t >= 1).all()  # the empty path's tie, and no empty plan
    assert torch.equal(as_t["actions"], torch.from_numpy(res["actions"]))  # not written


def queue_oracle(tstate, respawns, plan_of, macros, jumps):
    """Hand-stepped queue semantics: one plan entry per macro step, a new
    plan when the queue ran out, a flush on scoring."""
    env = tstate
    B = env.batch
    plans = [None] * B
    qpos = np.zeros(B, np.int64)
    for t in range(macros):
        for b in range(B):
            if plans[b] is None or qpos[b] >= len(plans[b]):
                plans[b], qpos[b] = plan_of(t, b), 0
        a = torch.tensor([plans[b][qpos[b]] for b in range(B)])
        qpos += 1
        env, scored = tenv.step_repeated(env, tenv.to_env_actions(a, 4), jumps,
                                         respawns=respawns[t])
        for b in np.nonzero(scored.numpy())[0]:
            plans[b] = None
    return env


FOUR_ACTIONS = types.SimpleNamespace(pi_dim=4)  # all the sweep asks of a stubbed agent


def stub_planner(monkeypatch, plan_of, max_depth):
    """Replace the sweep's planner call by ``plan_of(t, b) -> list``; t is
    the macro step, read from the planner's seed path."""
    def fake(agent, o, planner, seed_path, draws):
        B = o.shape[0]
        path = torch.full((B, max_depth), -1, dtype=torch.long)
        lengths = torch.zeros(B, dtype=torch.long)
        for b in range(B):
            plan = plan_of(seed_path[-1], b)
            path[b, :len(plan)] = torch.tensor(plan)
            lengths[b] = len(plan)
        return path, lengths
    monkeypatch.setattr(tsweep, "_mcts_plan", fake)


def sweep_inputs(B, macros, jumps, seed):
    gen = seeded_generator("cpu", seed)
    tstate, _ = start(B, seed)
    respawns = torch.stack([torch.stack([tenv.sample_latents(gen, B, "cpu")
                                         for _ in range(jumps)]) for _ in range(macros)])
    return tstate, respawns


@pytest.mark.parametrize("queue_cap", [0, 2])
def test_plan_queue_executes_the_mcts_plan(monkeypatch, luts, queue_cap):
    """The whole plan (or its first ``queue_cap`` entries) executes one
    entry per macro step, and scoring flushes it
    (tests/test_sweep.py:171)."""
    B, macros, jumps, depth = 8, 9, 4, 5
    plan_of = lambda t, b: [0, 0, 3] if b % 2 else [0, 2, 0, 0]  # mostly up: envs score
    stub_planner(monkeypatch, plan_of, depth)
    tstate, respawns = sweep_inputs(B, macros, jumps, seed=7)
    run = tsweep.make_sweep(FOUR_ACTIONS, Config(), luts[1], method="mcts",
                            n_macro_steps=macros, jumps=jumps, plan_queue=True, queue_cap=queue_cap,
                            mcts_params=tmcts.MCTSParams(repeats=2, max_depth=depth))
    draws = [tsweep.MacroDraws(None, respawns[t]) for t in range(macros)]
    # The stub reads the macro step from the seed path, so give the run a generator.
    out = run(seeded_generator("cpu", 0), tstate, draws=draws)
    executed = (lambda t, b: plan_of(t, b)[:queue_cap]) if queue_cap else plan_of
    want = queue_oracle(tstate, respawns, executed, macros, jumps)
    assert torch.equal(out["env"].latents, want.latents)
    torch.testing.assert_close(out["env"].score, want.score, rtol=0, atol=1e-6)
    queue, qlen, qpos = out["qstate"]
    assert queue.shape == (B, queue_cap or depth)
    assert ((qpos >= 0) & (qpos <= qlen)).all()
    assert set(qlen.tolist()) == ({queue_cap} if queue_cap else {3, 4})
    assert out["scoring_events"] > 0  # the flush was exercised


def test_queue_cap_one_is_replanning_every_macro(monkeypatch, luts):
    """queue_cap=1 reduces the queue protocol to per-macro re-planning: the
    same trajectory as plan_queue=False (tests/test_sweep.py:252)."""
    B, macros, jumps, depth = 8, 6, 2, 5
    plan_of = lambda t, b: [(b + t) % 4, (b + t + 1) % 4, (b + t + 2) % 4]
    stub_planner(monkeypatch, plan_of, depth)
    tstate, respawns = sweep_inputs(B, macros, jumps, seed=11)
    draws = [tsweep.MacroDraws(None, respawns[t]) for t in range(macros)]
    kw = dict(method="mcts", n_macro_steps=macros, jumps=jumps,
              mcts_params=tmcts.MCTSParams(repeats=2, max_depth=depth))
    capped = tsweep.make_sweep(FOUR_ACTIONS, Config(), luts[1], plan_queue=True, queue_cap=1, **kw)(
        seeded_generator("cpu", 0), tstate, draws=draws)
    plain = tsweep.make_sweep(FOUR_ACTIONS, Config(), luts[1], plan_queue=False, **kw)(
        seeded_generator("cpu", 0), tstate, draws=draws)
    assert torch.equal(capped["env"].latents, plain["env"].latents)
    assert capped["qstate"][0].shape == (B, 1) and (capped["qstate"][1] == 1).all()
    assert "qstate" not in plain


@pytest.mark.parametrize("plan_queue", [False, True])
def test_run_sweep_bucketed_runs(plan_queue):
    """The bucketed sweep at 8 envs: finite scores, one bucket trace per
    plan, at most one plan per macro step; a seeded run repeats exactly."""
    agent = tsweep_app.build_agent(Config(), "", torch.device("cpu"))
    lut = traster.build_sprite_lut("cpu")
    kw = dict(seed=6, n_envs=8, n_macro_steps=3, jumps=2, check_every=2, min_bucket=4,
              mcts_params=tmcts.MCTSParams(repeats=3, simulation_depth=1, max_depth=8),
              plan_queue=plan_queue, queue_cap=2 if plan_queue else 0)
    out = tsweep.run_sweep_bucketed(agent, Config(), lut, **kw)
    assert out["scores"].shape == (8,) and torch.isfinite(out["scores"]).all()
    traces = out["bucket_traces"]
    assert 1 <= len(traces) <= 3 and (plan_queue or len(traces) == 3)
    assert traces[0][0] == 8 and all(b >= 4 for tr in traces for b in tr)
    again = tsweep.run_sweep_bucketed(agent, Config(), lut, **kw)
    assert torch.equal(out["env"].latents, again["env"].latents)
    assert again["bucket_traces"] == traces


MCTS_CLI = ["--device", "cpu", "--method", "mcts", "--envs", "8", "--macro", "2",
            "--mcts_repeats", "6"]


@pytest.mark.parametrize("flags, label", [
    ([], "mcts"),
    (["--mcts_fused", "--mcts_c", "2", "--mcts_prior_explore", "--mcts_habit",
      "--mcts_threshold", "0.4", "--mcts_depth", "2"], "mcts"),
    (["--mcts_crn", "--plan_queue", "--queue_cap", "2"], "mcts+queuecap2"),
    (["--mcts_bucketed", "--mcts_check_every", "2", "--mcts_min_bucket", "4"], "mcts"),
    (["--mcts_bucketed", "--plan_queue", "--mcts_min_bucket", "4"], "mcts+queue"),
], ids=["plain", "fused-and-knobs", "crn-queue", "bucketed", "bucketed-queue"])
def test_mcts_cli_prints_its_row(capsys, flags, label):
    out = tsweep_app.main(MCTS_CLI + flags)
    row = capsys.readouterr().out.strip().splitlines()[-1]
    assert row.startswith(f"method={label} ckpt=untrained seed=0 envs=8 macro=2 score: ")
    assert out["scores"].shape == (8,) and torch.isfinite(out["scores"]).all()
    assert ("bucket_traces" in out) == ("--mcts_bucketed" in flags)


def test_mcts_cli_refusals():
    with pytest.raises(SystemExit, match="--mcts_bucketed requires --method mcts"):
        tsweep_app.main(["--device", "cpu", "--method", "ai", "--mcts_bucketed"])
    for flags in (["--mesh", "2"], ["--bf16"]):  # both run
        out = tsweep_app.main(MCTS_CLI + flags)
        assert out["scores"].shape == (8,) and torch.isfinite(out["scores"]).all()
    assert tsweep.make_sweep(None, Config(), None, method="mcts") is not None
    with pytest.raises(ValueError, match="not in"):
        tsweep.make_sweep(None, Config(), None, method="mctz")
