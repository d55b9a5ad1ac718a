"""PyTorch port: the benchmark harness ``deep_active_inference_mc_torch/bench.py``
against the JAX package's ``bench.py``.

- The env-step body (step, render, checksum) equals ``bench.py``'s scan body
  on the same actions and respawns.
- Every MCTS key's ``MCTSParams`` and every training key's ``Config`` equal
  what ``bench.py`` builds for the same key. Both ``main``s run with their
  planners and training epochs stubbed, so only what they build is compared.
- Each ``bench_*`` function at a tiny size on the CPU returns a positive,
  finite rate, and under a fake clock the rate is ``bench.py``'s work count
  over the time.
- The stdout keys are ``bench.py``'s (read from its source) plus
  ``"device"``; without a card ``main`` raises.
"""

import ast
import contextlib
import dataclasses
import importlib.util
import io
import json
import math
import shutil
import types
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deep_active_inference_mc_tpu.envs import dsprites as jenv
from deep_active_inference_mc_tpu.envs import raster as jraster
from deep_active_inference_mc_tpu.plan import mcts as jmcts
from deep_active_inference_mc_tpu.train import loop as jloop
from deep_active_inference_mc_tpu.utils import compcache as jcompcache
from deep_active_inference_mc_torch import bench
from deep_active_inference_mc_torch.config import Config
from deep_active_inference_mc_torch.envs import dsprites as tenv
from deep_active_inference_mc_torch.envs import raster as traster
from deep_active_inference_mc_torch.plan import mcts as tmcts
from deep_active_inference_mc_torch.train import loop as tloop
from deep_active_inference_mc_torch.utils import convert

ROOT = Path(__file__).resolve().parent.parent
JAX_BENCH = ROOT / "bench.py"
CPU = torch.device("cpu")

MCTS_KEYS = (
    "mcts_plans_per_sec", "mcts_plans_per_sec_fused", "mcts_plans_per_sec_fused_bf16",
    "mcts_plans_per_sec_ref_budget", "mcts_plans_per_sec_ref_budget_k4",
    "mcts_plans_per_sec_ref_budget_trained", "mcts_plans_per_sec_ref_budget_trained_bucketed",
    "mcts_plans_per_sec_ref_budget_trained_bucketed_b256",
)
TRAIN_KEYS = ("train_env_steps_per_sec", "train_env_steps_per_sec_bf16",
              "train_env_steps_per_sec_b2048_bf16")


def load_jax_bench():
    spec = importlib.util.spec_from_file_location("jax_bench", JAX_BENCH)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def fake_time(step=0.25):
    """A ``time`` module whose clock advances ``step`` seconds per reading."""
    t = [0.0]

    def perf_counter():
        t[0] += step
        return t[0]

    return types.SimpleNamespace(perf_counter=perf_counter)


@pytest.fixture(scope="module")
def lut():
    return traster.build_sprite_lut(CPU)


@pytest.fixture(scope="module")
def agents():
    cfg = Config()
    return {"f32": bench.build_agent(cfg, "", CPU),
            "bf16": bench.build_agent(cfg, "", CPU, torch.bfloat16),
            "trained": bench._try_load_trained_agent(CPU)}


# ------------------------------------------------------------ the env step


def test_env_step_body_matches_jax_bench_scan_body(lut):
    """8 steps at B = 64 (half the envs near the top edge, so objects score
    and respawn): JAX draws actions and steps as bench.py:45-50 does; the
    port takes those actions and ``jenv.sample_latents(k, B)`` as its
    respawns. State exactly equal, checksums within 1e-6 relative."""
    B, steps = 64, 8
    rng = np.random.default_rng(3)
    lat = np.stack([rng.integers(0, n, B) for n in tenv.LATENT_SIZES], -1)
    lat[: B // 2, 5] = rng.integers(28, 32, B // 2)
    last_r = rng.uniform(-1, 1, B).astype(np.float32)
    jst = jenv.EnvState(latents=jnp.asarray(lat, jnp.int32), score=jnp.zeros((B,), jnp.float32),
                        last_r=jnp.asarray(last_r))
    tst = tenv.EnvState(torch.as_tensor(lat, dtype=torch.long), torch.zeros(B),
                        torch.as_tensor(last_r))
    jlut = jraster.build_sprite_lut()
    scored = 0
    for k in jax.random.split(jax.random.key(7), steps):
        a = jax.random.randint(k, (B,), 0, 4)
        jst, jscored = jenv.step(k, jst, a)
        jchk = jnp.sum(jenv.render(jlut, jst)[:, 0, 0, 0])
        tst, tchk = bench.env_step(lut, tst, torch.as_tensor(np.array(a), dtype=torch.long),
                                   respawn=torch.as_tensor(np.array(jenv.sample_latents(k, B)),
                                                           dtype=torch.long))
        np.testing.assert_array_equal(tst.latents.numpy(), np.asarray(jst.latents))
        np.testing.assert_array_equal(tst.score.numpy(), np.asarray(jst.score))
        np.testing.assert_array_equal(tst.last_r.numpy(), np.asarray(jst.last_r))
        np.testing.assert_allclose(float(tchk), float(jchk), rtol=1e-6)
        scored += int(jnp.sum(jscored))
    assert scored > 0  # the respawn path ran


# ------------------------------------------- what the two mains build


@dataclasses.dataclass
class Call:
    """One bench function call of a ``main``, and what it built."""

    fn: str
    kwargs: dict
    agent: str = ""  # "f32", "bf16", or "trained" (bf16 on the trained weights)
    batch: int = 0
    params: list = dataclasses.field(default_factory=list)  # MCTSParams built
    planner_kwargs: list = dataclasses.field(default_factory=list)
    plans: int = 0  # planner calls, warm-ups included
    cfg: object = None
    agent_dtype: str = ""
    rounds: int = 0
    epochs: int = 0  # epochs run, the warm-up included


def recording(calls, name, real, result):
    """Wrap bench function ``real``: record the call, run it, then return
    ``result(index)`` so that the stdout key names the call."""
    def wrapper(*args, **kwargs):
        calls.append(Call(name, kwargs))
        real(*args, **kwargs)
        return result(len(calls) - 1)
    return wrapper


def mcts_result(i):
    return (1000.0 + i, 0.0, 1.0)


def rate_of(i):
    return 1000.0 + i


@pytest.fixture(scope="module")
def port_main():
    """The port's ``main`` on the CPU with the planners and the training
    epochs stubbed (what they are given is recorded), the env-step and G
    benches replaced. Returns (stdout JSON, stderr, calls)."""
    calls = []
    names = {}

    def stub_result(B):
        z = torch.zeros(B, dtype=torch.long)
        return types.SimpleNamespace(depth_capped=z, repeats_done=z + 1)

    def plain_factory(agent, p, collect_paths=False, graphed=None):
        c = calls[-1]
        c.params.append(p)
        c.agent = names[id(agent)]

        def plan(frames, seed_path=None, draws=None):
            c.batch = frames.shape[0]
            c.plans += 1
            return stub_result(frames.shape[0])
        return plan

    def bucketed_factory(agent, p, check_every=16, min_bucket=32, graphed=None):
        c = calls[-1]
        c.params.append(p)
        c.planner_kwargs.append(dict(check_every=check_every, min_bucket=min_bucket))
        c.agent = names[id(agent)]

        def plan(frames, seed_path):
            c.batch = frames.shape[0]
            c.plans += 1
            return stub_result(frames.shape[0])
        return plan

    def create_train_state(cfg, agent, generator, device):
        c = calls[-1]
        c.cfg, c.agent_dtype = cfg, str(agent.dtype).split(".")[-1]
        return "state"

    def make_epoch_fn(cfg, lut, rounds, mesh=None, graphed=None):
        c = calls[-1]
        c.rounds = rounds

        def epoch(state, generator):
            c.epochs += 1
            return state, {}
        return epoch

    real_build = bench.build_agent

    def build_agent(cfg, network, device, dtype=torch.float32):
        agent = real_build(cfg, network, device, dtype)
        names[id(agent)] = ("trained" if network else
                            {torch.float32: "f32", torch.bfloat16: "bf16"}[dtype])
        return agent

    out, err = io.StringIO(), io.StringIO()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(bench, "time", fake_time())
        mp.setattr(bench, "build_agent", build_agent)
        mp.setattr(bench, "bench_env_steps", lambda *a, **k: 3.0e5)
        mp.setattr(bench, "bench_efe_rollouts", lambda *a, **k: 2.0e4)
        mp.setattr(bench, "bench_mcts_plans",
                   recording(calls, "plans", bench.bench_mcts_plans, mcts_result))
        mp.setattr(bench, "bench_mcts_bucketed",
                   recording(calls, "bucketed", bench.bench_mcts_bucketed, rate_of))
        mp.setattr(bench, "bench_train_round",
                   recording(calls, "train", bench.bench_train_round, rate_of))
        mp.setattr(tmcts, "make_jit_planner", plain_factory)
        mp.setattr(tmcts, "make_bucketed_planner", bucketed_factory)
        mp.setattr(tloop, "create_train_state", create_train_state)
        mp.setattr(tloop, "make_epoch_fn", make_epoch_fn)
        with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
            ret = bench.main(["--device", "cpu"])
    lines = out.getvalue().strip().splitlines()
    assert len(lines) == 1
    result = json.loads(lines[0])
    assert result == ret
    return result, err.getvalue(), calls


@pytest.fixture(scope="module")
def jax_main():
    """``bench.py``'s ``main`` with its planners and epochs stubbed in the
    same way, the trained params replaced by the seeded ones (what is
    compared is what is built, not the weights). Returns (stdout JSON,
    calls)."""
    jb = load_jax_bench()
    calls = []

    def planner_stub(c, agent):
        def plan(params, key, o):
            c.batch = o.shape[0]
            c.agent = "trained" if params is trained_marker[0] else (
                "bf16" if agent.dtype == jnp.bfloat16 else "f32")
            c.plans += 1
            z = jnp.zeros((o.shape[0],), jnp.int32)
            return types.SimpleNamespace(actions=jnp.zeros((o.shape[0], 16), jnp.int32),
                                         depth_capped=z, repeats_done=z + 1)
        return plan

    def make_jit_planner(agent, p):
        calls[-1].params.append(p)
        return planner_stub(calls[-1], agent)

    def make_bucketed_planner(agent, p, check_every=16, min_bucket=32):
        calls[-1].params.append(p)
        calls[-1].planner_kwargs.append(dict(check_every=check_every, min_bucket=min_bucket))
        return planner_stub(calls[-1], agent)

    def create_train_state(cfg, agent, key):
        c = calls[-1]
        c.cfg, c.agent_dtype = cfg, jnp.dtype(agent.dtype).name
        return "state"

    def make_jit_epoch(agent, cfg, lut, rounds):
        c = calls[-1]
        c.rounds = rounds

        def epoch(state, key):
            c.epochs += 1
            return state, {"F_down": jnp.zeros(())}
        return epoch

    trained_marker = [None]

    def try_load(agent):
        trained_marker[0] = {"trained": True}
        return trained_marker[0]

    out = io.StringIO()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jb, "time", fake_time())
        mp.setattr(jb, "bench_env_steps", lambda *a, **k: 3.0e5)
        mp.setattr(jb, "bench_efe_rollouts", lambda *a, **k: 2.0e4)
        mp.setattr(jb, "bench_mcts_plans",
                   recording(calls, "plans", jb.bench_mcts_plans, mcts_result))
        mp.setattr(jb, "bench_mcts_bucketed",
                   recording(calls, "bucketed", jb.bench_mcts_bucketed, rate_of))
        mp.setattr(jb, "bench_train_round",
                   recording(calls, "train", jb.bench_train_round, rate_of))
        mp.setattr(jb, "_try_load_trained_params", try_load)
        mp.setattr(jmcts, "make_jit_planner", make_jit_planner)
        mp.setattr(jmcts, "make_bucketed_planner", make_bucketed_planner)
        mp.setattr(jloop, "create_train_state", create_train_state)
        mp.setattr(jloop, "make_jit_epoch", make_jit_epoch)
        mp.setattr(jcompcache, "enable_persistent_cache", lambda *a, **k: "")
        with contextlib.redirect_stdout(out), contextlib.redirect_stderr(io.StringIO()):
            jb.main()
    return json.loads(out.getvalue().strip().splitlines()[-1]), calls


def call_of(run, key, calls):
    """The recorded call whose result the stdout ``key`` holds."""
    return calls[int(run[key]) - 1000]


def fields_of(dc):
    return {f.name: getattr(dc, f.name) for f in dataclasses.fields(dc)}


@pytest.mark.parametrize("key", MCTS_KEYS)
def test_mcts_key_builds_the_jax_bench_params(key, port_main, jax_main):
    """Per key: the same MCTSParams field by field, the same planner (plain
    or bucketed, with its check cadence), batch, agent (dtype, trained or
    seeded) and number of planner calls (warm-ups + reps)."""
    t_run, _, t_calls = port_main
    j_run, j_calls = jax_main
    t, j = call_of(t_run, key, t_calls), call_of(j_run, key, j_calls)
    assert t.fn == j.fn
    assert len(t.params) == len(j.params) == 1
    jp, tp = fields_of(j.params[0]), fields_of(t.params[0])
    assert tp == jp
    assert t.planner_kwargs == j.planner_kwargs
    assert (t.batch, t.agent, t.plans) == (j.batch, j.agent, j.plans)


def test_mcts_avg_expansions_and_cap_fractions_come_from_their_keys(port_main, jax_main):
    t_run, _, t_calls = port_main
    j_run, j_calls = jax_main
    for run, calls in ((t_run, t_calls), (j_run, j_calls)):
        assert [c.fn for c in calls].count("plans") == 6
        assert run["mcts_depth_cap_bind_frac"] == 0.0
        assert run["mcts_trained_avg_expansions"] == 1.0


@pytest.mark.parametrize("key", TRAIN_KEYS)
def test_train_key_builds_the_jax_bench_config(key, port_main, jax_main):
    """Per training key: ``Config(batch, bf16)`` field by field, the agent's
    compute dtype, the rounds per epoch and the epochs run."""
    t_run, _, t_calls = port_main
    j_run, j_calls = jax_main
    t, j = call_of(t_run, key, t_calls), call_of(j_run, key, j_calls)
    assert fields_of(t.cfg) == fields_of(j.cfg)
    assert (t.agent_dtype, t.rounds, t.epochs) == (j.agent_dtype, j.rounds, j.epochs)


def jax_bench_stdout_keys():
    """The keys of the dict literal that bench.py's ``json.dumps`` prints."""
    for node in ast.walk(ast.parse(JAX_BENCH.read_text())):
        if (isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute)
                and node.func.attr == "dumps" and node.args
                and isinstance(node.args[0], ast.Dict)):
            return {k.value for k in node.args[0].keys}
    raise AssertionError("no json.dumps dict literal in bench.py")


def test_stdout_keys_are_the_jax_bench_keys_plus_device(port_main):
    run, err, _ = port_main
    keys = jax_bench_stdout_keys()
    assert len(keys) == 21
    assert set(run) == keys | {"device"}
    assert run["device"] == "cpu"
    assert all(run[k] is not None for k in keys)  # the committed flagship loaded
    summary = err.strip().splitlines()[-1]
    assert summary.startswith("env_steps/s: ") and "trained-prior" in summary
    assert "[cpu; cuBLAS TF32" in summary
    per_key = [line for line in err.splitlines() if line.startswith("# ")]
    assert len(per_key) == 3 + len(MCTS_KEYS) + len(TRAIN_KEYS)


# ------------------------------------------------ each bench, tiny


TINY = {
    "env_steps": (lambda a, lut: bench.bench_env_steps(lut, batch=8, iters=2, reps=1),
                  8 * 2 * 1),
    "efe_f32": (lambda a, lut: bench.bench_efe_rollouts(a["f32"], lut, batch=8, iters=2, reps=1),
                8 * 4 * 2 * 1),
    "efe_bf16": (lambda a, lut: bench.bench_efe_rollouts(a["bf16"], lut, batch=4, iters=2,
                                                         reps=1),
                 4 * 4 * 2 * 1),
    "mcts_unfused": (lambda a, lut: bench.bench_mcts_plans(a["f32"], lut, repeats=4, reps=1,
                                                           batch=8),
                     8 * 1),
    "mcts_fused_bf16_k2": (lambda a, lut: bench.bench_mcts_plans(
        a["bf16"], lut, repeats=4, fused=True, reps=1, expand_k=2, batch=8), 8 * 1),
    "mcts_trained": (lambda a, lut: bench.bench_mcts_plans(a["trained"], lut, repeats=4,
                                                           fused=True, reps=1, batch=8),
                     8 * 1),
    "bucketed_trained": (lambda a, lut: bench.bench_mcts_bucketed(
        a["trained"], lut, repeats=4, reps=1, check_every=1, min_bucket=2, B=8), 8 * 1),
    "train_f32": (lambda a, lut: bench.bench_train_round(lut, batch=8, rounds=2, reps=1),
                  8 * 5 * 2 * 1),
    "train_bf16": (lambda a, lut: bench.bench_train_round(lut, batch=8, bf16=True, rounds=2,
                                                          reps=1),
                   8 * 5 * 2 * 1),
}


@pytest.mark.parametrize("case", TINY)
def test_bench_function_at_a_tiny_size(case, agents, lut, monkeypatch):
    """A positive, finite rate; under a fake clock (0.25 s per reading,
    read twice around the timed region) the rate is the work count / 0.25,
    ``bench.py``'s formula (batch x steps x reps, batch x 4 actions x
    iterations x reps, plans x reps, batch x Config.repeats x rounds x
    reps)."""
    run, work = TINY[case]
    out = run(agents, lut)
    rate = out[0] if isinstance(out, tuple) else out
    assert math.isfinite(rate) and rate > 0
    if isinstance(out, tuple):
        assert 0.0 <= out[1] <= 1.0 and 1.0 <= out[2] <= 4.0
    monkeypatch.setattr(bench, "time", fake_time(0.25))
    out = run(agents, lut)
    rate = out[0] if isinstance(out, tuple) else out
    assert rate == work / 0.25


# ------------------------------------------------- device and loading


def test_main_without_a_card_raises(monkeypatch):
    """The default device is the card; without one, ``main`` raises before
    any bench runs and does not fall back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)

    def never(*a, **k):
        raise AssertionError("a bench ran without a card")

    for name in ("bench_env_steps", "bench_efe_rollouts", "bench_mcts_plans",
                 "bench_mcts_bucketed", "bench_train_round"):
        monkeypatch.setattr(bench, name, never)
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        bench.main([])


def test_trained_agent_loads_the_export_or_raises(tmp_path, agents):
    """The committed flagship loads in bf16 with the export's weights; an
    absent directory gives None (the trained keys are null, as in
    bench.py); a directory that does not load raises, where bench.py
    prints the error and carries on."""
    export = convert.load_export(bench.TRAINED_CHECKPOINTS / "torch_export.npz")
    trained = agents["trained"]
    assert trained.dtype == torch.bfloat16
    sd = trained.state_dict()
    assert sd.keys() == export["agent"].keys()
    assert all(torch.equal(sd[k], v) for k, v in export["agent"].items())
    assert bench._try_load_trained_agent(CPU, tmp_path / "absent") is None
    with pytest.raises(FileNotFoundError):
        bench._try_load_trained_agent(CPU, tmp_path)  # present, empty
    bare = tmp_path / "orbax_only"  # an Orbax store without its export
    shutil.copytree(ROOT / "artifacts" / "run512" / "checkpoints_distilled", bare,
                    ignore=shutil.ignore_patterns("torch_export.npz"))
    with pytest.raises(FileNotFoundError, match="torch_export.npz"):
        bench._try_load_trained_agent(CPU, bare)
