"""PyTorch port: the committed distilled agent
(``artifacts/run512/checkpoints_distilled``, the round-4 MCTS-visit-distilled
agent at epoch 1199) read through its ``torch_export.npz``.

The flagship was resumed from this agent with ``--gen_habit_mix 0.5
--freeze_top`` (``artifacts/run512/config.json``), so the two stores share
``top`` (the habit net) and the precision and differ in every other leaf:
the transition net, the VAE and the envs. Held here: the export's leaves
against the flagship's; the port's loaders against ``params_from_jax`` of
the Orbax store; G on these weights against the JAX functions under
injected noise (tests/test_torch_efe.py's oracles, its G_TOL: rtol 1e-4,
atol 1e-2, since G sums ~4k Bernoulli entropies); the habit controller,
which reads the shared ``top`` through each agent's own encoder; the CLIs'
``-n`` and the trainer's phase-3 ``--resume``.
"""

import functools
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deep_active_inference_mc_tpu.infer import efe as jefe
from deep_active_inference_mc_torch.apps import demo as demo_app
from deep_active_inference_mc_torch.apps import distill as distill_app
from deep_active_inference_mc_torch.apps import sweep as sweep_app
from deep_active_inference_mc_torch.apps import train as train_app
from deep_active_inference_mc_torch.config import Config
from deep_active_inference_mc_torch.infer import efe as tefe
from deep_active_inference_mc_torch.infer.agent import ActiveInferenceAgent
from deep_active_inference_mc_torch.utils import checkpoint as ckpt
from deep_active_inference_mc_torch.utils import convert
from test_torch_efe import (S_DIM, _oracle_rows, close, draws, frames, jax_simulate_draws,
                            jax_trajectory_draws, oracle_G, oracle_G_mean, to_torch)
from test_torch_flagship import (DISTILLED, FLAGSHIP, LADDER_SIGMA, RUN_FLAGS, TINY, jax_store,
                                 row_mean)
from test_torch_models import JAgent, few_torch_threads  # noqa: F401 (autouse fixture)

EXPORT = DISTILLED / ckpt.EXPORT_FILE
# What the distilled export shares with the flagship's: "same" groups are
# bit-equal leaf for leaf, "differ" groups differ in every leaf.
SHARED = {"params/top": "same", "precision": "same", "params/mid": "differ",
          "params/down": "differ", "env": "differ"}


@pytest.fixture(scope="module")
def exports():
    with np.load(EXPORT) as d, np.load(FLAGSHIP / ckpt.EXPORT_FILE) as f:
        return dict(d), dict(f)


@pytest.mark.parametrize("group", sorted(SHARED))
def test_distilled_export_shares_only_top_and_precision(exports, group):
    """Guards against exporting the wrong store: the habit net and the
    precision are the flagship's, bit for bit; every leaf of the transition
    net, the VAE and the envs is not."""
    d, f = exports
    assert sorted(d) == sorted(f)
    keys = [k for k in d if k.startswith(group + "/")]
    assert keys
    equal = {k: d[k].dtype == f[k].dtype and np.array_equal(d[k], f[k]) for k in keys}
    if SHARED[group] == "same":
        assert all(equal.values()), [k for k, v in equal.items() if not v]
    else:
        assert not any(equal.values()), [k for k, v in equal.items() if v]


@pytest.fixture(scope="module")
def distilled():
    """(JAX agent, the Orbax store's params, the port agent loaded from the
    export by ``load_weights``)."""
    state, _ = jax_store(DISTILLED)
    ja = JAgent()
    return ja, state.params, ckpt.load_weights(DISTILLED, ActiveInferenceAgent())


def test_loaders_give_params_from_jax_of_the_distilled_store(distilled):
    _, jp, ta = distilled
    want = convert.params_from_jax(jax.tree.map(np.asarray, jp))
    got = ta.state_dict()
    assert got.keys() == want.keys()
    assert all(torch.equal(got[k], want[k]) for k in want)
    assert ckpt._source(DISTILLED).name == ckpt.EXPORT_FILE


# G on the distilled weights, one case per estimator: (port, JAX) arrays.
def _g_mean(ja, jp, ta):
    B = 8
    rng = np.random.default_rng(1)
    s0 = rng.standard_normal((B, S_DIM)).astype(np.float32)
    pi = np.eye(4, dtype=np.float32)[rng.integers(0, 4, B)]
    d = draws(B, seed=2, sampled=False)
    G_o, _, _ = oracle_G_mean(ja, jp, s0, pi, *d[:3])
    G = tefe.calculate_G_mean(ta, torch.from_numpy(s0), torch.from_numpy(pi),
                              draws=to_torch(d))[0]
    return G, G_o


def _g_sampled(ja, jp, ta):
    B, S = 4, 3
    rng = np.random.default_rng(3)
    s0 = rng.standard_normal((B, S_DIM)).astype(np.float32)
    pi = np.eye(4, dtype=np.float32)[rng.integers(0, 4, B)]
    d = draws(S * B, seed=4, sampled=True)
    G_o = oracle_G(ja, jp, s0, pi, S, *d)[0]
    G = tefe.calculate_G(ta, torch.from_numpy(s0), torch.from_numpy(pi), samples=S,
                         draws=to_torch(d))[0]
    return G, G_o


def _g4_mean(ja, jp, ta):
    """The sweep's ``ai`` estimator (steps 2, the mean) from frames: the
    encoder, the transition net and the decoder."""
    B, A, steps = 3, 4, 2
    o, jo = frames(B, seed=5)
    step_draws = [draws(B * A, seed=10 + k, sampled=False) for k in range(steps)]
    rollout = tefe.RolloutDraws(None, [to_torch(d) for d in step_draws])
    G = tefe.calculate_G_4_repeated(ta, o, steps=steps, calc_mean=True, samples=1,
                                    draws=rollout)[0]
    s = jnp.asarray(_oracle_rows(np.asarray(ja.encode(jp, jo)[0]), A))
    pi = jnp.asarray([np.eye(A, dtype=np.float32)[a] for _ in range(B) for a in range(A)])
    G_o = 0.0
    for d in step_draws:
        G_k, _, s = oracle_G_mean(ja, jp, s, pi, *d[:3])
        G_o = G_o + G_k
    return G, np.asarray(G_o).reshape(B, A)


def _g_given_trajectory(ja, jp, ta):
    """The planner's G, against the JAX function itself."""
    N = 12
    rng = np.random.default_rng(30)
    arrays = [rng.standard_normal((N, S_DIM)).astype(np.float32) * 0.5 for _ in range(4)]
    pi = np.eye(4, dtype=np.float32)[rng.integers(0, 4, N)]
    key = jax.random.key(31)
    G_o = jax.jit(functools.partial(jefe.calculate_G_given_trajectory, ja))(
        jp, key, *arrays, pi)
    G = tefe.calculate_G_given_trajectory(
        ta, *[torch.from_numpy(x) for x in arrays + [pi]],
        draws=jax_trajectory_draws(ja, jp, key, N))
    return G, G_o


def _mcts_step_simulate(ja, jp, ta):
    """The planner's simulation (habit rollout, then G), against the JAX
    function itself."""
    B, depth = 5, 3
    s = np.random.default_rng(32).standard_normal((B, S_DIM)).astype(np.float32) * 0.5
    key = jax.random.key(33)
    G_o = jax.jit(functools.partial(jefe.mcts_step_simulate, ja, depth=depth,
                                    use_means=False))(jp, key, s)[0]
    G = tefe.mcts_step_simulate(ta, torch.from_numpy(s), depth, use_means=False,
                                draws=jax_simulate_draws(ja, jp, key, B, depth))[0]
    return G, G_o


G_CASES = {"G_mean": _g_mean, "G_sampled": _g_sampled, "G4_mean_steps2": _g4_mean,
           "G_given_trajectory": _g_given_trajectory, "mcts_step_simulate": _mcts_step_simulate}


@pytest.mark.parametrize("case", sorted(G_CASES))
def test_G_on_the_distilled_weights_matches_jax(distilled, case):
    ja, jp, ta = distilled
    with torch.inference_mode():
        got, want = G_CASES[case](ja, jp, ta)
    assert tuple(got.shape) == np.shape(want)
    close(got, want)  # G_TOL
    assert np.isfinite(got.numpy()).all()


def test_habit_reads_the_shared_top_through_each_agents_encoder(distilled):
    """The ``habit`` controller is Q(pi | encoder mean(o)): the shared
    ``top`` on each agent's own encoder (``down``). On the same encoder
    means the two agents' habit nets agree bit for bit; on frames they do
    not, in the port as in the JAX package, so the habit rows of the two
    agents differ at one seed (as the JAX sweep CLI's do)."""
    ja, jp, ta = distilled
    tf = ckpt.load_weights(FLAGSHIP, ActiveInferenceAgent())
    o, jo = frames(16, seed=40)
    with torch.inference_mode():
        mean = ta.encode(o)[0]
        assert torch.equal(ta.habit(mean)[1], tf.habit(mean)[1])
        q_d, q_f = ta.habitual_net(o), tf.habitual_net(o)
    close(q_d, ja.habitual_net(jp, jo), rtol=0, atol=1e-5)
    close(q_f, ja.habitual_net(jax_store(FLAGSHIP)[0].params, jo), rtol=0, atol=1e-5)
    assert (q_d - q_f).abs().max() > 1e-3
    base = ["--device", "cpu", "--method", "habit", "--envs", "64", "--macro", "20"]
    a = sweep_app.main(base + ["-n", str(DISTILLED)])
    b = sweep_app.main(base + ["-n", str(FLAGSHIP)])
    assert not torch.equal(a["scores"], b["scores"])


def test_trainer_resumes_the_distilled_agent_at_epoch_1200(tmp_path, capsys):
    """The phase-3 workflow that made the flagship: ``--resume`` on a run
    folder whose checkpoints/ is a copy of the distilled store, with
    config.json's flags (``--gen_habit_mix 0.5 --freeze_top``): epoch 1200,
    fresh Adams, ``top`` bit-equal, ``mid`` and ``down`` moved."""
    argv = RUN_FLAGS + TINY + ["--device", "cpu", "--out_root", str(tmp_path)]
    run = Config.from_args(RUN_FLAGS + TINY + ["--out_root", str(tmp_path)])
    shutil.copytree(DISTILLED, run.folder_chp)
    out = train_app.main(argv + ["--resume", "--epochs", "1200"])
    text = capsys.readouterr().out
    assert f"Resumed from {run.folder_chp} at epoch 1200" in text
    assert [ln.split(",")[0] for ln in text.splitlines() if ", F: " in ln] == ["1200"]
    assert out["start_epoch"] == 1200 and len(out["stats"]["F"]) == 1200
    export = convert.load_export(EXPORT)["agent"]
    sd = out["state"].agent.state_dict()
    assert all(torch.equal(sd[k], v) for k, v in export.items() if k.startswith("top."))
    for part in ("mid.", "down."):
        moved = [k for k, v in export.items() if k.startswith(part)
                 and not torch.equal(sd[k], v)]
        assert moved == [k for k in export if k.startswith(part)], part
    steps = {k: [int(s["step"]) for s in o.state_dict()["state"].values()]
             for k, o in out["state"].opts.items()}
    assert steps["top"] == [] and set(steps["mid"]) == set(steps["down"]) == {1}


def test_sweep_distill_and_demo_clis_load_the_distilled_agent(tmp_path, capsys):
    out = sweep_app.main(["--device", "cpu", "-n", str(DISTILLED), "--method", "ai",
                          "--envs", "8", "--macro", "2"])
    assert f"ckpt={DISTILLED}" in capsys.readouterr().out
    assert bool(torch.isfinite(out["scores"]).all())
    res = distill_app.main(["--device", "cpu", "-n", str(DISTILLED), "-o", str(tmp_path / "d"),
                            "--iters", "1", "--distill_envs", "4", "--distill_macro", "2",
                            "--distill_repeats", "2", "--distill_batch", "8",
                            "--sweep_envs", "8", "--sweep_steps", "2"])
    assert f"Loaded {DISTILLED} (epoch 1199)" in capsys.readouterr().out
    export = convert.load_export(EXPORT)["agent"]
    saved = torch.load(tmp_path / "d" / "state" / "state.pt", weights_only=True)
    assert all(torch.equal(saved["agent"][k], v) for k, v in export.items()
               if not k.startswith("top."))
    assert res["iters_run"] == 1
    for method in ("habit", "ai"):
        demo = demo_app.main(["--device", "cpu", "-n", str(DISTILLED), "--method", method,
                              "--headless", "50"])
        assert demo["plans"] >= 1 and bool(torch.isfinite(demo["trace"]).all())


AI_SEEDS, AI_ENVS, AI_MACRO = (0, 1, 2, 3), 64, 20


@pytest.mark.slow
def test_ai_row_on_the_cpu_matches_the_jax_cli(capsys):
    """The distilled agent's ``ai`` row (the ladder's flags, steps 2) on the
    CPU at a small size: the port's sweep CLI on the export and the JAX CLI
    on the Orbax store at a few seeds (each package draws its own noise).
    The difference of the two means over the seeds is within LADDER_SIGMA
    of its standard error from the per-seed spread."""
    from deep_active_inference_mc_tpu.apps import sweep as jsweep_app

    base = ["-n", str(DISTILLED), "--method", "ai", "--steps", "2", "--envs", str(AI_ENVS),
            "--macro", str(AI_MACRO), "--jumps", "5"]
    port, ref = [], []
    for seed in AI_SEEDS:
        port.append(sweep_app.main(base + ["--device", "cpu", "--seed", str(seed)])["score_mean"])
        capsys.readouterr()
        jsweep_app.main(base + ["--seed", str(seed)])
        ref.append(row_mean(capsys))
    port, ref = np.asarray(port), np.asarray(ref)
    n = len(AI_SEEDS)
    se = np.sqrt(port.var(ddof=1) / n + ref.var(ddof=1) / n)
    gap = abs(port.mean() - ref.mean())
    assert gap <= LADDER_SIGMA * se, (port, ref, gap / se)
