"""PyTorch port: the committed flagship agent (``artifacts/run512/checkpoints``)
read through its ``torch_export.npz`` by the port's loaders and CLIs.

The JAX package reads the Orbax store (``utils/checkpoint.load_all``) on the
reference side; the port reads only the export. Each committed export (the
flagship's and the distilled agent's, ``checkpoints_distilled``) is held
equal to an in-process re-export of its store, leaf for leaf and bit for
bit; the port's loaders give exactly ``params_from_jax`` of the JAX params;
the habit net's edge policy equals the JAX test's ``_edge_policy`` to 1e-5.
"""

import functools
import pickle
import shutil

import jax
import numpy as np
import pytest
import torch

from deep_active_inference_mc_tpu import config as jconfig
from deep_active_inference_mc_tpu.infer.agent import ActiveInferenceAgent as JAgent
from deep_active_inference_mc_torch.apps import demo as demo_app
from deep_active_inference_mc_torch.apps import distill as distill_app
from deep_active_inference_mc_torch.apps import sweep as sweep_app
from deep_active_inference_mc_torch.apps import train as train_app
from deep_active_inference_mc_torch.config import Config
from deep_active_inference_mc_torch.envs import raster
from deep_active_inference_mc_torch.infer.agent import ActiveInferenceAgent
from deep_active_inference_mc_torch.train import evaluate
from deep_active_inference_mc_torch.train import loop as train_loop
from deep_active_inference_mc_torch.utils import checkpoint as ckpt
from deep_active_inference_mc_torch.utils import convert
from test_torch_models import RUN, few_torch_threads  # noqa: F401 (autouse fixture)

FLAGSHIP = RUN / "checkpoints"
DISTILLED = RUN / "checkpoints_distilled"
EXPORT = FLAGSHIP / ckpt.EXPORT_FILE
RUNS = {"flagship": FLAGSHIP, "distilled": DISTILLED}
# artifacts/run512/config.json's flags that differ from the defaults
# (freeze_top included), at a tiny size without figures.
RUN_FLAGS = ["--crn", "--gen_mean", "--explore_eps", "0.1", "--edge_frac", "0.3",
             "--gen_habit_mix", "0.5", "--freeze_top"]
TINY = ["--batch", "8", "--rounds", "1", "--test_size", "16", "--sweep_envs", "8",
        "--sweep_steps", "2", "--viz_every", "1000"]
# The wrong-side bound of each contrast contract in tests/test_trained_artifact.py.
WRONG_SIDE_MAX = {"flagship": 0.08, "distilled": 0.05}


@functools.lru_cache(maxsize=None)
def jax_store(run_dir):
    """(JAX train state, stats) of the Orbax store in ``run_dir``, as the
    README's recipe reads it (template from shapes alone)."""
    from deep_active_inference_mc_tpu.train import loop as jloop
    from deep_active_inference_mc_tpu.utils import checkpoint as jckpt

    cfg = jconfig.Config()
    agent = JAgent(s_dim=cfg.s_dim, pi_dim=cfg.pi_dim)
    shapes = jax.eval_shape(lambda k: jloop.create_train_state(cfg, agent, k),
                            jax.random.key(0))
    state, stats, _ = jckpt.load_all(
        run_dir, jax.tree.map(lambda s: np.zeros(s.shape, s.dtype), shapes))
    return state, stats


@pytest.fixture(scope="module")
def store():
    return jax_store(FLAGSHIP)


def reexport(state) -> dict:
    """The README recipe's flat dict of a JAX train state."""
    flat = {"params/" + "/".join(k.key for k in path): np.asarray(v)
            for path, v in jax.tree_util.tree_leaves_with_path(state.params)}
    flat.update({f"precision/{f}": np.asarray(getattr(state.precision, f))
                 for f in ("gamma", "beta_s", "beta_o")})
    flat.update({f"env/{f}": np.asarray(getattr(state.env, f))
                 for f in ("latents", "score", "last_r")})
    return flat


@pytest.mark.parametrize("run", sorted(RUNS))
def test_committed_export_equals_the_orbax_store(run):
    """Drift guard: every leaf of each committed export is its store's, same
    dtype and shape, bit for bit; nothing else is in the file."""
    want = reexport(jax_store(RUNS[run])[0])
    with np.load(RUNS[run] / ckpt.EXPORT_FILE) as z:
        assert sorted(z.files) == sorted(want)
        for k, v in want.items():
            assert z[k].dtype == v.dtype and z[k].shape == v.shape, k
            assert np.array_equal(z[k], v), k
    assert sum(v.size for k, v in want.items() if k.startswith("params/")) == 5_463_501


def test_loaders_give_params_from_jax_of_the_store(store):
    state, stats = store
    want = convert.params_from_jax(jax.tree.map(np.asarray, state.params))
    agent = ckpt.load_weights(FLAGSHIP, ActiveInferenceAgent())
    got = agent.state_dict()
    assert got.keys() == want.keys()
    assert all(torch.equal(got[k], want[k]) for k in want)

    # load_all: weights, precision and the run's 512 envs; fresh Adams and
    # the generator as it was (a weight-only archive).
    cfg = Config(batch=512)
    gen = torch.Generator().manual_seed(3)
    tstate = train_loop.create_train_state(cfg, ActiveInferenceAgent(), gen, "cpu")
    g_before = gen.get_state()
    tstate, tstats = ckpt.load_all(FLAGSHIP, tstate, gen)
    assert all(torch.equal(v, want[k]) for k, v in tstate.agent.state_dict().items())
    for f in ("gamma", "beta_s", "beta_o"):
        assert float(getattr(tstate.precision, f)) == float(getattr(state.precision, f))
    for f in ("latents", "score", "last_r"):
        np.testing.assert_array_equal(getattr(tstate.env, f).numpy(),
                                      np.asarray(getattr(state.env, f)))
    assert tstate.env.latents.dtype == torch.int64
    assert all(o.state_dict()["state"] == {} for o in tstate.opts.values())
    assert torch.equal(gen.get_state(), g_before)
    assert len(tstats["F"]) == len(stats["F"]) == 1299

    # At another batch the template's envs stay.
    small = train_loop.create_train_state(Config(batch=8), ActiveInferenceAgent(), gen, "cpu")
    envs = small.env
    small, _ = ckpt.load_all(FLAGSHIP, small, gen)
    assert small.env is envs
    assert ckpt.latest_exists(FLAGSHIP)


def test_params_npz_of_the_export_loads_the_same_weights(tmp_path):
    """``load_npz`` on the export's ``params/`` entries without the prefix
    (the params-only ``.npz`` that ``-n`` also takes) gives the export's
    agent; ``load_export`` refuses such a file."""
    with np.load(EXPORT) as z:
        params = {k[len("params/"):]: z[k] for k in z.files if k.startswith("params/")}
    np.savez(tmp_path / "p.npz", **params)
    a, b = convert.load_export(EXPORT)["agent"], convert.load_npz(tmp_path / "p.npz")
    assert a.keys() == b.keys() and all(torch.equal(a[k], b[k]) for k in a)
    with pytest.raises(ValueError, match="not a train-state export"):
        convert.load_export(tmp_path / "p.npz")


def test_jax_dir_without_export_raises(tmp_path):
    """A JAX (Orbax) dir without the export (a copy of
    ``checkpoints_distilled`` without its ``torch_export.npz``): every loader
    names the missing file and the recipe instead of falling back to a
    seeded init."""
    match = f"{ckpt.EXPORT_FILE}.*README"
    bare = tmp_path / "orbax_only"
    shutil.copytree(DISTILLED, bare, ignore=shutil.ignore_patterns(ckpt.EXPORT_FILE))
    with pytest.raises(FileNotFoundError, match=match):
        ckpt.load_weights(bare, ActiveInferenceAgent())
    with pytest.raises(FileNotFoundError, match=match):
        ckpt.latest_exists(bare)
    gen = torch.Generator()
    state = train_loop.create_train_state(Config(batch=8), ActiveInferenceAgent(), gen, "cpu")
    with pytest.raises(FileNotFoundError, match=match):
        ckpt.load_all(bare, state, gen)
    with pytest.raises(FileNotFoundError, match=match):
        sweep_app.main(["--device", "cpu", "-n", str(bare), "--method", "habit",
                        "--envs", "4", "--macro", "1"])
    # The trainer's --resume on such a folder raises too.
    run = Config.from_args(TINY + ["--out_root", str(tmp_path)])
    shutil.copytree(bare, run.folder_chp)
    with pytest.raises(FileNotFoundError, match=match):
        train_app.main(TINY + ["--device", "cpu", "--out_root", str(tmp_path), "--resume",
                               "--epochs", "1300"])


@functools.lru_cache(maxsize=None)
def edge_policies(run):
    """(port, JAX) habit P(up) at the scoring edge, each (left, right) by
    class: the port's ``habit_edge_policy`` on ``run``'s export, the JAX
    test's ``_edge_policy`` on its Orbax store."""
    from test_trained_artifact import _edge_policy

    agent = ckpt.load_weights(RUNS[run], ActiveInferenceAgent())
    port = evaluate.habit_edge_policy(agent, raster.build_sprite_lut("cpu"))
    return tuple(x.numpy() for x in port), _edge_policy(RUNS[run])


@pytest.mark.parametrize("contract", sorted(WRONG_SIDE_MAX))
@pytest.mark.parametrize("run", sorted(RUNS))
def test_edge_policy_matches_jax_and_meets_the_contracts(run, contract):
    """On each export the port's probabilities equal JAX's to 1e-5 and meet
    each contrast contract of tests/test_trained_artifact.py (the
    flagship's and the distilled habit's: ``top`` is shared, so both hold
    on both exports)."""
    (left, right), (jl, jr) = edge_policies(run)
    np.testing.assert_allclose(left, jl, rtol=0, atol=1e-5)
    np.testing.assert_allclose(right, jr, rtol=0, atol=1e-5)
    wrong = WRONG_SIDE_MAX[contract]
    assert left[0] > 2.0 * right[0] + 1e-3 and right[0] < wrong
    for c in (1, 2):
        assert right[c] > 2.0 * left[c] + 1e-3 and left[c] < wrong


def test_sweep_row_from_the_jax_dir_equals_the_params_npz_row(tmp_path, capsys):
    with np.load(EXPORT) as z:
        np.savez(tmp_path / "flagship.npz",
                 **{k[len("params/"):]: z[k] for k in z.files if k.startswith("params/")})
    base = ["--device", "cpu", "--method", "habit", "--envs", "8", "--macro", "3"]
    a = sweep_app.main(base + ["-n", str(FLAGSHIP)])
    b = sweep_app.main(base + ["-n", str(tmp_path / "flagship.npz")])
    assert torch.equal(a["scores"], b["scores"])
    assert a["score_mean"] == b["score_mean"]
    assert f"ckpt={FLAGSHIP}" in capsys.readouterr().out


def test_trainer_resumes_the_flagship_at_epoch_1300(tmp_path, capsys):
    """``--resume`` on a run folder whose checkpoints/ is a copy of the
    store: epoch 1300, fresh Adams, ``top`` unchanged under freeze_top."""
    argv = RUN_FLAGS + TINY + ["--device", "cpu", "--out_root", str(tmp_path)]
    run = Config.from_args(RUN_FLAGS + TINY + ["--out_root", str(tmp_path)])
    shutil.copytree(FLAGSHIP, run.folder_chp)
    out = train_app.main(argv + ["--resume", "--epochs", "1300"])
    text = capsys.readouterr().out
    assert f"Resumed from {run.folder_chp} at epoch 1300" in text
    assert [ln.split(",")[0] for ln in text.splitlines() if ", F: " in ln] == ["1300"]
    assert out["start_epoch"] == 1300 and len(out["stats"]["F"]) == 1300
    top = convert.load_export(EXPORT)["agent"]
    assert all(torch.equal(v, top[f"top.{k}"])
               for k, v in out["state"].agent.top.state_dict().items())
    steps = {k: [int(s["step"]) for s in o.state_dict()["state"].values()]
             for k, o in out["state"].opts.items()}
    assert steps["top"] == [] and set(steps["mid"]) == set(steps["down"]) == {1}
    # The save into the folder is a port checkpoint, read before the export.
    out2 = train_app.main(argv + ["--resume", "--epochs", "1300", "--save_every", "1"])
    assert out2["start_epoch"] == 1301
    saved = pickle.loads((run.folder_chp / "stats.pkl").read_bytes())
    assert len(saved["F"]) == 1300
    assert (run.folder_chp / "state" / "state.pt").exists()
    assert ckpt._source(run.folder_chp).name == "state.pt"


def test_distill_and_demo_clis_load_the_flagship(tmp_path, capsys):
    res = distill_app.main(["--device", "cpu", "-n", str(FLAGSHIP), "-o", str(tmp_path / "d"),
                            "--iters", "1", "--distill_envs", "4", "--distill_macro", "2",
                            "--distill_repeats", "2", "--distill_batch", "8",
                            "--sweep_envs", "8", "--sweep_steps", "2"])
    assert f"Loaded {FLAGSHIP} (epoch 1299)" in capsys.readouterr().out
    top = convert.load_export(EXPORT)["agent"]
    saved = torch.load(tmp_path / "d" / "state" / "state.pt", weights_only=True)
    assert all(torch.equal(saved["agent"][k], v) for k, v in top.items()
               if not k.startswith("top."))
    assert res["iters_run"] == 1
    out = demo_app.main(["--device", "cpu", "-n", str(FLAGSHIP), "--method", "habit",
                         "--headless", "100"])
    assert out["plans"] >= 1 and bool(torch.isfinite(out["trace"]).all())


LADDER_SEEDS, LADDER_ENVS, LADDER_MACRO = (0, 1, 2, 3), 1024, 100
LADDER_SIGMA = 4.0


def row_mean(capsys) -> float:
    """The score mean of the last row a sweep CLI printed."""
    row = [ln for ln in capsys.readouterr().out.splitlines() if ln.startswith("method=")][-1]
    return float(row.split("score: ")[1].split()[0])


@pytest.mark.slow
@pytest.mark.parametrize("method", ["habit", "expert", "random"])
def test_ladder_row_on_the_cpu_matches_the_jax_cli(method, capsys):
    """The ladder held on the CPU: the port's sweep CLI on the export and
    the JAX CLI on the Orbax store, the same row at a few seeds (each
    package draws its own noise). The difference of the two means over the
    seeds is within LADDER_SIGMA of its standard error from the per-seed
    spread."""
    from deep_active_inference_mc_tpu.apps import sweep as jsweep_app

    base = ["-n", str(FLAGSHIP), "--method", method, "--envs", str(LADDER_ENVS), "--macro",
            str(LADDER_MACRO), "--jumps", "5"]
    port, ref = [], []
    for seed in LADDER_SEEDS:
        port.append(sweep_app.main(base + ["--device", "cpu", "--seed", str(seed)])["score_mean"])
        capsys.readouterr()
        jsweep_app.main(base + ["--seed", str(seed)])
        ref.append(row_mean(capsys))
    port, ref = np.asarray(port), np.asarray(ref)
    n = len(LADDER_SEEDS)
    se = np.sqrt(port.var(ddof=1) / n + ref.var(ddof=1) / n)
    gap = abs(port.mean() - ref.mean())
    assert gap <= LADDER_SIGMA * se, (method, port, ref, gap / se)
