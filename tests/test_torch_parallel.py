"""PyTorch port: multi-device execution (``parallel/mesh.py``) on the CPU,
with gloo between spawned ranks.

The tensor-parallel split is held to the JAX package's ``param_shardings``
on every leaf of the flagship tree; a data-parallel round (2 and 4 ranks)
and a 2 x 2 data x tensor-parallel round to the single-rank round under
the same injected draws, to ``tests/test_parallel.py``'s tolerances (rtol
2e-3 on F_down and omega, atol 5e-5 on the params under data parallelism
and 3e-4 under tensor parallelism); the mesh sweep to the single-rank
sweep, score for score. A non-primary rank writes nothing
(tests/test_torch_checkpoint.py holds a mesh checkpoint to a single-rank
run and back).

Spawned ranks import this module to find their functions, so it imports
no JAX at its top: the tests that compare with the JAX package import it
inside.
"""

import argparse
import copy
import dataclasses
from pathlib import Path

import numpy as np
import pytest
import torch

from deep_active_inference_mc_torch.apps import sweep as sweep_app
from deep_active_inference_mc_torch.apps import train as train_app
from deep_active_inference_mc_torch.config import Config
from deep_active_inference_mc_torch.envs import dsprites as env_lib
from deep_active_inference_mc_torch.envs import raster
from deep_active_inference_mc_torch.infer.precision import PrecisionState
from deep_active_inference_mc_torch.parallel import comm
from deep_active_inference_mc_torch.parallel import mesh as mesh_lib
from deep_active_inference_mc_torch.train import loop as tloop
from deep_active_inference_mc_torch.train import sweep as tsweep

CPU = torch.device("cpu")
B = 8
# The flagship's generator flags: CRN and the mean estimator, the
# exploration floor, the edge curriculum and habit mixing.
FLAGS = dict(crn=True, gen_mean=True, explore_eps=0.1, edge_frac=0.3, gen_habit_mix=0.5)
TINY = ["--device", "cpu", "--batch", "8", "--rounds", "2", "--test_size", "8",
        "--sweep_envs", "8", "--sweep_steps", "2", "--viz_every", "1000"]


@pytest.fixture(autouse=True, scope="module")
def few_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


# ------------------------------------------------------------ the TP split
@pytest.mark.parametrize("tp", [2, 4])
def test_tp_spec_matches_jax_param_shardings(tp):
    """Every leaf of the flagship tree, by the port's name and layout: a
    JAX kernel's (in, out) is the port's weight (out, in)."""
    import jax
    from jax.sharding import PartitionSpec as P

    from deep_active_inference_mc_tpu.infer.agent import ActiveInferenceAgent as JAgent
    from deep_active_inference_mc_tpu.parallel import mesh as jmesh

    ja = JAgent()
    params = jax.eval_shape(ja.init, jax.random.key(0))
    shardings = jmesh.param_shardings(params, jmesh.make_mesh(8, n_model=tp))
    want = {P(): None, P(None, "model"): 0, P("model", None): 1, P("model"): 0}
    pairs = []
    for path, sh in jax.tree_util.tree_leaves_with_path(shardings):
        keys = [k.key for k in path]
        layer, kind = keys[-2], keys[-1]
        kindex = int(layer.rsplit("_", 1)[1])
        prefix = ".".join(keys[:-2])
        name = {"Dense": f"{prefix}.fc.{kindex}", "Conv": f"{prefix}.conv.{kindex}",
                "ConvTranspose": f"{prefix}.deconv.{kindex}"}[layer.rsplit("_", 1)[0]]
        name += ".weight" if kind == "kernel" else ".bias"
        leaf = ja_leaf(params, keys)
        tshape = leaf.shape[::-1] if (kind == "kernel" and leaf.ndim == 2) else leaf.shape
        got = mesh_lib.tp_spec(name, tshape, tp)
        assert got == want[sh.spec], (name, sh.spec, got)
        if got is not None:
            pairs.append(name)
    split = sorted({n.rsplit(".", 2)[0] + "." + n.rsplit(".", 2)[1] for n in pairs
                    if n.endswith("weight")})
    # Seven column/row pairs at tp 2 and at tp 4; top's 128 -> 4 head stays whole.
    assert len(split) == 14, split
    assert "top.fc.2" not in split


def ja_leaf(tree, keys):
    for k in keys:
        tree = tree[k]
    return tree


def test_take_rows_keeps_sample_major_action_fastest_layout():
    batch, A, S = 4, 3, 2
    x = torch.arange(S * batch * A).reshape(S * batch * A, 1)
    got = mesh_lib.take_rows(x, slice(2, 4), batch, inner=A)
    want = x.reshape(S, batch, A, 1)[:, 2:4].reshape(-1, 1)
    assert torch.equal(got, want)
    tree = ([x[:batch], None], (x[:batch * A],))
    out = mesh_lib.take_rows(tree, slice(0, 2), batch)
    assert torch.equal(out[0][0], x[:2]) and out[0][1] is None
    assert out[1][0].shape == (2 * A, 1)


def test_layout_guards():
    with pytest.raises(ValueError, match="not divisible by tp=3"):
        mesh_lib.check_layout(4, 3)
    with pytest.raises(ValueError, match="batch 6 not divisible by data-axis size 4"):
        mesh_lib.check_layout(4, 1, batch=6)
    mesh_lib.initialize_multihost(None, num_hosts=1)  # a no-op
    mesh_lib.initialize_multihost("ignored:1234", num_hosts=0)
    assert mesh_lib.is_primary()
    with pytest.raises(ValueError, match="coordinator"):
        mesh_lib.initialize_multihost(None, num_hosts=2, host_id=0)
    with pytest.raises(ValueError, match="coordinator"):
        mesh_lib.launch(print, world=2, num_hosts=2, device="cpu")


# ------------------------------------------------------- the sharded round
def seeded_agent():
    return sweep_app.build_agent(Config(), "", CPU)


def round_on_rank(mesh, cfg, sd, draws, lut):
    """One round on this rank's shard of the full weights ``sd`` under the
    global ``draws``: the metrics and the full weights after it."""
    agent = seeded_agent()
    agent.load_state_dict(sd)
    state = tloop.TrainState(agent, tloop.make_optimizers(cfg, agent),
                             PrecisionState.create(0.5),
                             env_lib.reset(torch.Generator().manual_seed(0), cfg.batch, CPU))
    state = mesh_lib.shard_train_state(state, mesh, cfg)
    _, metrics = tloop.make_round_fn(cfg, lut, mesh)(state, draws=draws)
    params = mesh_lib.full_state_dict(state.agent, mesh)
    return {"metrics": {k: float(v) for k, v in metrics.items()}, "params": params,
            "env_rows": state.env.batch,
            "adam": mesh_lib.full_opt_state(state.opts["mid"], mesh)["state"][1]["exp_avg"]}


@pytest.mark.parametrize("world, tp", [(2, 1), (4, 1), (4, 2)], ids=["dp2", "dp4", "dp2xtp2"])
def test_sharded_round_matches_single_rank(world, tp):
    cfg = Config(batch=B, **FLAGS)
    agent = seeded_agent()
    sd = copy.deepcopy(agent.state_dict())
    draws = tloop.draw_round(agent, cfg, B, torch.Generator().manual_seed(5), CPU)
    state = tloop.TrainState(agent, tloop.make_optimizers(cfg, agent),
                             PrecisionState.create(0.5), env_lib.reset(
                                 torch.Generator().manual_seed(0), B, CPU))
    lut = raster.build_sprite_lut(CPU)
    _, m1 = tloop.make_round_fn(cfg, lut)(state, draws=copy.deepcopy(draws))
    m1 = {k: float(v) for k, v in m1.items()}
    ranks = mesh_lib.launch(round_on_rank, (cfg, sd, draws, lut), world=world, n_model=tp,
                            device="cpu")
    assert [r["env_rows"] for r in ranks] == [B // (world // tp)] * world
    for r in ranks:  # every rank holds the same global metrics and weights
        m2 = r["metrics"]
        np.testing.assert_allclose(m2["F_down"], m1["F_down"], rtol=2e-3)
        np.testing.assert_allclose(m2["omega"], m1["omega"], rtol=2e-3)
        for k in ("F_top", "F_mid", "omega_std", "score", "gnorm_top", "gnorm_mid",
                  "gnorm_down"):
            np.testing.assert_allclose(m2[k], m1[k], rtol=2e-3, atol=1e-6, err_msg=k)
        atol = 5e-5 if tp == 1 else 3e-4
        for name, p in agent.state_dict().items():
            np.testing.assert_allclose(r["params"][name].numpy(), p.numpy(), rtol=0,
                                       atol=atol, err_msg=name)
    # Adam's moments gather back to the single-rank layout.
    mu = state.opts["mid"].state_dict()["state"][1]["exp_avg"]
    assert ranks[0]["adam"].shape == mu.shape
    np.testing.assert_allclose(ranks[0]["adam"].numpy(), mu.numpy(), rtol=2e-3,
                               atol=1e-3 * float(mu.abs().max()))


def test_single_rank_round_matches_jax():
    """The round the sharded rounds are held to, against the JAX package's
    ``train_round`` (tests/test_torch_loop.py holds it in full)."""
    import jax

    from deep_active_inference_mc_tpu import config as jconfig
    from deep_active_inference_mc_tpu.envs import raster as jraster
    from deep_active_inference_mc_tpu.train import loop as jloop
    from test_torch_loop import jax_state, port_state, round_draws
    from test_torch_models import jax_flagship, torch_agent

    ja, jp = jax_flagship()
    jcfg, tcfg = jconfig.Config(batch=B, **FLAGS), Config(batch=B, **FLAGS)
    key = jax.random.key(3)
    _, jm = jax.jit(jloop.make_round_fn(ja, jcfg, jraster.build_sprite_lut()))(
        jax_state(jcfg, jp, 0.5), key)
    _, tm = tloop.make_round_fn(tcfg, raster.build_sprite_lut(CPU))(
        port_state(torch_agent(jp), tcfg, 0.5), draws=round_draws(ja, jp, tcfg, key, B))
    for k in tloop.METRIC_KEYS:
        rtol = 1e-3 if k.startswith("gnorm") else 1e-4
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=rtol, atol=1e-3,
                                   err_msg=k)


# ---------------------------------------------------------------- sweeps
def sweep_on_rank(mesh, lut, kw):
    out = tsweep.run_sweep(seeded_agent(), Config(), lut, mesh=mesh, **kw)
    env = mesh_lib.full_env(out["env"], mesh)
    return {k: out[k] for k in ("scores", "scoring_events", "events_sq", "events_other",
                                "score_sq", "score_other", "score_mean", "score_traj")
            } | {"latents": env.latents}


@pytest.mark.parametrize("method, env_chunk", [("ai", None), ("habit", None),
                                               ("habit", 8)],
                         ids=["ai", "habit", "habit-env_chunk"])
def test_mesh_sweep_equals_single_rank(method, env_chunk):
    """Scores, tallies, the score trajectory and the end envs, exactly; two
    chunks, so the env carries across. With ``env_chunk`` each group is
    spread over both ranks again."""
    kw = dict(seed=2, n_envs=16, n_macro_steps=12, chunk=6, env_chunk=env_chunk,
              method=method, jumps=5, record_traj=True, temperature=10.0)
    lut = raster.build_sprite_lut(CPU)
    want = sweep_on_rank(None, lut, kw)
    got = mesh_lib.launch(sweep_on_rank, (lut, kw), world=2, device="cpu")[0]
    latents = want["latents"]
    if env_chunk:  # a rank's env holds its rows of every group, group-major
        latents = latents.reshape(16 // env_chunk, 2, -1, 6).transpose(0, 1).reshape(-1, 6)
    assert torch.equal(got["latents"], latents)
    assert torch.equal(got["scores"], want["scores"]) and want["scoring_events"] > 0
    assert torch.equal(got["score_traj"], want["score_traj"])
    for k in ("scoring_events", "events_sq", "events_other", "score_sq", "score_other",
              "score_mean"):
        assert got[k] == want[k], k


def test_macro_draws_replay_the_unsharded_stream():
    """``draw_macro`` draws what a single-rank macro step draws in line:
    injected, it gives the same step."""
    agent, lut = seeded_agent(), raster.build_sprite_lut(CPU)
    g = torch.Generator().manual_seed(7)
    env = env_lib.randomize(env_lib.reset(g, 6, CPU), g)
    run = tsweep.make_sweep(agent, Config(), lut, method="ai", n_macro_steps=1, jumps=5)
    inline = run(torch.Generator().manual_seed(9), env)
    d = tsweep.draw_macro(agent, "ai", 6, torch.Generator().manual_seed(9), CPU, jumps=5)
    injected = run(torch.Generator().manual_seed(9), env, draws=[d])
    assert torch.equal(inline["env"].latents, injected["env"].latents)
    assert torch.equal(inline["scores"], injected["scores"])


# ------------------------------------------------------------ writes
def train_on_rank(mesh, roots, argv):
    """The trainer's rank body with a run root per rank."""
    known = argparse.Namespace(resume=False, device="cpu", profile_dir=None)
    cfg = dataclasses.replace(Config.from_args(argv), out_root=roots[mesh.rank])
    train_app._train(mesh, cfg, known)
    return sorted(str(p.relative_to(roots[mesh.rank])) for p in
                  Path(roots[mesh.rank]).rglob("*") if p.is_file())


def test_non_primary_rank_writes_nothing(tmp_path):
    """As tests/test_parallel.py:178 checks for the JAX trainer: with a run
    root of its own, rank 1 trains, saves and evaluates with rank 0 and
    leaves its root empty."""
    roots = [str(tmp_path / "r0"), str(tmp_path / "r1")]
    argv = TINY[2:] + ["--epochs", "1", "--save_every", "1"]
    files = mesh_lib.launch(train_on_rank, (roots, argv), world=2, device="cpu")
    assert files[1] == [] and not Path(roots[1]).exists()
    assert any(f.endswith("config.json") for f in files[0])
    assert any(f.endswith("state.pt") for f in files[0])


def test_comm_gathers_without_a_group():
    x = torch.arange(6.0).reshape(3, 2)
    assert comm.gather_rows(x) is x and comm.gather_dim(x, 1) is x
    assert comm.all_reduce_(x) is x


def test_distillation_under_a_mesh_matches_one_rank(tmp_path):
    """The trainer's ``--distill_every`` on a 2-rank tensor-parallel mesh:
    the primary distills the gathered habit net and every rank takes its
    shard back, so the saved weights match a single-rank run's (Adam's
    steps amplify float reassociation, hence atol 1e-3)."""
    argv = TINY + ["--rounds", "1", "--sweep_steps", "1", "--epochs", "1", "--save_every", "1",
                   "--distill_every", "1", "--distill_envs", "4", "--distill_macro", "2",
                   "--distill_repeats", "2", "--distill_batch", "8"]
    one = train_app.main(argv + ["--out_root", str(tmp_path / "one")])
    mesh = train_app.main(argv + ["--out_root", str(tmp_path / "mesh"), "--mesh_shape", "2",
                                  "--tp", "2"])
    assert mesh["adam_steps"] == {"top": 1 + 4, "mid": 1, "down": 1}
    for k in ("distill_kl_first", "distill_kl_last", "distill_match_last"):
        np.testing.assert_allclose(mesh["stats"][k], one["stats"][k], rtol=1e-3, err_msg=k)
    want = torch.load(one["folder"] / "checkpoints" / "state" / "state.pt", weights_only=True)
    got = torch.load(mesh["folder"] / "checkpoints" / "state" / "state.pt", weights_only=True)
    for k, v in want["agent"].items():
        np.testing.assert_allclose(got["agent"][k].numpy(), v.numpy(), rtol=0, atol=1e-3,
                                   err_msg=k)


def describe(mesh):
    return mesh.describe()


def test_a_process_inside_a_launched_group_runs_as_its_rank(monkeypatch):
    """As under ``torchrun``: the group comes from the environment, and the
    process runs as its own rank instead of starting others."""
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    for k, v in dict(RANK="0", WORLD_SIZE="1", MASTER_ADDR="127.0.0.1",
                     MASTER_PORT=str(port)).items():
        monkeypatch.setenv(k, v)
    assert mesh_lib.in_launched_group()
    assert mesh_lib.launch(describe, world=1, device="cpu") == [
        "mesh: 1 ranks = data 1 x model 1, backend gloo, the CPU"]
    assert not torch.distributed.is_initialized()
