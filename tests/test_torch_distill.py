"""PyTorch port: MCTS-visit distillation (``train/distill.py``), the
trainer's ``--distill_every`` hook and the distillation CLI
(``apps/distill.py``), against the JAX package where it has a counterpart.

``visit_targets`` holds to rtol 1e-6; one replay step on the converted
flagship, with the JAX step's encoder noise rebuilt from its key and the
same fresh Adam state, holds F, the argmax match and the new ``top``
weights to 1e-5. The collect runs on the deterministic mock of the model
(tests/test_mcts.py's, with a frame encoder that rounds the same in both
packages) with the JAX env draws rebuilt from their keys: the records are
equal.
"""

import contextlib
import dataclasses
import io

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deep_active_inference_mc_tpu import config as jconfig
from deep_active_inference_mc_tpu.envs import dsprites as jenv
from deep_active_inference_mc_tpu.envs import raster as jraster
from deep_active_inference_mc_tpu.plan import mcts as jmcts
from deep_active_inference_mc_tpu.train import distill as jdistill
from deep_active_inference_mc_tpu.train import loop as jloop
from deep_active_inference_mc_torch import config as tconfig
from deep_active_inference_mc_torch.apps import distill as distill_app
from deep_active_inference_mc_torch.apps import train as train_app
from deep_active_inference_mc_torch.envs import dsprites as tenv
from deep_active_inference_mc_torch.envs import raster as traster
from deep_active_inference_mc_torch.infer.agent import ActiveInferenceAgent
from deep_active_inference_mc_torch.plan import mcts as tmcts
from deep_active_inference_mc_torch.train import distill as tdistill
from deep_active_inference_mc_torch.train import loop as tloop
from deep_active_inference_mc_torch.train import sweep as tsweep
from deep_active_inference_mc_torch.utils import checkpoint as ckpt
from test_mcts import A, C_A, D_A, W_G, MockAgent, mock_calculate_G_mean
from test_torch_data import env_draws, respawn_draws
from test_torch_losses import jax_normal
from test_torch_mcts import TMockAgent, t_mock_calculate_G_mean
from test_torch_models import few_torch_threads  # noqa: F401 (autouse fixture)
from test_torch_models import jax_flagship, torch_agent

TINY = dict(batch=8, distill_envs=4, distill_macro=3, distill_repeats=6, distill_expand_k=2,
            distill_batch=8, distill_passes=2)
# The CLIs' runs: one planner iteration per decision, one step per pass.
FAST = dict(distill_envs=4, distill_macro=2, distill_repeats=2, distill_expand_k=2,
            distill_batch=8, distill_passes=2)
FAST_ARGS = [x for k, v in FAST.items() for x in (f"--{k}", str(v))]
TRAIN_TINY = ["--device", "cpu", "--rounds", "2", "--test_size", "16", "--sweep_envs", "8",
              "--sweep_steps", "2", "--viz_every", "1000"]


@pytest.fixture(scope="module")
def flagship():
    agent, params = jax_flagship()
    return agent, params, torch_agent(params)


@pytest.fixture(scope="module")
def luts():
    return jraster.build_sprite_lut(), traster.build_sprite_lut("cpu")


def seeded_agent(seed=0):
    return ActiveInferenceAgent().init(torch.Generator().manual_seed(seed))


@pytest.mark.parametrize("temp", [0.5, 1.0, 2.0])
def test_visit_targets_match_jax(temp):
    N = np.random.default_rng(0).integers(0, 40, (64, 4)).astype(np.float32)
    N[0] = 0.0  # an unvisited root: the clamp keeps it finite
    want = np.asarray(jdistill.visit_targets(jnp.asarray(N), temp))
    got = tdistill.visit_targets(torch.from_numpy(N), temp).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-12)
    np.testing.assert_allclose(got[1:].sum(-1), 1.0, rtol=1e-6)


def test_dstep_matches_jax(flagship, luts):
    """One replay step from the same fresh Adam state: F, the match and
    the new top weights to 1e-5."""
    ja, jp, ta = flagship
    jlut, tlut = luts
    jcfg, tcfg = jconfig.Config(), tconfig.Config()
    rows = 16
    rng = np.random.default_rng(3)
    lat = np.stack([rng.integers(0, n, rows) for n in (1, 3, 6, 40, 32, 32)], -1)
    last_r = rng.uniform(-1, 1, rows).astype(np.float32)
    N = rng.integers(0, 30, (rows, 4)).astype(np.float32)
    log_target = np.log(np.asarray(jdistill.visit_targets(jnp.asarray(N))) + 1e-20)
    key = jax.random.key(5)

    top_opt = jloop.make_optimizers(jcfg)["top"]
    jd = jdistill.Distiller(ja, jcfg, jlut, top_opt)
    new_top, _, F, match = jd._dstep(jp, top_opt.init(jp["top"]), key,
                                     jnp.asarray(lat, jnp.int32), jnp.asarray(last_r),
                                     jnp.asarray(log_target))

    agent = torch_agent(jp)
    opt = tloop.make_optimizers(tcfg, agent)["top"]
    td = tdistill.Distiller(agent, tcfg, tlut)
    got_F, got_match = td.dstep(
        opt, torch.from_numpy(lat), torch.from_numpy(last_r), torch.from_numpy(log_target),
        draws=tdistill.StepDraws(eps=jax_normal(jax.random.split(key)[1], rows)))
    np.testing.assert_allclose(float(got_F), float(F), rtol=1e-5)
    np.testing.assert_allclose(float(got_match), float(match), rtol=1e-5)
    for i in range(3):
        w = np.asarray(new_top[f"Dense_{i}"]["kernel"]).T
        np.testing.assert_allclose(agent.top.fc[i].weight.detach().numpy(), w,
                                   rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(agent.top.fc[i].bias.detach().numpy(),
                                   np.asarray(new_top[f"Dense_{i}"]["bias"]), rtol=1e-5,
                                   atol=1e-5)
    # The step moved the weights and left mid and down alone.
    assert not torch.equal(agent.top.fc[0].weight, ta.top.fc[0].weight)
    for name in ("mid", "down"):
        for a, b in zip(getattr(agent, name).parameters(), getattr(ta, name).parameters()):
            assert torch.equal(a, b)


# ---- the collect on the deterministic mock ----------------------------------
def jax_frame_states(frames):
    """(B, 6) states from NHWC frames: the reward strip's two end
    pixels and four row-band sums of the binary sprite (integers, exact in
    any order), scaled by a power of two."""
    f = frames[..., 0]
    bands = [jnp.sum(f[:, 3 + 15 * j:18 + 15 * j], axis=(1, 2)) / 64.0 for j in range(4)]
    return jnp.stack([f[:, 1, 0], f[:, 1, 63]] + bands, axis=-1)


def torch_frame_states(frames):
    f = frames[:, 0]
    bands = [torch.sum(f[:, 3 + 15 * j:18 + 15 * j], dim=(1, 2)) / 64.0 for j in range(4)]
    return torch.stack([f[:, 1, 0], f[:, 1, 63]] + bands, dim=-1)


class FrameMockAgent(MockAgent):
    def encode(self, params, frames):
        return jax_frame_states(frames), None


class TFrameMockAgent(TMockAgent):
    def encode(self, frames):
        return torch_frame_states(frames), None


def mock_fused(agent, params, key, leaf_s, p):
    """The fused evaluator on the mock: the mock expand for every action,
    the mock simulation."""
    G = (leaf_s @ jnp.asarray(W_G))[:, None] + jnp.asarray(C_A)[None]
    ps_next = leaf_s[:, None] * 0.9 + jnp.asarray(D_A)[None]
    e = jnp.exp(leaf_s[:, :A] - leaf_s[:, :A].max(-1, keepdims=True))
    return G, ps_next, jnp.sum(leaf_s, -1) * 0.7, e / e.sum(-1, keepdims=True)


def t_mock_fused(agent, leaf_s, p, generator=None, draws=None):
    G = (leaf_s @ torch.from_numpy(W_G))[:, None] + torch.from_numpy(C_A)[None]
    ps_next = leaf_s[:, None] * 0.9 + torch.from_numpy(D_A)[None]
    e = torch.exp(leaf_s[:, :A] - leaf_s[:, :A].max(dim=-1, keepdim=True).values)
    return G, ps_next, leaf_s.sum(dim=-1) * 0.7, e / e.sum(dim=-1, keepdim=True)


def test_collect_records_equal_jax(monkeypatch, luts):
    """4 envs, 3 decisions, 6 repeats at expand_k 2: the JAX collect
    (``Distiller._collect``'s steps composed from the public functions)
    and the port's give equal latents, last rewards and root visits."""
    monkeypatch.setattr(jmcts.efe, "calculate_G_mean", mock_calculate_G_mean)
    monkeypatch.setattr(jmcts, "_fused_expand_sim", mock_fused)
    monkeypatch.setattr(tmcts.efe, "calculate_G_mean", t_mock_calculate_G_mean)
    monkeypatch.setattr(tmcts, "_fused_expand_sim", t_mock_fused)
    jlut, tlut = luts
    cfg = tconfig.Config(**TINY)
    p = jmcts.MCTSParams(repeats=cfg.distill_repeats, expand_k=cfg.distill_expand_k,
                         fused_eval=True, max_depth=16)
    key = jax.random.key(7)
    k_env, k_run = jax.random.split(key)
    env = jenv.randomize(k_env, jenv.reset(k_env, cfg.distill_envs))
    want, respawns = [], []
    for k in jax.random.split(k_run, cfg.distill_macro):
        k_plan, k_step = jax.random.split(k)
        o = jenv.render(jlut, env)
        res = jmcts.active_inference_mcts(FrameMockAgent(), {}, k_plan, o, p)
        a = jnp.where(res.lengths > 0, res.actions[:, 0],
                      jnp.argmax(res.root_N, -1).astype(jnp.int32))
        want.append((env.latents, env.last_r, res.root_N))
        respawns.append(respawn_draws(k_step, cfg.distill_envs, cfg.repeats))
        env, _ = jenv.step_repeated(k_step, env, a, repeats=cfg.repeats)
    distiller = tdistill.Distiller(TFrameMockAgent(), cfg, tlut)
    lat, last_r, root_N = distiller.collect(
        draws=tdistill.CollectDraws(env=env_draws(k_env, cfg.distill_envs), respawns=respawns))
    assert lat.shape == (12, 6) and root_N.shape == (12, 4)
    np.testing.assert_array_equal(lat.numpy(), np.concatenate([np.asarray(w[0]) for w in want]))
    np.testing.assert_array_equal(last_r.numpy(),
                                  np.concatenate([np.asarray(w[1]) for w in want]))
    np.testing.assert_array_equal(root_N.numpy(),
                                  np.concatenate([np.asarray(w[2]) for w in want]))
    # The fleet moved and scored on the way: the records are not one state.
    assert len({tuple(r) for r in lat.tolist()}) > 4


def test_phase_changes_only_top_and_its_adam():
    cfg = tconfig.Config(**FAST)
    agent = seeded_agent()
    state = tloop.create_train_state(cfg, agent, torch.Generator().manual_seed(1), "cpu")
    before = {k: v.clone() for k, v in agent.state_dict().items()}
    opt_before = {k: str(o.state_dict()) for k, o in state.opts.items()}
    distiller = tdistill.Distiller(agent, cfg, traster.build_sprite_lut("cpu"))
    state, metrics = distiller(state, torch.Generator().manual_seed(2))
    after = agent.state_dict()
    for k, v in before.items():
        if k.startswith("top."):
            continue
        assert torch.equal(after[k], v), k
    assert any(not torch.equal(after[k], v) for k, v in before.items() if k.startswith("top."))
    for k in ("mid", "down"):
        assert str(state.opts[k].state_dict()) == opt_before[k]
    steps = cfg.distill_passes * (cfg.distill_envs * cfg.distill_macro // cfg.distill_batch)
    assert metrics["distill_steps"] == steps == 2
    assert tloop_step_count(state.opts["top"]) == steps
    for k, v in metrics.items():
        assert np.isfinite(v), k
    assert 0.0 <= metrics["distill_target_entropy"] <= np.log(4.0) + 1e-6
    # Every draw injected (the planner seeded by the decision): two phases
    # from the same weights and the same fresh Adam end bit-equal.
    g = torch.Generator().manual_seed(5)
    n = cfg.distill_envs * cfg.distill_macro
    draws = tdistill.DistillDraws(
        collect=tdistill.CollectDraws(
            env=tenv.draw_randomize(g, cfg.distill_envs, "cpu"),
            respawns=[tenv.sample_latents(g, (cfg.repeats, cfg.distill_envs), "cpu")
                      for _ in range(cfg.distill_macro)]),
        perms=[torch.randperm(n, generator=g) for _ in range(cfg.distill_passes)],
        steps=[tdistill.StepDraws(eps=torch.randn(cfg.distill_batch, 10, generator=g))
               for _ in range(steps)])
    start = {k: v.clone() for k, v in agent.top.state_dict().items()}
    tops = []
    for _ in range(2):
        agent.top.load_state_dict(start)
        state.opts["top"] = tloop.make_optimizers(cfg, agent)["top"]
        distiller(state, draws=draws)
        tops.append({k: v.clone() for k, v in agent.top.state_dict().items()})
    assert all(torch.equal(tops[0][k], tops[1][k]) for k in start)


def tloop_step_count(opt):
    return int(next(iter(opt.state_dict()["state"].values()))["step"])


def test_zero_step_phase_raises():
    cfg = tconfig.Config(**{**TINY, "distill_passes": 0})
    agent = seeded_agent()
    state = tloop.create_train_state(cfg, agent, torch.Generator().manual_seed(1), "cpu")
    with pytest.raises(ValueError, match="0 steps"):
        tdistill.Distiller(agent, cfg, traster.build_sprite_lut("cpu"))(
            state, torch.Generator().manual_seed(2))


@pytest.fixture(scope="module")
def distilled_run(tmp_path_factory):
    """A tiny trainer run with ``--distill_every 2``: 2 epochs, a checkpoint
    after each (the distillation CLI's tests start from it)."""
    root = tmp_path_factory.mktemp("distill_run")
    text = io.StringIO()
    with contextlib.redirect_stdout(text):
        out = train_app.main(TRAIN_TINY + FAST_ARGS + [
            "--batch", "8", "--epochs", "2", "--save_every", "1", "--distill_every", "2",
            "--out_root", str(root)])
    return out, text.getvalue()


def test_trainer_distill_every_fills_series_and_saves_after(distilled_run):
    """``--distill_every 2``: epoch 2 prints a ``distill@2`` line and fills
    the distill series (zero on epoch 1), and the checkpoint holds the
    distilled top."""
    out, text = distilled_run
    assert [ln.split(":")[0].strip() for ln in text.splitlines() if "distill@" in ln] == [
        "distill@2"]
    stats = out["stats"]
    for k in ("distill_kl_first", "distill_kl_last", "distill_match_first",
              "distill_target_entropy"):
        assert stats[k][0] == 0.0 and stats[k][1] != 0.0, k
    # Top: 2 rounds per epoch + 2 distill steps; mid and down: the rounds.
    steps = {k: tloop_step_count(o) for k, o in out["state"].opts.items()}
    assert steps == {"top": 6, "mid": 4, "down": 4}
    saved = torch.load(out["folder"] / "checkpoints" / "state" / "state.pt", weights_only=True)
    for k, v in out["state"].agent.top.state_dict().items():
        assert torch.equal(saved["agent"][f"top.{k}"], v), k


@pytest.fixture(scope="module")
def tiny_checkpoint(distilled_run):
    return distilled_run[0]["folder"] / "checkpoints"


def test_distill_cli_keeps_best_top_and_stops_early(tiny_checkpoint, tmp_path, monkeypatch,
                                                    capsys):
    """Scripted readouts 0.1 (iter 0), 0.5, 0.2, 0.3: the best is iter 1,
    ``--patience 2`` stops after iter 3, and the saved top is iter 1's."""
    scores = iter([0.1, 0.5, 0.2, 0.3, 0.9])

    def fake_make_sweep(*a, **kw):
        return lambda gen, env: {"score_mean": next(scores), "score_sem": 0.0}

    tops = []
    real_call = tdistill.Distiller.__call__

    def recording_call(self, state, generator=None, draws=None):
        out = real_call(self, state, generator, draws)
        tops.append({k: v.clone() for k, v in self.agent.top.state_dict().items()})
        return out

    monkeypatch.setattr(tsweep, "make_sweep", fake_make_sweep)
    monkeypatch.setattr(tdistill.Distiller, "__call__", recording_call)
    out_dir = tmp_path / "distilled"
    res = distill_app.main(["-n", str(tiny_checkpoint), "-o", str(out_dir), "--device", "cpu",
                            "--iters", "10", "--patience", "2", *FAST_ARGS,
                            "--sweep_envs", "8", "--sweep_steps", "2"])
    text = capsys.readouterr().out
    assert res["iters_run"] == 3 and res["best_iter"] == 1 and res["readouts"] == [
        0.1, 0.5, 0.2, 0.3]
    assert "Early stop" in text and "Restoring best habit (iter 1" in text
    agent = ckpt.load_weights(out_dir, ActiveInferenceAgent())
    for k, v in tops[0].items():
        assert torch.equal(agent.top.state_dict()[k], v), k
    assert not torch.equal(agent.top.fc[0].weight, tops[-1]["fc.0.weight"])
    # The default resets the top Adam: its step count is this run's 3 phases.
    assert tloop_step_count(res["state"].opts["top"]) == 3 * 2


@pytest.mark.parametrize("keep_opt", [False, True])
def test_distill_cli_keep_opt(tiny_checkpoint, tmp_path, keep_opt):
    loaded = torch.load(tiny_checkpoint / "state" / "state.pt", weights_only=True)
    before = int(next(iter(loaded["opt_states"]["top"]["state"].values()))["step"])
    assert before == 6  # the trainer's 4 rounds and 2 distill steps
    res = distill_app.main(["-n", str(tiny_checkpoint), "-o", str(tmp_path / "d"), "--device",
                            "cpu", "--iters", "1", *FAST_ARGS, "--sweep_envs", "8",
                            "--sweep_steps", "2"] + (["--keep_opt"] if keep_opt else []))
    assert tloop_step_count(res["state"].opts["top"]) == (before if keep_opt else 0) + 2
    # mid and down come out of the saved checkpoint bit for bit.
    saved = torch.load(tmp_path / "d" / "state" / "state.pt", weights_only=True)
    for k, v in loaded["agent"].items():
        if not k.startswith("top."):
            assert torch.equal(saved["agent"][k], v), k
    assert dataclasses.is_dataclass(res["state"])
