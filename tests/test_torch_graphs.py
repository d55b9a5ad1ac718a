"""PyTorch port: the hot loops as CUDA graphs (``utils/graphs.py``).

On the CPU the graphed paths' bodies run op by op (``eager_scan`` and the
sweep's eager loop), fed each step's noise drawn ahead, as a graph's
replays are fed. These tests hold that refactor:

- the training epoch over 3 rounds, a sweep chunk (``ai``, ``habit``, and
  ``t1`` with the plan queue) and the bench's env-step and G runs, with
  pre-drawn noise, bit-equal to the functional path that draws as it goes;
- the epoch through the new body against the JAX package's jitted epoch
  (``deep_active_inference_mc_tpu/train/loop.py:235``), 2 rounds under
  injected noise, to ``tests/test_torch_loop.py``'s tolerances;
- the graph helper raises on CPU tensors, and a graphed path asked for
  where it cannot run raises; Adam's ``capturable`` survives a checkpoint.

A ``cuda``-marked test captures and replays each path against its eager
body; without a card it skips. JAX is imported only inside the test that
compares with it, so the card's machine runs this file as
``python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_graphs.py``.
"""

import copy

import pytest
import torch

from deep_active_inference_mc_torch import bench
from deep_active_inference_mc_torch.config import Config
from deep_active_inference_mc_torch.envs import dsprites as tenv
from deep_active_inference_mc_torch.envs import raster as traster
from deep_active_inference_mc_torch.infer import efe
from deep_active_inference_mc_torch.infer.agent import ActiveInferenceAgent
from deep_active_inference_mc_torch.ops.cuda import LAUNCHES
from deep_active_inference_mc_torch.train import loop as tloop
from deep_active_inference_mc_torch.train import sweep as tsweep
from deep_active_inference_mc_torch.utils import graphs
from deep_active_inference_mc_torch.utils.device import seeded_generator

CPU = torch.device("cpu")
FLAGSHIP_GEN = dict(crn=True, gen_mean=True, explore_eps=0.1, edge_frac=0.3, gen_habit_mix=0.5)


@pytest.fixture(autouse=True, scope="module")
def few_torch_threads():
    """Two intra-op threads: the suite runs in several processes at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def lut():
    return traster.build_sprite_lut(CPU)


@pytest.fixture(scope="module")
def agent():
    a = ActiveInferenceAgent()
    a.init(seeded_generator(CPU, 0))
    return a


def fresh_envs(batch, device=CPU, seed=1):
    g = seeded_generator(device, seed)
    return tenv.randomize(tenv.reset(g, batch, device), g)


def assert_trees_equal(a, b):
    la, lb = graphs.leaves_of(a), graphs.leaves_of(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        assert x.dtype == y.dtype and torch.equal(x, y)


def train_state(cfg, agent, device=CPU):
    agent = copy.deepcopy(agent).to(device)
    return tloop.TrainState(agent, tloop.make_optimizers(cfg, agent),
                            tloop.PrecisionState.create(0.5, device=device),
                            tenv.reset(seeded_generator(device, 2), cfg.batch, device))


# ------------------------------------------------------------ the epoch
@pytest.mark.parametrize("flags", [{}, FLAGSHIP_GEN], ids=["defaults", "flagship-flags"])
def test_epoch_body_with_drawn_noise_equals_the_round_loop(agent, lut, flags):
    """3 rounds: the epoch's scan body fed each round's draws ahead equals
    ``train_round`` drawing as it goes, in the metrics, the weights, Adam's
    moments and the envs."""
    cfg = Config(batch=4, **flags)
    rounds = 3
    loop_state, g = train_state(cfg, agent), torch.Generator().manual_seed(9)
    round_fn = tloop.make_round_fn(cfg, lut)
    rows = []
    for _ in range(rounds):
        loop_state, m = round_fn(loop_state, g)
        rows.append(torch.stack([m[k] for k in tloop.METRIC_KEYS]))
    g = torch.Generator().manual_seed(9)
    scan_state = train_state(cfg, agent)
    draws = [tloop.draw_round(scan_state.agent, cfg, cfg.batch, g, CPU) for _ in range(rounds)]
    scan_state, out = tloop.make_epoch_fn(cfg, lut, rounds)(scan_state, None, draws=draws)
    assert [out[k] for k in tloop.METRIC_KEYS] == rows[-1].tolist()
    for k in tloop.EPOCH_MAX_KEYS:
        assert out[k + "_max"] == max(r[tloop.METRIC_KEYS.index(k)].item() for r in rows)
    assert_trees_equal(list(loop_state.agent.state_dict().values()),
                       list(scan_state.agent.state_dict().values()))
    for k in tloop.LAYERS:
        assert_trees_equal(graphs.optimizer_deps(loop_state.opts[k]),
                           graphs.optimizer_deps(scan_state.opts[k]))
    assert_trees_equal(loop_state.env, scan_state.env)


def test_epoch_matches_the_jax_jitted_epoch():
    """2 rounds of the JAX package's jitted epoch (its ``lax.scan`` of
    rounds, keys split per round) and of the port's epoch body, the port's
    noise rebuilt from each round's key: the last round's metrics and the
    worst-round maxima to ``test_torch_loop.py``'s second-round
    tolerances."""
    import jax
    import numpy as np

    from deep_active_inference_mc_tpu import config as jconfig
    from deep_active_inference_mc_tpu.envs import raster as jraster
    from deep_active_inference_mc_tpu.infer.agent import ActiveInferenceAgent as JAgent
    from deep_active_inference_mc_tpu.train import loop as jloop
    from test_torch_loop import jax_state, port_state, round_draws
    from test_torch_models import torch_agent

    B, rounds = 4, 2
    ja = JAgent()
    jp = jax.jit(ja.init)(jax.random.key(3))
    jcfg, tcfg = jconfig.Config(batch=B, **FLAGSHIP_GEN), Config(batch=B, **FLAGSHIP_GEN)
    key = jax.random.key(11)
    js, jm = jax.jit(jloop.make_epoch_fn(ja, jcfg, jraster.build_sprite_lut(), rounds))(
        jax_state(jcfg, jp, gamma=0.5), key)
    draws = [round_draws(ja, jp, tcfg, k, B) for k in jax.random.split(key, rounds)]
    epoch = tloop.make_epoch_fn(tcfg, traster.build_sprite_lut(CPU), rounds)
    ts, tm = epoch(port_state(torch_agent(jp), tcfg, gamma=0.5), None, draws=draws)
    assert set(tm) == set(jm)
    for k in tm:
        rtol = (1e-3 if k.startswith("gnorm") else 1e-4) * 20
        np.testing.assert_allclose(tm[k], float(jm[k]), rtol=rtol, atol=1e-3, err_msg=k)
    np.testing.assert_array_equal(ts.env.latents.numpy(), np.asarray(js.env.latents))
    assert all(int(o.state_dict()["state"][0]["step"]) == rounds for o in ts.opts.values())


# ------------------------------------------------------------ the sweep
@pytest.mark.parametrize("method,queue", [("ai", False), ("habit", False), ("t1", True)])
def test_sweep_chunk_with_drawn_noise_equals_the_drawing_chunk(agent, lut, method, queue):
    """A 3-macro-step chunk at 8 envs, and a second chunk carrying the
    queue: the macro-step body fed ``draw_macro``'s draws equals the chunk
    that draws as it goes, in every score, tally, env and queue entry."""
    cfg = Config()
    run = tsweep.make_sweep(agent, cfg, lut, method=method, n_macro_steps=3, plan_queue=queue,
                            steps=2 if queue else 1, record_traj=True)
    outs = {}
    for mode in ("drawing", "drawn"):
        env, qstate, res = fresh_envs(8), None, []
        for chunk in range(2):
            g = seeded_generator(CPU, 5, chunk)
            draws = None
            if mode == "drawn":
                draws = [tsweep.draw_macro(agent, method, 8, g, CPU, steps=2 if queue else 1)
                         for _ in range(3)]
            out = run(g if mode == "drawing" else None, env, qstate, draws=draws)
            env, qstate = out["env"], out.get("qstate")
            res.append(out)
        outs[mode] = res
    for a, b in zip(outs["drawing"], outs["drawn"]):
        assert_trees_equal((a["scores"], a["score_traj"], a["env"], a.get("qstate")),
                           (b["scores"], b["score_traj"], b["env"], b.get("qstate")))
        for k in ("scoring_events", "events_sq", "events_other", "score_sq", "score_other"):
            assert a[k] == b[k]
    assert ("qstate" in outs["drawn"][0]) == queue


# ------------------------------------------------------------ the bench
def test_bench_env_step_run_equals_the_drawing_loop(lut):
    """8 steps at 32 envs (half near the top edge, so objects respawn):
    the run's scan body fed each step's action and respawns equals
    ``env_step`` drawing its respawns as it goes, checksum included."""
    start = fresh_envs(32)
    start.latents[:16, 5] = 31
    state, acc = bench.env_step_run(lut, start, 3, 8)
    g = seeded_generator(CPU, 3)
    want, chk = start, torch.zeros(())
    for _ in range(8):
        a = torch.randint(0, tenv.NUM_ACTIONS, (32,), generator=g)
        want, c = bench.env_step(lut, want, a, g)
        chk += c
    assert_trees_equal((state, acc), (want, chk))
    assert not torch.equal(state.latents, start.latents)


def test_bench_g_run_equals_the_drawing_estimates(agent, lut):
    """2 single-step G estimates of 4 frames x every action: the scan body
    fed ``draw_rollout``'s draws equals ``calculate_G_4_repeated`` drawing
    its own, in the summed G."""
    o = tenv.render(lut, fresh_envs(4))
    got = bench.efe_run(agent, o, 4, 2)
    g = seeded_generator(CPU, 4)
    want = torch.zeros(())
    for _ in range(2):
        G, _, _ = efe.calculate_G_4_repeated(agent, o, g, steps=1, calc_mean=True, samples=1)
        want += G.sum()
    assert torch.equal(got, want)


# ------------------------------------------------------------ the helper
def test_graph_helper_raises_on_cpu_tensors():
    with pytest.raises(ValueError, match="CUDA tensors only"):
        graphs.Graphs().scan(lambda c, x: (c, None), torch.zeros(2), iter([None]), 1)


def test_graphed_paths_refuse_what_they_cannot_run(agent, lut):
    """A graphed epoch, sweep or bench run on CPU tensors raises (no
    fallback); so does a graphed mcts sweep, and a graphed epoch under a
    mesh."""
    cfg = Config(batch=2)
    with pytest.raises(ValueError, match="CUDA tensors only"):
        tloop.make_epoch_fn(cfg, lut, 1, graphed=True)(train_state(cfg, agent), None,
                                                       draws=[None])
    with pytest.raises(ValueError, match="CUDA tensors only"):
        tsweep.make_sweep(agent, cfg, lut, method="habit", n_macro_steps=1,
                          graphed=True)(seeded_generator(CPU, 0), fresh_envs(2))
    with pytest.raises(ValueError, match="CUDA tensors only"):
        bench.bench_env_steps(lut, batch=2, iters=1, reps=1, graphed=True)
    with pytest.raises(ValueError, match="not for mcts"):
        tsweep.make_sweep(agent, cfg, lut, method="mcts", graphed=True)
    with pytest.raises(ValueError, match="one rank"):
        tloop.make_epoch_fn(cfg, lut, 1, mesh=object(), graphed=True)


def test_tree_helpers_round_trip_the_round_draws(agent):
    """``leaves_of`` / ``rebuild`` over a round's draws (dataclasses, lists,
    tuples, None) give back the same structure with the new tensors."""
    cfg = Config(batch=2, **FLAGSHIP_GEN)
    d = tloop.draw_round(agent, cfg, 2, torch.Generator().manual_seed(0), CPU)
    leaves = graphs.leaves_of(d)
    copies = [t.clone() for t in leaves]
    back = graphs.rebuild(d, copies)
    assert type(back) is type(d) and back.data.rollout.eps0 is None
    assert all(a is b for a, b in zip(graphs.leaves_of(back), copies))
    assert_trees_equal(back, d)


def test_optimizer_load_keeps_its_own_capturable(agent):
    """A state saved by a capturable Adam (a card's) loads into a CPU
    Adam as a CPU one: ``capturable`` stays False and the step counters
    stay 0-d float32 tensors on the CPU, the format a checkpoint holds."""
    cfg = Config(batch=2)
    opts = tloop.make_optimizers(cfg, copy.deepcopy(agent))
    assert not any(g["capturable"] for o in opts.values() for g in o.param_groups)
    p = next(iter(opts["mid"].param_groups[0]["params"]))
    p.grad = torch.ones_like(p)
    opts["mid"].step()
    sd = opts["mid"].state_dict()
    saved = dict(sd, param_groups=[dict(g, capturable=True) for g in sd["param_groups"]])
    fresh = tloop.make_optimizers(cfg, copy.deepcopy(agent))["mid"]
    tloop.load_optimizer_state(fresh, saved)
    assert fresh.param_groups[0]["capturable"] is False
    step = fresh.state_dict()["state"][0]["step"]
    assert step.device == CPU and step.dtype == torch.float32 and int(step) == 1


# ------------------------------------------------------------ on a card
@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: run `python -m pytest --noconftest -m cuda "
                    "tests/test_torch_graphs.py` on one")
    return torch.device("cuda")


@pytest.mark.cuda
def test_each_graphed_path_replays_its_eager_body(cuda_device):
    """On a card, each path graphed against the same body op by op, from
    one seed: the env-step and G runs and the ai / habit / t1+queue /
    expert sweep chunks bit-equal, the epoch's metrics within 1e-5
    relative (cuDNN deterministic); K1's launch counts equal; the second call of a path replays
    without a new capture."""
    dev = cuda_device
    lut = traster.build_sprite_lut(dev)
    agent = ActiveInferenceAgent().to(dev)
    agent.init(seeded_generator(dev, 0))
    start = fresh_envs(64, dev)

    def both(run):
        out = {}
        for graphed in (False, True):
            LAUNCHES.clear()
            out[graphed] = (run(graphed), LAUNCHES.get("render", 0))
        return out[False], out[True]

    with torch.inference_mode():
        g_env = graphs.Graphs()
        (e, le), (g, lg) = both(lambda gr: bench.env_step_run(lut, start, 1, 6,
                                                              g_env if gr else None))
        assert_trees_equal(e, g)
        assert le == lg == 6
        bench.env_step_run(lut, start, 2, 6, g_env)
        assert (g_env.captures, g_env.replays) == (1, 5 + 6)  # the warm-up step is eager
        o = tenv.render(lut, start)
        (e, _), (g, _) = both(lambda gr: bench.efe_run(agent, o, 1, 3,
                                                       graphs.Graphs() if gr else None))
        assert torch.equal(e, g)
    for method, queue in (("ai", False), ("habit", False), ("t1", True), ("expert", False)):
        def sweep(graphed):
            run = tsweep.make_sweep(agent, Config(), lut, method=method, n_macro_steps=4,
                                    plan_queue=queue, steps=2 if queue else 1, graphed=graphed)
            return run(seeded_generator(dev, 3), start)
        (e, le), (g, lg) = both(sweep)
        assert_trees_equal((e["scores"], e["env"], e.get("qstate")),
                           (g["scores"], g["env"], g.get("qstate")))
        assert le == lg == 4, method
    cfg = Config(batch=16, **FLAGSHIP_GEN)

    def epoch(graphed):
        state = train_state(cfg, agent, dev)
        fn = tloop.make_epoch_fn(cfg, lut, 3, graphed=graphed)
        state, out = fn(state, seeded_generator(dev, 4))
        state, out = fn(state, seeded_generator(dev, 5))
        assert fn.graphs.captures == int(graphed)
        return out, [int(o.state_dict()["state"][0]["step"]) for o in state.opts.values()]

    # cuDNN's default float32 backward sums with atomics, so eager differs
    # from eager; its deterministic algorithms leave the graph's replays
    # nothing to differ by.
    saved = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        (e, le), (g, lg) = both(epoch)
    finally:
        torch.backends.cudnn.deterministic = saved
    assert e[1] == g[1] == [6, 6, 6] and le == lg == 12
    for k in e[0]:
        assert abs(g[0][k] - e[0][k]) <= 1e-5 * abs(e[0][k]), k
