"""PyTorch port: the JAX package's remaining single-card compiled functions
as CUDA graphs (``utils/graphs.py``'s ``Graphs.call`` and ``Graphs.scan``):
the causal epoch and eval (``train/causal.py``), the trainer's eval pass
(``train/evaluate.py``), distillation's replay steps (``train/distill.py``)
and the demo's device-queue round (``apps/demo.py``).

On the CPU a graph's body runs op by op. ``EagerGraphs`` below stands in
for ``Graphs`` (its ``call`` calls the function, its ``scan`` is
``eager_scan``), so ``graphed=True`` takes the graph's path on the CPU:
the noise drawn ahead, the inputs handed over as the replays take them.
These tests hold, at B 4 to 16 on the CPU:

- (a) the causal epoch fed ``draw_causal_round``'s draws equal to the
  rounds drawing as they go, bit for bit (metrics, weights, Adam, envs,
  the generator's state);
- (b) two rounds of the JAX package's jitted causal epoch
  (``deep_active_inference_mc_tpu/train/causal.py:138``) against the
  port's, the noise rebuilt from each round's key: metrics and weights to
  ``tests/test_torch_causal.py``'s 1e-4;
- (c) the causal eval against JAX's ``make_jit_causal_eval`` on rebuilt
  draws: the five scalars and the latents to 1e-4, the frames bit for
  bit, the decode to 1e-4;
- (d) the trainer's eval pass fed ``draw_eval``'s draws equal to the pass
  drawing as it goes, bit for bit;
- (e) a distillation phase's replay scan, fed each step's minibatch and
  ``draw_step``'s noise, equal to the op-by-op loop that draws as it goes,
  bit for bit (F, match, the top weights and Adam's state);
- (f) ``run_round`` (the device queue, its ticks and plans through the
  graph's path) equal to 100 host ticks (the queue a host list, the plans
  op by op) for ``habit``, ``ai`` and ``t1``: the score after every tick,
  the plans, the final envs;
- (g) every entry point building its path graphed by default (on a card),
  op by op when asked or under a mesh; ``graphed=True`` and
  ``Graphs.call`` raising on the CPU.

A ``cuda``-marked test replays each new graphed path against its eager
body, bit for bit under cuDNN's deterministic algorithms; without a card
it skips. JAX is imported only inside the tests that compare with it, so
the card's machine runs this file as
``python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_call_graphs.py``.
"""

import argparse
import copy
import inspect

import numpy as np
import pytest
import torch

from deep_active_inference_mc_torch.apps import demo as demo_app
from deep_active_inference_mc_torch.apps import train as train_app
from deep_active_inference_mc_torch.config import Config
from deep_active_inference_mc_torch.envs import dsprites as tenv
from deep_active_inference_mc_torch.envs import raster as traster
from deep_active_inference_mc_torch.infer.agent import ActiveInferenceAgent
from deep_active_inference_mc_torch.infer.precision import PrecisionState
from deep_active_inference_mc_torch.models.causal import StructuralCausalModel
from deep_active_inference_mc_torch.ops.cuda import LAUNCHES
from deep_active_inference_mc_torch.train import causal as tcausal
from deep_active_inference_mc_torch.train import distill as tdistill
from deep_active_inference_mc_torch.train import evaluate as teval
from deep_active_inference_mc_torch.train import loop as tloop
from deep_active_inference_mc_torch.utils import graphs
from deep_active_inference_mc_torch.utils.device import seeded_generator

CPU = torch.device("cpu")
B = 4
TOL = dict(rtol=1e-4, atol=1e-4)  # tests/test_torch_causal.py's


@pytest.fixture(autouse=True, scope="module")
def few_torch_threads():
    """Two intra-op threads: the suite runs in several processes at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


class EagerGraphs:
    """``Graphs`` for any device: ``call`` calls the function, ``scan``
    runs the body through ``eager_scan``; both read ``deps`` as a capture
    does."""

    def __init__(self):
        self.calls = self.scans = 0
        self.keys = []

    def call(self, fn, inputs, deps=tuple, key=()):
        deps()
        self.calls += 1
        self.keys.append(key)
        return fn(*inputs)

    def scan(self, body, carry, xs, n, deps=tuple):
        deps()
        self.scans += 1
        return graphs.eager_scan(body, carry, xs, n)


@pytest.fixture
def eager_graphs(monkeypatch):
    """Every ``Graphs`` built while the test runs is an ``EagerGraphs``."""
    monkeypatch.setattr(graphs, "Graphs", EagerGraphs)


@pytest.fixture(scope="module")
def lut():
    return traster.build_sprite_lut(CPU)


@pytest.fixture(scope="module")
def agent():
    return ActiveInferenceAgent().init(seeded_generator(CPU, 0))


def assert_trees_equal(a, b):
    la, lb = graphs.leaves_of(a), graphs.leaves_of(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        assert x.dtype == y.dtype and torch.equal(x, y)


def opt_state(opt):
    return graphs.optimizer_deps(opt)


# ------------------------------------------------------------ (a)-(c) causal
def causal_state(cfg, seed=0, lr=1e-4):
    return tcausal.create_causal_state(cfg, StructuralCausalModel(), seeded_generator(CPU, seed),
                                       CPU, lr)


@pytest.mark.parametrize("graphed", [False, True], ids=["op_by_op", "graph_path"])
def test_causal_epoch_with_drawn_noise_equals_the_round_loop(lut, graphed, eager_graphs):
    """(a) 3 rounds at batch 4: the epoch's scan body fed each round's
    ``draw_causal_round`` draws equals ``causal_round`` drawing as it goes,
    bit for bit: the last round's metrics, the weights, Adam's moments and
    step, the envs, and the generator's state after."""
    cfg = Config(batch=B)
    rounds = 3
    loop_state, g_loop = causal_state(cfg), seeded_generator(CPU, 7)
    for _ in range(rounds):
        loop_state, m = tcausal.causal_round(cfg, loop_state, lut, g_loop)
    epoch = tcausal.make_causal_epoch(cfg, lut, rounds, graphed=graphed)
    scan_state, g_scan = causal_state(cfg), seeded_generator(CPU, 7)
    scan_state, out = epoch(scan_state, g_scan)
    assert out == dict(zip(tcausal.METRIC_KEYS,
                           torch.stack([m[k] for k in tcausal.METRIC_KEYS]).tolist()))
    assert_trees_equal(list(loop_state.model.state_dict().values()),
                       list(scan_state.model.state_dict().values()))
    assert_trees_equal(opt_state(loop_state.opt), opt_state(scan_state.opt))
    assert_trees_equal(loop_state.env, scan_state.env)
    assert torch.equal(g_loop.get_state(), g_scan.get_state())
    assert epoch.graphs.scans == int(graphed)
    assert not scan_state.opt.param_groups[0]["capturable"]  # a CPU Adam


def jax_causal_models(seed=0):
    import jax
    import jax.numpy as jnp

    from deep_active_inference_mc_tpu.models.causal import StructuralCausalModel as JModel
    from deep_active_inference_mc_torch.utils import convert

    jm = JModel()
    params = jax.jit(jm.init)(jax.random.key(seed), jnp.zeros((1, 64, 64, 1)))["params"]
    tm = StructuralCausalModel()
    tm.load_state_dict(convert.causal_params_from_jax(jax.tree.map(np.asarray, params)))
    return jm, params, tm


def jax_random_draws(key, n, cfg):
    """The RandomDraws of the JAX ``make_batch_random(cfg, key, ...)``
    (its key split in four, ``tests/test_torch_causal.py``'s rebuild)."""
    import jax

    from test_torch_data import env_draws, respawn_draws
    from test_torch_losses import t

    from deep_active_inference_mc_torch.envs import data as tdata

    k_rand, k_ppi, k_act, k_step = jax.random.split(key, 4)
    return tdata.RandomDraws(env_draws(k_rand, n), t(jax.random.uniform(k_ppi, (n, cfg.pi_dim))),
                             t(jax.random.gumbel(k_act, (n, cfg.pi_dim))),
                             respawn_draws(k_step, n, cfg.repeats))


def test_causal_epoch_matches_the_jax_jitted_epoch(lut):
    """(b) 2 rounds of ``make_jit_causal_epoch`` (one ``lax.scan``, a key
    per round) and of the port's epoch from the same weights and fresh
    Adam, each round's draws rebuilt from its key: the last round's
    metrics, every weight and the envs to 1e-4."""
    import jax

    from deep_active_inference_mc_tpu import config as jconfig
    from deep_active_inference_mc_tpu.envs import raster as jraster
    from deep_active_inference_mc_tpu.infer import precision as jprecision
    from deep_active_inference_mc_tpu.train import causal as jcausal
    from deep_active_inference_mc_torch.utils import convert

    rounds, lr = 2, 1e-4  # the causal CLI's l_rate
    jm, params, tm = jax_causal_models()
    jcfg, tcfg = jconfig.Config(batch=B), Config(batch=B)
    jstate, opt = jcausal.create_causal_state(jcfg, jm, jax.random.key(1), lr=lr)
    jstate = jstate.replace(params=params, opt_state=opt.init(params),
                            precision=jprecision.PrecisionState.create(0.3, 0.7, 1.2))
    key = jax.random.key(5)
    new_j, m_j = jcausal.make_jit_causal_epoch(jm, jcfg, opt, jraster.build_sprite_lut(),
                                               rounds)(jstate, key)
    state = tcausal.CausalTrainState(
        model=tm, opt=torch.optim.Adam(tm.parameters(), lr=lr),
        precision=PrecisionState.create(0.3, 0.7, 1.2), env=tenv.reset(seeded_generator(CPU, 0),
                                                                       B, CPU))
    draws = [jax_random_draws(k, B, tcfg) for k in jax.random.split(key, rounds)]
    state, m = tcausal.make_causal_epoch(tcfg, lut, rounds)(state, None, draws=draws)
    assert set(m) == set(m_j)
    for k in m:
        np.testing.assert_allclose(m[k], float(m_j[k]), err_msg=k, **TOL)
    want = convert.causal_params_from_jax(jax.tree.map(np.asarray, new_j.params))
    for k, v in tm.state_dict().items():
        np.testing.assert_allclose(v.numpy(), want[k].numpy(), err_msg=k, **TOL)
    np.testing.assert_array_equal(state.env.latents.numpy(), np.asarray(new_j.env.latents))
    assert int(state.opt.state_dict()["state"][0]["step"]) == rounds


@pytest.mark.parametrize("graphed", [False, True], ids=["op_by_op", "graph_path"])
def test_causal_eval_matches_the_jax_jitted_eval(lut, graphed, eager_graphs):
    """(c) ``make_causal_eval`` against ``make_jit_causal_eval`` at test
    size 16 on the same weights, the batch's draws rebuilt from the key:
    F, mse_o, kl_div_s, omega, cf_effect and the latents to 1e-4, the
    frames o0 and o1 bit for bit, the decode x_recon to 1e-4."""
    import jax

    from deep_active_inference_mc_tpu import config as jconfig
    from deep_active_inference_mc_tpu.envs import raster as jraster
    from deep_active_inference_mc_tpu.infer import precision as jprecision
    from deep_active_inference_mc_tpu.train import causal as jcausal

    n = 16
    jm, params, tm = jax_causal_models(2)
    jcfg, tcfg = jconfig.Config(test_size=n), Config(test_size=n)
    key = jax.random.key(8)
    want = jcausal.make_jit_causal_eval(jm, jcfg, jraster.build_sprite_lut())(
        params, jprecision.PrecisionState.create(0.3, 0.7, 1.2), key)
    evaluate = tcausal.make_causal_eval(tcfg, lut, graphed=graphed)
    got = evaluate(tm, PrecisionState.create(0.3, 0.7, 1.2), draws=jax_random_draws(key, n, tcfg))
    assert set(got) == set(want)
    for k in ("F", "mse_o", "kl_div_s", "omega", "cf_effect", "s"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), err_msg=k, **TOL)
    nhwc = lambda x: x.permute(0, 2, 3, 1).numpy()
    for k in ("o0", "o1"):
        np.testing.assert_array_equal(nhwc(got[k]), np.asarray(want[k]), err_msg=k)
    np.testing.assert_allclose(nhwc(got["x_recon"]), np.asarray(want["x_recon"]), **TOL)
    np.testing.assert_array_equal(got["S0_real"].numpy(), np.asarray(want["S0_real"]))
    assert float(got["cf_effect"]) > 0
    assert evaluate.graphs.calls == int(graphed)


def test_causal_eval_draws_as_the_pass_drew(lut):
    """The eval's eager draws (the reset, then the batch) leave the
    generator where the pass that drew as it went left it, with the same
    numbers: the reset's draws are taken and dropped."""
    cfg = Config(test_size=8)
    state = causal_state(Config(batch=2))
    g1, g2 = seeded_generator(CPU, 4), seeded_generator(CPU, 4)
    got = tcausal.make_causal_eval(cfg, lut)(state.model, state.precision, g1)
    env = tenv.reset(g2, cfg.test_size, CPU)
    want = tcausal.causal_eval_pass(
        cfg, lut, state.model, state.precision, tcausal.draw_causal_round(cfg, 8, g2, CPU))
    assert torch.equal(g1.get_state(), g2.get_state()) and env.batch == 8
    assert_trees_equal(got, want)


# ------------------------------------------------------------ (d) the eval pass
@pytest.mark.parametrize("flags", [{}, dict(vae_train_dropout=1)], ids=["defaults", "vae_dropout"])
@pytest.mark.parametrize("graphed", [False, True], ids=["op_by_op", "graph_path"])
def test_eval_pass_with_drawn_noise_equals_the_drawing_pass(agent, lut, flags, graphed,
                                                            eager_graphs):
    """(d) The trainer's eval pass at test size 16: ``make_eval`` fed
    ``draw_eval``'s draws equals ``eval_pass`` drawing from its generator
    as it goes, every output bit for bit, the generator's state after
    equal; its 5 K1 renders are the pass's (the graph's path counts one
    call per pass)."""
    cfg = Config(test_size=16, **flags)
    precision = PrecisionState.create(0.4)
    g1, g2 = seeded_generator(CPU, 3), seeded_generator(CPU, 3)
    want = teval.eval_pass(agent, cfg, lut, precision, g1)
    evaluate = teval.make_eval(agent, cfg, lut, graphed=graphed)
    got = evaluate(precision, g2)
    assert list(got) == list(want)
    assert_trees_equal(got, want)
    assert torch.equal(g1.get_state(), g2.get_state())
    assert evaluate.graphs.calls == int(graphed)


# ------------------------------------------------------------ (e) the replay
def records(n, seed=0):
    g = seeded_generator(CPU, seed)
    lat = tenv.sample_latents(g, n, CPU)
    last_r = torch.rand((n,), generator=g) * 2 - 1
    root_N = torch.randint(0, 20, (n, 4), generator=g).float()
    return lat, last_r, torch.log(tdistill.visit_targets(root_N) + 1e-20)


@pytest.mark.parametrize("flags", [{}, dict(vae_train_dropout=1)], ids=["defaults", "vae_dropout"])
@pytest.mark.parametrize("graphed", [False, True], ids=["op_by_op", "graph_path"])
def test_replay_scan_with_drawn_noise_equals_the_step_loop(agent, lut, flags, graphed,
                                                           eager_graphs):
    """(e) 2 passes over 24 records in minibatches of 8 (6 steps): the
    replay's scan, fed each step's minibatch and ``draw_step`` noise,
    equals the loop of ``dstep`` drawing its permutations and noise as it
    goes: each step's F and match, the top weights and the top Adam's state
    bit for bit, the generator's state after equal, mid and down
    untouched."""
    cfg = Config(distill_batch=8, distill_passes=2, **flags)
    lat, last_r, log_target = records(24)
    runs = {}
    for mode in ("loop", "scan"):
        a = copy.deepcopy(agent)
        opt = tloop.make_optimizers(cfg, a)["top"]
        distiller = tdistill.Distiller(a, cfg, lut, graphed=graphed if mode == "scan" else False)
        g = seeded_generator(CPU, 11)
        if mode == "loop":
            rows = []
            for _ in range(cfg.distill_passes):
                perm = torch.randperm(24, generator=g)
                for i in range(3):
                    idx = perm[i * 8:(i + 1) * 8]
                    rows.append(torch.stack(distiller.dstep(
                        opt, lat[idx], last_r[idx], log_target[idx], g)))
            table = torch.stack(rows)
        else:
            table = distiller.replay(opt, lat, last_r, log_target, g)
            assert distiller.graphs.scans == int(graphed)
        runs[mode] = (table, a, opt, g.get_state())
    (t_loop, a_loop, o_loop, s_loop), (t_scan, a_scan, o_scan, s_scan) = runs["loop"], runs["scan"]
    assert t_scan.shape == (6, 2) and torch.equal(t_loop, t_scan)
    assert_trees_equal(list(a_loop.state_dict().values()), list(a_scan.state_dict().values()))
    assert_trees_equal(opt_state(o_loop), opt_state(o_scan))
    assert int(o_scan.state_dict()["state"][0]["step"]) == 6
    assert torch.equal(s_loop, s_scan)
    for k, v in agent.state_dict().items():
        if not k.startswith("top."):
            assert torch.equal(a_scan.state_dict()[k], v), k


def test_phase_reads_first_and_last_replay_steps(agent, lut, monkeypatch):
    """A phase's metrics are the replay table's first and last rows."""
    cfg = Config(distill_envs=4, distill_macro=2, distill_batch=4, distill_passes=2)
    distiller = tdistill.Distiller(copy.deepcopy(agent), cfg, lut)
    lat, last_r, log_target = records(8)
    table = torch.tensor([[1.0, 0.25], [2.0, 0.5], [3.0, 0.75], [4.0, 1.0]])
    monkeypatch.setattr(distiller, "collect", lambda *a: (lat, last_r, torch.ones(8, 4)))
    monkeypatch.setattr(distiller, "replay", lambda *a: table)
    state = tloop.TrainState(distiller.agent, tloop.make_optimizers(cfg, distiller.agent), None,
                             None)
    _, m = distiller(state, seeded_generator(CPU, 0))
    assert (m["distill_kl_first"], m["distill_match_first"]) == (1.0, 0.25)
    assert (m["distill_kl_last"], m["distill_match_last"], m["distill_steps"]) == (4.0, 1.0, 4.0)


# ------------------------------------------------------------ (f) the demo round
def demo_args(**over):
    base = dict(network="", mean=False, duration=100, method="habit", steps=3,
                temperature=1.0, jumps=5, C=1.0, repeats=4, threshold=0.5, depth=2,
                no_habit=False, headless=0, seed=0, device="cpu")
    base.update(over)
    return argparse.Namespace(**base)


@pytest.mark.parametrize("method,mean", [("habit", False), ("ai", False), ("ai", True),
                                         ("t1", False)])
@pytest.mark.parametrize("graphed", [False, True], ids=["op_by_op", "graph_path"])
def test_round_with_drawn_plan_noise_equals_host_ticks(agent, method, mean, graphed,
                                                       eager_graphs):
    """(f) One ``run_round``, its plans fed their action uniform and G
    noise drawn ahead (the graph's inputs), against 100 host ticks of a
    second demo (the queue a host list, each plan op by op): the same
    score after every tick, the same plans, the same final envs. The
    graph's path makes one call per tick and one per plan."""
    args = demo_args(method=method, mean=mean)
    host = demo_app.Demo(agent, args)
    dev = demo_app.Demo(agent, args, graphed=graphed)
    for d in (host, dev):  # a nonzero score that the round boundary keeps
        d.env = d.env.replace(score=torch.full((1,), -1.5))
    trace = []
    for _ in range(demo_app.DURATION_OF_ROUND):
        host.tick()
        trace.append(host.score)
    got = dev.run_round()
    np.testing.assert_array_equal(got.numpy(), np.asarray(trace, np.float32))
    assert dev.plans_made == host.plans_made >= 2
    assert_trees_equal(dev.env, host.env)
    if graphed:
        keys = dev.graphs.keys
        assert keys.count(("tick",)) == demo_app.DURATION_OF_ROUND
        assert len(keys) - demo_app.DURATION_OF_ROUND == dev.plans_made
        assert all(k[:2] == ("plan", method) for k in keys if k != ("tick",))


# ------------------------------------------------------------ (g) entry points
class _Built(Exception):
    """A path was built: (what, its ``graphed``)."""


def spy(what, real):
    def build(*a, **kw):
        raise _Built(what, inspect.signature(real).bind(*a, **kw).arguments.get("graphed"))
    return build


def _train_causal(tmp_path):
    from deep_active_inference_mc_torch.apps import train_causal as app

    return app.main(["--device", "cpu", "--batch", "2", "--out_root", str(tmp_path)])


def _trainer(tmp_path, *flags):
    return train_app.main(["--device", "cpu", "--batch", "2", "--rounds", "1", "--test_size", "4",
                     "--sweep_envs", "2", "--sweep_steps", "1", "--out_root", str(tmp_path),
                     *flags])


def _demo(tmp_path, graphed=None):
    return demo_app.main(["--device", "cpu", "--method", "habit", "--headless", "1"],
                         graphed=graphed)


def _distiller(tmp_path):
    return tdistill.Distiller(ActiveInferenceAgent(), Config(), traster.build_sprite_lut(CPU))


# entry point: (how it is called, (module, name) spied, the build and its
# ``graphed``). None: graphed on a card; False: op by op.
ENTRY_POINTS = {
    "train_causal_epoch": (_train_causal, (tcausal, "make_causal_epoch"), ("epoch", None)),
    "train_causal_eval": (_train_causal, (tcausal, "make_causal_eval"), ("eval", None)),
    "trainer_eval": (_trainer, (train_app, "make_eval"), ("eval", None)),
    "trainer_distill_hook": (lambda p: _trainer(p, "--distill_every", "1"),
                             (train_app, "Distiller"), ("distiller", None)),
    "distiller": (_distiller, (tdistill.Distiller, "__init__"), ("distiller", None)),
    "demo": (_demo, (demo_app, "Demo"), ("demo", None)),
    "demo_op_by_op": (lambda p: _demo(p, graphed=False), (demo_app, "Demo"), ("demo", False)),
}


@pytest.mark.parametrize("case", ENTRY_POINTS)
def test_each_entry_point_builds_its_path_graphed_by_default(tmp_path, monkeypatch, case):
    """Every entry point of the four paths builds it with ``graphed=None``
    (a graph on a card) unless asked for op by op: the causal CLI's epochs
    and eval, the trainer's eval and its distillation hook, the
    distillation phase, the demo."""
    run, (owner, name), want = ENTRY_POINTS[case]
    real = getattr(owner, name)
    monkeypatch.setattr(owner, name, spy(want[0], real))
    with pytest.raises(_Built) as built:
        run(tmp_path)
    assert built.value.args == want


def test_graphed_paths_raise_on_the_cpu(agent, lut):
    """``graphed=True`` where it cannot run raises (no fallback), as does
    ``Graphs.call`` given CPU tensors."""
    with pytest.raises(ValueError, match="CUDA tensors only"):
        graphs.Graphs().call(lambda x: x + 1, (torch.zeros(2),))
    cfg = Config(batch=2, test_size=4, distill_batch=4, distill_passes=1)
    state = causal_state(cfg)
    with pytest.raises(ValueError, match="CUDA tensors only"):
        tcausal.make_causal_epoch(cfg, lut, 1, graphed=True)(state, seeded_generator(CPU, 0))
    with pytest.raises(ValueError, match="CUDA tensors only"):
        tcausal.make_causal_eval(cfg, lut, graphed=True)(state.model, state.precision,
                                                         seeded_generator(CPU, 0))
    with pytest.raises(ValueError, match="CUDA tensors only"):
        teval.make_eval(agent, cfg, lut, graphed=True)(PrecisionState.create(),
                                                       seeded_generator(CPU, 0))
    a = copy.deepcopy(agent)
    with pytest.raises(ValueError, match="CUDA tensors only"):
        tdistill.Distiller(a, cfg, lut, graphed=True).replay(
            tloop.make_optimizers(cfg, a)["top"], *records(4), seeded_generator(CPU, 0))
    with pytest.raises(ValueError, match="CUDA tensors only"):
        demo_app.Demo(agent, demo_args(), graphed=True).run_round()


@pytest.mark.parametrize("graphed,where,want", [
    (None, torch.device("cpu"), False), (None, torch.device("cuda"), True),
    (None, torch.zeros(1), False), (False, torch.device("cuda"), False),
    (True, torch.device("cpu"), True)],
    ids=["none_cpu", "none_card", "none_cpu_tensor", "false_card", "true_cpu"])
def test_use_graphs_reads_the_device_only_when_graphed_is_none(graphed, where, want):
    """The paths' one rule: None means graphs on a card, op by op
    elsewhere; False and True are kept (True on the CPU then raises where
    a graph would be captured)."""
    assert graphs.use_graphs(graphed, where) is want


def test_call_trees_round_trip_dicts():
    """The trees ``Graphs.call`` takes and gives: dicts keep their keys in
    order."""
    tree = {"b": torch.zeros(2), "a": [torch.ones(1), None], "c": (3, torch.full((1,), 2.0))}
    leaves = graphs.leaves_of(tree)
    back = graphs.rebuild(tree, [t + 1 for t in leaves])
    assert list(back) == ["b", "a", "c"] and back["a"][1] is None and back["c"][0] == 3
    assert_trees_equal(back, {"b": torch.ones(2), "a": [torch.full((1,), 2.0), None],
                              "c": (3, torch.full((1,), 3.0))})


# ------------------------------------------------------------ on a card
@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: run `python -m pytest --noconftest -m cuda "
                    "tests/test_torch_call_graphs.py` on one")
    return torch.device("cuda")


@pytest.mark.cuda
def test_each_new_graphed_path_replays_its_eager_body(cuda_device):
    """On a card, from one seed, each path graphed against op by op with
    cuDNN's deterministic algorithms, bit for bit: the causal epoch (2
    epochs of 3 rounds, so the second replays) and eval, the trainer's eval
    pass (twice), a distillation phase's replay steps (twice) and a demo
    round per controller; K1's launches equal; each replays without a new
    capture the second time. First, two functions through one ``Graphs``
    keep one graph each."""
    saved = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        replay_each_path(cuda_device)
    finally:
        torch.backends.cudnn.deterministic = saved


def replay_each_path(dev):
    # Two functions through one ``Graphs``, equal inputs and key: each keeps
    # its own graph, and a lambda made anew with the same code replays it.
    g, x = graphs.Graphs(), torch.arange(4.0, device=dev)
    for _ in range(2):
        assert torch.equal(g.call(lambda v: v + 1, (x,)), x + 1)
        assert torch.equal(g.call(lambda v: v * 3, (x,)), x * 3)
    assert (g.captures, g.replays) == (2, 2)

    lut = traster.build_sprite_lut(dev)

    def both(run):
        out = {}
        for graphed in (False, True):
            LAUNCHES.clear()
            out[graphed] = (run(graphed), LAUNCHES.get("render", 0))
        (e, le), (g, lg) = out[False], out[True]
        assert_trees_equal(e, g)
        assert le == lg
        return g, lg

    cfg = Config(batch=16, test_size=32)

    def causal(graphed):
        state = tcausal.create_causal_state(cfg, StructuralCausalModel(),
                                            seeded_generator(dev, 0), dev)
        epoch = tcausal.make_causal_epoch(cfg, lut, 3, graphed=graphed)
        evaluate = tcausal.make_causal_eval(cfg, lut, graphed=graphed)
        gen = seeded_generator(dev, 1)
        outs = []
        for _ in range(2):
            state, m = epoch(state, gen)
            outs.append((torch.tensor(list(m.values())),
                         evaluate(state.model, state.precision, gen)))
        assert epoch.graphs.captures == evaluate.graphs.captures == int(graphed)
        return outs, list(state.model.state_dict().values()), opt_state(state.opt)

    _, launches = both(causal)
    assert launches == 2 * (2 * 3 + 2)

    agent = ActiveInferenceAgent().to(dev)
    agent.init(seeded_generator(dev, 0))

    def eval_pass(graphed):
        evaluate = teval.make_eval(agent, cfg, lut, graphed=graphed)
        gen = seeded_generator(dev, 2)
        outs = [evaluate(PrecisionState.create(0.4, device=dev), gen) for _ in range(2)]
        assert evaluate.graphs.captures == int(graphed)
        return outs

    _, launches = both(eval_pass)
    assert launches == 2 * 5

    dcfg = Config(distill_batch=16, distill_passes=2)
    lat, last_r, log_target = (x.to(dev) for x in records(48))

    def replay(graphed):
        a = copy.deepcopy(agent)
        opt = tloop.make_optimizers(dcfg, a)["top"]
        distiller = tdistill.Distiller(a, dcfg, lut, graphed=graphed)
        gen = seeded_generator(dev, 3)
        tables = [distiller.replay(opt, lat, last_r, log_target, gen) for _ in range(2)]
        assert distiller.graphs.captures == int(graphed)
        return tables, list(a.top.state_dict().values()), opt_state(opt)

    _, launches = both(replay)
    assert launches == 2 * 6

    for method in ("habit", "ai", "t1"):
        def round_(graphed):
            d = demo_app.Demo(agent, demo_args(method=method, device="cuda"), graphed=graphed)
            traces = [d.run_round() for _ in range(2)]
            if graphed:
                assert d.graphs.captures == 2  # the tick's graph and the plan's
            return traces, d.env, d.plans_made

        (_, _, plans), launches = both(round_)
        assert launches == plans >= 2, method
