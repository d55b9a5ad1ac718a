"""PyTorch port: the bf16 forwards (``ActiveInferenceAgent(dtype=torch.bfloat16)``)
against the JAX package's ``dtype=jnp.bfloat16`` agent, on the flagship
weights.

XLA on the CPU and oneDNN round bf16 at different places, so the two
packages' bf16 outputs are not held to each other. Each package's bf16
error against its own float32, on the same weights and inputs, is measured
instead (the relative RMS error), and the port's may be at most twice the
JAX package's: in every network forward, in G and in one training round.
The planner scores G in float32 under a bf16 agent, and gradients reach
float32 weights.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deep_active_inference_mc_tpu import config as jconfig
from deep_active_inference_mc_tpu.infer import efe as jefe
from deep_active_inference_mc_tpu.infer.agent import ActiveInferenceAgent as JAgent
from deep_active_inference_mc_tpu.train import loop as jloop
from deep_active_inference_mc_torch import config as tconfig
from deep_active_inference_mc_torch.infer import efe as tefe
from deep_active_inference_mc_torch.plan import mcts as tmcts
from deep_active_inference_mc_torch.train import loop as tloop
from test_torch_data import FLAGSHIP_GEN
from test_torch_efe import frames
from test_torch_loop import jax_state, luts, port_state, round_draws  # noqa: F401 (fixture)
from test_torch_models import _inputs, jax_flagship, nchw, torch_agent
from test_torch_models import few_torch_threads  # noqa: F401 (autouse fixture)

RATIO = 2.0  # the port's bf16 error may be at most this multiple of the JAX package's
BF16 = torch.bfloat16


def rel_rms(a, b) -> float:
    """RMS of ``a - b`` over the RMS of ``b`` (float64)."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.sqrt(np.mean((a - b) ** 2)) / np.sqrt(np.mean(b ** 2)))


@pytest.fixture(scope="module")
def agents():
    """(JAX f32, JAX bf16, params, port f32, port bf16) on the flagship."""
    ja, jp = jax_flagship()
    return ja, JAgent(dtype=jnp.bfloat16), jp, torch_agent(jp), torch_agent(jp, dtype=BF16)


def forward_outputs(agents):
    """Each forward's output in both packages, f32 and bf16, as numpy."""
    ja, jb, jp, ta, tb = agents
    o, s, pi = _inputs(64, seed=1)
    to, ts, tpi = nchw(o), torch.from_numpy(s), torch.from_numpy(pi)
    out = {}
    with torch.inference_mode():
        for name, t_fn, j_fn in (
            ("enc_mean", lambda a: a.encode(to)[0], lambda a: a.encode(jp, o)[0]),
            ("enc_logvar", lambda a: a.encode(to)[1], lambda a: a.encode(jp, o)[1]),
            ("decode", lambda a: a.decode(ts).permute(0, 2, 3, 1), lambda a: a.decode(jp, s)),
            ("trans_mean", lambda a: a.transition(tpi, ts)[0],
             lambda a: a.transition(jp, pi, s, dropout=False)[0]),
            ("trans_logvar", lambda a: a.transition(tpi, ts)[1],
             lambda a: a.transition(jp, pi, s, dropout=False)[1]),
            ("habit_logits", lambda a: a.habit(ts)[0], lambda a: a.habit(jp, s)[0]),
        ):
            t32, t16 = t_fn(ta), t_fn(tb)
            assert t16.dtype == torch.float32, name  # every head returns float32
            out[name] = (t32.numpy(), t16.numpy(), np.asarray(j_fn(ja)), np.asarray(j_fn(jb)))
    return out


@pytest.fixture(scope="module")
def outputs(agents):
    return forward_outputs(agents)


@pytest.mark.parametrize("name", ["enc_mean", "enc_logvar", "decode", "trans_mean",
                                  "trans_logvar", "habit_logits"])
def test_bf16_forward_error_within_twice_jax(outputs, name):
    t32, t16, j32, j16 = outputs[name]
    err_t, err_j = rel_rms(t16, t32), rel_rms(j16, j32)
    assert 0.0 < err_t <= RATIO * err_j, (name, err_t, err_j)


def test_bf16_G_error_within_twice_jax(agents):
    """G of all four actions (mean estimator, one step) on 16 env frames;
    each package's bf16 and f32 passes share their own noise."""
    ja, jb, jp, ta, tb = agents
    o, jo = frames(16, seed=3)
    d = tefe.draw_rollout(ta, 16, 64, torch.Generator().manual_seed(4), "cpu", steps=1,
                          calc_mean=True, samples=1, mean_estimator=True)
    with torch.inference_mode():
        t32, t16 = (tefe.calculate_G_4_repeated(a, o, steps=1, calc_mean=True, samples=1,
                                                draws=d)[0].numpy() for a in (ta, tb))
    j32, j16 = (np.asarray(jax.jit(lambda p, k, x, a=a: jefe.calculate_G_4_repeated(
        a, p, k, x, steps=1, calc_mean=True, samples=1)[0])(jp, jax.random.key(4), jo))
        for a in (ja, jb))
    assert t16.dtype == np.float32
    err_t, err_j = rel_rms(t16, t32), rel_rms(j16, j32)
    assert 0.0 < err_t <= RATIO * err_j, (err_t, err_j)


def test_bf16_round_error_within_twice_jax(agents, luts):
    """One training round with the flagship's generator flags: the
    losses and gradient norms, bf16 against f32, in each package under
    its round's noise."""
    ja, jb, jp, ta, tb = agents
    jlut, tlut = luts
    B = 8
    jcfg, tcfg = (jconfig.Config(batch=B, **FLAGSHIP_GEN),
                  tconfig.Config(batch=B, **FLAGSHIP_GEN))
    key = jax.random.key(11)
    draws = round_draws(ja, jp, tcfg, key, B)
    keys = ("F_top", "F_mid", "F_down", "gnorm_top", "gnorm_mid", "gnorm_down")
    jm = {}
    for name, a in (("f32", ja), ("bf16", jb)):
        _, m = jax.jit(jloop.make_round_fn(a, jcfg, jlut))(jax_state(jcfg, jp, 0.5), key)
        jm[name] = np.asarray([float(m[k]) for k in keys])
    tm = {}
    for name, a in (("f32", ta), ("bf16", tb)):
        _, m = tloop.make_round_fn(tcfg, tlut)(port_state(a, tcfg, 0.5),
                                               draws=copy.deepcopy(draws))
        tm[name] = np.asarray([float(m[k]) for k in keys])
    rel = lambda m: np.abs(m["bf16"] - m["f32"]) / np.abs(m["f32"])
    err_t, err_j = float(np.sqrt(np.mean(rel(tm) ** 2))), float(np.sqrt(np.mean(rel(jm) ** 2)))
    assert np.isfinite(tm["bf16"]).all()
    assert 0.0 < err_t <= RATIO * err_j, (dict(zip(keys, rel(tm))), dict(zip(keys, rel(jm))))


def test_bf16_gradients_reach_float32_weights(agents):
    _, _, _, _, tb = agents
    tb = copy.deepcopy(tb)
    o, s, _ = _inputs(4, seed=2)
    mean, logvar = tb.encode(nchw(o))
    loss = (mean.square().sum() + logvar.sum()) + tb.decode(torch.from_numpy(s)).sum()
    loss.backward()
    for name, p in tb.down.named_parameters():
        assert p.dtype == torch.float32 and p.grad is not None, name
        assert p.grad.dtype == torch.float32 and torch.isfinite(p.grad).all(), name


def test_planner_scores_G_in_float32_under_bf16(agents):
    """The fused evaluator (plan/mcts.py's G terms) and a whole search on a
    bf16 agent: G, the tree's values and the visits are float32."""
    _, _, _, _, tb = agents
    p = tmcts.MCTSParams(repeats=3, simulation_depth=2, simulation_repeats=2,
                         fused_eval=True, max_depth=8)
    s = torch.randn((3, tb.s_dim), generator=torch.Generator().manual_seed(0))
    with torch.inference_mode():
        G_leaf, ps_next, G_sim, Qpi = tmcts._fused_expand_sim(
            tb, s, p, generator=torch.Generator().manual_seed(1))
        o, _ = frames(3, seed=5)
        res = tmcts.active_inference_mcts(tb, o, p, (0, 1))
    for x in (G_leaf, ps_next, G_sim, Qpi, res.root_N):
        assert x.dtype == torch.float32 and torch.isfinite(x).all()
