"""PyTorch port: math, config, networks and agent against the JAX package.

Networks run with dropout off on weights converted by
``utils/convert.params_from_jax``, from a seeded JAX init and from the
committed flagship checkpoint, to rtol 1e-4 / atol 1e-4. Stochastic
wrappers get the same noise on both sides.
"""

import dataclasses
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deep_active_inference_mc_tpu import config as jconfig
from deep_active_inference_mc_tpu.infer.agent import ActiveInferenceAgent as JAgent
from deep_active_inference_mc_tpu.ops import math as jm
from deep_active_inference_mc_torch import config as tconfig
from deep_active_inference_mc_torch.infer.agent import ActiveInferenceAgent as TAgent
from deep_active_inference_mc_torch.ops import math as tm
from deep_active_inference_mc_torch.utils import convert

RUN = Path(__file__).parent.parent / "artifacts" / "run512"
TOL = dict(rtol=1e-4, atol=1e-4)


@pytest.fixture(autouse=True, scope="module")
def few_torch_threads():
    """Two intra-op threads while this module runs: the suite runs in
    several worker processes at once, and torch's default of one thread
    per core oversubscribes the machine."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def jax_flagship():
    """(JAX agent, params) of the committed flagship checkpoint, read by
    ``checkpoint.load_all`` as tests/test_trained_artifact.py reads it; the
    train-state template is built from shapes alone (``eval_shape``),
    which skips compiling the init."""
    from deep_active_inference_mc_tpu.train import loop as train_loop
    from deep_active_inference_mc_tpu.utils import checkpoint as ckpt

    cfg = jconfig.Config()
    agent = JAgent(s_dim=cfg.s_dim, pi_dim=cfg.pi_dim)
    shapes = jax.eval_shape(lambda k: train_loop.create_train_state(cfg, agent, k),
                            jax.random.key(0))
    template = jax.tree.map(lambda s: np.zeros(s.shape, s.dtype), shapes)
    state, _, _ = ckpt.load_all(RUN / "checkpoints", template)
    return agent, state.params


# The JAX package's variant configurations (tests/test_variants.py): the
# Animal-AI action set at 32x32, 32x32 colour frames, and the action set at
# 64x64. The flagship's widths do not fit them, so they run on a seeded init.
VARIANTS = {"pi3-res32": dict(pi_dim=3, resolution=32),
            "res32-rgb": dict(resolution=32, colour_channels=3),
            "pi3": dict(pi_dim=3)}


def seeded_variant(seed=0, **dims):
    """(JAX agent, its seeded params, the converted port agent) at ``dims``."""
    ja = JAgent(**dims)
    jp = jax.jit(ja.init)(jax.random.key(seed))
    return ja, jp, torch_agent(jp, **dims)


def torch_agent(jparams, **kw):
    agent = TAgent(**kw)
    agent.load_state_dict(convert.params_from_jax(jax.tree.map(np.asarray, jparams)))
    return agent


def jax_transition(params, pi, s0, masks=None, rate=0.5):
    """The transition net rebuilt from its Dense kernels, with explicit
    keep-masks (Flax dropout semantics: kept units scaled by 1/(1-rate))."""
    p = params["mid"]
    x = jnp.concatenate([pi, s0], axis=-1)
    for i in range(3):
        x = jax.nn.relu(x @ p[f"Dense_{i}"]["kernel"] + p[f"Dense_{i}"]["bias"])
        if masks is not None:
            x = jnp.where(masks[i], x / (1.0 - rate), 0.0)
    out = x @ p["Dense_3"]["kernel"] + p["Dense_3"]["bias"]
    mean, logvar = jnp.split(out, 2, axis=-1)
    return mean, jnp.clip(logvar, -10.0, 10.0)


def nchw(o):
    return torch.from_numpy(np.array(o)).permute(0, 3, 1, 2)


def close(t, j, **tol):
    np.testing.assert_allclose(t.detach().numpy(), np.asarray(j), **(tol or TOL))


# ------------------------------------------------------------------ config
def test_config_fields_and_defaults_match():
    jf = [(f.name, f.default) for f in dataclasses.fields(jconfig.Config)]
    tf = [(f.name, f.default) for f in dataclasses.fields(tconfig.Config)]
    assert tf == jf
    assert tconfig.Config().signature == jconfig.Config().signature


# -------------------------------------------------------------------- math
_rng = np.random.default_rng(0)


def _n(*s):
    return _rng.standard_normal(s).astype(np.float32)


def _u(*s):
    return _rng.uniform(0.01, 0.99, s).astype(np.float32)


def _logp(*s):
    return np.log(np.asarray(jax.nn.softmax(_n(*s), -1)))


MATH_CASES = {
    "kl_div_gaussian_precision": (_n(5, 10), _n(5, 10), _n(5, 10), _n(5, 10),
                                  np.abs(_n(5, 1)) + 0.5),
    "kl_div_gaussian": (_n(5, 10), _n(5, 10), _n(5, 10), _n(5, 10)),
    "kl_div_categorical": (np.exp(_logp(6, 4)), _logp(6, 4), _logp(6, 4)),
    "entropy_normal_from_logvar": (_n(5, 10),),
    "entropy_bernoulli": (_u(5, 64),),
    "log_bernoulli": ((_u(5, 64) > 0.5).astype(np.float32), _u(5, 64)),
    "softmax_multi_with_log": (_n(8, 4) * 10,),
    "compute_omega": (_n(16) * 20, 1.0, 25.0, 5.0, 1.5),
}


@pytest.mark.parametrize("name", sorted(MATH_CASES))
def test_math_matches_jax(name):
    args = MATH_CASES[name]
    j = getattr(jm, name)(*[jnp.asarray(a) if isinstance(a, np.ndarray) else a for a in args])
    t = getattr(tm, name)(*[torch.from_numpy(a) if isinstance(a, np.ndarray) else a
                            for a in args])
    for tv, jv in zip(t if isinstance(t, tuple) else (t,), j if isinstance(j, tuple) else (j,)):
        np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("res", [64, 32])
def test_calc_reward_and_total_correlation_match_jax(res):
    o = _u(3, res, res, 2)
    want = np.asarray(jm.calc_reward(jnp.asarray(o), res))  # (3, 3, W, C)
    got = tm.calc_reward(nchw(o), res)  # (3, C, 3, W)
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want, rtol=1e-6, atol=1e-6)
    data = _n(200, 4) @ _n(4, 4)
    assert tm.total_correlation(data) == jm.total_correlation(data)


# ---------------------------------------------------------------- networks
@pytest.fixture(scope="module")
def flagship():
    agent, params = jax_flagship()
    return agent, params, torch_agent(params)


@pytest.fixture(scope="module")
def seeded():
    agent = JAgent()
    params = jax.jit(agent.init)(jax.random.key(3))
    return agent, params, torch_agent(params)


def _inputs(B, res=64, ch=1, seed=0):
    rng = np.random.default_rng(seed)
    o = (rng.random((B, res, res, ch)) > 0.8).astype(np.float32)
    o[:, :3, : res // 2] = rng.random((B, 1, 1, 1))  # a reward strip
    s = rng.standard_normal((B, 10)).astype(np.float32)
    pi = np.eye(4, dtype=np.float32)[rng.integers(0, 4, B)]
    return o, s, pi


@pytest.mark.parametrize("weights", ["seeded", "flagship"])
def test_forwards_match_jax(weights, request):
    ja, jp, ta = request.getfixturevalue(weights)
    o, s, pi = _inputs(6)
    with torch.inference_mode():
        for t, j in zip(ta.encode(nchw(o)), ja.encode(jp, jnp.asarray(o))):
            close(t, j)
        po = ta.decode(torch.from_numpy(s))
        jpo = ja.decode(jp, jnp.asarray(s))
        close(po.permute(0, 2, 3, 1), jpo)
        close(ta.check_reward(po), ja.check_reward(jpo))
        for t, j in zip(ta.transition(torch.from_numpy(pi), torch.from_numpy(s)),
                        ja.transition(jp, jnp.asarray(pi), jnp.asarray(s), dropout=False)):
            close(t, j)
        for t, j in zip(ta.habit(torch.from_numpy(s)), ja.habit(jp, jnp.asarray(s))):
            close(t, j)
        close(ta.habitual_net(nchw(o)), ja.habitual_net(jp, jnp.asarray(o)))


def test_forwards_match_jax_32res_rgb():
    ja = JAgent(colour_channels=3, resolution=32)
    jp = jax.jit(ja.init)(jax.random.key(5))
    ta = torch_agent(jp, colour_channels=3, resolution=32)
    o, s, _ = _inputs(4, res=32, ch=3)
    with torch.inference_mode():
        for t, j in zip(ta.encode(nchw(o)), ja.encode(jp, jnp.asarray(o))):
            close(t, j)
        po = ta.decode(torch.from_numpy(s))
        jpo = ja.decode(jp, jnp.asarray(s))
        close(po.permute(0, 2, 3, 1), jpo)
        close(ta.check_reward(po), ja.check_reward(jpo))


def test_imagine_future_with_injected_noise(flagship):
    ja, jp, ta = flagship
    B = 5
    o, _, pi = _inputs(B, seed=2)
    rng = np.random.default_rng(7)
    eps_enc, eps_t = (rng.standard_normal((B, 10)).astype(np.float32) for _ in range(2))
    masks = [rng.random((B, 512)) < 0.5 for _ in range(3)]
    mean, logvar = ja.encode(jp, jnp.asarray(o))
    s0 = eps_enc * jnp.exp(logvar * 0.5) + mean
    m1, lv1 = jax_transition(jp, jnp.asarray(pi), s0, masks)
    want = ja.decode(jp, eps_t * jnp.exp(lv1 * 0.5) + m1)
    with torch.inference_mode():
        got = ta.imagine_future_from_o(
            nchw(o), torch.from_numpy(pi), eps_enc=torch.from_numpy(eps_enc),
            masks=[torch.from_numpy(mk) for mk in masks], eps_trans=torch.from_numpy(eps_t))
    close(got.permute(0, 2, 3, 1), want)


# -------------------------------------------------------------------- init
def test_seeded_init_bounds_zero_biases_and_counts(seeded):
    ja, jp, _ = seeded
    agent = TAgent().init(torch.Generator().manual_seed(0))
    assert agent.param_counts() == ja.param_counts(jp)
    assert sum(agent.param_counts().values()) == 5_463_501
    for name, w in agent.state_dict().items():
        if name.endswith("bias"):
            assert not w.any(), name
            continue
        # Flax fan-in: Dense in; Conv and ConvTranspose kh*kw*in.
        if w.ndim == 2:
            fan_in = w.shape[1]
        elif ".deconv." in name:
            fan_in = w.shape[0] * w.shape[2] * w.shape[3]
        else:
            fan_in = w.shape[1] * w.shape[2] * w.shape[3]
        bound = np.sqrt(6.0 / fan_in)
        assert float(w.abs().max()) <= bound, name
        assert float(w.abs().max()) > 0.9 * bound, name


def test_load_npz_reads_the_readme_export(flagship, tmp_path):
    """The README's params-only export (a flat .npz keyed by tree path, the
    export's ``params/`` entries without the prefix) loads into the same
    state_dict as ``params_from_jax``."""
    _, jp, ta = flagship
    path = tmp_path / "flagship.npz"
    np.savez(path, **{"/".join(k.key for k in p): np.asarray(v)
                      for p, v in jax.tree_util.tree_leaves_with_path(jp)})
    sd = convert.load_npz(path)
    assert sd.keys() == ta.state_dict().keys()
    for name, w in ta.state_dict().items():
        assert torch.equal(sd[name], w), name
