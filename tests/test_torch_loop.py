"""PyTorch port: the training round (``train/loop.py``), the slice as a
whole, against the JAX package's ``train_round``.

The round's noise is rebuilt from the JAX round's PRNG key
(``test_torch_losses`` / ``test_torch_data`` helpers) and injected, so one
JAX round and one port round from the same converted weights compute on
the same numbers: metrics to rtol 1e-4 (losses) and 1e-3 (gradient norms),
gradients to rtol 1e-3 of each tensor's largest entry. Adam and the
hand-written clip are held to optax on the same gradients, atol 1e-7.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from deep_active_inference_mc_tpu import config as jconfig
from deep_active_inference_mc_tpu.envs import dsprites as jenv
from deep_active_inference_mc_tpu.envs import raster as jraster
from deep_active_inference_mc_tpu.infer import precision as jprecision
from deep_active_inference_mc_tpu.infer.agent import ActiveInferenceAgent as JAgent
from deep_active_inference_mc_tpu.train import loop as jloop
from deep_active_inference_mc_tpu.train import losses as jlosses
from deep_active_inference_mc_torch import config as tconfig
from deep_active_inference_mc_torch.envs import raster as traster
from deep_active_inference_mc_torch.infer import precision as tprecision
from deep_active_inference_mc_torch.train import loop as tloop
from deep_active_inference_mc_torch.train import losses as tlosses
from deep_active_inference_mc_torch.utils import convert
from test_torch_data import FLAGSHIP_GEN, generator_draws, tstate
from test_torch_losses import (flax_vae_masks, jax_down_draws, jax_mid_draws, jax_normal,
                               loss_inputs, t)
from test_torch_models import few_torch_threads  # noqa: F401 (autouse fixture)
from test_torch_models import VARIANTS, jax_flagship, nchw, seeded_variant, torch_agent

B = 8


@pytest.fixture(scope="module")
def flagship():
    agent, params = jax_flagship()
    return agent, params, torch_agent(params)


@pytest.fixture(scope="module")
def luts():
    return jraster.build_sprite_lut(), traster.build_sprite_lut("cpu")


def port_state(agent, cfg, gamma=0.0):
    """A TrainState around a private copy of ``agent`` (rounds update the
    weights in place)."""
    agent = copy.deepcopy(agent)
    return tloop.TrainState(agent, tloop.make_optimizers(cfg, agent),
                            tprecision.PrecisionState.create(gamma), tstate(cfg.batch))


def jax_state(cfg, params, gamma=0.0):
    opts = jloop.make_optimizers(cfg)
    return jloop.TrainState(
        params=params, opt_states={k: opts[k].init(params[k]) for k in opts},
        precision=jprecision.PrecisionState.create(gamma),
        env=jenv.reset(jax.random.key(0), cfg.batch))


def round_draws(ja, jp, cfg, key, batch):
    """RoundDraws of ``train_round(key)`` (loop.py:95); under
    ``vae_train_dropout`` with the encoder masks of the qs0 pass (:105), of
    the qs1 pass (:132) and of the down loss."""
    k_data, k_qs0, k_enc1, k_mid, k_down = jax.random.split(key, 5)
    vae_do = bool(cfg.vae_train_dropout)
    k_drop0, k_samp0 = jax.random.split(k_qs0)
    enc = lambda k: flax_vae_masks(ja, jp, k, batch, "encoder") if vae_do else None
    return tloop.RoundDraws(
        data=generator_draws(ja, jp, cfg, k_data, batch),
        staged=tlosses.StagedDraws(
            eps_s0=jax_normal(k_samp0, batch),
            mid=jax_mid_draws(ja, jp, k_mid, batch),
            down=jax_down_draws(k_down, batch, ja, jp, vae_do),
            enc0_masks=enc(k_drop0), enc1_masks=enc(k_enc1)),
    )


def floats(metrics):
    return {k: float(v) for k, v in metrics.items()}


# --------------------------------------------------- the slice as a whole
@pytest.mark.parametrize("flags", [{}, dict(clip_grad=50.0, **FLAGSHIP_GEN),
                                   dict(vae_train_dropout=1), *VARIANTS.values()],
                         ids=["defaults", "flagship-flags-clipped", "vae-dropout", *VARIANTS])
def test_two_rounds_match_jax_train_round(flagship, luts, flags):
    """Two consecutive rounds from the converted flagship (a seeded init in
    the variant configurations): the second round's metrics depend on the
    first round's three Adam updates."""
    ja, jp, ta = seeded_variant(**flags) if flags in VARIANTS.values() else flagship
    jlut, tlut = luts
    jcfg, tcfg = jconfig.Config(batch=B, **flags), tconfig.Config(batch=B, **flags)
    jstep = jax.jit(jloop.make_round_fn(ja, jcfg, jlut))
    tstep = tloop.make_round_fn(tcfg, tlut)
    js, ts = jax_state(jcfg, jp, gamma=0.5), port_state(ta, tcfg, gamma=0.5)
    for i, key in enumerate(jax.random.split(jax.random.key(7), 2)):
        params = js.params  # the draws' dropout masks do not depend on them
        js, jm = jstep(js, key)
        ts, tm = tstep(ts, draws=round_draws(ja, params, tcfg, key, B))
        jm, tm = floats(jm), floats(tm)
        assert set(tm) == set(jm) == set(tloop.METRIC_KEYS)
        for k in tm:
            # Round 2 runs on weights that moved by ~lr per entry, with
            # Adam's sign-like first step amplifying f32 gradient noise.
            rtol = (1e-3 if k.startswith("gnorm") else 1e-4) * (1 if i == 0 else 20)
            np.testing.assert_allclose(tm[k], jm[k], rtol=rtol, atol=1e-3, err_msg=f"{i} {k}")
    np.testing.assert_array_equal(ts.env.latents.numpy(), np.asarray(js.env.latents))
    assert all(int(o.state_dict()["state"][0]["step"]) == 2 for o in ts.opts.values())


# ---------------------------------------------------------------- gradients
def test_staged_gradients_match_jax_grad(flagship):
    ja, jp, ta = flagship
    o, s, pi, log_Ppi, mean, logvar, omega = loss_inputs(B, seed=4)
    k_mid, k_down = jax.random.split(jax.random.key(13))
    prec_j = jprecision.PrecisionState.create(gamma=0.5)
    grads_j = {
        "top": jax.grad(lambda p: jlosses.compute_loss_top(ja, p, s, log_Ppi)[0].mean())(
            jp["top"]),
        "mid": jax.grad(lambda p: jlosses.compute_loss_mid(
            ja, p, k_mid, s, pi, mean, logvar, omega)[0].mean())(jp["mid"]),
        "down": jax.grad(lambda p: jlosses.compute_loss_down(
            ja, p, k_down, o, mean, logvar, omega, prec_j,
            vae_dropout=False)[0].mean())(jp["down"]),
    }
    want = convert.params_from_jax(jax.tree.map(np.asarray, grads_j))

    ta = copy.deepcopy(ta)
    F_top, _ = tlosses.compute_loss_top(ta, t(s), t(log_Ppi))
    F_mid, _ = tlosses.compute_loss_mid(ta, t(s), t(pi), t(mean), t(logvar), t(omega),
                                        draws=jax_mid_draws(ja, jp, k_mid, B))
    F_down, _ = tlosses.compute_loss_down(
        ta, nchw(o), t(mean), t(logvar), t(omega),
        tprecision.PrecisionState.create(gamma=0.5), vae_dropout=False,
        draws=jax_down_draws(k_down, B))
    names, params = zip(*ta.named_parameters())
    # Each staged loss reaches its own layer only.
    for layer, F in (("top", F_top), ("mid", F_mid), ("down", F_down)):
        grads = torch.autograd.grad(F.mean(), params, allow_unused=True)
        for name, g in zip(names, grads):
            if not name.startswith(layer + "."):
                assert g is None, (layer, name)
                continue
            scale = float(want[name].abs().max())
            np.testing.assert_allclose(g.numpy(), want[name].numpy(), rtol=1e-3,
                                       atol=1e-3 * scale, err_msg=name)
        norm = tloop.global_norm([g for g in grads if g is not None])
        np.testing.assert_allclose(float(norm), float(optax.global_norm(grads_j[layer])),
                                   rtol=1e-3)


# ------------------------------------------------------------ Adam and clip
@pytest.mark.parametrize("clip", [0.0, 1.0, 1e3])
def test_adam_and_hand_clip_match_optax(clip):
    """Five steps on the same gradients: clip 1.0 scales every step, 1e3
    never does (max_norm / max(norm, max_norm) = 1 exactly)."""
    rng = np.random.default_rng(0)
    shapes = [(7, 5), (5,), (3, 2, 2, 2)]
    # Weights of O(0.05), as the networks' are: one f32 ulp is then ~4e-9.
    init = [(0.05 * rng.standard_normal(s)).astype(np.float32) for s in shapes]
    lr = 1e-3
    tx = optax.adam(lr) if clip == 0.0 else optax.chain(
        optax.clip_by_global_norm(clip), optax.adam(lr))
    jparams = [jnp.asarray(p) for p in init]
    jstate = tx.init(jparams)
    tparams = [torch.nn.Parameter(torch.from_numpy(p.copy())) for p in init]
    opt = torch.optim.Adam(tparams, lr=lr)
    for step in range(5):
        grads = [(rng.standard_normal(s) * 10.0 ** (step - 2)).astype(np.float32)
                 for s in shapes]
        upd, jstate = tx.update([jnp.asarray(g) for g in grads], jstate, jparams)
        jparams = optax.apply_updates(jparams, upd)
        tg = [torch.from_numpy(g.copy()) for g in grads]
        norm = tloop.clip_by_global_norm_(tg, clip) if clip else tloop.global_norm(tg)
        np.testing.assert_allclose(float(norm), float(optax.global_norm(grads)), rtol=1e-6)
        for p, g in zip(tparams, tg):
            p.grad = g
        opt.step()
        for p, j in zip(tparams, jparams):
            np.testing.assert_allclose(p.detach().numpy(), np.asarray(j), rtol=0, atol=1e-7)


# ---------------------------------------------------------------- the rest
def test_freeze_top_withholds_only_the_top_update(flagship, luts):
    """tests/test_train_loop.py:86: omega still flows from the live habit
    KL; top weights and top Adam state are bit-frozen; mid/down move."""
    _, _, ta = flagship
    cfg = tconfig.Config(batch=B, freeze_top=True)
    state = port_state(ta, cfg)
    before = copy.deepcopy(state.agent.state_dict())
    state, metrics = tloop.make_round_fn(cfg, luts[1])(state, torch.Generator().manual_seed(1))
    m = floats(metrics)
    assert np.isfinite(m["kl_pi"]) and np.isfinite(m["omega"]) and m["gnorm_top"] > 0
    after = state.agent.state_dict()
    moved = {layer: any(not torch.equal(after[k], before[k]) for k in after
                        if k.startswith(layer + ".")) for layer in tloop.LAYERS}
    assert moved == {"top": False, "mid": True, "down": True}
    assert state.opts["top"].state_dict()["state"] == {}
    assert len(state.opts["mid"].state_dict()["state"]) == 8
    assert all(p.grad is None for p in state.agent.parameters())


def test_epoch_returns_last_round_and_worst_round_maxima(luts):
    cfg = tconfig.Config(batch=4)
    rounds = 3

    def fresh():
        g = torch.Generator().manual_seed(5)
        return tloop.create_train_state(cfg, tloop.ActiveInferenceAgent(), g, "cpu"), g

    state, g = fresh()
    round_fn = tloop.make_round_fn(cfg, luts[1])
    per_round = []
    for _ in range(rounds):
        state, m = round_fn(state, g)
        per_round.append(floats(m))
    state, g = fresh()
    state, out = tloop.make_epoch_fn(cfg, luts[1], rounds)(state, g)
    assert set(out) == set(tloop.METRIC_KEYS) | {k + "_max" for k in tloop.EPOCH_MAX_KEYS}
    for k in tloop.METRIC_KEYS:
        np.testing.assert_allclose(out[k], per_round[-1][k], rtol=1e-6)
    for k in tloop.EPOCH_MAX_KEYS:
        np.testing.assert_allclose(out[k + "_max"], max(r[k] for r in per_round), rtol=1e-6)
    assert all(isinstance(v, float) for v in out.values())


@pytest.fixture(scope="module")
def seeded_init():
    ja = JAgent()
    return ja, jax.jit(ja.init)(jax.random.key(3))


def test_loss_trajectory_inside_the_jax_spread(seeded_init, luts):
    """12 rounds at batch 8 from one converted untrained init, each package
    on its own random stream: the pixel NLL falls (tests/test_train_loop.py
    :180), and the port's mean NLL over the last 4 rounds lies within the
    range of three JAX seeds widened by that range on either side."""
    ja, jp = seeded_init
    jlut, tlut = luts
    rounds = 12
    jcfg, tcfg = jconfig.Config(batch=B), tconfig.Config(batch=B)
    jstep = jax.jit(jloop.make_round_fn(ja, jcfg, jlut))
    tails = []
    for seed in range(3):
        js, nll = jax_state(jcfg, jp), []
        for key in jax.random.split(jax.random.key(100 + seed), rounds):
            js, m = jstep(js, key)
            nll.append(float(m["nll_o"]))
        tails.append(np.mean(nll[-4:]))
    state = port_state(torch_agent(jp), tcfg)
    g = torch.Generator().manual_seed(0)
    tstep = tloop.make_round_fn(tcfg, tlut)
    nll = []
    for _ in range(rounds):
        state, m = tstep(state, g)
        nll.append(float(m["nll_o"]))
    assert min(nll[:3]) > np.mean(nll[-4:]), nll
    lo, hi = min(tails), max(tails)
    assert lo - (hi - lo) <= np.mean(nll[-4:]) <= hi + (hi - lo), (nll, tails)
