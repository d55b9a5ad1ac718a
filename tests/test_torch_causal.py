"""PyTorch port: the structural causal model (``models/causal.py``), its
weight converter (``utils/convert.causal_params_from_jax``), its training
(``train/causal.py``) and its CLI (``apps/train_causal.py``) against the
JAX package.

Each converted layer holds to Flax's on the same input, and the whole
encode, decode and counterfactual to 1e-4; the loss to rtol 1e-5; one
training round, with the JAX round's batch draws rebuilt from its key and
injected, to 1e-4 in its loss and in every weight after the Adam step.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from flax import linen as nn

from deep_active_inference_mc_tpu import config as jconfig
from deep_active_inference_mc_tpu.envs import raster as jraster
from deep_active_inference_mc_tpu.infer import precision as jprecision
from deep_active_inference_mc_tpu.models.causal import StructuralCausalModel as JModel
from deep_active_inference_mc_tpu.train import causal as jcausal
from deep_active_inference_mc_torch import config as tconfig
from deep_active_inference_mc_torch.apps import train_causal as causal_app
from deep_active_inference_mc_torch.envs import data as tdata
from deep_active_inference_mc_torch.envs import raster as traster
from deep_active_inference_mc_torch.infer import precision as tprecision
from deep_active_inference_mc_torch.models.causal import StructuralCausalModel as TModel
from deep_active_inference_mc_torch.train import causal as tcausal
from deep_active_inference_mc_torch.utils import convert
from test_torch_data import env_draws, respawn_draws, tstate
from test_torch_losses import t
from test_torch_models import few_torch_threads  # noqa: F401 (autouse fixture)

TOL = dict(rtol=1e-4, atol=1e-4)
B = 4


@pytest.fixture(scope="module")
def models():
    jm = JModel()
    params = jax.jit(jm.init)(jax.random.key(0), jnp.zeros((1, 64, 64, 1)))["params"]
    tm = TModel()
    tm.load_state_dict(convert.causal_params_from_jax(jax.tree.map(np.asarray, params)))
    return jm, params, tm


def frames(seed, n=B, hw=64, c=1):
    x = np.random.default_rng(seed).random((n, hw, hw, c)).astype(np.float32)
    return x, torch.from_numpy(x).permute(0, 3, 1, 2).contiguous()


def nhwc(x):
    return x.detach().permute(0, 2, 3, 1).numpy()


# (Flax name, input size, input channels, output channels)
LAYERS = {
    "enc_convs_0": (64, 1, 32), "enc_convs_1": (32, 32, 64), "enc_convs_2": (16, 64, 128),
    "dec_convs_0": (8, 128, 64), "dec_convs_1": (16, 64, 32), "dec_out": (32, 32, 1),
}


@pytest.mark.parametrize("name", LAYERS)
def test_each_converted_conv_layer_matches_flax(models, name):
    """A stride-2 SAME kernel-4 conv is conv2d with padding 1 (the
    asymmetric pad is wrong); the transposed conv is conv_transpose2d with
    padding 1 and the flipped kernel (unflipped is wrong)."""
    jm, params, tm = models
    hw, cin, cout = LAYERS[name]
    leaf = params[name]
    x, tx = frames(list(LAYERS).index(name), n=2, hw=hw, c=cin)
    sd = convert.causal_params_from_jax(jax.tree.map(np.asarray, params))
    target = {"dec_out": "dec_convs.2"}.get(name, name.replace("_convs_", "_convs."))
    w, b = sd[f"{target}.weight"], sd[f"{target}.bias"]
    if name.startswith("enc"):
        want = nn.Conv(cout, (4, 4), strides=(2, 2), padding="SAME").apply(
            {"params": leaf}, jnp.asarray(x))
        got = F.conv2d(tx, w, b, stride=2, padding=1)
        wrong = F.conv2d(F.pad(tx, (2, 1, 2, 1)), w, b, stride=2)
        assert got.shape[-1] == hw // 2
    else:
        want = nn.ConvTranspose(cout, (4, 4), strides=(2, 2), padding="SAME").apply(
            {"params": leaf}, jnp.asarray(x))
        got = F.conv_transpose2d(tx, w, b, stride=2, padding=1)
        wrong = F.conv_transpose2d(tx, w.flip(-1, -2), b, stride=2, padding=1)
        assert got.shape[-1] == 2 * hw
    err = np.abs(nhwc(got) - np.asarray(want)).max()
    assert err <= 1e-5, err
    assert np.abs(nhwc(wrong) - np.asarray(want)).max() > 100 * max(err, 1e-7)
    # The module's own layer is the converted one.
    layer = dict(tm.named_modules())[target]
    torch.testing.assert_close(layer(tx), got, rtol=0, atol=0)


def test_encode_decode_counterfactual_match_flax(models):
    jm, params, tm = models
    x, tx = frames(1)
    delta = np.zeros((B, 10), np.float32)
    delta[:, 0] = 3.0
    recon_j, s_j = jm.apply({"params": params}, jnp.asarray(x))
    cf_j, s_cf_j = jm.apply({"params": params}, jnp.asarray(x), jnp.asarray(delta),
                            method=JModel.counterfactual)
    with torch.no_grad():
        s = tm.encode(tx)
        recon, s2 = tm(tx)
        cf, s_cf = tm.counterfactual(tx, torch.from_numpy(delta))
        dec = tm.decode(torch.from_numpy(np.array(s_j)))
    np.testing.assert_allclose(s.numpy(), np.asarray(s_j), **TOL)
    assert torch.equal(s, s2)
    np.testing.assert_allclose(nhwc(recon), np.asarray(recon_j), **TOL)
    np.testing.assert_allclose(nhwc(dec), np.asarray(recon_j), **TOL)
    np.testing.assert_allclose(s_cf.numpy(), np.asarray(s_cf_j), **TOL)
    np.testing.assert_allclose(nhwc(cf), np.asarray(cf_j), **TOL)
    assert recon.min() >= 0 and recon.max() <= 1 and (cf - recon).abs().mean() > 1e-6


def test_loss_matches_jax():
    rng = np.random.default_rng(2)
    x_recon = rng.random((B, 64, 64, 1)).astype(np.float32)
    o1 = rng.random((B, 64, 64, 1)).astype(np.float32)
    s = rng.standard_normal((B, 10)).astype(np.float32)
    jp = jprecision.PrecisionState.create(gamma=0.2, beta_s=0.7, beta_o=1.3)
    want = jcausal.compute_loss_causal(None, None, jnp.asarray(x_recon), jnp.asarray(o1),
                                       jnp.asarray(s), jp)
    got = tcausal.compute_loss_causal(
        torch.from_numpy(x_recon).permute(0, 3, 1, 2), torch.from_numpy(o1).permute(0, 3, 1, 2),
        torch.from_numpy(s), tprecision.PrecisionState.create(0.2, 0.7, 1.3))
    for g, w in zip(got, want):
        np.testing.assert_allclose(float(g), float(w), rtol=1e-5)


def test_one_round_matches_jax(models):
    """``causal_round`` on the same weights, the same fresh Adam and the
    JAX round's batch draws: the loss and every weight after the step."""
    jm, params, _ = models
    jcfg, tcfg = jconfig.Config(batch=B), tconfig.Config(batch=B)
    jlut, tlut = jraster.build_sprite_lut(), traster.build_sprite_lut("cpu")
    jstate, opt = jcausal.create_causal_state(jcfg, jm, jax.random.key(1), lr=1e-3)
    jstate = jstate.replace(params=params, opt_state=opt.init(params))
    key = jax.random.key(9)
    new_j, m_j = jax.jit(lambda st, k: jcausal.causal_round(jm, jcfg, opt, st, k, jlut))(
        jstate, key)

    tm = TModel()
    tm.load_state_dict(convert.causal_params_from_jax(jax.tree.map(np.asarray, params)))
    state = tcausal.CausalTrainState(
        model=tm, opt=torch.optim.Adam(tm.parameters(), lr=1e-3),
        precision=tprecision.PrecisionState.create(), env=tstate(B))
    k_rand, k_ppi, k_act, k_step = jax.random.split(key, 4)
    draws = tdata.RandomDraws(env_draws(k_rand, B), t(jax.random.uniform(k_ppi, (B, 4))),
                              t(jax.random.gumbel(k_act, (B, 4))),
                              respawn_draws(k_step, B, tcfg.repeats))
    state, m = tcausal.causal_round(tcfg, state, tlut, draws=draws)
    for k in ("F", "mse_o", "kl_div_s", "omega"):
        np.testing.assert_allclose(float(m[k]), float(m_j[k]), err_msg=k, **TOL)
    want = convert.causal_params_from_jax(jax.tree.map(np.asarray, new_j.params))
    for k, v in tm.state_dict().items():
        np.testing.assert_allclose(v.numpy(), want[k].numpy(), err_msg=k, **TOL)
    np.testing.assert_array_equal(state.env.latents.numpy(), np.asarray(new_j.env.latents))


def test_eval_counterfactual_effect_is_positive():
    cfg = tconfig.Config(batch=B, test_size=16)
    lut = traster.build_sprite_lut("cpu")
    state = tcausal.create_causal_state(cfg, TModel(), torch.Generator().manual_seed(0), "cpu")
    ev = tcausal.make_causal_eval(cfg, lut)(state.model, state.precision,
                                           torch.Generator().manual_seed(1))
    for k in ("F", "mse_o", "kl_div_s", "omega", "cf_effect"):
        assert ev[k].ndim == 0 and torch.isfinite(ev[k]), k
    assert float(ev["cf_effect"]) > 0
    assert ev["s"].shape == (16, 10) and ev["S0_real"].shape == (16, 6)
    assert ev["x_recon"].shape == ev["o1"].shape == (16, 1, 64, 64)


def test_cli_trains_saves_and_resumes(tmp_path, capsys):
    argv = ["--device", "cpu", "--batch", "8", "--rounds", "3", "--test_size", "16",
            "--save_every", "1", "--archive_every", "2", "--out_root", str(tmp_path)]
    out = causal_app.main(argv + ["--epochs", "2", "--l_rate", "1e-3"])
    lines = [ln for ln in capsys.readouterr().out.splitlines() if ", F: " in ln]
    assert [ln.split(",")[0] for ln in lines] == ["1", "2"] and "cf_effect: " in lines[-1]
    folder = out["folder"]
    assert folder.name.startswith("figs_causal_model_")
    for name in ("traversals_at_epoch_0001.png", "traversals_at_epoch_0002.png",
                 f"imagination_{folder.name[5:]}_2.png"):
        assert (folder / name).exists(), name
    arch = torch.load(folder / "checkpoints_epoch_2" / "state" / "state.pt", weights_only=True)
    assert "opt_states" not in arch
    out2 = causal_app.main(argv + ["--resume", "--epochs", "3", "--l_rate", "1e-3"])
    text = capsys.readouterr().out
    assert "Resumed from" in text and "at epoch 3" in text and out2["start_epoch"] == 3
    stats = out2["stats"]
    assert len(stats["F"]) == 3 and stats["F"][:2] == out["stats"]["F"]
    assert all(np.isfinite(stats[k]).all() for k in ("F", "mse_o", "kl_div_s", "omega"))
    step = int(next(iter(out2["state"].opt.state_dict()["state"].values()))["step"])
    assert step == 9  # 2 epochs restored + 1 trained, 3 rounds each
