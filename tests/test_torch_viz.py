"""PyTorch port: the figure and overlay modules (``viz/``) and the
trainer's per-epoch figures.

The score overlay is held bit-equal to the JAX package's
(``scripts/gif_score.py`` decodes its pixels); the three figure functions
write their files, as tests/test_viz.py checks the JAX ones; a tiny CPU
trainer run writes every per-epoch figure.
"""

import numpy as np
import pytest

from deep_active_inference_mc_tpu.viz import scoretext as jscoretext
from deep_active_inference_mc_torch.apps import train as train_app
from deep_active_inference_mc_torch.utils import stats as stats_lib
from deep_active_inference_mc_torch.viz import scoretext
from deep_active_inference_mc_torch.viz.generate_traversals import generate_traversals
from deep_active_inference_mc_torch.viz.reconstructions_plot import reconstructions_plot
from deep_active_inference_mc_torch.viz.stats_plot import behavior_plot, stats_plot
from test_torch_models import few_torch_threads  # noqa: F401 (autouse fixture)

SCORES = [0.0, 11.6875, -3.25, 0.0625, 12.3125, -0.5625, 9.9375, 5.5, -17.0, 123.4375]


def test_templates_equal_jax():
    got, want = scoretext.templates(), jscoretext.templates()
    assert set(got) == set(want) == set("0123456789.-")
    for ch in want:
        np.testing.assert_array_equal(got[ch], want[ch], err_msg=ch)


@pytest.mark.parametrize("channels", [0, 3])
def test_paint_score_equals_jax(channels):
    rng = np.random.default_rng(channels)
    shape = (500, 500) + ((channels,) if channels else ())
    for v in SCORES:
        base = (rng.random(shape) * 200).astype(np.uint8)  # sprite-like ink under the text
        got = scoretext.paint_score(base.copy(), v, rate=abs(v) / 3.7)
        want = jscoretext.paint_score(base.copy(), v, rate=abs(v) / 3.7)
        np.testing.assert_array_equal(got, want, err_msg=str(v))
        assert (got != base).any()
    assert scoretext.format_score(11.6875) == jscoretext.format_score(11.6875) == "11.6875"


def test_reconstructions_plot(tmp_path):
    o = np.random.RandomState(0).rand(8, 64, 64, 1).astype(np.float32)
    out = tmp_path / "recon.png"
    reconstructions_plot(o, o, o, filename=out)
    assert out.exists() and out.stat().st_size > 1000


def test_stats_and_behavior_plots(tmp_path):
    stats = stats_lib.new_stats()
    rng = np.random.RandomState(1)
    for _ in range(5):
        for k in stats_lib.STATS_KEYS:
            if k.endswith("_anal"):
                stats[k].append(np.abs(rng.rand(4 if "pi" in k else 10)) + 0.1)
            elif k.startswith("train_scores") or k == "deep_mse_o":
                continue  # legitimately empty series
            else:
                stats[k].append(float(np.abs(rng.rand())) + 0.1)
    stats_plot(stats, tmp_path / "stats")
    behavior_plot(stats, tmp_path / "behavior")
    for name in ("stats.png", "stats.svg", "behavior.png"):
        assert (tmp_path / name).exists(), name


def test_generate_traversals(tmp_path):
    rng = np.random.RandomState(2)
    s_dim = 4  # small for speed (the MI regression is the slow part)

    def decode_fn(s):
        return np.tile(np.abs(s[:, :1, None, None]) % 1.0, (1, 16, 16, 1)).astype(np.float32)

    out = tmp_path / "trav.png"
    generate_traversals(decode_fn, s_dim, rng.randn(60, s_dim).astype(np.float32),
                        rng.randn(60, 6).astype(np.float32), filenames=[out])
    assert out.exists() and out.stat().st_size > 1000


def test_trainer_draws_every_figure(tmp_path):
    out = train_app.main(["--device", "cpu", "--batch", "8", "--rounds", "2", "--test_size",
                          "16", "--sweep_envs", "8", "--sweep_steps", "2", "--epochs", "1",
                          "--out_root", str(tmp_path)])
    folder, sig = out["folder"], out["state"] and train_app.Config(batch=8).signature
    for name in ("traversals_at_epoch_0001.png", f"imagination_{sig}_1.png",
                 f"reward_imagination_{sig}_1.png", f"1_result_{sig}.png",
                 f"1_result_{sig}.svg", f"2_behavior_{sig}.png"):
        assert (folder / name).stat().st_size > 1000, name
