"""PyTorch port: the demo (``apps/demo.py``) against the JAX demo's logic.

``make_mask`` equals the JAX one; the habit and manual ticks and the key
map mirror tests/test_demo_logic.py; the habit tick trajectory equals the
JAX ``Demo``'s on the converted flagship with the JAX demo's env draws
rebuilt from its key stream (both draw the action from
``np.random.default_rng(t + seed)``); the round with its queue on the
device gives the host tick loop's score trace on the same draws; a
``--record_ref`` gif decodes with ``scripts/gif_score.py`` to its own
score trace.
"""

import argparse
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from deep_active_inference_mc_tpu.apps import demo as jdemo
from deep_active_inference_mc_tpu.envs import dsprites as jenv
from deep_active_inference_mc_torch.apps import demo as tdemo
from deep_active_inference_mc_torch.infer.agent import ActiveInferenceAgent
from test_torch_losses import t
from test_torch_models import few_torch_threads  # noqa: F401 (autouse fixture)
from test_torch_models import jax_flagship, torch_agent

ROOT = Path(__file__).resolve().parent.parent


def demo_args(**over):
    base = dict(network="", mean=False, duration=100, method="habit", steps=2,
                temperature=1.0, jumps=2, C=1.0, repeats=3, threshold=0.5, depth=2,
                no_habit=False, headless=0, seed=0, device="cpu")
    base.update(over)
    return argparse.Namespace(**base)


def seeded_agent():
    return ActiveInferenceAgent().init(torch.Generator().manual_seed(0))


@pytest.fixture(scope="module")
def demo():
    return tdemo.Demo(seeded_agent(), demo_args())


def test_make_mask_equals_jax():
    rng = np.random.default_rng(0)
    for _ in range(20):
        paths = [list(rng.integers(0, 4, rng.integers(0, 6))) for _ in range(rng.integers(0, 9))]
        x, y = (int(v) for v in rng.integers(0, 32, 2))
        jumps = int(rng.integers(1, 6))
        np.testing.assert_array_equal(tdemo.make_mask(paths, x, y, jumps),
                                      jdemo.make_mask(paths, x, y, jumps))
    mask = tdemo.make_mask([[0, 2]], pos_x=10, pos_y=5, jumps=2)
    assert mask[11, 5] > 0 and mask[12, 5] > 0 and mask[12, 6] > 0 and mask[12, 7] > 0
    assert mask.max() == 1.0 and tdemo.make_mask([], 0, 0, 1).max() == 0.0


def test_choose_is_numpy_choice():
    rng = np.random.default_rng(1)
    for s in range(200):
        p = rng.dirichlet(np.ones(4)).astype(np.float32)
        u = np.random.default_rng(s).random()
        want = np.random.default_rng(s).choice(4, p=p / p.sum())
        assert int(tdemo.choose(torch.from_numpy(p), u)) == want


def test_habit_tick_fills_and_consumes_queue(demo):
    demo.method = "habit"
    demo.t = 1  # away from the round boundary
    demo.executing_steps = []
    demo.tick()
    assert len(demo.executing_steps) in (demo.steps - 1, 0)
    assert demo.last_info.startswith("habit Qpi=")


def test_manual_mode_and_keys(demo):
    demo.method = "no"
    demo.executing_steps = []
    y0 = int(demo.env.latents[0, 5])
    demo.on_key("s")  # up
    assert int(demo.env.latents[0, 5]) in (y0 + 1, 0, y0)  # up or respawn
    t0 = demo.t
    demo.tick()  # manual: no plan, no step
    assert demo.executing_steps == [] and demo.t == t0 + 1
    for k, check in (("2", lambda d: d.method == "ai"), ("3", lambda d: d.method == "habit"),
                     ("p", lambda d: d.steps == 3), ("o", lambda d: d.steps == 2),
                     ("9", lambda d: d.temperature == 6.0),
                     ("8", lambda d: d.temperature == 1.0), ("m", lambda d: d.mean),
                     ("m", lambda d: not d.mean), ("1", lambda d: d.method == "mcts"),
                     ("4", lambda d: d.method == "no"), ("5", lambda d: d.method == "t1"),
                     ("6", lambda d: d.method == "t12")):
        demo.on_key(k)
        assert check(demo), k
    demo.on_key("r")
    assert demo.score == 0.0 and demo.t == 0


def test_frame_overlay(demo):
    f = demo.frame()
    assert f.shape == (64, 64) and f[59, 31] == 1.0


class JaxKeyDraws(tdemo.DemoDraws):
    """The JAX ``Demo``'s env draws, from its key stream: one key for the
    reset (unused: the randomize replaces every field), then one per
    randomize and one per step, in the order the habit demo takes them."""

    def __init__(self, seed):
        super().__init__("cpu", seed)
        self.key = jax.random.key(seed)
        self._next()

    def _next(self):
        self.key, sub = jax.random.split(self.key)
        return sub

    def randomize(self):
        k = self._next()
        r = jenv.randomize(k, jenv.reset(k, 1))
        return t(r.latents).long(), t(r.score), t(r.last_r)

    def round_respawns(self):
        return torch.stack([t(jenv.sample_latents(self._next(), 1)).long()
                            for _ in range(tdemo.DURATION_OF_ROUND)])


def test_habit_tick_trajectory_matches_jax():
    ja, jp = jax_flagship()
    args = demo_args(steps=3, seed=4)
    want = jdemo.Demo(ja, jp, None, args)
    got = tdemo.Demo(torch_agent(jp), args, draws=JaxKeyDraws(args.seed))
    np.testing.assert_array_equal(got.env.latents.numpy(), np.asarray(want.env.latents))
    moved = 0
    for _ in range(40):
        want.tick()
        got.tick()
        np.testing.assert_array_equal(got.env.latents.numpy(), np.asarray(want.env.latents))
        np.testing.assert_allclose(got.env.score.numpy(), np.asarray(want.env.score), atol=1e-6)
        assert got.executing_steps == want.executing_steps
        moved += got.executing_steps != []
    assert moved > 0 and got.t == want.t == 40


@pytest.mark.parametrize("method", ["habit", "ai", "mcts"])
def test_device_queue_round_equals_host_ticks(method):
    """One round with the plan queue on the device, against 100 host
    ticks of a second demo on the same draws: the same score after every
    tick, the same plans, the same final env."""
    args = demo_args(method=method, steps=3, jumps=5, repeats=4, depth=2)
    agent = seeded_agent()
    host, dev = tdemo.Demo(agent, args), tdemo.Demo(agent, args)
    for d in (host, dev):  # a nonzero score that the round boundary keeps
        d.env = d.env.replace(score=torch.full((1,), 3.25))
    trace = []
    for _ in range(tdemo.DURATION_OF_ROUND):
        host.tick()
        trace.append(host.score)
    got = dev.run_round()
    assert got.shape == (tdemo.DURATION_OF_ROUND,)
    np.testing.assert_array_equal(got.numpy(), np.asarray(trace, np.float32))
    assert dev.plans_made == host.plans_made >= 2
    assert torch.equal(dev.env.latents, host.env.latents) and dev.t == host.t == 100
    with pytest.raises(ValueError, match="round boundary"):
        dev.t = 1
        dev.run_round()


def test_headless_runs_whole_rounds(capsys):
    out = tdemo.main(["--device", "cpu", "--method", "habit", "--headless", "150",
                      "--steps", "3"])
    assert out["trace"].shape == (200,) and out["plans"] >= 200 // 15
    assert "note: running 200 frames" in capsys.readouterr().out


def test_record_ref_gif_decodes_to_its_scores(tmp_path):
    sys.path.insert(0, str(ROOT / "scripts"))
    import gif_score
    from PIL import Image

    demo = tdemo.Demo(seeded_agent(), demo_args(steps=3))
    demo.env = demo.env.replace(score=torch.full((1,), 11.6875))
    path = str(tmp_path / "demo.gif")
    tdemo.run_record_ref(demo, 60, path)
    with Image.open(path) as im:
        assert im.n_frames == 60 and im.size == (500, 500)
    scores, clean = gif_score.decode_gif(Path(path), gif_score.load_pixel_templates())
    want = np.load(path + ".scores.npz")["scores"]
    assert len(want) == 60 and clean.sum() >= 30
    np.testing.assert_array_equal(scores[clean], want[clean])
    assert (want == 11.6875).any()
