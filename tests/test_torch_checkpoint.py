"""PyTorch port: checkpoint / resume / archive round trips, mirroring the
seven tests of tests/test_checkpoint.py on the torch-native checkpoint, and
the port's stats registry against the JAX package's."""

import numpy as np
import pytest
import torch

from deep_active_inference_mc_tpu.utils import stats as jstats
from deep_active_inference_mc_torch.config import Config
from deep_active_inference_mc_torch.envs import raster
from deep_active_inference_mc_torch.infer.agent import ActiveInferenceAgent
from deep_active_inference_mc_torch.train import loop as train_loop
from deep_active_inference_mc_torch.utils import checkpoint as ckpt
from deep_active_inference_mc_torch.utils import stats as stats_lib
from test_torch_models import few_torch_threads  # noqa: F401 (autouse fixture)

CFG = Config(batch=4, test_size=4)


def make_state(seed, agent=None):
    gen = torch.Generator().manual_seed(seed)
    agent = agent or ActiveInferenceAgent(s_dim=CFG.s_dim, pi_dim=CFG.pi_dim)
    return train_loop.create_train_state(CFG, agent, gen, "cpu"), gen


@pytest.fixture(scope="module")
def trained():
    """A state one round into training, so the Adam moments are non-trivial."""
    state, gen = make_state(0)
    state.precision = state.precision.replace(gamma=torch.tensor(0.25))
    state, _ = train_loop.make_round_fn(CFG, raster.build_sprite_lut("cpu"))(state, gen)
    return state, gen


def load_state_file(folder):
    return torch.load(folder / "state" / "state.pt", weights_only=True)


def test_save_load_roundtrip(tmp_path, trained):
    state, gen = trained
    stats = stats_lib.new_stats()
    stats["F"].append(1.25)
    stats["mse_o"].append(99.0)
    folder = tmp_path / "checkpoints"
    ckpt.save_all(folder, state, stats, gen, script_file="")
    assert ckpt.latest_exists(folder)
    assert (folder / "stats.pkl").exists()
    assert (folder / "networks.py").exists()  # source snapshot

    template, gen2 = make_state(7)
    restored, stats2 = ckpt.load_all(folder, template, gen2)
    assert stats2["F"] == [1.25]
    # Weights restored exactly (the template had a different init).
    for k, v in state.agent.state_dict().items():
        assert torch.equal(restored.agent.state_dict()[k], v), k
    # Optimizer state restored: step counts and both moments.
    for layer in train_loop.LAYERS:
        a = state.opts[layer].state_dict()["state"]
        b = restored.opts[layer].state_dict()["state"]
        assert a.keys() == b.keys() and len(a) > 0
        for i in a:
            assert int(b[i]["step"]) == 1
            assert torch.equal(a[i]["exp_avg"], b[i]["exp_avg"])
            assert torch.equal(a[i]["exp_avg_sq"], b[i]["exp_avg_sq"])
    # The random stream continues where the saved run stopped.
    assert torch.equal(torch.rand(5, generator=gen2), torch.rand(5, generator=gen))
    # Precision scalars and envs restored.
    assert float(restored.precision.gamma) == 0.25
    assert torch.equal(restored.env.latents, state.env.latents)
    # The restored state trains on.
    restored, m = train_loop.make_round_fn(CFG, raster.build_sprite_lut("cpu"))(restored, gen2)
    assert np.isfinite(float(m["F_down"]))
    assert int(restored.opts["down"].state_dict()["state"][0]["step"]) == 2


def test_archive_drops_optimizer(tmp_path, trained):
    state, gen = trained
    folder = tmp_path / "checkpoints"
    ckpt.save_all(folder, state, stats_lib.new_stats(), gen)
    ckpt.archive(folder, epoch=25)
    arch = tmp_path / "checkpoints_epoch_25"
    payload = load_state_file(arch)
    assert "opt_states" not in payload
    assert "agent" in payload and (arch / "stats.pkl").exists()
    # The original checkpoint still has the optimizer state.
    assert "opt_states" in load_state_file(folder)


def test_load_all_from_weight_only_archive(tmp_path, trained):
    """load_all on an archive (no optimizer state) loads the saved weights
    into the template and leaves its optimizers fresh."""
    state, gen = trained
    folder = tmp_path / "checkpoints"
    ckpt.save_all(folder, state, stats_lib.new_stats(), gen)
    ckpt.archive(folder, epoch=25)
    template, gen2 = make_state(7)
    before = {k: v.clone() for k, v in template.agent.state_dict().items()}
    restored, _ = ckpt.load_all(tmp_path / "checkpoints_epoch_25", template, gen2)
    saved = state.agent.state_dict()
    got = restored.agent.state_dict()
    assert all(torch.equal(got[k], saved[k]) for k in saved)
    assert any(not torch.equal(got[k], before[k]) for k in saved)
    assert all(o.state_dict()["state"] == {} for o in restored.opts.values())


def test_load_all_refuses_missing_params(tmp_path, trained):
    """A template with a weight the checkpoint lacks raises instead of
    silently evaluating an untrained subtree."""
    state, gen = trained
    folder = tmp_path / "checkpoints"
    ckpt.save_all(folder, state, stats_lib.new_stats(), gen)
    ckpt.archive(folder, epoch=25)
    agent = ActiveInferenceAgent(s_dim=CFG.s_dim, pi_dim=CFG.pi_dim)
    agent.phantom_layer = torch.nn.Linear(2, 2)
    template, gen2 = make_state(7, agent)
    with pytest.raises(ValueError, match="params.*phantom"):
        ckpt.load_all(tmp_path / "checkpoints_epoch_25", template, gen2)


def test_pad_missing_stats_and_key_list_match_jax():
    stats = stats_lib.pad_missing({"F": [1.0, 2.0], "mse_o": [3.0]})
    assert len(stats["mse_o"]) == 2
    assert all(len(v) in (0, 2) for v in stats.values())
    assert set(stats_lib.STATS_KEYS) <= set(stats.keys())
    assert stats_lib.STATS_KEYS == jstats.STATS_KEYS
    assert stats_lib.new_stats() == jstats.new_stats()


def test_crash_between_swap_renames_recovers(tmp_path, trained):
    """If a kill lands between the two swap renames in _write_payload
    (``state`` renamed away, ``state.tmp`` not yet renamed in), the loader
    and the archive fall back to the complete ``state.old`` checkpoint."""
    state, gen = trained
    stats = stats_lib.new_stats()
    stats["F"].append(2.5)
    folder = tmp_path / "checkpoints"
    ckpt.save_all(folder, state, stats, gen)
    ckpt.save_all(folder, state, stats, gen)  # exercise the swap path
    assert not (folder / "state.tmp").exists() and not (folder / "state.old").exists()

    (folder / "state").rename(folder / "state.old")
    assert ckpt.latest_exists(folder)
    template, gen2 = make_state(1)
    restored, got_stats = ckpt.load_all(folder, template, gen2)
    assert torch.equal(restored.agent.state_dict()["mid.fc.0.weight"],
                       state.agent.state_dict()["mid.fc.0.weight"])
    assert got_stats["F"] == [2.5]
    ckpt.archive(folder, epoch=3)
    assert "agent" in load_state_file(tmp_path / "checkpoints_epoch_3")


def test_async_saver_surfaces_writer_errors(tmp_path, trained):
    state, gen = trained
    saver = ckpt.AsyncSaver()
    # Unwritable destination: a path under a regular file.
    blocker = tmp_path / "blocker"
    blocker.write_text("x")
    saver.save(blocker / "sub", state, stats_lib.new_stats(), gen)
    with pytest.raises(OSError):
        saver.wait()
    saver.wait()  # the error is cleared after being raised once
    # A good save takes a snapshot: later in-place updates do not reach it.
    folder = tmp_path / "checkpoints"
    w = state.agent.top.fc[0].weight
    kept = w.detach().clone()
    saver.save(folder, state, stats_lib.new_stats(), gen)
    with torch.no_grad():
        w.add_(1.0)
    saver.wait()
    with torch.no_grad():
        w.sub_(1.0)
    assert torch.equal(load_state_file(folder)["agent"]["top.fc.0.weight"], kept)


def test_resume_on_another_device_type_is_refused(tmp_path, trained):
    """A full checkpoint continues its run's random stream, so a generator
    of another device type refuses it; its weight-only archive loads on any
    device and leaves the generator alone."""
    state, gen = trained
    folder = tmp_path / "checkpoints"
    ckpt.save_all(folder, state, stats_lib.new_stats(), gen)
    payload = load_state_file(folder)
    payload["rng_device"] = "cuda"
    torch.save(payload, folder / "state" / "state.pt")
    template, gen2 = make_state(7)
    expect = gen2.get_state()
    with pytest.raises(ValueError, match="saved by a run on cuda"):
        ckpt.load_all(folder, template, gen2)
    ckpt.archive(folder, epoch=1)
    restored, _ = ckpt.load_all(tmp_path / "checkpoints_epoch_1", template, gen2)
    assert torch.equal(gen2.get_state(), expect)
    assert torch.equal(restored.agent.state_dict()["top.fc.0.weight"],
                       state.agent.state_dict()["top.fc.0.weight"])


def test_mesh_checkpoint_resumes_single_rank_and_back(tmp_path):
    """A 2-rank tensor-parallel run saves the unsharded state (gathered
    weights and Adam moments); a single-rank run resumes it, and a 2-rank
    data-parallel run resumes that, the Adam step counts continuing."""
    from deep_active_inference_mc_torch.apps import train as train_app

    argv = ["--device", "cpu", "--batch", "8", "--rounds", "1", "--test_size", "8",
            "--sweep_envs", "8", "--sweep_steps", "1", "--viz_every", "1000",
            "--save_every", "1", "--out_root", str(tmp_path)]
    first = train_app.main(argv + ["--epochs", "1", "--mesh_shape", "2", "--tp", "2"])
    assert [r["rank"] for r in first["ranks"]] == [0, 1]
    assert first["adam_steps"] == {"top": 1, "mid": 1, "down": 1}
    full = load_state_file(first["folder"] / "checkpoints")
    assert full["agent"]["mid.fc.0.weight"].shape == (512, 14)  # unsharded
    assert full["opt_states"]["mid"]["state"][0]["exp_avg"].shape == (512, 14)

    single = train_app.main(argv + ["--epochs", "2", "--resume"])
    assert single["start_epoch"] == 2
    assert {k: int(o.state_dict()["state"][0]["step"]) for k, o in
            single["state"].opts.items()} == {"top": 2, "mid": 2, "down": 2}

    again = train_app.main(argv + ["--epochs", "3", "--resume", "--mesh_shape", "2"])
    assert again["start_epoch"] == 3 and again["adam_steps"] == {"top": 3, "mid": 3, "down": 3}
    assert len(again["stats"]["F"]) == 3 and again["stats"]["F"][:2] == single["stats"]["F"]
    assert all(r["round_launches"] == [0] for r in again["ranks"])  # K1 runs only on a card
