"""PyTorch port: the trainer CLI (``apps/train.py``) end to end on the CPU
at a tiny size, its multi-device and bf16 flags (gloo between ranks on the
CPU), its guards, and its Config parsing against the JAX package's."""

import dataclasses
import json
import os
import pickle
import signal
import socket
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from deep_active_inference_mc_tpu import config as jconfig
from deep_active_inference_mc_torch.apps import train as train_app
from deep_active_inference_mc_torch.config import Config
from deep_active_inference_mc_torch.utils import stats as stats_lib
from test_torch_models import few_torch_threads  # noqa: F401 (autouse fixture)

ROOT = Path(__file__).resolve().parent.parent
# No figures (tests/test_torch_viz.py draws them): matplotlib's ~18 s per
# epoch on the CPU would dominate these runs.
TINY = ["--device", "cpu", "--batch", "8", "--rounds", "3", "--test_size", "16",
        "--sweep_envs", "8", "--sweep_steps", "2", "--viz_every", "1000"]


def steps_of(state):
    return {k: int(o.state_dict()["state"][0]["step"]) for k, o in state.opts.items()}


def test_train_two_epochs_then_resume(tmp_path, capsys):
    argv = TINY + ["--out_root", str(tmp_path)]
    out = train_app.main(argv + ["--epochs", "2"])
    lines = [ln for ln in capsys.readouterr().out.splitlines() if ", F: " in ln]
    assert [ln.split(",")[0] for ln in lines] == ["1", "2"]
    for part in ("MSEo: ", "(clean ", "KLs: ", "omega: ", "KLpi: ", "TC: ", "score: ",
                 "edge: h ", "gn: ", "env_steps/s: ", "dur. "):
        assert part in lines[-1], part
    assert out["start_epoch"] == 1 and steps_of(out["state"]) == {"top": 6, "mid": 6, "down": 6}
    stats = out["stats"]
    assert set(stats) == set(stats_lib.STATS_KEYS)
    assert all(len(v) == 2 for v in stats.values())
    for k, v in stats.items():
        assert np.all(np.isfinite(np.asarray(v, dtype=np.float64))), k
    assert stats["kl_div_s_anal"][0].shape == (10,)

    folder = out["folder"]
    assert folder.parent == tmp_path and folder.name.startswith("figs_final_model_")
    assert json.loads((folder / "config.json").read_text())["batch"] == 8
    chp = folder / "checkpoints"
    # save_every=2: the checkpoint holds the weights after epoch 2 beside
    # both epochs' stats.
    saved = pickle.loads((chp / "stats.pkl").read_bytes())
    assert len(saved["F"]) == 2
    assert (chp / "state" / "state.pt").exists() and (chp / "train.py").exists()
    assert not list(folder.glob("checkpoints_epoch_*"))  # archive_every=25

    out2 = train_app.main(argv + ["--resume", "--epochs", "3", "--archive_every", "3",
                                  "--save_every", "1"])
    text = capsys.readouterr().out
    assert "Resumed from" in text and "at epoch 3" in text
    assert [ln.split(",")[0] for ln in text.splitlines() if ", F: " in ln] == ["3"]
    assert out2["start_epoch"] == 3
    # The Adam step counts continue: 2 epochs restored + 1 trained.
    assert steps_of(out2["state"]) == {"top": 9, "mid": 9, "down": 9}
    assert len(out2["stats"]["F"]) == 3 and out2["stats"]["F"][:2] == stats["F"]
    arch = torch.load(folder / "checkpoints_epoch_3" / "state" / "state.pt", weights_only=True)
    assert "opt_states" not in arch and "agent" in arch
    # Nothing left to do: a clean exit that trains nothing.
    out3 = train_app.main(argv + ["--resume", "--epochs", "3"])
    assert out3["start_epoch"] == 4 and out3["env_steps_per_s"] == []


def test_resume_without_checkpoint_starts_fresh_and_epochs_0_exits_cleanly(tmp_path, capsys):
    out = train_app.main(TINY + ["--resume", "--epochs", "0", "--out_root", str(tmp_path)])
    assert out["start_epoch"] == 1 and out["stats"]["F"] == []
    assert "Resumed" not in capsys.readouterr().out
    assert (out["folder"] / "config.json").exists()


def test_typoed_flag_errors(tmp_path):
    with pytest.raises(SystemExit) as exc:
        train_app.main(TINY + ["--epocs", "2", "--out_root", str(tmp_path)])
    assert exc.value.code == 2


# One round per epoch: the mesh cases start their ranks as fresh processes.
ONE_ROUND = ["--rounds", "1", "--sweep_steps", "1", "--test_size", "8", "--epochs", "1"]


def free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_two_hosts(argv, tmp_path):
    """The trainer as two hosts of one rank each, meeting at a coordinator
    on this machine; returns each host's output."""
    coord = f"127.0.0.1:{free_port()}"
    env = dict(os.environ, OMP_NUM_THREADS="2")
    procs = [subprocess.Popen(
        [sys.executable, "-m", "deep_active_inference_mc_torch.apps.train", *argv,
         "--coordinator", coord, "--num_hosts", "2", "--host_id", str(h)],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for h in (0, 1)]
    try:
        outs = [p.communicate(timeout=300)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out
    return outs


@pytest.mark.parametrize("flags, ranks", [
    (["--mesh_shape", "2"], 2),
    (["--mesh_shape", "4", "--tp", "2"], 4),
    (["--coordinator"], 2),
    (["--bf16"], 1),
], ids=["mesh_shape-2", "mesh_shape-4-tp-2", "coordinator-2-hosts", "bf16"])
def test_multi_device_and_bf16_flags_run(tmp_path, capfd, flags, ranks):
    """Each flag set trains one epoch: one epoch line (the primary's), a
    checkpoint of the unsharded weights, finite stats."""
    argv = TINY + ONE_ROUND + ["--save_every", "1", "--out_root", str(tmp_path)]
    if flags == ["--coordinator"]:
        outs = run_two_hosts(argv, tmp_path)
        lines = [[ln for ln in out.splitlines() if ", F: " in ln] for out in outs]
        assert len(lines[0]) == 1 and lines[1] == [], outs
        assert "mesh: 2 ranks = data 2 x model 1, backend gloo" in outs[0]
        chp = next(tmp_path.glob("figs_*")) / "checkpoints"
        stats = pickle.loads((chp / "stats.pkl").read_bytes())
    else:
        out = train_app.main(argv + flags)
        # capfd: the ranks are processes of their own.
        lines = [ln for ln in capfd.readouterr().out.splitlines() if ", F: " in ln]
        assert [ln.split(",")[0] for ln in lines] == ["1"]
        assert len(out.get("ranks", [out])) == ranks
        chp, stats = out["folder"] / "checkpoints", out["stats"]
    assert all(np.isfinite(np.asarray(v, np.float64)).all() for v in stats.values())
    saved = torch.load(chp / "state" / "state.pt", weights_only=True)
    assert saved["agent"]["down.decoder.fc.3.weight"].shape == (16 * 16 * 64, 256)
    assert json.loads((chp.parent / "config.json").read_text())["bf16"] == ("--bf16" in flags)


@pytest.mark.parametrize("flags, match", [
    (["--num_hosts", "2", "--host_id", "0"], "--coordinator"),
    (["--mesh_shape", "4", "--batch", "6"], "batch 6 not divisible by data-axis size 4"),
    (["--mesh_shape", "4", "--tp", "3"], "not divisible by tp=3"),
], ids=["no-coordinator", "batch", "tp"])
def test_mesh_flag_guards(tmp_path, flags, match):
    """The JAX trainer's guards, before anything starts or is written."""
    with pytest.raises(ValueError, match=match):
        train_app.main(TINY + flags + ["--epochs", "1", "--out_root", str(tmp_path)])
    assert not list(tmp_path.iterdir())


def test_default_device_is_cuda_and_raises_without_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="cuda"):
        train_app.main(["--batch", "8", "--epochs", "0", "--out_root", str(tmp_path)])


def test_config_from_args_and_save_load_match_jax(tmp_path):
    argv = ["--mesh_shape", "4", "--bf16", "--sweep_envs", "16", "--sweep_steps", "3",
            "--viz_every", "2", "--l_rate_down", "0.01", "--prefix", "x_", "--crn"]
    tcfg, jcfg = Config.from_args(argv, batch=7), jconfig.Config.from_args(argv, batch=7)
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    assert tcfg.mesh_shape == 4 and tcfg.bf16 is True and tcfg.crn is True and tcfg.batch == 7
    assert (tcfg.folder, tcfg.folder_chp) == (jcfg.folder, jcfg.folder_chp)
    tcfg.save(tmp_path / "config.json")
    assert Config.load(tmp_path / "config.json") == tcfg
    assert jconfig.Config.load(tmp_path / "config.json") == jcfg
    with pytest.raises(SystemExit):
        Config.from_args(["--no_such_field", "1"])


def test_sigterm_saves_a_resumable_checkpoint_and_exits_130(tmp_path):
    """A supervisor's SIGTERM mid-run: exit code 130 and a checkpoint that
    ``--resume`` picks up."""
    env = dict(os.environ, OMP_NUM_THREADS="2")
    argv = [sys.executable, "-m", "deep_active_inference_mc_torch.apps.train", *TINY,
            "--rounds", "2", "--epochs", "100000", "--save_every", "100000",
            "--out_root", str(tmp_path)]
    proc = subprocess.Popen(argv, cwd=ROOT, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    try:
        deadline = time.time() + 120
        for line in proc.stdout:  # wait for the first epoch line
            if ", F: " in line or time.time() > deadline:
                break
        proc.send_signal(signal.SIGTERM)
        rest = proc.stdout.read()
        assert proc.wait(timeout=60) == 130, rest
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    assert "Interrupted: saving checkpoint for --resume" in rest
    chp = next(tmp_path.glob("figs_*")) / "checkpoints"
    n = len(pickle.loads((chp / "stats.pkl").read_bytes())["F"])
    assert n >= 1 and (chp / "state" / "state.pt").exists()
    out = train_app.main(TINY + ["--resume", "--epochs", "0", "--out_root", str(tmp_path)])
    assert out["start_epoch"] == n + 1
