"""Checkpoint / resume, torch-native.

Port of ``deep_active_inference_mc_tpu/utils/checkpoint.py`` with
``torch.save`` in Orbax's place. It reads this package's checkpoints, and a
JAX checkpoint dir that holds ``torch_export.npz`` (the JAX train state
exported by the README's recipe, read by ``convert.load_export``): the port
cannot read Orbax, and a JAX dir without the export is refused.

  - a full save holds the agent's ``state_dict``, the three optimizers'
    ``state_dict``s, the precision scalars, the env state and the training
    generator's state (``<folder>/state/state.pt``), beside the pickled
    stats dict (``stats.pkl``) and a source snapshot of the model/loss
    modules and the trainer script;
  - the write is crash-safe: the new state is fully written to
    ``state.tmp`` before the old ``state`` is touched, then swapped in via
    renames; a kill at any point leaves a complete ``state`` or
    ``state.old`` on disk;
  - ``archive`` makes an immutable weight-only copy (no optimizer state);
  - ``load_all`` restores everything including the optimizer state, loads
    a weight-only archive onto a template, and refuses a checkpoint whose
    agent weights do not cover the template's. A JAX dir's export is a
    weight-only archive (the Orbax store holds no optimizer state): its
    weights, precision and envs are loaded, the optimizers and the
    generator stay as they are;
  - under a mesh (``parallel/mesh.py``) a save gathers the full weights,
    Adam moments and envs from every rank (a collective: every rank calls
    it) and only the primary rank writes, as the JAX trainer gates its
    writes. A checkpoint is always the single-rank layout: a mesh run
    loads it into the full state and shards it after
    (``mesh.shard_train_state``), so mesh and single-rank runs resume each
    other's.
"""

from __future__ import annotations

import pickle
import shutil
import threading
from pathlib import Path
from typing import Any, Dict, Optional, Tuple

import torch

from deep_active_inference_mc_torch.envs import dsprites as env_lib
from deep_active_inference_mc_torch.infer.precision import PrecisionState
from deep_active_inference_mc_torch.parallel import mesh as mesh_lib
from deep_active_inference_mc_torch.train.loop import TrainState, load_optimizer_state
from deep_active_inference_mc_torch.utils import convert, profiling

_SNAPSHOT_SOURCES = ["models/networks.py", "train/losses.py", "train/loop.py"]
_STATE_FILE = "state.pt"
EXPORT_FILE = "torch_export.npz"


def _to_host(tree):
    """A copy of ``tree`` with every tensor cloned to the CPU: the live
    weights and optimizer moments are updated in place by the next round."""
    if isinstance(tree, torch.Tensor):
        return tree.detach().to("cpu", copy=True)
    if isinstance(tree, dict):
        return {k: _to_host(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_host(v) for v in tree)
    return tree


def _payload(state: TrainState, generator: torch.Generator,
             mesh: Optional[mesh_lib.Mesh] = None) -> Dict[str, Any]:
    """The host-side checkpoint payload of a train state, unsharded."""
    env = mesh_lib.full_env(state.env, mesh)
    return _to_host({
        "agent": mesh_lib.full_state_dict(state.agent, mesh),
        "opt_states": {k: mesh_lib.full_opt_state(opt, mesh) for k, opt in state.opts.items()},
        "precision": {f: getattr(state.precision, f) for f in ("gamma", "beta_s", "beta_o")},
        "env": {f: getattr(env, f) for f in ("latents", "score", "last_r")},
        "rng_state": generator.get_state(),
        "rng_device": generator.device.type,
    })


def _write_payload(folder_chp: Path, payload: Dict, stats: Dict, script_file: str) -> None:
    """Disk half of a checkpoint save (host tensors already materialized)."""
    folder_chp.mkdir(parents=True, exist_ok=True)
    ckpt_dir = folder_chp / "state"
    tmp_dir = folder_chp / "state.tmp"
    old_dir = folder_chp / "state.old"
    for d in (tmp_dir, old_dir):
        if d.exists():
            shutil.rmtree(d)
    tmp_dir.mkdir()
    torch.save(payload, tmp_dir / _STATE_FILE)
    if ckpt_dir.exists():
        ckpt_dir.rename(old_dir)
    tmp_dir.rename(ckpt_dir)
    if old_dir.exists():
        shutil.rmtree(old_dir)

    stats_tmp = folder_chp / "stats.pkl.tmp"
    with open(stats_tmp, "wb") as f:
        pickle.dump(stats, f)
    stats_tmp.replace(folder_chp / "stats.pkl")

    pkg_root = Path(__file__).resolve().parent.parent
    for rel in _SNAPSHOT_SOURCES:
        src = pkg_root / rel
        if src.exists():
            shutil.copyfile(src, folder_chp / src.name)
    if script_file and Path(script_file).exists():
        shutil.copyfile(script_file, folder_chp / Path(script_file).name)


def save_all(folder_chp: Path, state: TrainState, stats: Dict,
             generator: torch.Generator, script_file: str = "",
             mesh: Optional[mesh_lib.Mesh] = None) -> None:
    """Full checkpoint: state + stats.pkl + source snapshot (written by
    the primary rank only)."""
    payload = _payload(state, generator, mesh)
    if mesh_lib.is_primary():
        _write_payload(Path(folder_chp).resolve(), payload, stats, script_file)


class AsyncSaver:
    """Checkpoint saver with an asynchronous disk write.

    The device->host copy happens synchronously in ``save`` (the next round
    updates the weights and moments in place); the disk write runs on a
    background thread. At most one write is in flight; ``wait()`` before
    reading the checkpoint dir (archive/resume) or exiting."""

    def __init__(self) -> None:
        self._thread: Optional[threading.Thread] = None
        self._exc: Optional[BaseException] = None

    def _run(self, *args) -> None:
        try:
            _write_payload(*args)
        except BaseException as e:  # re-raised by the next wait()/save()
            self._exc = e

    def save(self, folder_chp: Path, state: TrainState, stats: Dict,
             generator: torch.Generator, script_file: str = "",
             mesh: Optional[mesh_lib.Mesh] = None) -> None:
        """Every rank of a mesh calls this (the gather is a collective);
        only the primary rank writes."""
        self.wait()
        payload = _payload(state, generator, mesh)
        if not mesh_lib.is_primary():
            return
        # Snapshot the append-only stats lists: the main thread keeps
        # appending while the writer pickles.
        stats_copy = {k: list(v) for k, v in stats.items()}
        self._thread = threading.Thread(
            target=self._run,
            args=(Path(folder_chp).resolve(), payload, stats_copy, script_file),
            daemon=True,
        )
        self._thread.start()

    def wait(self) -> None:
        """Join the in-flight write; re-raise any writer-thread failure (a
        silently failing saver would let hours of training go unsaved)."""
        if self._thread is not None:
            self._thread.join()
        self._thread = None
        if self._exc is not None:
            exc, self._exc = self._exc, None
            raise exc


def _resolve_state_dir(folder_chp: Path) -> Path:
    """The live state dir, falling back to ``state.old`` if a crash landed
    between the two swap renames in ``_write_payload`` (both are complete
    checkpoints; ``state.old`` is simply one save older)."""
    state = Path(folder_chp) / "state"
    if state.exists():
        return state
    old = Path(folder_chp) / "state.old"
    if old.exists():
        return old
    return state


def _source(folder_chp: Path) -> Path:
    """The file a checkpoint dir is read from: a port checkpoint's
    ``state.pt``, else a JAX checkpoint's ``torch_export.npz`` (a port save
    into such a dir takes precedence over the export). The returned path
    need not exist; a JAX dir without its export raises."""
    folder_chp = Path(folder_chp)
    state_dir = _resolve_state_dir(folder_chp)
    export = folder_chp / EXPORT_FILE
    orbax = (state_dir / "_METADATA").exists()
    if (state_dir / _STATE_FILE).exists() or not (orbax or export.exists()):
        return state_dir / _STATE_FILE
    if not export.exists():
        raise FileNotFoundError(
            f"{folder_chp} is a JAX (Orbax) checkpoint without {EXPORT_FILE}: the port cannot "
            f"read Orbax. Write {export} with the JAX package by the README's recipe "
            f"(\"Weights\").")
    return export


def _read(folder_chp: Path) -> Tuple[Path, Dict[str, Any]]:
    """(source, payload) of a checkpoint dir; a JAX export reads as a
    weight-only payload (no optimizer or generator state)."""
    src = _source(Path(folder_chp).resolve())
    if src.name == EXPORT_FILE:
        return src, convert.load_export(src)
    # Read onto the CPU: loading moves weights and moments to their params'
    # device, and Adam's step counters to where a fresh optimizer keeps
    # them (the card's for a capturable Adam, else the CPU).
    return src, torch.load(src, map_location="cpu", weights_only=True)


@profiling.spanned("checkpoint.load")
def load_all(folder_chp: Path, state: TrainState, generator: torch.Generator
             ) -> Tuple[TrainState, Dict]:
    """Restore a checkpoint into ``state`` (a freshly created TrainState:
    its agent and optimizers are loaded in place) and ``generator``, and
    return (state, stats).

    A weight-only archive (``archive`` drops the optimizer state, and a JAX
    dir's export has none) leaves the optimizers and ``generator`` as they
    are, so sweeps and probes can evaluate archived epochs directly and a
    run resumed from one starts with fresh Adams. Its envs are loaded when
    they are as many as the template's, else the template's stay (a run at
    another batch). A full checkpoint continues the saved run's random
    stream, and is refused when ``generator`` is of another device type
    than the one that saved it. A checkpoint that lacks any of the agent's
    weights is refused: falling back to the template's values would
    silently evaluate a random-init subtree."""
    folder_chp = Path(folder_chp).resolve()
    src, payload = _read(folder_chp)
    device = state.env.device

    missing = sorted(set(state.agent.state_dict()) - set(payload["agent"]))
    if missing:
        raise ValueError(
            f"checkpoint at {src} does not cover the agent's params: missing "
            f"{missing[:5]} (+{max(0, len(missing) - 5)} more)")
    resumable = "opt_states" in payload
    if resumable and payload["rng_device"] != generator.device.type:
        raise ValueError(
            f"checkpoint at {src} was saved by a run on {payload['rng_device']}: its "
            f"random stream cannot continue on {generator.device.type}")
    state.agent.load_state_dict(payload["agent"])
    for k, sd in payload.get("opt_states", {}).items():
        load_optimizer_state(state.opts[k], sd)
    state.precision = PrecisionState(**{k: v.to(device) for k, v in payload["precision"].items()})
    env = env_lib.EnvState(**{k: v.to(device) for k, v in payload["env"].items()})
    if resumable or env.batch == state.env.batch:
        state.env = env
    if resumable:  # a weight-only archive leaves the caller's stream as it is
        generator.set_state(payload["rng_state"])
    with open(folder_chp / "stats.pkl", "rb") as f:
        stats = pickle.load(f)
    return state, stats


@profiling.spanned("checkpoint.load")
def load_weights(folder_chp: Path, module: torch.nn.Module) -> torch.nn.Module:
    """Load only the model weights of a checkpoint (full, archive or a JAX
    dir's export) into ``module``: what a sweep or the demo needs, on any
    device."""
    module.load_state_dict(_read(folder_chp)[1]["agent"])
    return module


def archive(folder_chp: Path, epoch: int) -> None:
    """Immutable weight-only archive ``<folder>_epoch_<n>``: a copy of the
    checkpoint dir whose state has no optimizer state."""
    folder_chp = Path(folder_chp).resolve()
    dst = folder_chp.parent / f"{folder_chp.name}_epoch_{epoch}"
    if dst.exists():
        shutil.rmtree(dst)
    shutil.copytree(folder_chp, dst,
                    ignore=shutil.ignore_patterns("state", "state.tmp", "state.old"))
    # Read the resolved live state dir: if a crash left the checkpoint in
    # its recovery window (only state.old present), the archive still gets
    # a state.
    src_state = _resolve_state_dir(folder_chp) / _STATE_FILE
    if src_state.exists():
        payload = torch.load(src_state, map_location="cpu", weights_only=True)
        payload.pop("opt_states", None)
        (dst / "state").mkdir()
        torch.save(payload, dst / "state" / _STATE_FILE)


def latest_exists(folder_chp: Path) -> bool:
    """Whether ``folder_chp`` holds a checkpoint to resume (a JAX dir
    without its export raises rather than answering no: a resume must not
    start from a seeded init)."""
    return _source(folder_chp).exists() and (Path(folder_chp) / "stats.pkl").exists()
