"""Multi-device execution: data and Megatron tensor parallelism over ranks.

Port of ``deep_active_inference_mc_tpu/parallel/mesh.py``. JAX drives every
device from one controller and XLA inserts the collectives from sharding
annotations; here each rank is a process and the collectives are written
out (``parallel/comm.py``):

  - ``launch`` runs a function on every rank of a ``(data, model)`` grid:
    on one host it starts the ranks itself (``torch.multiprocessing``,
    spawn), across hosts each host starts its own and they meet at
    ``--coordinator`` (``initialize_multihost``); a process already inside
    a launched group (``torchrun``) runs as its rank.
  - The grid is ``make_mesh``'s ``reshape(-1, n_model)``: consecutive ranks
    form a tensor-parallel (model) group, data groups are strided.
  - Devices: one rank per card over NCCL when there are enough cards,
    else the ranks share the cards over gloo (NCCL refuses two ranks on
    one device); the CPU runs gloo.
  - Envs and every per-sample loss term shard over the data ranks; with
    ``n_model > 1`` the Dense chains split Megatron-style (``tp_spec``):
    even layers by column, odd layers by row, one all-reduce per pair,
    convs replicated. Adam's moments shard with their parameters.
  - ``shard_*`` / ``full_*`` move the agent, its optimizers and the envs
    between the full layout and a rank's shard, so a rank of a mesh run
    starts from the single-rank state, and a checkpoint holds full tensors.

Every rank draws the global batch's noise from the same seeded generator
and keeps its rows (``take_rows``), so a sharded round computes what the
single-rank round does, up to float reassociation.
"""

from __future__ import annotations

import dataclasses
import datetime
import os
import pickle
import socket
import traceback
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

from deep_active_inference_mc_torch.models.networks import Dense
from deep_active_inference_mc_torch.parallel import comm
from deep_active_inference_mc_torch.utils import compcache

# Every process group gives up after this long in one collective, so a rank
# whose peer died fails instead of waiting out a run's time limit.
DIST_TIMEOUT_S = 600


def _timeout() -> datetime.timedelta:
    return datetime.timedelta(seconds=DIST_TIMEOUT_S)


@dataclasses.dataclass
class Mesh:
    """This rank's place on the ``(data, model)`` grid, its device and its
    two process groups (``None`` for the world; a group of one is never
    reduced over)."""

    rank: int
    world: int
    n_model: int
    device: torch.device
    backend: str
    local_rank: int = 0
    data_group: Any = None
    model_group: Any = None

    @property
    def n_data(self) -> int:
        return self.world // self.n_model

    @property
    def data_rank(self) -> int:
        return self.rank // self.n_model

    @property
    def model_rank(self) -> int:
        return self.rank % self.n_model

    @property
    def is_primary(self) -> bool:
        return self.rank == 0

    def data_slice(self, batch: int) -> slice:
        """This data rank's rows of a global batch."""
        b = batch // self.n_data
        return slice(self.data_rank * b, (self.data_rank + 1) * b)

    def sum_data_(self, x: torch.Tensor) -> torch.Tensor:
        return comm.all_reduce_(x, self.data_group) if self.n_data > 1 else x

    def sum_model_(self, x: torch.Tensor) -> torch.Tensor:
        return comm.all_reduce_(x, self.model_group) if self.n_model > 1 else x

    def gather_data(self, x: torch.Tensor) -> torch.Tensor:
        """Every data rank's rows of ``x``, in rank order."""
        return comm.gather_rows(x, self.data_group) if self.n_data > 1 else x

    def gather_model(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        return comm.gather_dim(x, dim, self.model_group) if self.n_model > 1 else x

    def describe(self) -> str:
        if self.device.type == "cuda":
            n = torch.cuda.device_count()
            where = f"{n} card(s) per host" + (", shared by its ranks" if
                                               self.backend == "gloo" else "")
        else:
            where = "the CPU"
        return (f"mesh: {self.world} ranks = data {self.n_data} x model {self.n_model}, "
                f"backend {self.backend}, {where}")


# ------------------------------------------------------------- process setup
def initialize_multihost(coordinator: Optional[str] = None, num_hosts: int = 1,
                         host_id: Optional[int] = None, *, world: Optional[int] = None,
                         rank: Optional[int] = None, backend: str = "gloo") -> None:
    """Multi-host wiring: ``init_process_group`` at ``tcp://<coordinator>``
    (host 0's address). A no-op for ``num_hosts <= 1``; a missing
    coordinator or host id is refused before anything connects. ``world``
    and ``rank`` default to one rank per host."""
    if num_hosts <= 1:
        return
    if coordinator is None:
        raise ValueError("multi-host run needs --coordinator host:port")
    if host_id is None:
        raise ValueError("multi-host run needs --host_id (0 on the coordinator's host)")
    dist.init_process_group(backend, init_method=f"tcp://{coordinator}",
                            world_size=world or num_hosts,
                            rank=host_id if rank is None else rank, timeout=_timeout())


def is_primary() -> bool:
    """True on the rank that owns checkpoint, stats and figure writes
    (global rank 0); a run without a process group is primary."""
    return not dist.is_initialized() or dist.get_rank() == 0


def check_layout(n_devices: int, n_model: int = 1, batch: Optional[int] = None) -> None:
    """The divisibility rules of a ``(data, model)`` grid over a batch."""
    if n_model < 1 or n_devices % n_model:
        raise ValueError(f"{n_devices} devices not divisible by tp={n_model}")
    n_data = n_devices // n_model
    if batch is not None and batch % n_data:
        raise ValueError(f"batch {batch} not divisible by data-axis size {n_data}")


def make_mesh(n_model: int = 1, device: torch.device = torch.device("cpu"),
              backend: str = "gloo", local_rank: int = 0) -> Mesh:
    """This rank's Mesh over the initialized world: ranks laid out as
    ``arange(world).reshape(-1, n_model)``, rows are model groups and
    columns data groups. Every rank creates every group, in one order."""
    world, rank = dist.get_world_size(), dist.get_rank()
    check_layout(world, n_model)
    grid = np.arange(world).reshape(-1, n_model)
    mesh = Mesh(rank, world, n_model, device, backend, local_rank)
    if n_model > 1:
        for row in grid:
            g = dist.new_group(row.tolist(), timeout=_timeout())
            if rank in row:
                mesh.model_group = g
        for col in grid.T:
            g = dist.new_group(col.tolist(), timeout=_timeout())
            if rank in col:
                mesh.data_group = g
    return mesh


def _placement(device_type: str, local_rank: int, n_local: int):
    """(device, backend) of a host's ``local_rank`` out of ``n_local``.
    ``$DAIF_DIST_BACKEND`` overrides the backend: hosts that share a card
    (two host processes on one machine) need gloo, which no host can tell
    on its own."""
    if device_type != "cuda":
        return torch.device("cpu"), "gloo"
    n_cards = torch.cuda.device_count()
    if n_cards == 0:
        raise RuntimeError("device 'cuda' requested but torch.cuda.device_count() is 0; "
                           "pass --device cpu to run on the CPU")
    backend = os.environ.get("DAIF_DIST_BACKEND") or ("nccl" if n_cards >= n_local else "gloo")
    return torch.device("cuda", local_rank % n_cards), backend


@dataclasses.dataclass
class _Spec:
    init_method: str
    world: int
    first_rank: int  # of this host
    n_model: int
    device_type: str
    n_local: int  # ranks on this host
    coordinator: Optional[str] = None  # host 0's host:port, across hosts
    num_hosts: int = 1
    host_id: int = 0


def _run_rank(local_rank: int, fn: Callable, args: Sequence, spec: _Spec):
    device, backend = _placement(spec.device_type, local_rank, spec.n_local)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    rank = spec.first_rank + local_rank
    created = not dist.is_initialized()
    if created and spec.coordinator:
        initialize_multihost(spec.coordinator, spec.num_hosts, spec.host_id,
                             world=spec.world, rank=rank, backend=backend)
    elif created:
        dist.init_process_group(backend, init_method=spec.init_method,
                                world_size=spec.world, rank=rank, timeout=_timeout())
    try:
        mesh = make_mesh(spec.n_model, device, backend, local_rank)
        compcache.build_kernels(mesh)
        return fn(mesh, *args)
    finally:
        if created:
            dist.destroy_process_group()


def _spawned(local_rank: int, fn: Callable, args: Sequence, spec: _Spec, queue) -> None:
    torch.set_num_threads(1)
    try:
        out = to_host(_run_rank(local_rank, fn, args, spec))
    except BaseException:
        # The launcher re-raises the child's error; print it here too, so a
        # rank's traceback is never lost behind the launcher's summary.
        traceback.print_exc()
        raise
    # Pickled by value: a tensor put on a torch queue as-is travels as a
    # shared-memory handle, which dies with this process.
    queue.put((local_rank, pickle.dumps(out)))


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def in_launched_group() -> bool:
    """Inside a process group already, or started by ``torchrun``."""
    return dist.is_initialized() or ("RANK" in os.environ and "WORLD_SIZE" in os.environ
                                     and "MASTER_ADDR" in os.environ)


def launch(fn: Callable, args: Sequence = (), *, world: int, n_model: int = 1,
           device: str = "cuda", num_hosts: int = 1, host_id: Optional[int] = 0,
           coordinator: Optional[str] = None) -> List[Any]:
    """Run ``fn(mesh, *args)`` on ``world`` ranks; returns this host's
    results by local rank, moved to the host. A rank that raises makes this
    raise (the other local ranks are terminated), so a failing rank fails
    the run."""
    num_hosts = max(num_hosts, 1)
    if num_hosts > 1 and coordinator is None:
        raise ValueError("multi-host run needs --coordinator host:port")
    if num_hosts > 1 and host_id is None:
        raise ValueError("multi-host run needs --host_id (0 on the coordinator's host)")
    if world % num_hosts:
        raise ValueError(f"--mesh_shape {world} not divisible by --num_hosts {num_hosts}")
    host_id = host_id or 0
    check_layout(world, n_model)
    device_type = torch.device(device).type
    if in_launched_group():
        size = dist.get_world_size() if dist.is_initialized() else int(os.environ["WORLD_SIZE"])
        rank = dist.get_rank() if dist.is_initialized() else int(os.environ["RANK"])
        if size != world:
            raise ValueError(f"--mesh_shape {world} but the launched group has {size} ranks")
        local = int(os.environ.get("LOCAL_RANK", 0))
        spec = _Spec("env://", world, rank - local, n_model, device_type,
                     int(os.environ.get("LOCAL_WORLD_SIZE", 1)))
        return [_run_rank(local, fn, args, spec)]
    n_local = world // num_hosts
    if num_hosts > 1:
        spec = _Spec(f"tcp://{coordinator}", world, host_id * n_local, n_model, device_type,
                     n_local, coordinator, num_hosts, host_id)
    else:
        spec = _Spec(f"tcp://127.0.0.1:{_free_port()}", world, 0, n_model, device_type,
                     n_local)
    if n_local == 1:
        return [_run_rank(0, fn, args, spec)]
    ctx = torch.multiprocessing.get_context("spawn")
    queue = ctx.SimpleQueue()
    procs = torch.multiprocessing.start_processes(
        _spawned, args=(fn, tuple(args), spec, queue), nprocs=n_local, join=False,
        start_method="spawn")
    results: Dict[int, Any] = {}
    try:
        # Drain the queue while joining: a large result would otherwise
        # fill the pipe and block its rank's exit.
        while True:
            while not queue.empty():
                r, out = queue.get()
                results[r] = pickle.loads(out)
            if procs.join(timeout=0.5):
                break
    except KeyboardInterrupt:
        for p in procs.processes:
            if p.is_alive():
                p.terminate()
        raise
    while not queue.empty():
        r, out = queue.get()
        results[r] = pickle.loads(out)
    return [results.get(r) for r in range(n_local)]


def to_host(tree):
    """``tree`` with every tensor moved to the CPU (dicts, lists, tuples,
    dataclasses)."""
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu()
    if isinstance(tree, dict):
        return {k: to_host(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(to_host(v) for v in tree)
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return dataclasses.replace(tree, **{f.name: to_host(getattr(tree, f.name))
                                            for f in dataclasses.fields(tree)})
    return tree


# ------------------------------------------------------------------ sharding
def take_rows(tree, rows: slice, batch: int, inner: int = 1):
    """The rows ``rows`` of a ``batch``-row layout in every tensor of
    ``tree`` (dataclasses, lists, tuples, None). Each tensor's leading axis
    is laid out (outer, batch, inner): MC samples outermost, actions
    innermost, as the G estimators fold them."""
    if tree is None:
        return None
    if isinstance(tree, torch.Tensor):
        rest = tuple(tree.shape[1:])
        return tree.reshape((-1, batch, inner) + rest)[:, rows].reshape((-1,) + rest)
    if dataclasses.is_dataclass(tree):
        return dataclasses.replace(tree, **{
            f.name: take_rows(getattr(tree, f.name), rows, batch, inner)
            for f in dataclasses.fields(tree)})
    if isinstance(tree, (list, tuple)):
        return type(tree)(take_rows(x, rows, batch, inner) for x in tree)
    return tree


def tp_spec(name: str, shape: Sequence[int], n_model: int) -> Optional[int]:
    """The dimension that tensor parallelism over ``n_model`` ranks splits
    in parameter ``name`` (torch layout: Linear weight (out, in)), or None
    when it stays replicated. ``_tp_spec``'s rules: the ``i``-th Dense of a
    chain is column-parallel for even ``i`` (weight rows and bias split)
    and row-parallel for odd ``i`` (weight columns split, bias replicated);
    nothing is split below ``8 * n_model``; convs stay replicated."""
    parts = name.split(".")
    if n_model <= 1 or len(parts) < 3 or parts[-3] != "fc":
        return None
    col = int(parts[-2]) % 2 == 0
    min_dim = 8 * n_model
    if parts[-1] == "weight":
        out_d, in_d = shape
        if col and out_d % n_model == 0 and out_d >= min_dim:
            return 0
        if not col and in_d % n_model == 0 and in_d >= min_dim:
            return 1
        return None
    if col and shape[0] % n_model == 0 and shape[0] >= min_dim:
        return 0
    return None


def _shard(t: torch.Tensor, dim: int, mesh: Mesh, n: int) -> torch.Tensor:
    return t.narrow(dim, mesh.model_rank * n, n).clone()


def shard_agent_(agent: nn.Module, mesh: Mesh) -> nn.Module:
    """In place: every Dense that ``tp_spec`` splits keeps this rank's
    shard, a new Parameter tagged with its split dim (``tp_dim``). Run it
    before the optimizers are made."""
    if mesh.n_model <= 1:
        return agent
    for name, layer in agent.named_modules():
        if not isinstance(layer, Dense):
            continue
        dim = tp_spec(name + ".weight", layer.weight.shape, mesh.n_model)
        if dim is None:
            continue
        n = layer.weight.shape[dim] // mesh.n_model
        layer.weight = nn.Parameter(_shard(layer.weight.data, dim, mesh, n))
        layer.weight.tp_dim = dim
        if dim == 0:
            layer.bias = nn.Parameter(_shard(layer.bias.data, 0, mesh, n))
            layer.bias.tp_dim = 0
            layer.out_features = n
        else:
            layer.in_features = n
        layer.split = "col" if dim == 0 else "row"
        layer.group, layer.shard = mesh.model_group, (mesh.model_rank, mesh.n_model)
    # A column shard feeds the row shard after it; any other layout would
    # need a gather this port does not do.
    for name, chain in agent.named_modules():
        fc = getattr(chain, "fc", None)
        if isinstance(fc, nn.ModuleList):
            for i, layer in enumerate(fc):
                nxt = fc[i + 1] if i + 1 < len(fc) else None
                if (layer.split == "col") != (nxt is not None and nxt.split == "row"):
                    raise ValueError(f"{name}.fc.{i}: tensor-parallel layout needs a "
                                     "column-parallel layer before each row-parallel one")
    return agent


def _tp_dims(params: Sequence[torch.Tensor]) -> List[Optional[int]]:
    return [getattr(p, "tp_dim", None) for p in params]


def full_state_dict(agent: nn.Module, mesh: Optional[Mesh]) -> Dict[str, torch.Tensor]:
    """The unsharded ``state_dict`` (a collective over each model group)."""
    sd = agent.state_dict()
    if mesh is None or mesh.n_model <= 1:
        return sd
    for name, p in agent.named_parameters():
        dim = getattr(p, "tp_dim", None)
        if dim is not None:
            sd[name] = mesh.gather_model(p.detach(), dim)
    return sd


def shard_state_dict(full: Dict[str, torch.Tensor], agent: nn.Module,
                     mesh: Mesh) -> Dict[str, torch.Tensor]:
    """This rank's shard of a full ``state_dict`` for the sharded ``agent``."""
    sd = dict(full)
    for name, p in agent.named_parameters():
        dim = getattr(p, "tp_dim", None)
        if dim is not None:
            sd[name] = _shard(full[name], dim, mesh, p.shape[dim])
    return sd


_MOMENTS = ("exp_avg", "exp_avg_sq")


def _map_moments(sd: dict, params, fn) -> dict:
    """A copy of an Adam ``state_dict`` with ``fn(moment, param, dim)``
    applied to the moments of every split parameter."""
    state = {}
    for i, st in sd["state"].items():
        dim = getattr(params[i], "tp_dim", None)
        st = dict(st)
        if dim is not None:
            for k in _MOMENTS:
                if k in st:
                    st[k] = fn(st[k], params[i], dim)
        state[i] = st
    return {"state": state, "param_groups": sd["param_groups"]}


def _opt_params(opt: torch.optim.Optimizer) -> List[torch.Tensor]:
    return [p for group in opt.param_groups for p in group["params"]]


def full_opt_state(opt: torch.optim.Optimizer, mesh: Optional[Mesh]) -> dict:
    """An Adam ``state_dict`` with the moments of split parameters gathered
    (a collective over each model group)."""
    sd = opt.state_dict()
    if mesh is None or mesh.n_model <= 1:
        return sd
    return _map_moments(sd, _opt_params(opt), lambda m, p, d: mesh.gather_model(m, d))


def shard_opt_state(full: dict, opt: torch.optim.Optimizer, mesh: Mesh) -> dict:
    """This rank's shard of a full Adam ``state_dict`` for ``opt``, which
    steps the sharded parameters."""
    return _map_moments(full, _opt_params(opt),
                        lambda m, p, d: _shard(m, d, mesh, p.shape[d]))


def shard_train_state(state, mesh: Mesh, cfg):
    """A single-rank TrainState (full agent and optimizers, the global
    envs) made this rank's: the agent sharded in place, optimizers over
    the shards with their moments sliced, the data rank's envs."""
    from deep_active_inference_mc_torch.train import loop as train_loop

    full_opts = {k: o.state_dict() for k, o in state.opts.items()}
    shard_agent_(state.agent, mesh)
    opts = train_loop.make_optimizers(cfg, state.agent)
    for k, opt in opts.items():
        opt.load_state_dict(shard_opt_state(full_opts[k], opt, mesh))
    env = state.env.select(mesh.data_slice(state.env.batch))
    return dataclasses.replace(state, opts=opts, env=env)


def full_env(env, mesh: Optional[Mesh]):
    """The global envs, every data rank's rows in order (a collective)."""
    if mesh is None:
        return env
    return type(env)(*(mesh.gather_data(getattr(env, f)) for f in ("latents", "score",
                                                                    "last_r")))


def sync_generator_(generator: torch.Generator, mesh: Optional[Mesh]) -> None:
    """Every rank's ``generator`` continues rank 0's stream: after work
    that only the primary did (eval, sweeps), the streams agree again."""
    if mesh is None:
        return
    state = generator.get_state().to(mesh.device)
    comm.broadcast_(state)
    generator.set_state(state.cpu())


def global_norm(grads: Sequence[torch.Tensor], params: Sequence[torch.Tensor],
                mesh: Mesh) -> torch.Tensor:
    """sqrt of the sum of squares of the full gradient: split parameters'
    squares summed over the model group, replicated ones counted once."""
    dims = _tp_dims(params)
    rep = [g for g, d in zip(grads, dims) if d is None]
    split = [g for g, d in zip(grads, dims) if d is not None]
    norm = torch.linalg.vector_norm(torch.stack([torch.linalg.vector_norm(g) for g in rep]))
    if not split:
        return norm
    sq = torch.stack([torch.linalg.vector_norm(g) for g in split]).square().sum()
    return torch.sqrt(norm.square() + mesh.sum_model_(sq))


def mean_grads(grads: Sequence[torch.Tensor], mesh: Mesh) -> List[torch.Tensor]:
    """Gradients averaged over the data group: one all-reduce of one flat
    buffer."""
    if mesh.n_data <= 1:
        return list(grads)
    flat = torch.cat([g.reshape(-1) for g in grads])
    mesh.sum_data_(flat).div_(mesh.n_data)
    return [x.view_as(g) for x, g in zip(flat.split([g.numel() for g in grads]), grads)]
