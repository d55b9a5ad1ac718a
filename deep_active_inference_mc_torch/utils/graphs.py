"""CUDA graphs of the port's hot loops: the counterpart of ``jax.jit`` over a
``lax.scan``.

The JAX package compiles each hot loop (the training epoch, a sweep chunk,
the bench's env-step and G runs) into one device program. Here the loop's
body is captured once as a CUDA graph and replayed once per step:

  - ``scan(body, carry, xs, n)`` runs ``carry, y = body(carry, x)`` for the
    ``n`` inputs of ``xs``, which the caller draws eagerly, step by step,
    from its ``torch.Generator`` in the order the eager loop draws them. No
    generator is registered with a graph, so a graphed loop gives the
    numbers of the same body run eagerly (``eager_scan``).
  - The graph's inputs are static buffers: the carry's tensors and one
    step's draws. The captured body ends by writing its new carry into the
    carry's buffers and its ``y`` into row ``t`` of a static ``(n, ...)``
    table, so N replays are the scan.
  - The first step of a capture runs eagerly on a side stream, on the
    static buffers: it is a real step, and it settles everything a first
    call sets up (K1's build and its carveout, the optimizers' state,
    cuBLAS's workspace) outside the capture.
  - ``Graphs`` keeps one graph per (shapes, dtypes, step count, backend
    flags) as jit keeps one program per trace. A graph also depends on the
    addresses of what its body reads or updates in place besides the carry
    (``deps``: weights, optimizer state, the LUT): new addresses capture
    anew.

Kernel launch counts (``ops.cuda.LAUNCHES``) stay what the eager loop
counts: a wrapper counts once while its launch is captured, and the count
is taken back and added on every replay instead.

``Graphs.scan`` raises on CPU tensors: on the CPU the callers run the same
body through ``eager_scan``. A capture or a replay that fails raises.
"""

from __future__ import annotations

import collections
import dataclasses
from typing import Any, Callable, Dict, Iterable, List, Optional, Sequence, Tuple

import torch

from deep_active_inference_mc_torch.ops.cuda import LAUNCHES

Body = Callable[[Any, Any], Tuple[Any, Optional[torch.Tensor]]]


# ---------------------------------------------------------------- trees
# A tree is a tensor, None, a plain scalar, or a dataclass, list or tuple
# of trees: the draws and states of the port.

def _flatten(tree, leaves: List[torch.Tensor]):
    """Append ``tree``'s tensors to ``leaves``; return its spec (types,
    static values, and each tensor's shape, dtype and device)."""
    if isinstance(tree, torch.Tensor):
        leaves.append(tree)
        return (tuple(tree.shape), tree.dtype, tree.device)
    if tree is None or isinstance(tree, (bool, int, float, str)):
        return tree
    if dataclasses.is_dataclass(tree):
        return (type(tree),) + tuple(_flatten(getattr(tree, f.name), leaves)
                                     for f in dataclasses.fields(tree))
    if isinstance(tree, (list, tuple)):
        return (type(tree),) + tuple(_flatten(v, leaves) for v in tree)
    raise TypeError(f"not a tree of tensors: {type(tree).__name__}")


def leaves_of(tree) -> List[torch.Tensor]:
    leaves: List[torch.Tensor] = []
    _flatten(tree, leaves)
    return leaves


def rebuild(tree, leaves: Iterable[torch.Tensor]):
    """``tree`` with its tensors replaced, in order, by ``leaves``."""
    it = iter(leaves)

    def go(node):
        if isinstance(node, torch.Tensor):
            return next(it)
        if dataclasses.is_dataclass(node):
            return dataclasses.replace(node, **{f.name: go(getattr(node, f.name))
                                                for f in dataclasses.fields(node)})
        if isinstance(node, (list, tuple)):
            return type(node)(go(v) for v in node)
        return node

    return go(tree)


def _copy_(dst: Sequence[torch.Tensor], src: Sequence[torch.Tensor]) -> None:
    """``dst[i].copy_(src[i])``, one multi-tensor copy per dtype."""
    groups: Dict[torch.dtype, Tuple[list, list]] = collections.defaultdict(lambda: ([], []))
    for d, s in zip(dst, src, strict=True):
        groups[d.dtype][0].append(d)
        groups[d.dtype][1].append(s)
    for d, s in groups.values():
        torch._foreach_copy_(d, s)


def _backend_flags() -> tuple:
    """The settings that choose kernels at capture time."""
    return (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32,
            torch.backends.cudnn.benchmark, torch.backends.cudnn.deterministic,
            torch.get_float32_matmul_precision(), torch.are_deterministic_algorithms_enabled(),
            torch.is_grad_enabled(), torch.is_inference_mode_enabled())


# ---------------------------------------------------------------- scans

def eager_scan(body: Body, carry, xs: Iterable, n: int):
    """``n`` steps of ``body`` op by op, on any device: (carry, the stacked
    ``y``s, or None when the body gives none)."""
    xs = iter(xs)
    ys = []
    for _ in range(n):
        carry, y = body(carry, next(xs))
        ys.append(y)
    return carry, (torch.stack(ys) if ys and ys[0] is not None else None)


@dataclasses.dataclass
class _Graph:
    graph: torch.cuda.CUDAGraph
    deps: tuple  # the addresses the body was captured on
    carry: List[torch.Tensor]  # static carry buffers
    x_spec: Any
    x: List[torch.Tensor]  # static input buffers
    ys: Optional[torch.Tensor]  # the static (n, ...) table of the ys
    t: torch.Tensor  # the table's next row, on the device
    launches: collections.Counter  # kernel launches per replay


class Graphs:
    """Captured scan bodies, one graph per signature (see the module's
    docstring). ``captures`` and ``replays`` count what it did."""

    def __init__(self):
        self._graphs: Dict[Any, _Graph] = {}
        self.captures = 0
        self.replays = 0

    def scan(self, body: Body, carry, xs: Iterable, n: int,
             deps: Callable[[], Sequence[torch.Tensor]] = tuple):
        """``eager_scan(body, carry, xs, n)`` as graph replays. ``deps()``:
        the tensors that ``body`` reads or updates in place besides
        ``carry`` and its input (called again after the warm-up step, which
        may create some: an optimizer's state). Returns fresh tensors."""
        leaves: List[torch.Tensor] = []
        spec = _flatten(carry, leaves)
        if not leaves or not all(t.is_cuda for t in leaves):
            raise ValueError("Graphs.scan captures CUDA tensors only; on the CPU run the "
                             "body through eager_scan")
        xs = iter(xs)
        if n == 0:
            return carry, None
        sig = (spec, n, _backend_flags())
        g = self._graphs.get(sig)
        done = 0
        if g is not None and g.deps == _addresses(deps):
            _copy_(g.carry, leaves)
            g.t.zero_()
        else:
            g = self._graphs[sig] = self._capture(body, carry, leaves, xs, n, deps)
            done = 1
        for _ in range(done, n):
            x_leaves: List[torch.Tensor] = []
            if _flatten(next(xs), x_leaves) != g.x_spec:
                raise ValueError("a step's input differs in structure, shape or dtype "
                                 "from the captured step's")
            _copy_(g.x, x_leaves)
            g.graph.replay()
            LAUNCHES.update(g.launches)
            self.replays += 1
        out = rebuild(carry, [c.clone() for c in g.carry])
        return out, None if g.ys is None else g.ys.clone()

    def _capture(self, body: Body, carry, leaves, xs, n: int, deps) -> _Graph:
        """One real step on a side stream (the warm-up, on the static
        buffers), then the capture of one step."""
        main = torch.cuda.current_stream()
        static = [t.clone() for t in leaves]
        t = torch.zeros((1,), dtype=torch.long, device=static[0].device)
        x = next(xs)  # drawn on the main stream, which the side stream then waits for
        side = torch.cuda.Stream()
        side.wait_stream(main)
        with torch.cuda.stream(side):
            new, y = body(rebuild(carry, static), x)
            _copy_(static, leaves_of(new))
            if y is not None:
                y.record_stream(main)
        main.wait_stream(side)
        ys = None
        if y is not None:
            ys = torch.empty((n,) + tuple(y.shape), dtype=y.dtype, device=y.device)
            ys[0].copy_(y)
        x_leaves: List[torch.Tensor] = []
        x_spec = _flatten(x, x_leaves)
        static_x = [v.clone() for v in x_leaves]
        graph = torch.cuda.CUDAGraph()
        before = collections.Counter(LAUNCHES)
        with torch.cuda.graph(graph):
            new, y = body(rebuild(carry, static), rebuild(x, static_x))
            _copy_(static, leaves_of(new))
            if ys is not None:
                ys.index_copy_(0, t, y.unsqueeze(0))
                t.add_(1)
        # The capture launched nothing: its counts move to the replays.
        launches = collections.Counter(LAUNCHES) - before
        LAUNCHES.subtract(launches)
        t.fill_(1)
        self.captures += 1
        return _Graph(graph, _addresses(deps), static, x_spec, static_x, ys, t, launches)


def _addresses(deps: Callable[[], Sequence[torch.Tensor]]) -> tuple:
    return tuple(d.data_ptr() for d in deps())


def module_deps(*modules: torch.nn.Module) -> List[torch.Tensor]:
    """The weights and buffers of ``modules``: what a body reads of them."""
    return [t for m in modules for t in (*m.parameters(), *m.buffers())]


def optimizer_deps(*opts: torch.optim.Optimizer) -> List[torch.Tensor]:
    """Every tensor of the optimizers' states (moments, step counters)."""
    return [v for opt in opts for st in opt.state.values() for v in st.values()
            if isinstance(v, torch.Tensor)]
