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
is taken back and added on every replay instead. Each method's call is a
span (``utils/profiling.py``: ``graphs.scan``, ``graphs.while_loop``,
``graphs.call``), and inside it each warm-up step, capture and replay
(``graphs.warm_up``, ``graphs.capture``, ``graphs.feed``).

``Graphs.while_loop(body, carry, xs, n, stop)`` is the counterpart of a
``lax.while_loop`` whose condition reads the device (the planner's search,
``plan/mcts.py``): it replays one captured step until ``stop(carry)``, a
0-d bool on the device, says stop, at most ``n`` times. The flag is read one
step late, so the card always has a step queued: before each step it is
copied into one of two pinned slots, and the host reads that slot before
it enqueues the step after. At most one step runs after the flag turned
true (a step that must then change nothing, as a search iteration with
every env decided). There is no ``ys`` table, and the carry is not cloned
out: it lives in the graph's static buffers (a carry that is already there
is not copied in again) until the next loop of the same signature. The
loop's graphs share one memory pool: their replays never overlap, and
every output lands in buffers allocated outside the pool.
``eager_while_loop`` is its op-by-op twin.

``Graphs.call(fn, inputs, deps, key)`` is the counterpart of ``jax.jit``
on a function with no loop (an eval pass, a demo plan, a decode): the
first call runs ``fn(*inputs)`` once eagerly on the side stream, which is
its result, and captures it; a later call with the same signature (``fn``'s
code, the inputs' shapes and dtypes, the backend flags, ``key`` and the
addresses of ``deps``) copies its inputs into the graph's static buffers, replays, and
returns the outputs copied out of the graph's buffers into fresh tensors.

``Graphs.scan``, ``Graphs.while_loop`` and ``Graphs.call`` raise on CPU
tensors: on the CPU the callers run the same body through ``eager_scan``,
``eager_while_loop`` or a plain call. A capture or a replay that fails
raises. ``use_graphs(graphed, device)`` is the callers' one rule for their
``graphed`` option: None means graphs on a card and op by op elsewhere.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import gc
from typing import Any, Callable, Dict, Iterable, List, Optional, Sequence, Tuple

import torch

from deep_active_inference_mc_torch.ops.cuda import LAUNCHES
from deep_active_inference_mc_torch.utils import profiling

Body = Callable[[Any, Any], Tuple[Any, Optional[torch.Tensor]]]
LoopBody = Callable[[Any, Any], Any]  # (carry, x) -> carry
Stop = Callable[[Any], torch.Tensor]  # carry -> 0-d bool on the carry's device


# ---------------------------------------------------------------- trees
# A tree is a tensor, None, a plain scalar, or a dataclass, list, tuple or
# dict of trees: the draws, states and outputs of the port.

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
    if isinstance(tree, dict):
        return (dict, tuple(tree)) + tuple(_flatten(v, leaves) for v in tree.values())
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
        if isinstance(node, dict):
            return {k: go(v) for k, v in node.items()}
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


def _copied(src: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """Fresh copies of ``src``, one multi-tensor copy per dtype."""
    out = [torch.empty_like(t) for t in src]
    _copy_(out, src)
    return out


def _copy_changed_(dst: Sequence[torch.Tensor], src: Sequence[torch.Tensor]) -> None:
    """``_copy_`` of the pairs whose source is not already the destination."""
    pairs = [(d, s) for d, s in zip(dst, src, strict=True) if d.data_ptr() != s.data_ptr()]
    if pairs:
        _copy_([d for d, _ in pairs], [s for _, s in pairs])


@contextlib.contextmanager
def _capturing(graph: torch.cuda.CUDAGraph, **kwargs):
    """``torch.cuda.graph(graph, **kwargs)`` with Python's cyclic collector
    run first and off until the capture ends: a collection inside a
    capture could free a dead graph (a planner's graphs sit in a closure
    cycle), and destroying a graph invalidates the capture."""
    gc.collect()
    enabled = gc.isenabled()
    gc.disable()
    try:
        with torch.cuda.graph(graph, **kwargs):
            yield
    finally:
        if enabled:
            gc.enable()


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


class HostSlots:
    """Tensors on their way to the host through two reused slots, written
    by turns, so that the host reads copy k while copy k + 1 is being
    written. On a card a slot is pinned, its copy is enqueued, and ``get``
    waits for that copy alone; a slot is allocated anew only when the shape
    or dtype changes. One per loop (the search's flags, the bucketed
    planner's done masks)."""

    def __init__(self):
        self._host: List[Optional[torch.Tensor]] = [None, None]
        self._events: List[Optional[torch.cuda.Event]] = [None, None]

    def put(self, k: int, x: torch.Tensor) -> None:
        """Enqueue the copy of ``x`` into slot k % 2."""
        slot, cuda = k % 2, x.is_cuda
        host = self._host[slot]
        if host is None or host.shape != x.shape or host.dtype != x.dtype:
            host = self._host[slot] = torch.empty(x.shape, dtype=x.dtype, pin_memory=cuda)
        host.copy_(x, non_blocking=cuda)
        self._events[slot] = None
        if cuda:
            self._events[slot] = torch.cuda.Event()
            self._events[slot].record()

    def get(self, k: int) -> torch.Tensor:
        """Copy k, once it has landed (valid until copy k + 2 is put)."""
        event = self._events[k % 2]
        if event is not None:
            event.synchronize()
        return self._host[k % 2]


def eager_while_loop(body: LoopBody, carry, xs: Iterable, n: int, stop: Stop):
    """At most ``n`` steps of ``carry = body(carry, x)`` op by op, on any
    device, taking the inputs of ``xs`` as it goes. ``stop(carry)`` is
    copied to the host before each step; before step k > 0 the host reads
    the copy made before step k - 1 and stops if it is true. Returns
    (carry, steps run)."""
    xs = iter(xs)
    flags = HostSlots()
    for k in range(n):
        if k and bool(flags.get(k - 1)):
            return carry, k
        flags.put(k, stop(carry))
        carry = body(carry, next(xs))
    return carry, n


@dataclasses.dataclass
class _Graph:
    graph: torch.cuda.CUDAGraph
    deps: tuple  # the addresses the body was captured on
    carry: List[torch.Tensor]  # static carry buffers
    x_spec: Any
    x: List[torch.Tensor]  # static input buffers
    ys: Optional[torch.Tensor]  # the static (n, ...) table of the ys (a scan's)
    t: Optional[torch.Tensor]  # the table's next row, on the device (a scan's)
    launches: collections.Counter  # kernel launches per replay
    flag: Optional[torch.Tensor] = None  # a loop's stop flag after a replay
    flags: Optional[HostSlots] = None  # a loop's host slots
    out: Any = None  # a call's outputs in the graph's buffers


class Graphs:
    """Captured scan bodies, one graph per signature (see the module's
    docstring). ``captures`` and ``replays`` count what it did."""

    def __init__(self):
        self._graphs: Dict[Any, _Graph] = {}
        self._pool = None  # the loops' shared memory pool
        self.captures = 0
        self.replays = 0

    @property
    def count(self) -> int:
        """Graphs held."""
        return len(self._graphs)

    @profiling.spanned("graphs.scan")
    def scan(self, body: Body, carry, xs: Iterable, n: int,
             deps: Callable[[], Sequence[torch.Tensor]] = tuple):
        """``eager_scan(body, carry, xs, n)`` as graph replays. ``deps()``:
        the tensors that ``body`` reads or updates in place besides
        ``carry`` and its input (called again after the warm-up step, which
        may create some: an optimizer's state). The carry may hold no
        tensor when the inputs do (a body that only updates ``deps``).
        Returns fresh tensors."""
        leaves: List[torch.Tensor] = []
        spec = _flatten(carry, leaves)
        if n == 0:
            return carry, None
        xs = iter(xs)
        x = next(xs)
        tensors = leaves + leaves_of(x)
        if not tensors or not all(t.is_cuda for t in tensors):
            raise ValueError("Graphs.scan captures CUDA tensors only; on the CPU run the "
                             "body through eager_scan")
        sig = (spec, n, _backend_flags())
        g = self._graphs.get(sig)
        if g is not None and g.deps == _addresses(deps):
            _copy_(g.carry, leaves)
            g.t.zero_()
            self._feed(g, x)
        else:
            g = self._graphs[sig] = self._capture(body, carry, leaves, x, n, deps,
                                                  tensors[0].device)
        for _ in range(1, n):
            self._feed(g, next(xs))
        out = rebuild(carry, [c.clone() for c in g.carry])
        return out, None if g.ys is None else g.ys.clone()

    def _capture(self, body: Body, carry, leaves, x, n: int, deps, device) -> _Graph:
        """A scan's graph: its first step, on input ``x``, is the warm-up."""
        static = [t.clone() for t in leaves]
        t = torch.zeros((1,), dtype=torch.long, device=device)
        ys = None

        def step(x):
            new, y = body(rebuild(carry, static), x)
            _copy_(static, leaves_of(new))
            if ys is None:
                return y
            ys.index_copy_(0, t, y.unsqueeze(0))
            t.add_(1)

        # x was drawn on the main stream, which the warm-up's stream waits for.
        y = _warm_up(lambda: step(x))
        if y is not None:
            ys = torch.empty((n,) + tuple(y.shape), dtype=y.dtype, device=y.device)
            ys[0].copy_(y)
        graph, x_spec, static_x, launches = self._capture_step(step, x)
        t.fill_(1)
        return _Graph(graph, _addresses(deps), static, x_spec, static_x, ys, t, launches)

    @profiling.spanned("graphs.while_loop")
    def while_loop(self, body: LoopBody, carry, xs: Iterable, n: int, stop: Stop,
                   deps: Callable[[], Sequence[torch.Tensor]] = tuple, key: Any = ()):
        """``eager_while_loop(body, carry, xs, n, stop)`` as graph replays
        (the module's docstring). ``deps`` as ``scan``'s; ``key``: the
        body's static parameters, which select its graph. Returns (the
        carry in the graph's static buffers, steps run)."""
        leaves: List[torch.Tensor] = []
        spec = _flatten(carry, leaves)
        if not leaves or not all(t.is_cuda for t in leaves):
            raise ValueError("Graphs.while_loop captures CUDA tensors only; on the CPU run "
                             "the body through eager_while_loop")
        if n <= 0:
            return carry, 0
        xs = iter(xs)
        x = next(xs)
        sig = ("while_loop", spec, _flatten(x, []), key, _backend_flags())
        g = self._graphs.get(sig)
        flag = stop(carry)
        if g is not None and g.deps == _addresses(deps):
            _copy_changed_(g.carry, leaves)  # copy in, once per loop
            g.flags.put(0, flag)
            self._feed(g, x)
        else:  # the first step is the capture's warm-up
            g = self._graphs[sig] = self._capture_loop(body, carry, leaves, x, flag, stop,
                                                       deps)
        for k in range(1, n):
            if bool(g.flags.get(k - 1)):
                return rebuild(carry, g.carry), k
            g.flags.put(k, g.flag)
            self._feed(g, next(xs))
        return rebuild(carry, g.carry), n

    def _capture_loop(self, body: LoopBody, carry, leaves, x, flag0, stop, deps) -> _Graph:
        """A loop's graph, in the loops' shared pool: its first step (its
        flag copied before it) is the warm-up."""
        static = [t.clone() for t in leaves]
        flag = torch.zeros((), dtype=torch.bool, device=static[0].device)
        flags = HostSlots()
        flags.put(0, flag0)

        def step(x_):
            new = body(rebuild(carry, static), x_)
            _copy_changed_(static, leaves_of(new))
            flag.copy_(stop(new))

        _warm_up(lambda: step(x))
        if self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
        graph, x_spec, static_x, launches = self._capture_step(step, x, self._pool)
        return _Graph(graph, _addresses(deps), static, x_spec, static_x, None, None, launches,
                      flag, flags)

    @profiling.spanned("graphs.call")
    def call(self, fn: Callable[..., Any], inputs: Sequence[Any],
             deps: Callable[[], Sequence[torch.Tensor]] = tuple, key: Any = ()):
        """``fn(*inputs)`` as a graph replay (the module's docstring).
        ``deps`` as ``scan``'s; ``key``: the static values that ``fn``
        reads besides its inputs and ``fn``'s code (a lambda made anew on
        each call keeps its graph; two functions never share one). The first call of
        a signature returns the eager warm-up's outputs, a replay fresh
        copies of the graph's."""
        leaves: List[torch.Tensor] = []
        spec = _flatten(tuple(inputs), leaves)
        if not leaves or not all(t.is_cuda for t in leaves):
            raise ValueError("Graphs.call captures CUDA tensors only; on the CPU call the "
                             "function itself")
        sig = ("call", getattr(fn, "__code__", fn), spec, key, _backend_flags())
        g = self._graphs.get(sig)
        if g is not None and g.deps == _addresses(deps):
            self._feed(g, tuple(inputs))
            return rebuild(g.out, _copied(leaves_of(g.out)))
        out = _warm_up(lambda: fn(*inputs))
        box = []
        graph, x_spec, static_x, launches = self._capture_step(
            lambda x: box.append(fn(*x)), tuple(inputs))
        self._graphs[sig] = _Graph(graph, _addresses(deps), [], x_spec, static_x, None, None,
                                   launches, out=box[0])
        return out

    @profiling.spanned("graphs.capture")
    def _capture_step(self, step: Callable[[Any], Any], x, pool=None):
        """Capture ``step`` fed static copies of ``x``'s tensors: (graph,
        ``x``'s spec, the static inputs, kernel launches per replay)."""
        x_leaves: List[torch.Tensor] = []
        x_spec = _flatten(x, x_leaves)
        static_x = [v.clone() for v in x_leaves]
        graph = torch.cuda.CUDAGraph()
        before = collections.Counter(LAUNCHES)
        with _capturing(graph, pool=pool):
            step(rebuild(x, static_x))
        # The capture launched nothing: its counts move to the replays.
        launches = collections.Counter(LAUNCHES) - before
        LAUNCHES.subtract(launches)
        self.captures += 1
        return graph, x_spec, static_x, launches

    @profiling.spanned("graphs.feed")
    def _feed(self, g: _Graph, x) -> None:
        """Copy one step's input ``x`` into ``g``'s static buffers and replay."""
        x_leaves: List[torch.Tensor] = []
        if _flatten(x, x_leaves) != g.x_spec:
            raise ValueError("a step's input differs in structure, shape or dtype "
                             "from the captured step's")
        _copy_(g.x, x_leaves)
        g.graph.replay()
        LAUNCHES.update(g.launches)
        self.replays += 1


@profiling.spanned("graphs.warm_up")
def _warm_up(run: Callable[[], Any]):
    """``run()`` on a side stream that waits for the current one, which
    then waits for it: a step run eagerly before its capture, which settles
    what a first call sets up (K1's build, optimizer state, cuBLAS's
    workspace) outside the capture. Returns its result."""
    main = torch.cuda.current_stream()
    side = torch.cuda.Stream()
    side.wait_stream(main)
    with torch.cuda.stream(side):
        out = run()
        for t in leaves_of(out):
            t.record_stream(main)
    main.wait_stream(side)
    return out


def use_graphs(graphed: Optional[bool], device) -> bool:
    """Whether a path runs its graphs: ``graphed``, or where it is None,
    whether ``device`` (a ``torch.device`` or a tensor) is a card."""
    if graphed is not None:
        return graphed
    return getattr(device, "device", device).type == "cuda"


def _addresses(deps: Callable[[], Sequence[torch.Tensor]]) -> tuple:
    return tuple(d.data_ptr() for d in deps())


def module_deps(*modules: torch.nn.Module) -> List[torch.Tensor]:
    """The weights and buffers of ``modules``: what a body reads of them."""
    return [t for m in modules for t in (*m.parameters(), *m.buffers())]


def optimizer_deps(*opts: torch.optim.Optimizer) -> List[torch.Tensor]:
    """Every tensor of the optimizers' states (moments, step counters)."""
    return [v for opt in opts for st in opt.state.values() for v in st.values()
            if isinstance(v, torch.Tensor)]
