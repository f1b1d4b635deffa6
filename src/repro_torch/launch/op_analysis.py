"""Roofline counts of an eager step, by the ops it dispatches: the port's
counterpart of the reference's ``launch/hlo_analysis.py``.

The reference parses compiled HLO.  The port runs eagerly, so every op
that is dispatched is a pass over memory, and :class:`OpCounter` (a
``TorchDispatchMode``) counts them as they go, on meta tensors (the dry
run, ``launch/dryrun.py``) and on CUDA tensors alike:

  * flops        — 2*M*N*K per matrix product (``mm``, ``bmm``, ``addmm``,
                   ``baddbmm``, ``mv``, ``dot``: what ``einsum`` and
                   ``matmul`` decompose into); elementwise work is left
                   out, as in the reference
  * bytes        — operand + output bytes of every op that is not a view
                   or a metadata op (the reference's ``_SKIP_OPS`` and
                   fusion rule: an eager op is its own fusion)
  * dot_bytes    — operand + output bytes of the products alone
  * h2d          — the moves from the host to the step's device among
                   them (a CPU run of the same step dispatches none: its
                   host tables are on its device already)
  * peak_bytes   — the high-water mark of the bytes of the storages the
                   counted ops made that are alive at once (arguments, the
                   storages an op first sees as an input, excluded); each
                   storage's release is seen by a ``weakref.finalize``
  * collectives  — wire bytes reported by ``sharding/rules.py``'s
                   ``psum``, ``all_gather``, ``psum_scatter`` and
                   ``all_to_all`` with the reference's ring factors:
                   all-reduce 2T(g-1)/g; all-gather and all-to-all
                   T(g-1)/g; reduce-scatter T_in(g-1)/g.  Every
                   coordinate of a ``shard_map`` reports its own, so a
                   mesh's total is the sum over its devices.  A
                   collective is one op of its operand + result bytes, as
                   an HLO collective is: the copies and sums that emulate
                   it in one process are not counted (:func:`uncounted`).

:func:`repeats` is the counterpart of the reference's trip-count walk: a
loop of identical iterations (``runtime/train.py::grads_fn``'s
microbatches) run under a counter made with ``repeat=True`` runs its first
iteration alone, its counts multiplied by the trip count.  The step's
results are then not the step's (one microbatch's gradients): that is for
the dry run, whose tensors hold no values.

The hand-written kernels (K1-K6) are bound through ``ctypes``, so no
dispatch mode sees them, as the reference's parser does not see inside a
Pallas custom call: :attr:`OpCounts.kernel_launches` lists each wrapper's
launches during the count, and they add no FLOPs or bytes.
"""
from __future__ import annotations

import contextlib
import dataclasses
import importlib
import threading
import weakref
from collections import defaultdict

import torch
from torch.utils._python_dispatch import (TorchDispatchMode, _pop_mode,
                                          _push_mode)

aten = torch.ops.aten

#: the wrappers whose ``launches`` a count reports (module, counter name)
KERNEL_WRAPPERS = {
    "paged_attention": ("repro_torch.kernels.paged_attention.ops",
                        "launches"),
    "flash_attention": ("repro_torch.kernels.flash_attention.ops",
                        "launches"),
    "event_sweep": ("repro_torch.kernels.event_sweep.ops", "launches"),
    "spill_sweep": ("repro_torch.kernels.spill_sweep.ops", "launches"),
    "fail_sweep": ("repro_torch.kernels.fail_sweep.ops", "launches"),
    "pod_sweep": ("repro_torch.kernels.pod_sweep.ops", "launches"),
}

#: ops that move no bytes: allocation, aliasing and host reads (views are
#: found by their schema, ``OpOverload.is_view``)
_SKIP_OPS = {
    aten.empty.memory_format, aten.empty_strided.default,
    aten.new_empty.default, aten.new_empty_strided.default,
    aten.empty_like.default,
    aten.detach.default, aten.alias.default, aten.lift_fresh.default,
    aten._unsafe_view.default, aten._local_scalar_dense.default,
    aten.resize_.default, aten.set_.source_Storage_storage_offset,
    aten.sym_size.int, aten.sym_stride.int, aten.sym_numel.default,
    aten.sym_storage_offset.default, aten.is_same_size.default,
}

def _host_move(func, args, out) -> bool:
    """A move of a CPU tensor to another device, its dtype kept (which a
    CPU run of the same code does not dispatch)."""
    if func is aten._to_copy.default:
        src = args[0]
    elif func is aten.copy_.default:
        src = args[1]
    else:
        return False
    return (isinstance(src, torch.Tensor) and src.device.type == "cpu"
            and out.device.type != "cpu" and out.dtype == src.dtype)

#: ring factors of the reference (``hlo_analysis.py`` l.315-319)
_WIRE = {
    "all-reduce": lambda t_in, t_out, f: 2 * t_out * f,
    "all-gather": lambda t_in, t_out, f: t_out * f,
    "reduce-scatter": lambda t_in, t_out, f: t_in * f,
    "all-to-all": lambda t_in, t_out, f: t_out * f,
}


def _tensors(args, kwargs) -> list:
    """The tensors among an op's arguments (one level of lists: ``cat``'s,
    ``stack``'s, ``index``'s), faster than a pytree walk."""
    out = []
    for a in (*args, *kwargs.values()):
        if isinstance(a, torch.Tensor):
            out.append(a)
        elif isinstance(a, (list, tuple)):
            out.extend(t for t in a if isinstance(t, torch.Tensor))
    return out


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _dot_flops(func, args, out) -> int | None:
    """2*M*N*K of a matrix product, None for any other op."""
    if func in (aten.mm.default, aten.bmm.default):
        a = args[0]
    elif func in (aten.addmm.default, aten.baddbmm.default):
        a = args[1]
    elif func is aten.mv.default:
        return 2 * args[0].shape[0] * args[0].shape[1]
    elif func is aten.dot.default:
        return 2 * args[0].shape[0]
    else:
        return None
    return 2 * a.shape[-1] * out.numel()


@dataclasses.dataclass
class OpCounts:
    """The reference's ``HloCounts`` fields, summed over every device of
    the count (a ``shard_map`` coordinate counts its own work), plus the
    peak live bytes and the kernels' launches."""
    flops: int = 0
    bytes: int = 0
    dot_bytes: int = 0     # operands + outputs of the products alone
    collective_bytes: float = 0.0
    by_collective: dict = dataclasses.field(
        default_factory=lambda: defaultdict(float))
    dot_flops_by_comp: dict = dataclasses.field(
        default_factory=lambda: defaultdict(int))   # by module path
    collective_details: list = dataclasses.field(default_factory=list)
    ops: int = 0           # ops counted (times their multiplier)
    h2d_ops: int = 0       # of them, moves from the host to a device
    h2d_bytes: int = 0     # their bytes (in ``bytes`` too)
    peak_bytes: int = 0    # high-water mark of the step's live storages
    peak_storages: int = 0  # how many of them were alive at that mark
    kernel_launches: dict = dataclasses.field(default_factory=dict)


_ACTIVE: list = []           # the counters entered, innermost last
_ACTIVE_LOCK = threading.Lock()


def current() -> "OpCounter | None":
    """The innermost counter entered in any thread, or None."""
    return _ACTIVE[-1] if _ACTIVE else None


class OpCounter(TorchDispatchMode):
    """Counts the ops dispatched while it is entered (module docstring).

    ``with OpCounter() as c: step(...)``, then ``c.counts``.  With
    ``repeat=True`` the loops written with :func:`repeats` run one
    iteration, multiplied.  The products' FLOPs are also summed by the
    path of the modules whose forward is running (global forward hooks,
    which hold no tensor; a backward's products go under "backward").
    ``sharding/rules.py::shard_map`` enters the counter in each of its
    threads (:meth:`in_thread`)."""

    def __init__(self, repeat: bool = False):
        super().__init__()
        self.repeat = repeat
        self.counts = OpCounts()
        self._mult = 1
        # reentrant: a finalizer can run (at a GC) while the lock is held
        self._lock = threading.RLock()
        self._known: set[int] = set()      # storages seen, by _cdata
        self._live = 0
        self._live_n = 0
        self._modules: list[str] = []       # forwards running, outermost first
        self._hooks: list = []
        self._launches0: dict = {}
        self._paused = threading.local()

    # ---- entering -------------------------------------------------------
    def __enter__(self):
        self._launches0 = _kernel_launches()
        from torch.nn.modules import module as nn_module

        def enter(m, _args):
            self._modules.append(type(m).__name__)

        def leave(m, _args, _out):
            self._modules.pop()
        self._hooks = [
            nn_module.register_module_forward_pre_hook(enter),
            nn_module.register_module_forward_hook(leave, always_call=True)]
        with _ACTIVE_LOCK:
            _ACTIVE.append(self)
        return super().__enter__()

    def __exit__(self, *exc):
        out = super().__exit__(*exc)
        with _ACTIVE_LOCK:
            _ACTIVE.remove(self)
        for h in self._hooks:
            h.remove()
        now = _kernel_launches()
        self.counts.kernel_launches = {
            k: now[k] - self._launches0.get(k, 0) for k in now}
        return out

    @contextlib.contextmanager
    def in_thread(self):
        """The counter entered in another thread (a ``shard_map``
        coordinate's), without resetting its counts."""
        _push_mode(self)
        try:
            yield self
        finally:
            _pop_mode()

    # ---- counting -------------------------------------------------------
    def _storage(self, t: torch.Tensor, made: bool) -> None:
        """Note ``t``'s storage: an argument's when first seen as an input,
        the step's when first seen as an output (then counted live until
        it is released)."""
        st = t.untyped_storage()
        key = st._cdata
        with self._lock:
            if key in self._known:
                return
            self._known.add(key)
            n = st.nbytes() if made else 0
            self._live += n
            self._live_n += made
            if self._live > self.counts.peak_bytes:
                self.counts.peak_bytes = self._live
                self.counts.peak_storages = self._live_n
        weakref.finalize(st, self._release, key, n, made)

    def _release(self, key: int, n: int, made: bool) -> None:
        with self._lock:
            self._known.discard(key)
            self._live -= n
            self._live_n -= made

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if getattr(self._paused, "depth", 0):
            out = func(*args, **kwargs)
            for o in _tensors((out,), {}):
                self._storage(o, made=True)
            return out
        flat_in = _tensors(args, kwargs)
        for a in flat_in:
            self._storage(a, made=False)
        out = func(*args, **kwargs)
        flat_out = _tensors((out,), {})
        for o in flat_out:
            self._storage(o, made=True)
        if func in _SKIP_OPS or func.is_view:
            return out
        m = self._mult
        io = (sum(_nbytes(a) for a in flat_in)
              + sum(_nbytes(o) for o in flat_out))
        c = self.counts
        c.ops += m
        c.bytes += m * io
        if flat_out and _host_move(func, args, flat_out[0]):
            c.h2d_ops += m
            c.h2d_bytes += m * io
        fl = _dot_flops(func, args, out)
        if fl is not None:
            c.flops += m * fl
            c.dot_bytes += m * io
            where = (".".join(self._modules) if self._modules
                     else "backward" if torch._C._current_graph_task_id() >= 0
                     else "step")
            c.dot_flops_by_comp[where] += m * fl
        return out

    def collective(self, kind: str, t_in: int, t_out: int, group: int):
        """Record one collective of ``kind`` (the reference's names:
        all-reduce, all-gather, reduce-scatter, all-to-all) on one device:
        ``t_in`` / ``t_out`` its operand / result bytes, ``group`` the
        devices it spans."""
        f = (group - 1) / max(group, 1)
        wire = _WIRE[kind](t_in, t_out, f)
        c = self.counts
        with self._lock:
            c.ops += self._mult
            c.bytes += self._mult * (t_in + t_out)
            c.collective_bytes += self._mult * wire
            c.by_collective[kind] += self._mult * wire
            c.collective_details.append(
                (kind, t_out, group, self._mult, self._mult * wire))


def _kernel_launches() -> dict:
    out = {}
    for name, (mod, attr) in KERNEL_WRAPPERS.items():
        out[name] = getattr(importlib.import_module(mod), attr)
    return out


def report_collective(kind: str, x_in: torch.Tensor, x_out: torch.Tensor,
                      group: int) -> None:
    """Tell the active counter (if any) of one device's collective."""
    c = current()
    if c is not None:
        c.collective(kind, _nbytes(x_in), _nbytes(x_out), group)


@contextlib.contextmanager
def uncounted():
    """The ops inside are run but not counted (their storages still are
    live bytes): a collective's emulation, which its report replaces."""
    c = current()
    if c is None:
        yield
        return
    c._paused.depth = getattr(c._paused, "depth", 0) + 1
    try:
        yield
    finally:
        c._paused.depth -= 1


@contextlib.contextmanager
def times(n: int):
    """Every count inside multiplied by ``n`` (under an active counter)."""
    c = current()
    if c is None:
        yield
        return
    c._mult *= n
    try:
        yield
    finally:
        c._mult //= n


def repeats(n: int):
    """``range(n)`` for a loop of ``n`` identical iterations; under a
    counter made with ``repeat=True``, the first iteration alone with
    every count inside multiplied by ``n``."""
    c = current()
    if c is None or not c.repeat or n <= 1:
        yield from range(n)
        return
    with times(n):
        yield 0
