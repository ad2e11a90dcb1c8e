"""Step cost analysis: the FLOPs, bytes and collectives of one step,
counted while it runs.

Counterpart of ``repro/launch/hlo_analysis.py``. The reference re-derives
a compiled step's roofline inputs from its post-SPMD HLO text, with loop
multipliers. The port produces no HLO: :class:`StepCost`, a
``TorchDispatchMode``, tallies the same quantities from the aten ops the
step dispatches, on fake tensors (the dry-run) or on real ones, and
:func:`analyze_step` returns them under :func:`analyze_hlo`'s keys. Eager
PyTorch unrolls every loop and fuses nothing, so there is no trip count
to read and no fusion to see:

- **flops**: ``torch.utils.flop_counter``'s formulas (2 x numel(out) x K
  for ``mm``, ``bmm``, ``addmm``, ``baddbmm``, ``convolution`` and the
  rest of its registry), plus what a hand-written kernel reports through
  :meth:`StepCost.kernel` (B8);
- **bytes**: output plus operand bytes of every aten op, each of which
  reads its operands from device memory and writes its outputs back in
  eager mode; views, aliases, shape queries and uninitialised factories
  move nothing and count 0 (the reference's ``_FREE_OPS``);
- **collectives**: the reference's ring model, bytes per device
  (:func:`ring_bytes`), for every ``_c10d_functional`` op (DTensor's) and
  ``c10d`` op (``torch.distributed``'s, as the compressed gradients
  use), g the size of the op's process group. Each group's ranks are
  recorded too, so that the roofline can charge the slowest link the
  group crosses (:data:`repro_torch.launch.mesh.CARDS_PER_NODE`).

An op on a tensor subclass (DTensor, an async collective's wrapper) is
left to the subclass, whose local ops come back to the mode: the counts
are this rank's. DTensor's sharding propagation, which runs each new op
once on fake tensors of the global shape to learn its output's, and ops
on meta tensors alone are bookkeeping and count nothing.

While it is active the mode also follows the step's live memory: every
storage the step's arguments hold (:meth:`StepCost.arguments`) and every
storage an op returns, each until it is freed, so that the step's peak is
known without an allocator (fake tensors have none).
"""

from __future__ import annotations

import contextvars
import sys
import threading
import weakref
from typing import Any, Dict, List, Optional

import torch
import torch.distributed as dist
from torch._subclasses.fake_tensor import is_fake
from torch.utils._python_dispatch import (
    TorchDispatchMode,
    is_traceable_wrapper_subclass_type,
)
from torch.utils.flop_counter import FlopCounterMode, flop_registry

COLLECTIVE_OPS = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
                  "collective-permute")

#: torch's collective ops -> the reference's kind and where the op's
#: output is: ``None`` for its result, an index for an argument it writes.
#: DTensor sends the ``_c10d_functional`` ones, the compressed gradients
#: ``c10d.allreduce_``; another collective is named in ``warnings``
_COLLECTIVES = {
    "_c10d_functional.all_gather_into_tensor": ("all-gather", None),
    "_c10d_functional.all_reduce": ("all-reduce", None),
    "_c10d_functional.reduce_scatter_tensor": ("reduce-scatter", None),
    "_c10d_functional.all_to_all_single": ("all-to-all", None),
    "c10d.allreduce_": ("all-reduce", 0),
    "c10d.send": ("collective-permute", 0),
}

#: ops that move no device bytes (beside every op whose schema makes its
#: result a view, and every op that returns no tensor): views the schema
#: does not mark, uninitialised factories, the wait on a collective
_FREE_OPS = {"aten._unsafe_view", "aten.empty", "aten.empty_strided",
             "aten.empty_like", "aten.new_empty", "aten.new_empty_strided",
             "_c10d_functional.wait_tensor",
             "_c10d_functional._wrap_tensor_autograd"}


def _dtype_tolerant(formula):
    """``formula`` (one of ``torch.utils.flop_counter``'s) for a product
    whose overloads may take ``out_dtype`` positionally (``bmm.dtype``:
    the MoE's f32-out products on the card), which the stock formula reads
    as its output's shape and raises on."""
    def count(*args, out_val=None, **kwargs):
        return formula(*[a for a in args if not isinstance(a, torch.dtype)],
                       out_val=out_val, **kwargs)
    count._get_raw = True              # FlopCounterMode: no shape wrapper
    return count


_PRODUCTS = (torch.ops.aten.mm, torch.ops.aten.bmm, torch.ops.aten.addmm,
             torch.ops.aten.baddbmm)
#: the FLOP formulas: ``torch.utils.flop_counter``'s, the products' mended
FLOP_FORMULAS = {**flop_registry,
                 **{op: _dtype_tolerant(flop_registry[op])
                    for op in _PRODUCTS}}


def flop_counter() -> FlopCounterMode:
    """A ``FlopCounterMode`` (no display) whose product formulas take a
    positional ``out_dtype``: the independent second count of FLOPs."""
    return FlopCounterMode(display=False, custom_mapping={
        op: FLOP_FORMULAS[op] for op in _PRODUCTS})


_ACTIVE: contextvars.ContextVar = contextvars.ContextVar("step_cost",
                                                         default=None)


def ring_bytes(kind: str, out_bytes: float, g: int) -> float:
    """Bytes one device moves in a collective of ``kind`` whose output is
    ``out_bytes`` over a group of ``g`` (the reference's ring model)."""
    g = max(int(g), 1)
    if kind == "all-gather":
        return out_bytes * (g - 1) / g
    if kind == "all-reduce":
        return 2.0 * out_bytes * (g - 1) / g
    if kind == "reduce-scatter":
        return float(out_bytes) * (g - 1)
    if kind == "all-to-all":
        return out_bytes * (g - 1) / g
    if kind == "collective-permute":
        return float(out_bytes)
    raise ValueError(f"not a collective kind: {kind!r}")


def _tensors(x) -> List[torch.Tensor]:
    """The tensors in a (nested) argument or result."""
    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, (list, tuple)):
        return [t for v in x for t in _tensors(v)]
    if isinstance(x, dict):
        return [t for v in x.values() for t in _tensors(v)]
    return []


def _nbytes(ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def _group(func, args, kwargs):
    """The process group a collective op runs over."""
    from torch.distributed.distributed_c10d import (
        ProcessGroup,
        _resolve_process_group,
    )
    for i, a in enumerate(func._schema.arguments):
        val = args[i] if i < len(args) else kwargs.get(a.name)
        if a.name == "group_name":
            return _resolve_process_group(val)
        if a.name == "process_group":
            return ProcessGroup.unbox(val)
    raise ValueError(f"{func}: no process group argument")


_PROPAGATION = "/distributed/tensor/_sharding_prop.py"


def _propagating() -> bool:
    """Whether the op being dispatched runs inside DTensor's sharding
    propagation, which runs each new op once on fake tensors of the
    global shape to learn its output's (on a real step too, in a fake mode
    of its own): bookkeeping, not the rank's work."""
    f = sys._getframe(2)
    for _ in range(64):
        if f is None:
            return False
        if f.f_code.co_filename.replace("\\", "/").endswith(_PROPAGATION):
            return True
        f = f.f_back
    return False


def active() -> Optional["StepCost"]:
    """The innermost :class:`StepCost` active in this context, or None."""
    return _ACTIVE.get()


class StepCost(TorchDispatchMode):
    """Tallies a step's FLOPs, bytes, collectives and live memory while it
    is active (module docstring); :meth:`result` reads them."""

    def __init__(self):
        super().__init__()
        self.flops = 0.0
        self.bytes = 0.0
        self.coll_bytes = 0.0
        self.coll_detail: Dict[str, Dict] = {}
        self.bytes_by_op: Dict[str, float] = {}
        self.groups: Dict[tuple, Dict] = {}
        self.warnings: List[str] = []
        self._lock = threading.Lock()
        self._live: Dict[int, tuple] = {}        # id -> (weakref, nbytes)
        self._args: Dict[int, weakref.ref] = {}
        self.argument_bytes = 0
        self.live_bytes = 0
        self.peak_bytes = 0
        self._token = None

    def __enter__(self):
        self._token = _ACTIVE.set(self)
        return super().__enter__()

    def __exit__(self, *exc):
        _ACTIVE.reset(self._token)
        return super().__exit__(*exc)

    # ------------------------------------------------------------ memory
    def _storages(self, x):
        """The device storages under ``x`` (meta tensors hold none)."""
        out = []
        for t in _tensors(x):
            if is_traceable_wrapper_subclass_type(type(t)):
                names, _ = t.__tensor_flatten__()
                out += self._storages([getattr(t, n) for n in names])
            elif t.device.type != "meta":
                out.append(t.untyped_storage())
        return out

    def _track(self, storage) -> None:
        key = id(storage)
        with self._lock:
            have = self._live.get(key)
            if have is not None and have[0]() is storage:
                return
            n = storage.nbytes()
            ref = weakref.ref(storage, lambda _, k=key: self._free(k))
            self._live[key] = (ref, n)
            self.live_bytes += n
            self.peak_bytes = max(self.peak_bytes, self.live_bytes)

    def _free(self, key: int) -> None:
        with self._lock:
            ref_n = self._live.pop(key, None)
            if ref_n is not None:
                self.live_bytes -= ref_n[1]

    def arguments(self, tree) -> int:
        """Track the storages of a step's arguments (a tree of tensors and
        DTensors) as live; returns their bytes."""
        seen = {id(st): st for st in self._storages(tree)}
        for key, st in seen.items():
            self._args[key] = weakref.ref(st)
            self._track(st)
        self.argument_bytes += sum(st.nbytes() for st in seen.values())
        return self.argument_bytes

    def memory(self, outputs) -> Dict[str, int]:
        """Argument, output, peak and alias bytes of the step that
        returned ``outputs``: alias bytes are the outputs that are argument
        storages (donated inputs updated in place)."""
        outs = {id(st): st for st in self._storages(outputs)}
        alias = sum(st.nbytes() for k, st in outs.items()
                    if k in self._args and self._args[k]() is st)
        return {"argument_bytes": self.argument_bytes,
                "output_bytes": sum(st.nbytes() for st in outs.values()),
                "peak_bytes": self.peak_bytes, "alias_bytes": alias}

    # ------------------------------------------------------------- costs
    def tally(self, op: str, b: float) -> None:
        self.bytes += b
        self.bytes_by_op[op] = self.bytes_by_op.get(op, 0.0) + b

    def kernel(self, name: str, flops: float, nbytes: float) -> None:
        """A hand-written kernel's FLOPs and bytes (no aten op shows
        them)."""
        self.flops += flops
        self.tally(name, nbytes)

    def _collective(self, name: str, func, args, kwargs, out) -> None:
        kind, where = _COLLECTIVES[name]
        outs = _tensors(out if where is None else args[where])
        pg = _group(func, args, kwargs)
        g = pg.size()
        b = ring_bytes(kind, _nbytes(outs), g)
        self.coll_bytes += b
        rec = self.coll_detail.setdefault(kind, {"count": 0, "bytes": 0.0})
        rec["count"] += 1
        rec["bytes"] += b
        ranks = tuple(dist.get_process_group_ranks(pg))
        grp = self.groups.setdefault(ranks, {"count": 0, "bytes": 0.0})
        grp["count"] += 1
        grp["bytes"] += b
        self.tally(kind, _nbytes(outs))

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if any(is_traceable_wrapper_subclass_type(t) for t in types):
            return NotImplemented        # the subclass's local ops come back
        name = str(func.overloadpacket)
        if name == "_c10d_functional.wait_tensor" and is_fake(args[0]):
            return args[0]   # as the real op does: the collective's output
        if _propagating():
            return func(*args, **kwargs)
        out = func(*args, **kwargs)
        ts = _tensors((args, kwargs, out))
        if ts and all(t.device.type == "meta" for t in ts):
            return out       # shape propagation (DTensor's), not device work
        if name in _COLLECTIVES:
            self._collective(name, func, args, kwargs, out)
        elif name.startswith(("c10d.", "_c10d_functional.")) and \
                name not in _FREE_OPS:
            self.warnings.append(f"uncounted collective {name}")
        else:
            count = FLOP_FORMULAS.get(func.overloadpacket)
            if count is not None:
                self.flops += count(*args, **kwargs, out_val=out)
            outs = _tensors(out)
            if outs and not (func.is_view or name in _FREE_OPS):
                self.tally(name, _nbytes(outs)
                           + _nbytes(_tensors((args, kwargs))))
        for st in self._storages(out):
            self._track(st)
        return out

    def result(self) -> Dict[str, Any]:
        """:func:`analyze_hlo`'s keys, and ``collective_groups``: for each
        group a collective ran over, its ranks, count and bytes."""
        return {
            "flops": self.flops,
            "bytes": self.bytes,
            "collective_bytes": self.coll_bytes,
            "collectives": self.coll_detail,
            "bytes_by_op": dict(sorted(self.bytes_by_op.items(),
                                       key=lambda kv: -kv[1])),
            "warnings": self.warnings,
            "collective_groups": [
                {"ranks": list(r), "size": len(r), **v}
                for r, v in sorted(self.groups.items())],
        }


def analyze_step(fn, *args, **kw):
    """``(cost, fn(*args, **kw))``: ``fn`` run once under a
    :class:`StepCost`; ``cost`` holds :func:`analyze_hlo`'s keys, the
    collective groups and ``memory`` (:meth:`StepCost.memory`)."""
    with StepCost() as cost:
        cost.arguments((args, kw))
        out = fn(*args, **kw)
    res = cost.result()
    res["memory"] = cost.memory(out)
    return res, out
