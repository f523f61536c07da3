"""Executed, per-device costs of one rank's traced program (port of
``repro.launch.hlo_analysis``; the port reads the ops PyTorch dispatches
where the reference reads compiled HLO text).

The reference parses the SPMD-partitioned module and multiplies each
``while`` body's costs by its trip count, because XLA's own cost analysis
visits a loop body once.  The port's program runs eagerly: a
:class:`TraceAnalyzer` (a ``TorchDispatchMode``) sees every op of every
microbatch and every layer as it is dispatched, forward and backward, so
its counts are executed counts by construction and no multiplier is
applied.  Traced on meta tensors (the dry run, ``repro_torch.launch.dryrun``)
nothing is computed and no device is touched; traced on real tensors it
counts the same ops.

Per-device quantities (:class:`HloCosts`, the reference's fields):

* ``dot_flops``         2 · |result| · |contraction| of each contraction:
                        ``aten.mm``, ``addmm``, ``bmm`` and ``baddbmm`` (the
                        model's ``@`` and ``einsum`` reach these; the traces
                        of every arch show no other)
* ``dot_bytes``         operand + result bytes of those ops
* ``op_bytes``          HBM-traffic proxy: input + output bytes of every op
                        that is not a view or metadata op.  In eager PyTorch
                        every such op is a kernel boundary, which is the
                        reference's rule of counting bytes at fusion
                        boundaries only.  A view (an op whose outputs all
                        share an input's storage and write nothing: views,
                        ``detach``, ``_unsafe_view``) and an allocation
                        (``empty`` and its kin) move no bytes
* ``collective_bytes``  per collective, under the reference's opcode names
                        (:data:`C10D_OPS`), by the reference's byte rule: an
                        all-gather its result's bytes, every other its
                        operand's.  A ``c10d`` op outside the map fails the
                        trace: no op is dropped.  A collective's operand and
                        result bytes also count in ``op_bytes``
* ``by_opcode``         ``op_bytes`` by op (diagnosis aid)

Beside them the analyzer keeps what the trace alone can tell:

* ``kernels``: the hand-written kernels' stand-ins (their wrappers' shape
  functions on meta tensors): launches, operations and bytes by kernel, and
  the launches by shape.
  Their bytes count in ``op_bytes`` (and ``by_opcode``), their operations
  in ``kernel_flops``, apart from ``dot_flops``;
* ``op_count``: the ops dispatched (where the reference keeps the HLO
  text's length);
* ``peak_bytes``: the most bytes alive at once in storages on the traced
  device, the arguments (:meth:`TraceAnalyzer.hold`) included.  Each
  storage is keyed by ``untyped_storage()._cdata``, so views count once,
  and released by a ``weakref.finalize`` on the storage when its last
  tensor goes.
"""

from __future__ import annotations

import dataclasses
import weakref

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

from repro_torch.kernels import META_SINKS

__all__ = ["HloCosts", "COLLECTIVE_OPS", "C10D_OPS", "DOT_OPS", "TraceAnalyzer", "tensors_of"]

COLLECTIVE_OPS = (
    "all-reduce",
    "all-gather",
    "reduce-scatter",
    "all-to-all",
    "collective-permute",
)

# c10d op -> (the reference's opcode, the argument whose bytes count): an
# all-gather's output, every other collective's operand.  ``broadcast_`` (the
# pipeline stages' hand-off, ``dist/pipeline.py``) keeps its own name.
C10D_OPS = {
    "allreduce_": ("all-reduce", 0),
    "allgather_": ("all-gather", 0),
    "_allgather_base_": ("all-gather", 0),
    "reduce_scatter_": ("reduce-scatter", 1),
    "_reduce_scatter_base_": ("reduce-scatter", 1),
    "reduce_scatter_tensor_coalesced_": ("reduce-scatter", 1),
    "alltoall_": ("all-to-all", 1),
    "alltoall_base_": ("all-to-all", 1),
    "broadcast_": ("broadcast", 0),
}

# contraction -> the argument whose last dim is the contraction
DOT_OPS = {"mm": 0, "addmm": 1, "bmm": 0, "baddbmm": 1}

# allocations: an output whose bytes nothing writes
_ALLOCATIONS = {"empty", "empty_like", "empty_strided", "new_empty", "new_empty_strided"}


@dataclasses.dataclass
class HloCosts:
    """Executed, per-device costs of a traced program."""

    dot_flops: float = 0.0
    dot_bytes: float = 0.0
    op_bytes: float = 0.0
    collective_bytes: dict[str, float] = dataclasses.field(default_factory=dict)
    by_opcode: dict[str, float] = dataclasses.field(default_factory=dict)

    @property
    def total_collective_bytes(self) -> float:
        return sum(self.collective_bytes.values())

    def add(self, other: "HloCosts", mult: float = 1.0) -> None:
        self.dot_flops += other.dot_flops * mult
        self.dot_bytes += other.dot_bytes * mult
        self.op_bytes += other.op_bytes * mult
        for k, v in other.collective_bytes.items():
            self.collective_bytes[k] = self.collective_bytes.get(k, 0.0) + v * mult
        for k, v in other.by_opcode.items():
            self.by_opcode[k] = self.by_opcode.get(k, 0.0) + v * mult

    def to_json(self) -> dict:
        return {
            "dot_flops": self.dot_flops,
            "dot_bytes": self.dot_bytes,
            "op_bytes": self.op_bytes,
            "collective_bytes": dict(self.collective_bytes),
        }


def tensors_of(tree) -> list[torch.Tensor]:
    """The tensors of a tree of dicts, lists, tuples and dataclasses (a
    ``TrainState``)."""
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        tree = [getattr(tree, f.name) for f in dataclasses.fields(tree)]
    if isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, (list, tuple)):
        return [t for x in tree for t in tensors_of(x)]
    return [t for t in tree_leaves(tree) if isinstance(t, torch.Tensor)]



def _nbytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in tensors_of(tree))


class TraceAnalyzer(TorchDispatchMode):
    """Counts the ops dispatched while it is active (``with analyzer:``).

    ``device`` is the device type whose storages the live-bytes peak
    follows (``"meta"`` for the dry run).  Enter it once."""

    def __init__(self, device: str = "meta"):
        super().__init__()
        self.device = device
        self.costs = HloCosts()
        self.kernel_flops = 0.0
        self.kernels: dict[str, dict] = {}
        self.op_count = 0
        self.live_bytes = 0
        self.peak_bytes = 0
        self._live: dict[int, int] = {}  # storage _cdata -> its bytes

    # -- the live storages ----------------------------------------------------
    def hold(self, tree) -> int:
        """Count the storages of ``tree``'s tensors on the traced device as
        alive from now on (a step's arguments, made before the trace); the
        bytes of those not yet counted."""
        return sum(self._track(t) for t in tensors_of(tree))

    def _track(self, t: torch.Tensor) -> int:
        if t.device.type != self.device:
            return 0
        storage = t.untyped_storage()
        key = storage._cdata
        if key in self._live:
            return 0
        n = storage.nbytes()
        self._live[key] = n
        self.live_bytes += n
        self.peak_bytes = max(self.peak_bytes, self.live_bytes)
        weakref.finalize(storage, self._release, key)
        return n

    def _release(self, key: int) -> None:
        self.live_bytes -= self._live.pop(key, 0)

    def storage_keys(self, tree) -> set[int]:
        return {t.untyped_storage()._cdata for t in tensors_of(tree)}

    # -- the kernels' stand-ins -------------------------------------------------
    def _kernel(self, name: str, flops: float, nbytes: int, shape: str) -> None:
        k = self.kernels.setdefault(name, {"launches": 0, "flops": 0.0, "bytes": 0,
                                           "shapes": {}})
        k["launches"] += 1
        k["flops"] += flops
        k["bytes"] += nbytes
        k["shapes"][shape] = k["shapes"].get(shape, 0) + 1
        self.kernel_flops += flops
        self.costs.op_bytes += nbytes
        self.costs.by_opcode[name] = self.costs.by_opcode.get(name, 0.0) + nbytes

    def __enter__(self):
        META_SINKS.append(self._kernel)
        return super().__enter__()

    def __exit__(self, *exc):
        try:
            return super().__exit__(*exc)
        finally:
            META_SINKS.remove(self._kernel)

    # -- every dispatched op ----------------------------------------------------
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if torch._C._dispatch_has_kernel_for_dispatch_key(
                func.name(), torch._C.DispatchKey.CompositeImplicitAutograd):
            # Under inference mode a composite op (``matmul``, ``to``,
            # ``reshape``) reaches the mode whole; the device runs what it
            # decomposes into, so count that.
            with self:
                out = func.decompose(*args, **kwargs)
            if out is not NotImplemented:
                return out
        out = func(*args, **kwargs)
        self.op_count += 1
        name = func.__name__.split(".")[0]
        costs = self.costs
        if func.namespace == "c10d":
            if name not in C10D_OPS:
                raise NotImplementedError(
                    f"c10d.{name}: a collective the analyzer has no opcode for")
            opcode, which = C10D_OPS[name]
            b = _nbytes(args[which])
            costs.collective_bytes[opcode] = costs.collective_bytes.get(opcode, 0.0) + b
        elif name in DOT_OPS:
            costs.dot_flops += 2.0 * out.numel() * args[DOT_OPS[name]].shape[-1]
            costs.dot_bytes += _nbytes([x for x in args if isinstance(x, torch.Tensor)]) \
                + _nbytes(out)
        outs = tensors_of(out)
        if func.namespace == "c10d" or (
                name not in _ALLOCATIONS and not self._is_view(func, args, kwargs, outs)):
            b = _nbytes((args, kwargs)) + _nbytes(outs)
            key = f"{func.namespace}.{name}"
            costs.op_bytes += b
            costs.by_opcode[key] = costs.by_opcode.get(key, 0.0) + b
        for t in outs:
            self._track(t)
        return out

    @staticmethod
    def _is_view(func, args, kwargs, outs) -> bool:
        """A view or metadata op: it writes nothing and every output shares an
        input's storage."""
        if not outs or any(r.alias_info is not None and r.alias_info.is_write
                           for r in func._schema.returns):
            return False
        if any(a.alias_info is not None and a.alias_info.is_write for a in func._schema.arguments):
            return False
        ins = {t.untyped_storage()._cdata for t in tensors_of((args, kwargs))}
        return all(t.untyped_storage()._cdata in ins for t in outs)
