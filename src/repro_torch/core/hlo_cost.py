"""The cost-ledger producer (port of ``repro/core/hlo_cost.py``).

There is no HLO here.  The reference compiles a step with XLA and parses
the optimized HLO text into a :class:`~repro_torch.costmodel.CostLedger`;
the port runs the step eagerly on **meta tensors** (shapes and dtypes, no
storage, nothing launched) under a
``torch.utils._python_dispatch.TorchDispatchMode`` and writes one
:class:`~repro_torch.costmodel.OpCost` per aten op — forward, autograd
backward (remat recompute included) and optimizer update alike.  The
module keeps the reference's name so that a reader finds the counterpart.

Per record:

* ``flops`` — matrix products and convolutions only, as the reference
  counts dots and convolutions only (its ``_dot_flops`` / ``_conv_flops``):
  the formulas of ``torch.utils.flop_counter.flop_registry`` (``mm``,
  ``addmm``, ``bmm``, ``baddbmm``, ``convolution``,
  ``convolution_backward``, the SDPA ops, …); every other op counts 0;
* ``hbm_bytes`` — the op's tensor inputs read plus its outputs written,
  each once.  Eager PyTorch fuses nothing, so every op reads and writes
  HBM (XLA counts only buffers outside its fusions: the port's bytes are
  the larger, by design).  View and alias ops (``view``, ``expand``,
  ``permute``, ``t``, ``as_strided``, ``_unsafe_view``, ``detach``, …)
  and uninitialised allocations (``empty*``) move 0 bytes;
* ``op`` — the HLO opcode the aten op corresponds to, so that the port's
  :func:`~repro_torch.costmodel.classify_op` classifies it as the
  reference would: products → ``dot``, convolutions → ``convolution``,
  ``sum``/``amax``/``mean``/… → ``reduce``, ``sort``/``topk`` → ``sort``,
  ``cat`` → ``concatenate``, gathers and scatters, copies and pads to
  their data-movement opcodes, any other aten op → an elementwise
  opcode, and an op of another namespace (a custom kernel) →
  ``custom-call`` (class ``other``), never dropped;
* ``dtype`` — the first output's dtype in HLO spelling (``bf16``, ``f32``);
* ``origin`` — ``"backward"`` for ops an autograd node runs, else
  ``"forward"``; ``trip_multiplier`` is 1 (eager runs every layer).

A sharded step (a ``DTensor`` program on a ``DeviceMesh``) is counted
per device.  The mode declines every op whose types include ``DTensor``
(``__torch_dispatch__`` returns ``NotImplemented``), so DTensor desugars
it and the mode sees the local ops on each shard: FLOPs and bytes of the
local shapes, and the collectives DTensor inserts on its own (a plain
mode over a DTensor program sees global shapes and no collective).  Ops
whose arguments are ``FakeTensor``s are DTensor's sharding propagation
and are not recorded.  Each collective (``core/hlo_analysis
.collective_kind``: all-gather, all-reduce, reduce-scatter, all-to-all,
collective-permute) is an ``OpCost`` with that opcode, class
``collective``, its operand and result bytes as ``hbm_bytes`` and its
ring-model bytes (``core/hlo_analysis.ring_bytes``, ``g`` the op's group
size) as ``collective_bytes``; ``bytes_by_kind``/``count_by_kind`` sum
them by kind.  A step on one device records none, so its
``collective_bytes`` is exactly 0.  ``HloCost``'s scalars are
left-to-right sums of the ledger, so ``sum(ledger) == aggregates`` holds
bit for bit by construction.
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass, field

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import flop_registry

from repro_torch.core.hlo_analysis import _group_of, collective_kind, ring_bytes
from repro_torch.costmodel import CostLedger, OpCost, classify_op
from repro_torch.launch.mesh import dtensor_type

__all__ = ["HloCost", "trace_cost", "recording", "aten_opcode"]

HLO_DTYPE = {
    torch.bool: "pred", torch.int8: "s8", torch.uint8: "u8",
    torch.int16: "s16", torch.float16: "f16", torch.bfloat16: "bf16",
    torch.int32: "s32", torch.float32: "f32", torch.int64: "s64",
    torch.float64: "f64", torch.complex64: "c64", torch.complex128: "c128",
}

_DOT = {"mm", "bmm", "addmm", "baddbmm", "addbmm", "addmv", "mv", "dot",
        "_scaled_mm", "linear"}
_REDUCE = {"sum", "mean", "amax", "amin", "max", "min", "prod", "var",
           "std", "var_mean", "std_mean", "norm", "linalg_vector_norm",
           "logsumexp", "argmax", "argmin", "any", "all", "cumsum",
           "cumprod", "aminmax"}
_SORT = {"sort", "topk", "argsort", "kthvalue", "msort"}
_MOVES = {
    "cat": "concatenate", "stack": "concatenate",
    "index": "gather", "index_select": "gather", "gather": "gather",
    "take": "gather", "embedding": "gather", "take_along_dim": "gather",
    "scatter": "scatter", "scatter_": "scatter", "scatter_add": "scatter",
    "scatter_add_": "scatter", "scatter_reduce": "scatter",
    "scatter_reduce_": "scatter", "index_put": "scatter",
    "index_put_": "scatter", "_index_put_impl_": "scatter",
    "index_add": "scatter", "index_add_": "scatter", "index_copy": "scatter",
    "index_copy_": "scatter", "masked_scatter": "scatter",
    "embedding_dense_backward": "scatter",
    "copy_": "copy", "_to_copy": "copy", "clone": "copy", "_copy_from": "copy",
    "_copy_from_and_resize": "copy", "roll": "copy",
    "constant_pad_nd": "pad", "pad": "pad",
    "flip": "reverse", "arange": "iota", "repeat": "broadcast",
    "zeros": "broadcast", "ones": "broadcast", "full": "broadcast",
    "zeros_like": "broadcast", "ones_like": "broadcast",
    "full_like": "broadcast", "new_zeros": "broadcast",
    "new_ones": "broadcast", "new_full": "broadcast", "fill": "broadcast",
    "fill_": "broadcast", "zero_": "broadcast", "scalar_tensor": "broadcast",
    "select_scatter": "dynamic-update-slice",
    "slice_scatter": "dynamic-update-slice",
    "as_strided_scatter": "dynamic-update-slice",
}
# an aliasing op the schema does not tag as a view, and allocations that
# write nothing: 0 bytes
_ALIAS = {"_unsafe_view"}
_ALLOC = {"empty", "empty_like", "empty_strided", "new_empty",
          "new_empty_strided", "empty_permuted"}


def aten_opcode(func) -> str:
    """The HLO opcode one aten op corresponds to (module docstring)."""
    packet = func.overloadpacket
    name = packet.__name__
    kind = collective_kind(func)
    if kind is not None:
        return kind
    if func.namespace in ("_c10d_functional", "c10d_functional") \
            and name in ("wait_tensor", "_wrap_tensor_autograd"):
        return "reshape"            # an alias of the collective's result
    if func.namespace not in ("aten", "prims"):
        return "custom-call"
    if packet in flop_registry:
        return "convolution" if "conv" in name else "dot"
    if name in _DOT:
        return "dot"
    if name in _REDUCE:
        return "reduce"
    if name in _SORT:
        return "sort"
    if name in _MOVES:
        return _MOVES[name]
    if getattr(func, "is_view", False) or name in _ALIAS:
        return "reshape"
    if name in _ALLOC:
        return "custom-call"
    return name.rstrip("_") or "custom-call"


def _tensors(tree) -> list[torch.Tensor]:
    return [t for t in tree_flatten(tree)[0] if isinstance(t, torch.Tensor)]


def _nbytes(tensors) -> float:
    return float(sum(t.numel() * t.element_size() for t in tensors))


@dataclass
class HloCost:
    """Aggregate view over a traced step's :class:`CostLedger`.

    ``flops``/``hbm_bytes``/``collective_bytes`` are left-to-right sums of
    ``ledger`` (the parity contract).  ``bytes_by_kind``/``count_by_kind``
    sum the collectives by kind (empty on one device); ``trip_counts``
    (loops) keeps the reference's field and stays empty on this loop-free
    path."""

    flops: float = 0.0
    hbm_bytes: float = 0.0
    collective_bytes: float = 0.0
    bytes_by_kind: dict = field(default_factory=dict)
    count_by_kind: dict = field(default_factory=dict)
    trip_counts: dict = field(default_factory=dict)
    ledger: CostLedger = field(default_factory=CostLedger)

    def by_class(self) -> dict:
        """Per-op-class sums (``repro_torch.costmodel`` taxonomy)."""
        return self.ledger.class_sums()


def _fake(tree) -> bool:
    return _any_fake(_tensors(tree))


def _any_fake(tensors) -> bool:
    from torch._subclasses.fake_tensor import FakeTensor

    return any(isinstance(t, FakeTensor) for t in tensors)


class _LedgerMode(TorchDispatchMode):
    """Writes one :class:`OpCost` per op that reaches the dispatcher on
    plain (local) tensors; a ``DTensor`` op is declined so that it
    desugars into its local ops and collectives."""

    def __init__(self, cost: "HloCost"):
        super().__init__()
        self.cost = cost
        self.ledger = cost.ledger

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if _DTENSOR is not None and any(issubclass(t, _DTENSOR) for t in types):
            return NotImplemented
        out = func(*args, **kwargs)
        ins = _tensors((args, kwargs))
        if _DTENSOR is not None and _any_fake(ins):
            return out                  # DTensor's sharding propagation
        opcode = aten_opcode(func)
        flops = coll = 0.0
        formula = flop_registry.get(func.overloadpacket)
        if formula is not None:
            flops = float(formula(*args, **kwargs, out_val=out))
        outs = _tensors(out)
        moves = opcode != "reshape" and func.overloadpacket.__name__ not in _ALLOC
        hbm = _nbytes(ins) + _nbytes(outs) if moves else 0.0
        if collective_kind(func) is not None:
            coll = ring_bytes(opcode, _nbytes(outs), _group_of(args, kwargs))
            self.cost.bytes_by_kind[opcode] = self.cost.bytes_by_kind.get(opcode, 0.0) + coll
            self.cost.count_by_kind[opcode] = self.cost.count_by_kind.get(opcode, 0) + 1
        self.ledger.append(OpCost(
            op=opcode,
            op_class=classify_op(opcode, dot_flops=flops if opcode == "dot" else 0.0,
                                 conv_flops=flops if opcode == "convolution" else 0.0),
            dtype=HLO_DTYPE.get(outs[0].dtype, str(outs[0].dtype)) if outs else "",
            flops=flops, hbm_bytes=hbm, collective_bytes=coll,
            origin="backward" if torch._C._current_autograd_node() is not None
            else "forward",
        ))
        return out


_DTENSOR = dtensor_type()


@contextlib.contextmanager
def recording():
    """Yield an :class:`HloCost` whose ledger records every aten op run
    inside the block; its scalars are summed from the ledger on exit."""
    cost = HloCost()
    with _LedgerMode(cost):
        yield cost
    cost.flops = cost.ledger.flops
    cost.hbm_bytes = cost.ledger.hbm_bytes
    cost.collective_bytes = cost.ledger.collective_bytes


def trace_cost(fn, *args, **kw) -> HloCost:
    """Run ``fn(*args, **kw)`` once under :func:`recording` and return its
    :class:`HloCost`.  Give it meta tensors (``transformer.param_specs``,
    ``transformer.input_specs``): nothing is then allocated or launched.
    On real tensors it records the same ledger while computing."""
    with recording() as cost:
        fn(*args, **kw)
    return cost
