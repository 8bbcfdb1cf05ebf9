"""Operations and bytes of one CNN step, from the configuration's shapes.

The benchmark's own arithmetic, kept apart from the program's counters so
that a change to the program cannot move the yardstick.

* A convolution's products: ``2 * N * OH * OW * O * KH * KW * C / groups``
  flops, the same for the forward, the input gradient (dgrad) and the
  weight gradient (wgrad).
* Its bytes, each operand read once and the result written once: forward
  x, w read and y written; dgrad gy, w read and dx written; wgrad gy, x
  read and dw written; w holds ``KH * KW * C / groups * O`` numbers.
* ``Dense``: ``2 * N * in * out`` flops for the forward and for each of
  its two gradients.
* A training step has no dgrad for the stem (its input needs none).
  Elementwise work (BatchNorm, activations, pooling, loss, the update) is
  not counted.
"""

from __future__ import annotations

from dataclasses import dataclass

from perfbench.reference.cnn import Conv, Plan

__all__ = ["ConvCost", "StepCosts", "conv_costs", "step_flops", "bound_s", "cnn_step_costs"]


@dataclass(frozen=True)
class ConvCost:
    """flops and bytes of one convolution pass (``kind``: fwd, dgrad,
    wgrad) at batch ``n``."""
    name: str
    kind: str
    flops: float
    bytes: float


def _conv(c: Conv, n: int, kind: str, elt: int) -> ConvCost:
    i = c.cin // c.groups
    x = n * c.h * c.w * c.cin
    w = c.k * c.k * i * c.cout
    y = n * c.oh * c.ow * c.cout
    flops = 2.0 * n * c.oh * c.ow * c.cout * c.k * c.k * i
    moved = {"fwd": x + w + y, "dgrad": y + w + x, "wgrad": y + x + w}[kind]
    return ConvCost(c.name, kind, flops, float(moved * elt))


def conv_costs(p: Plan, n: int, kinds=("fwd",), elt: int = 4) -> list[ConvCost]:
    """One :class:`ConvCost` per convolution and pass in ``kinds``; the
    stem has no dgrad."""
    out = []
    for c in p.convs():
        for kind in kinds:
            if kind == "dgrad" and c is p.stem:
                continue
            out.append(_conv(c, n, kind, elt))
    return out


def step_flops(p: Plan, n: int, train: bool) -> float:
    """Convolution and ``Dense`` flops of one step at batch ``n``: the
    forward, and in training the dgrad (not the stem's) and the wgrad."""
    kinds = ("fwd", "dgrad", "wgrad") if train else ("fwd",)
    conv = sum(c.flops for c in conv_costs(p, n, kinds))
    dense = 2.0 * n * p.dense_in * p.dense_out * (3 if train else 1)
    return conv + dense


def bound_s(costs, peak_flops: float, peak_bytes: float) -> float:
    """The least time the chip could take for ``costs``: per pass the
    larger of its flops over the peak rate and its bytes over the peak
    bandwidth, summed."""
    return sum(max(c.flops / peak_flops, c.bytes / peak_bytes) for c in costs)


@dataclass(frozen=True)
class StepCosts:
    """What the per-layer readers price one step by: its flops (every
    pass); ``fwd``, the forward passes of the dense (groups = 1)
    convolutions, which ``conv_mm`` runs; ``bwd``, every backward pass
    (training), all of which run under ``aten::convolution_backward``; and
    ``dw``, every pass of the grouped convolutions."""
    step_flops: float
    fwd: tuple[ConvCost, ...]
    bwd: tuple[ConvCost, ...] = ()
    dw: tuple[ConvCost, ...] = ()


def cnn_step_costs(p: Plan, n: int, train: bool) -> StepCosts:
    grouped = {c.name for c in p.convs() if c.groups > 1}
    costs = conv_costs(p, n, ("fwd", "dgrad", "wgrad") if train else ("fwd",))
    return StepCosts(step_flops(p, n, train),
                     tuple(c for c in costs if c.kind == "fwd" and c.name not in grouped),
                     tuple(c for c in costs if c.kind != "fwd"),
                     tuple(c for c in costs if c.name in grouped))
