"""The numbers that decide ``correct``, each a gap between the program's
reading and the reference's (0 where they agree), and the verdict.
``limits/<workload>.json`` names the numbers a cell compares; the others
are printed beside them, not compared.

* ``loss_gap``: the largest ``|L_prog - L_ref| / |L_ref|`` over the
  checked steps; ``loss1_gap`` the same of step 1 alone.
* ``grad_gap`` (the first gradient) and ``update_gap`` (the parameters'
  change after the checked steps), by the worst leaf: the gap between the
  program's norm of a leaf and the reference's, ``|n_prog - n_ref|``,
  over the larger of the reference's norm of that leaf and of the median
  leaf; ``update_median_gap`` is the median leaf's gap of the change.
  The change leaves out leaves whose reference gradient is under a
  thousandth of the median leaf's (they move by round-off alone);
  ``update_leaves_left_out`` counts them.
* ``logits_gap``: the largest ``max|y_prog - y_ref|`` of a compared output
  over the root mean square of the reference's logits.
"""

from __future__ import annotations

import math

import torch

__all__ = ["loss_gap", "leaf_gaps", "train_readings", "moved", "logits_gap", "verdict"]

TINY_GRAD = 1e-3          # of the median leaf's reference gradient norm


def loss_gap(prog: torch.Tensor, ref: torch.Tensor) -> float:
    prog, ref = prog.double().cpu(), ref.double().cpu()
    return float(((prog - ref).abs() / ref.abs()).max())


def leaf_gaps(prog: torch.Tensor, ref: torch.Tensor, keep: torch.Tensor | None = None):
    """Each leaf's gap of norms (see the module's note)."""
    prog, ref = prog.double().cpu(), ref.double().cpu()
    if keep is not None:
        prog, ref = prog[keep], ref[keep]
    return (prog - ref).abs() / torch.clamp(ref, min=float(ref.median()))


def train_readings(prog, ref) -> dict[str, float]:
    """The numbers of a training check from (losses, first-gradient norms,
    change norms) of the program and of the reference."""
    (loss_p, g1_p, ch_p), (loss_r, g1_r, ch_r) = prog, ref
    keep = moved(g1_r)
    grad, update = leaf_gaps(g1_p, g1_r), leaf_gaps(ch_p, ch_r, keep)
    return {"loss_gap": loss_gap(loss_p, loss_r),
            "loss1_gap": loss_gap(loss_p[:1], loss_r[:1]),
            "grad_gap": float(grad.max()),
            "update_gap": float(update.max()), "update_median_gap": float(update.median()),
            "update_leaves_left_out": float((~keep).sum())}


def moved(ref_grad: torch.Tensor) -> torch.Tensor:
    """The leaves whose reference gradient norm is at least a thousandth of
    the median leaf's."""
    ref_grad = ref_grad.double().cpu()
    return ref_grad >= TINY_GRAD * float(ref_grad.median())


def logits_gap(prog: torch.Tensor, ref: torch.Tensor) -> float:
    prog, ref = prog.double(), ref.double()
    if prog.shape != ref.shape:
        return math.inf
    return float((prog - ref).abs().max() / ref.pow(2).mean().sqrt())


def verdict(readings: dict[str, float], limits: dict[str, dict]) -> tuple[bool, dict]:
    """``correct`` and each compared number beside its limit (``limits``:
    name -> ``{"limit": ...}`` and the readings it was set from); a number with
    no reading, or a reading that is not finite, fails."""
    checks, ok = {}, True
    for name, spec in limits.items():
        limit = float(spec["limit"])
        value = readings.get(name, math.nan)
        checks[name] = {"value": value, "limit": limit}
        ok = ok and math.isfinite(value) and value <= limit
    return ok, checks
