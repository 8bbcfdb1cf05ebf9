"""Per-op cost record shared by the kernel tiling models (port of
``repro/costmodel/``; see ledger.py)."""

from repro_torch.costmodel.ledger import OP_CLASSES, OpCost, classify_op

__all__ = ["OP_CLASSES", "OpCost", "classify_op"]
