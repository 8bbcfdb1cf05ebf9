"""Per-op cost IR shared by every cost producer and consumer (port of
``repro/costmodel/``; see ledger.py)."""

from repro_torch.costmodel.ledger import OP_CLASSES, CostLedger, OpCost, classify_op

__all__ = ["OP_CLASSES", "CostLedger", "OpCost", "classify_op"]
