"""A CNN inference step: the program's ``core.profiler.make_infer_fn``
(the forward under ``no_grad``, paper §6.4's φ), closed loop over a pool
of batches.

Set-up runs ``warmup_steps`` calls on pool batches 0, 1, ...; the window
goes on cycling the pool.  The check compares a sample of the window's
outputs, drawn from the seed (every ``keep_every``-th call from an offset
the seed picks, and the last call), each with the reference's logits of
its batch (``reference.cnn``), once the window has closed."""

from __future__ import annotations

import random

import torch

from perfbench import compare
from perfbench.counts import cnn_step_costs
from perfbench.entries.cnn_common import CnnShape, draw_inputs, port_model, port_tree
from perfbench.reference import cnn as ref

__all__ = ["Entry", "port_infer"]


def port_infer(entry: "Entry", model):
    """The program's forward: ``infer(params, x) -> logits``."""
    from repro_torch.core import profiler

    return profiler.make_infer_fn(model)


class Entry:
    def __init__(self, cell, seed: int, device, program=None):
        self.cell, self.seed, self.device = cell, int(seed), torch.device(device)
        self.shape = CnnShape(cell.config)
        self.traffic = cell.traffic
        self.items_per_step = int(self.traffic["batch_size"])
        self.program = program or port_infer
        self.every = int(self.traffic["keep_every"])
        self.phase = random.Random(self.seed).randrange(self.every)
        self.kept: list[tuple[int, torch.Tensor]] = []
        self.last = None

    def setup(self) -> None:
        model = port_model(self.shape.config)
        leaves, self.x, _ = draw_inputs(self.shape, self.traffic, self.seed, self.device)
        self.pool = self.x.shape[0]
        self.params = port_tree(model, self.shape, leaves)
        self.infer = self.program(self, model)
        warm = int(self.traffic["warmup_steps"])
        for i in range(warm):
            self.infer(self.params, self.x[i % self.pool])
        self.offset = warm
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def call(self, i: int):
        return self.infer(self.params, self.x[(self.offset + i) % self.pool])

    def keep(self, i: int, out) -> None:
        j = (self.offset + i) % self.pool
        if i % self.every == self.phase:
            self.kept.append((j, out))
        self.last = (j, out)

    def _compared(self):
        out = list(self.kept)
        if self.last is not None and (not out or out[-1][1] is not self.last[1]):
            out.append(self.last)
        return out

    def failed(self) -> int:
        return sum(int(not torch.isfinite(o).all()) for _, o in self._compared())

    def release(self) -> None:
        self.kept = self._compared()
        self.last = None
        self.params = self.infer = self.x = None

    def readings(self) -> dict[str, float]:
        leaves, x, _ = draw_inputs(self.shape, self.traffic, self.seed, self.device)
        params = dict(zip(self.shape.names, leaves))
        ref_logits = {}
        gap = 0.0
        with torch.no_grad():
            for j, out in self.kept:
                if j not in ref_logits:
                    ref_logits[j] = ref.forward(self.shape.plan, params, x[j])
                gap = max(gap, compare.logits_gap(out, ref_logits[j]))
        self.kept = []
        return {"logits_gap": gap} if ref_logits else {}

    def costs(self):
        return cnn_step_costs(self.shape.plan, self.items_per_step, train=False)
