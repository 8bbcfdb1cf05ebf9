"""A CNN training step: the program's ``core.profiler.make_train_step``
(forward, backward, SGD with momentum updated in place), closed loop over
a pool of batches.

Set-up drives the step from the seed through ``warmup_steps`` steps on
pool batches 0, 1, ... (all different rows); the window goes on from
there with the same state, the same call and the same feed.  Of the first
``checked_steps`` (3) the check keeps each loss, the per-leaf norms of the
momentum after step 1 (which is the first gradient, since the momentum
starts at 0) and the per-leaf norms of the parameters' change after step
3, read before step 4 overwrites them.  After the window the reference
runs the same three steps from the same inputs (``reference.cnn``)."""

from __future__ import annotations

import torch

from perfbench import compare
from perfbench.counts import cnn_step_costs
from perfbench.entries.cnn_common import CnnShape, draw_inputs, leaves_in_order, port_model, port_tree
from perfbench.reference import cnn as ref

__all__ = ["Entry", "port_step"]


def port_step(entry: "Entry", model):
    """The program's step: ``step(params, mom, x, y) -> (params, mom, loss)``."""
    from repro_torch.core import profiler

    opt = entry.shape.config["optimizer"]
    return profiler.make_train_step(model, lr=opt["lr"], momentum=opt["momentum"])


@torch.no_grad()
def _norms(leaves) -> torch.Tensor:
    return torch.stack(torch._foreach_norm(leaves))


@torch.no_grad()
def _change(leaves, start) -> torch.Tensor:
    return _norms(torch._foreach_sub(leaves, start))


class Entry:
    def __init__(self, cell, seed: int, device, program=None):
        self.cell, self.seed, self.device = cell, int(seed), torch.device(device)
        self.shape = CnnShape(cell.config)
        self.traffic = cell.traffic
        self.items_per_step = int(self.traffic["batch_size"])
        self.program = program or port_step
        self.losses: list[torch.Tensor] = []

    def setup(self) -> None:
        tr = self.traffic
        checked, warm = int(tr["checked_steps"]), int(tr["warmup_steps"])
        if warm < checked:
            raise ValueError("warmup_steps must cover checked_steps")
        model = port_model(self.shape.config)
        leaves, self.x, self.y = draw_inputs(self.shape, tr, self.seed, self.device)
        self.pool = self.x.shape[0]
        self.params = port_tree(model, self.shape, leaves)
        self.mom = port_tree(model, self.shape, [torch.zeros_like(t) for t in leaves])
        self.step = self.program(self, model)
        start = [t.clone() for t in leaves]
        losses = []
        for i in range(warm):
            self.params, self.mom, loss = self.step(self.params, self.mom,
                                                    self.x[i % self.pool],
                                                    self.y[i % self.pool])
            if i < checked:
                losses.append(loss.detach().reshape(()))
            if i == 0:
                g1 = _norms(leaves_in_order(self.mom))
            if i == checked - 1:
                change = _change(leaves_in_order(self.params), start)
                del start
        self.checked = (torch.stack(losses), g1, change)
        self.offset = warm
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def call(self, i: int):
        j = (self.offset + i) % self.pool
        self.params, self.mom, loss = self.step(self.params, self.mom, self.x[j], self.y[j])
        return loss

    def keep(self, i: int, out) -> None:
        self.losses.append(out)

    def failed(self) -> int:
        if not self.losses:
            return 0
        return int((~torch.isfinite(torch.stack([l.reshape(()) for l in self.losses]))).sum())

    def release(self) -> None:
        self.params = self.mom = self.step = self.x = self.y = None
        self.losses = []

    def readings(self) -> dict[str, float]:
        checked = int(self.traffic["checked_steps"])
        leaves, x, y = draw_inputs(self.shape, self.traffic, self.seed, self.device)
        opt = self.shape.config["optimizer"]
        loss_r, g1_r, change_r = ref.train_steps(
            self.shape.plan, self.shape.names, leaves,
            [(x[i % self.pool], y[i % self.pool]) for i in range(checked)],
            lr=opt["lr"], momentum=opt["momentum"])
        return compare.train_readings(self.checked, (loss_r, g1_r, change_r))

    def costs(self):
        return cnn_step_costs(self.shape.plan, self.items_per_step, train=True)
