"""Stand-ins for the program's step, for the check's control and its
faults.  Each is a factory ``(entry, model) -> step`` that an entry takes
as ``program``.

* ``reference_program(kind)``: the reference put in the program's place,
  computed in ``kind`` (the control: ``"tf32"``, the nearest precision
  below float32 with TF32 off);
* ``unchanged``: a training step that returns its state unchanged; an
  inference step that returns its first answer again (a stale answer);
* ``half_batch``: the step sees the first half of the batch's rows (a
  training step's loss is the mean over that half; an inference step
  returns that half's logits twice);
* ``altered``: one answer altered where it is produced: logit (0, 0) of
  the model's output raised by 1.
"""

from __future__ import annotations

import torch

from perfbench.entries.cnn_common import leaves_in_order
from perfbench.reference import cnn as ref

__all__ = ["reference_program", "FAULTS"]


def _train(entry) -> bool:
    return entry.traffic["entry"].endswith("train")


def _port(entry, model):
    """The program's own step for ``entry``."""
    from perfbench.entries import cnn_infer, cnn_train

    make = cnn_train.port_step if _train(entry) else cnn_infer.port_infer
    return make(entry, model)


def reference_program(kind: str):
    def factory(entry, model):
        p, names = entry.shape.plan, entry.shape.names
        if _train(entry):
            opt = entry.shape.config["optimizer"]

            def step(params, mom, x, y):
                loss, _ = ref.sgd_step(p, names, leaves_in_order(params),
                                       leaves_in_order(mom), x, y, lr=opt["lr"],
                                       momentum=opt["momentum"], kind=kind)
                return params, mom, loss
            return step

        def infer(params, x):
            with torch.no_grad():
                return ref.forward(p, dict(zip(names, leaves_in_order(params))), x, kind)
        return infer
    return factory


def unchanged(entry, model):
    if _train(entry):
        def step(params, mom, x, y):
            with torch.no_grad():
                logits = model.apply(params, x)
            return params, mom, ref.loss_fn(logits, y)
        return step
    infer, first = _port(entry, model), []

    def stale(params, x):
        if not first:
            first.append(infer(params, x))
        return first[0]
    return stale


def half_batch(entry, model):
    inner = _port(entry, model)
    if _train(entry):
        def step(params, mom, x, y):
            h = x.shape[0] // 2
            return inner(params, mom, x[:h], y[:h])
        return step

    def infer(params, x):
        out = inner(params, x[: x.shape[0] // 2])
        return torch.cat([out, out])
    return infer


def altered(entry, model):
    apply = model.apply

    def apply_altered(params, x):
        logits = apply(params, x)
        bump = torch.zeros_like(logits)
        bump[0, 0] = 1.0
        return logits + bump

    model.apply = apply_altered
    return _port(entry, model)


FAULTS = {"unchanged": unchanged, "half_batch": half_batch, "altered": altered}
