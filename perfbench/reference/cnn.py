"""Plain PyTorch CNNs (ResNet, MobileNetV2 and its kin), built from a
configuration file's layer list.

This is the benchmark's reference for the CNN cells: it imports nothing of
the program under test.  Activations are NHWC at its interface and NCHW
inside; convolution weights come in HWIO (a grouped convolution's I is
its group's width, 1 for a depthwise one) and the ``Dense`` weight as
(in, out), the layout the benchmark draws them in.

* convolution: ``F.conv2d`` with padding ``k // 2`` and ``groups``, no
  bias, then BatchNorm and the convolution's activation (``relu``,
  ``relu6`` = min(max(x, 0), 6), or ``none``);
* BatchNorm: batch statistics, biased variance, ``eps`` inside the rsqrt,
  then ``scale`` and ``shift`` (no running statistics: the training-mode
  layer that the profiled step runs);
* ``block: bottleneck`` or ``basic`` (arXiv:1512.03385): a residual block,
  ``relu(body(x) + shortcut(x))``, the shortcut a 1 x 1 convolution with
  BatchNorm where the stride or the width changes; a bottleneck body is
  1 x 1, 3 x 3 (carrying the stride), 1 x 1, a basic body is 3 x 3
  (carrying the stride), 3 x 3; the body's last BatchNorm and the
  shortcut have no activation;
* ``block: inverted_residual`` (MobileNetV2, arXiv:1801.04381 §3.3 and
  Tables 1-2): a 1 x 1 expansion to ``t`` times the input's width with
  ``relu6`` (only where ``t`` > 1), a ``k`` x ``k`` depthwise convolution
  (groups = channels) carrying the stride with ``relu6``, and a linear 1 x 1
  projection (no activation); the block's input is added, with no
  activation after the add, only where the stride is 1 and the width does
  not change; then a 1 x 1 head convolution (``head_conv``) before the
  pooling.  Departures from the paper: BatchNorm keeps batch statistics
  (the profiled training-mode step), there is no dropout before the
  classifier, and the classifier has 100 classes (CIFAR-100's, as the
  other configurations);
* head: the mean over the spatial positions, then ``Dense``;
* loss: the mean negative log-likelihood of ``log_softmax``;
* update: SGD with momentum, ``m = momentum * m + g``, ``p = p - lr * m``.

``precision`` is ``"float32"`` (TF32 off for convolutions and matrix
products) or ``"tf32"``, the nearest precision below, which is the
benchmark's control.  On the CPU, which has no TF32, ``"tf32"`` rounds the
operands of every convolution and matrix product to TF32's 10 mantissa
bits before an f32 product.
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass

import torch
import torch.nn.functional as F

__all__ = ["Conv", "Block", "Plan", "plan", "param_specs", "forward", "loss_fn",
           "sgd_step", "train_steps", "precision"]


@dataclass(frozen=True)
class Conv:
    """One convolution in ``groups`` groups, BatchNorm after it, then the
    activation ``act`` (``relu``, ``relu6`` or ``none``); ``h``, ``w`` are
    the input's spatial size."""
    name: str
    cin: int
    cout: int
    k: int
    stride: int
    act: str
    h: int
    w: int
    groups: int = 1

    @property
    def pad(self) -> int:
        return self.k // 2

    @property
    def oh(self) -> int:
        return 1 + (self.h + 2 * self.pad - self.k) // self.stride

    @property
    def ow(self) -> int:
        return 1 + (self.w + 2 * self.pad - self.k) // self.stride


@dataclass(frozen=True)
class Block:
    """``body``, and where ``add``: ``act(body(x) + shortcut(x))``, the
    shortcut the identity where it is None."""
    body: tuple[Conv, ...]
    shortcut: Conv | None
    add: bool = True
    act: str = "relu"


@dataclass(frozen=True)
class Plan:
    stem: Conv
    blocks: tuple[Block, ...]
    dense_in: int
    dense_out: int
    eps: float
    head: Conv | None = None

    def convs(self) -> list[Conv]:
        """Every convolution in the order the network runs them (a block's
        body, then its shortcut; the head convolution last)."""
        out = [self.stem]
        for b in self.blocks:
            out += list(b.body)
            if b.shortcut is not None:
                out.append(b.shortcut)
        if self.head is not None:
            out.append(self.head)
        return out


def _projection(name, c, out, s, h) -> Conv | None:
    return Conv(f"{name}.sc", c, out, 1, s, "none", h, h) if s != 1 or c != out else None


def _bottleneck(name: str, stage: dict, c: int, h: int, s: int) -> Block:
    mid, out = stage["mid"], stage["out"]
    a = Conv(f"{name}.a", c, mid, 1, 1, "relu", h, h)
    b = Conv(f"{name}.b", mid, mid, 3, s, "relu", h, h)
    body = (a, b, Conv(f"{name}.c", mid, out, 1, 1, "none", b.oh, b.oh))
    return Block(body, _projection(name, c, out, s, h))


def _basic(name: str, stage: dict, c: int, h: int, s: int) -> Block:
    mid, out = stage["mid"], stage["out"]
    a = Conv(f"{name}.a", c, mid, 3, s, "relu", h, h)
    body = (a, Conv(f"{name}.b", mid, out, 3, 1, "none", a.oh, a.oh))
    return Block(body, _projection(name, c, out, s, h))


def _inverted_residual(name: str, stage: dict, c: int, h: int, s: int) -> Block:
    t, out, k = stage["t"], stage["out"], stage["k"]
    e = t * c
    body = [Conv(f"{name}.expand", c, e, 1, 1, "relu6", h, h)] if t > 1 else []
    dw = Conv(f"{name}.dw", e, e, k, s, "relu6", h, h, groups=e)
    body += [dw, Conv(f"{name}.project", e, out, 1, 1, "none", dw.oh, dw.oh)]
    return Block(tuple(body), None, add=s == 1 and c == out, act="none")


_BLOCKS = {"bottleneck": _bottleneck, "basic": _basic, "inverted_residual": _inverted_residual}


def plan(config: dict) -> Plan:
    """The network that ``config`` describes: ``stem`` (``out``, ``k``,
    ``stride``, and ``act``, ``relu`` where it is absent), ``block``,
    ``stages``, ``input_hw``, ``in_channels``, ``num_classes``, and
    ``head_conv`` (``out``, ``act``) where the network has one.  A stage
    is ``blocks``, ``mid``, ``out``, ``stride`` for ``bottleneck`` and
    ``basic`` blocks, and ``t``, ``out``, ``blocks``, ``stride``, ``k`` for
    ``inverted_residual`` ones."""
    if config["block"] not in _BLOCKS:
        raise ValueError(f"unknown block {config['block']!r}")
    make = _BLOCKS[config["block"]]
    hw = config["input_hw"]
    st = config["stem"]
    stem = Conv("stem", config["in_channels"], st["out"], st["k"], st["stride"],
                st.get("act", "relu"), hw, hw)
    h, c = stem.oh, stem.cout
    blocks = []
    for si, stage in enumerate(config["stages"]):
        for bi in range(stage["blocks"]):
            block = make(f"s{si}b{bi}", stage, c, h, stage["stride"] if bi == 0 else 1)
            blocks.append(block)
            h, c = block.body[-1].oh, stage["out"]
    head = None
    if "head_conv" in config:
        hc = config["head_conv"]
        head = Conv("head", c, hc["out"], 1, 1, hc["act"], h, h)
        c = head.cout
    return Plan(stem, tuple(blocks), c, config["num_classes"],
                float(config["batchnorm"]["eps"]), head)


def param_specs(p: Plan) -> list[tuple[str, tuple[int, ...], str, int]]:
    """(name, shape, init, fan_in) of every parameter, in the order the
    network uses them: per convolution its HWIO weight (I its group's
    width), BatchNorm scale and shift; the ``Dense`` weight (in, out) and
    bias last.  ``init`` is ``he`` (normal with std sqrt(2 / fan_in)),
    ``ones`` or ``zeros``."""
    out = []
    for c in p.convs():
        i = c.cin // c.groups
        out += [(f"{c.name}.w", (c.k, c.k, i, c.cout), "he", c.k * c.k * i),
                (f"{c.name}.scale", (c.cout,), "ones", 0),
                (f"{c.name}.shift", (c.cout,), "zeros", 0)]
    out += [("fc.w", (p.dense_in, p.dense_out), "he", p.dense_in),
            ("fc.b", (p.dense_out,), "zeros", 0)]
    return out


# ---------------------------------------------------------------------------
# Precision
# ---------------------------------------------------------------------------


@contextlib.contextmanager
def precision(kind: str):
    """TF32 on (``"tf32"``) or off (``"float32"``) for cuDNN convolutions
    and matrix products inside the block; the previous flags come back."""
    if kind not in ("float32", "tf32"):
        raise ValueError(f"unknown precision {kind!r}")
    on = kind == "tf32"
    prev = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = on
    torch.backends.cuda.matmul.allow_tf32 = on
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = prev


def _tf32(t: torch.Tensor) -> torch.Tensor:
    """``t`` (f32) rounded to nearest at TF32's 10 mantissa bits."""
    bits = t.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def _operands(kind: str, *ts):
    """The operands of one product, rounded to TF32 on the CPU under
    ``"tf32"`` (the gradient passes the rounding unchanged)."""
    if kind == "tf32" and ts[0].device.type == "cpu":
        return tuple(t + (_tf32(t.detach()) - t.detach()) for t in ts)
    return ts


# ---------------------------------------------------------------------------
# Forward, loss and the update
# ---------------------------------------------------------------------------


def _act(y: torch.Tensor, act: str) -> torch.Tensor:
    if act == "relu":
        return torch.relu(y)
    if act == "relu6":
        return torch.clamp(y, 0.0, 6.0)
    if act == "none":
        return y
    raise ValueError(f"unknown activation {act!r}")


def _conv_bn(c: Conv, params: dict, x: torch.Tensor, eps: float, kind: str):
    w = params[f"{c.name}.w"].permute(3, 2, 0, 1)          # HWIO -> OIHW
    x, w = _operands(kind, x, w)
    y = F.conv2d(x, w, stride=c.stride, padding=c.pad, groups=c.groups)
    mu = y.mean(dim=(0, 2, 3), keepdim=True)
    var = y.var(dim=(0, 2, 3), unbiased=False, keepdim=True)
    y = (y - mu) * torch.rsqrt(var + eps)
    y = y * params[f"{c.name}.scale"][None, :, None, None] \
        + params[f"{c.name}.shift"][None, :, None, None]
    return _act(y, c.act)


def forward(p: Plan, params: dict, x: torch.Tensor, kind: str = "float32"):
    """Logits (N, classes) of NHWC ``x``; ``params`` by the names of
    :func:`param_specs`."""
    with precision(kind):
        h = _conv_bn(p.stem, params, x.permute(0, 3, 1, 2), p.eps, kind)
        for b in p.blocks:
            y = h
            for c in b.body:
                y = _conv_bn(c, params, y, p.eps, kind)
            if b.add:
                sc = h if b.shortcut is None else _conv_bn(b.shortcut, params, h, p.eps, kind)
                y = _act(y + sc, b.act)
            h = y
        if p.head is not None:
            h = _conv_bn(p.head, params, h, p.eps, kind)
        h = h.mean(dim=(2, 3))
        h, w = _operands(kind, h, params["fc.w"])
        return h @ w + params["fc.b"]


def loss_fn(logits: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    return -torch.log_softmax(logits, dim=-1).gather(1, y.long()[:, None]).mean()


def sgd_step(p: Plan, names: list[str], params: list[torch.Tensor],
             mom: list[torch.Tensor], x, y, *, lr: float, momentum: float,
             kind: str = "float32"):
    """One step in place on ``params`` and ``mom`` (in ``names``' order);
    returns the loss and the gradients."""
    for t in params:
        t.requires_grad_(True)
    with torch.enable_grad(), precision(kind):
        loss = loss_fn(forward(p, dict(zip(names, params)), x, kind), y)
        grads = torch.autograd.grad(loss, params)
    with torch.no_grad():
        for m, g, t in zip(mom, grads, params):
            m.mul_(momentum).add_(g)
            t.add_(m, alpha=-lr)
    return loss.detach(), grads


def train_steps(p: Plan, names: list[str], leaves: list[torch.Tensor], batches,
                *, lr: float, momentum: float, kind: str = "float32"):
    """SGD with momentum from ``leaves`` (not modified), one step per
    (x, y) of ``batches``.  Returns the losses, the per-leaf norms of the
    first gradient, and the per-leaf norms of the parameters' change after
    the last step (each a 1-D tensor in ``names``' order)."""
    params = [t.detach().clone() for t in leaves]
    mom = [torch.zeros_like(t) for t in params]
    losses, g1 = [], None
    for x, y in batches:
        loss, grads = sgd_step(p, names, params, mom, x, y, lr=lr,
                               momentum=momentum, kind=kind)
        if g1 is None:
            g1 = torch.stack([g.norm() for g in grads])
        losses.append(loss)
        del grads
    with torch.no_grad():
        change = torch.stack([(t - t0).norm() for t, t0 in zip(params, leaves)])
    return torch.stack(losses), g1, change
