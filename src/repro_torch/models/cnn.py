"""CNN zoo for the paper's profiling substrate (port of
``repro/models/cnn.py``; paper §5.1/§6).

The seven families (AlexNet, ResNet18/50, MobileNetV2, SqueezeNet,
MnasNet, GoogLeNet) are built from the same small declarative graph IR as
the reference, so one definition yields ``init``/``apply`` for profiling,
a :class:`~repro_torch.core.features.NetworkSpec` for the features, and a
``widths`` dict that pruning rewrites.  Shape propagation, widths and
``conv_specs()`` are pure Python and equal the reference's.

The public layout stays NHWC / HWIO, as in the reference, so parameters
and activations compare like with like and pruning scores sum the same
axes.  ``init`` draws the same numpy values as the reference, draw for
draw, so one seed gives the same parameter dict (numpy arrays);
:func:`repro_torch.convert.cnn_params_from_numpy` puts them on a device.
``apply`` takes torch tensors:

  * a groups = 1 convolution goes through ``kernels.conv_mm.conv_mm``:
    the hand-written CUDA kernel on the card, its plain version on the CPU;
  * a depthwise convolution runs ``torch.nn.functional.conv2d`` on
    channels-last views, in f32 (no TF32) forward and backward: the
    reference runs it through XLA, not through a Pallas kernel, and
    ``conv_mm`` does not take groups;
  * BatchNorm uses batch statistics with the biased variance and eps 1e-5
    inside the rsqrt, and keeps no running statistics (training mode, the
    profiled attribute);
  * max pooling pads with -inf and average pooling divides by the count
    of cells inside the image, as ``reduce_window`` does in the reference;
  * ``Dense`` flattens in NHWC order.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.core.features import ConvLayerSpec, NetworkSpec
from repro_torch.kernels.conv_mm.ops import conv_backward, conv_mm, fp32_convolutions

__all__ = [
    "CNNModel",
    "build_alexnet",
    "build_resnet18",
    "build_resnet50",
    "build_mobilenetv2",
    "build_squeezenet",
    "build_mnasnet",
    "build_googlenet",
    "CNN_BUILDERS",
    "canonical_widths",
    "iter_tagged",
]

NUM_CLASSES = 100  # CIFAR-100 is the paper's proxy dataset (via [19])


# ---------------------------------------------------------------------------
# Graph IR
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class Node:
    def out_shape(self, s: tuple[int, int, int], rec: list | None = None):
        raise NotImplementedError

    def init(self, rng, s):
        raise NotImplementedError

    def apply(self, params, x):
        raise NotImplementedError


def _act(x, kind: str):
    if kind == "relu":
        return torch.relu(x)
    if kind == "relu6":
        return torch.clamp(x, 0.0, 6.0)
    if kind == "none":
        return x
    raise ValueError(kind)


class _DepthwiseConv(torch.autograd.Function):
    """Depthwise convolution of NHWC x with HWIO w (C, 1 input each), in
    f32 both ways; the backward is ``conv_backward`` with groups = C."""

    @staticmethod
    def forward(ctx, x, w, stride, padding):
        ctx.save_for_backward(x, w)
        ctx.stride, ctx.padding = stride, padding
        with fp32_convolutions():
            y = F.conv2d(x.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1),
                         stride=stride, padding=padding, groups=x.shape[-1])
        return y.permute(0, 2, 3, 1).contiguous()

    @staticmethod
    def backward(ctx, gy):
        x, w = ctx.saved_tensors
        dx, dw = conv_backward(gy, x, w, stride=ctx.stride,
                               padding=ctx.padding, groups=x.shape[-1],
                               needs=ctx.needs_input_grad[:2])
        return dx, dw, None, None


@dataclass(frozen=True)
class C(Node):
    """Conv(+BN)(+act).  ``depthwise=True`` ties out=in, groups=channels.

    ``group`` names the prunable channel group this conv's filters belong to
    (the *primary* producer of that group) — used by the L1 pruning strategy
    to score filters.
    """

    out: int
    k: int
    stride: int = 1
    padding: int | None = None  # None = "same"-ish (k//2)
    depthwise: bool = False
    act: str = "relu"
    bn: bool = True
    bias: bool = False
    group: str | None = None

    @property
    def pad(self) -> int:
        return self.k // 2 if self.padding is None else self.padding

    def _geom(self, s):
        h, w, cin = s
        cout = cin if self.depthwise else self.out
        groups = cin if self.depthwise else 1
        oh = 1 + (h + 2 * self.pad - self.k) // self.stride
        ow = 1 + (w + 2 * self.pad - self.k) // self.stride
        return cin, cout, groups, oh, ow

    def out_shape(self, s, rec=None):
        cin, cout, groups, oh, ow = self._geom(s)
        if rec is not None:
            rec.append(
                ConvLayerSpec(
                    n=cout, m=cin, k=self.k, stride=self.stride,
                    padding=self.pad, groups=groups, ip=s[0],
                )
            )
        return (oh, ow, cout)

    def init(self, rng, s):
        cin, cout, groups, *_ = self._geom(s)
        fan_in = self.k * self.k * (cin // groups)
        p = {"w": (rng.standard_normal((self.k, self.k, cin // groups, cout))
                   * np.sqrt(2.0 / fan_in)).astype(np.float32)}
        if self.bias:
            p["b"] = np.zeros((cout,), np.float32)
        if self.bn:
            p["scale"] = np.ones((cout,), np.float32)
            p["shift"] = np.zeros((cout,), np.float32)
        return p

    def apply(self, params, x):
        if self.depthwise:
            y = _DepthwiseConv.apply(x, params["w"], self.stride, self.pad)
        else:
            y = conv_mm(x, params["w"], stride=self.stride, padding=self.pad)
        if self.bias:
            y = y + params["b"]
        if self.bn:
            mu = y.mean(dim=(0, 1, 2), keepdim=True)
            var = y.var(dim=(0, 1, 2), unbiased=False, keepdim=True)
            y = (y - mu) * torch.rsqrt(var + 1e-5)
            y = y * params["scale"] + params["shift"]
        return _act(y, self.act)


@dataclass(frozen=True)
class Seq(Node):
    nodes: tuple[Node, ...]

    def out_shape(self, s, rec=None):
        for n in self.nodes:
            s = n.out_shape(s, rec)
        return s

    def init(self, rng, s):
        params = {}
        for i, n in enumerate(self.nodes):
            params[str(i)] = n.init(rng, s)
            s = n.out_shape(s)
        return params

    def apply(self, params, x):
        for i, n in enumerate(self.nodes):
            x = n.apply(params[str(i)], x)
        return x


def seq(*nodes: Node) -> Seq:
    return Seq(tuple(nodes))


@dataclass(frozen=True)
class Residual(Node):
    """out = act(body(x) + shortcut(x)); identity shortcut when None."""

    body: Node
    shortcut: Node | None = None
    act: str = "relu"

    def out_shape(self, s, rec=None):
        out = self.body.out_shape(s, rec)
        sc = self.shortcut.out_shape(s, rec) if self.shortcut else s
        if out != sc:
            raise ValueError(f"residual mismatch: body {out} vs shortcut {sc}")
        return out

    def init(self, rng, s):
        p = {"body": self.body.init(rng, s)}
        if self.shortcut:
            p["shortcut"] = self.shortcut.init(rng, s)
        return p

    def apply(self, params, x):
        y = self.body.apply(params["body"], x)
        sc = self.shortcut.apply(params["shortcut"], x) if self.shortcut else x
        return _act(y + sc, self.act)


@dataclass(frozen=True)
class Concat(Node):
    branches: tuple[Node, ...]

    def out_shape(self, s, rec=None):
        outs = [b.out_shape(s, rec) for b in self.branches]
        hw = {(o[0], o[1]) for o in outs}
        if len(hw) != 1:
            raise ValueError(f"concat spatial mismatch: {outs}")
        return (outs[0][0], outs[0][1], sum(o[2] for o in outs))

    def init(self, rng, s):
        params = {}
        for i, b in enumerate(self.branches):
            params[str(i)] = b.init(rng, s)
        return params

    def apply(self, params, x):
        return torch.cat(
            [b.apply(params[str(i)], x) for i, b in enumerate(self.branches)], dim=-1
        )


@dataclass(frozen=True)
class Pool(Node):
    kind: str  # "max" | "avg"
    k: int
    stride: int
    padding: int = 0

    def out_shape(self, s, rec=None):
        h, w, c = s
        oh = 1 + (h + 2 * self.padding - self.k) // self.stride
        ow = 1 + (w + 2 * self.padding - self.k) // self.stride
        return (oh, ow, c)

    def init(self, rng, s):
        return {}

    def apply(self, params, x):
        xc = x.permute(0, 3, 1, 2)            # NCHW view of the NHWC tensor
        if self.kind == "max":                # implicit -inf padding
            y = F.max_pool2d(xc, self.k, self.stride, self.padding)
        else:                                 # mean over in-image cells only
            y = F.avg_pool2d(xc, self.k, self.stride, self.padding,
                             count_include_pad=False)
        return y.permute(0, 2, 3, 1).contiguous()


@dataclass(frozen=True)
class GlobalAvgPool(Node):
    def out_shape(self, s, rec=None):
        return (1, 1, s[2])

    def init(self, rng, s):
        return {}

    def apply(self, params, x):
        return x.mean(dim=(1, 2), keepdim=True)


@dataclass(frozen=True)
class Dense(Node):
    out: int
    act: str = "none"
    group: str | None = None

    def out_shape(self, s, rec=None):
        cin = int(np.prod(s))
        if rec is not None:
            # FC recorded as a 1x1 conv on a 1x1 map (exact allocations).
            rec.append(ConvLayerSpec(n=self.out, m=cin, k=1, ip=1))
        return (1, 1, self.out)

    def init(self, rng, s):
        cin = int(np.prod(s))
        return {
            "w": (rng.standard_normal((cin, self.out)) * np.sqrt(2.0 / cin)).astype(np.float32),
            "b": np.zeros((self.out,), np.float32),
        }

    def apply(self, params, x):
        x = x.reshape(x.shape[0], -1)        # NHWC order, as the reference
        return _act(x @ params["w"] + params["b"], self.act)


# ---------------------------------------------------------------------------
# Model container
# ---------------------------------------------------------------------------


@dataclass
class CNNModel:
    name: str
    family: str
    graph: Node
    widths: dict[str, int]
    input_hw: int = 32
    num_classes: int = NUM_CLASSES

    def conv_specs(self) -> NetworkSpec:
        rec: list[ConvLayerSpec] = []
        self.graph.out_shape((self.input_hw, self.input_hw, 3), rec)
        return NetworkSpec(name=self.name, layers=tuple(rec))

    def init(self, seed: "int | np.random.Generator" = 0) -> dict:
        """Initialise parameters as numpy arrays (He init), drawn exactly as
        the reference draws them."""
        rng = seed if isinstance(seed, np.random.Generator) else np.random.default_rng(seed)
        return self.graph.init(rng, (self.input_hw, self.input_hw, 3))

    def apply(self, params, x) -> torch.Tensor:
        """params: the nested dict of tensors (HWIO); x: (N, H, W, 3) NHWC
        → logits (N, num_classes)."""
        return self.graph.apply(params, x).reshape(x.shape[0], -1)

    def num_params(self) -> int:
        specs = self.conv_specs()
        return int(sum(l.n * l.m / l.groups * l.k**2 for l in specs.layers))


# ---------------------------------------------------------------------------
# Width utilities
# ---------------------------------------------------------------------------


def _scale_widths(widths: dict[str, int], mult: float, floor: int = 4) -> dict[str, int]:
    return {k: max(floor, int(round(v * mult))) for k, v in widths.items()}


def _w(widths: dict[str, int], key: str) -> int:
    if key not in widths:
        raise KeyError(f"missing width group {key!r}")
    return widths[key]


# ---------------------------------------------------------------------------
# AlexNet (used by the paper only to tune the training-set-size hyperparameter)
# ---------------------------------------------------------------------------

ALEXNET_WIDTHS = {"c1": 64, "c2": 192, "c3": 384, "c4": 256, "c5": 256, "fc1": 1024, "fc2": 1024}


def build_alexnet(widths=None, width_mult=1.0, input_hw=32) -> CNNModel:
    w = widths or _scale_widths(ALEXNET_WIDTHS, width_mult)
    g = seq(
        C(_w(w, "c1"), k=3, stride=2, group="c1"),
        Pool("max", 2, 2),
        C(_w(w, "c2"), k=3, group="c2"),
        Pool("max", 2, 2),
        C(_w(w, "c3"), k=3, group="c3"),
        C(_w(w, "c4"), k=3, group="c4"),
        C(_w(w, "c5"), k=3, group="c5"),
        Pool("max", 2, 2),
        Dense(_w(w, "fc1"), act="relu", group="fc1"),
        Dense(_w(w, "fc2"), act="relu", group="fc2"),
        Dense(NUM_CLASSES),
    )
    return CNNModel("alexnet", "alexnet", g, dict(w), input_hw)


# ---------------------------------------------------------------------------
# ResNet18 / ResNet50  (basic-block vs bottleneck residuals, App. C)
# ---------------------------------------------------------------------------


def _resnet18_widths() -> dict[str, int]:
    w = {"stem": 64}
    for si, c in enumerate([64, 128, 256, 512]):
        w[f"s{si}"] = c
        for bi in range(2):
            w[f"s{si}b{bi}"] = c  # internal 3x3 width, prunable independently
    return w


def build_resnet18(widths=None, width_mult=1.0, input_hw=32) -> CNNModel:
    w = widths or _scale_widths(_resnet18_widths(), width_mult)
    nodes: list[Node] = [C(_w(w, "stem"), k=3, group="stem")]
    in_group = "stem"
    for si in range(4):
        stride = 1 if si == 0 else 2
        for bi in range(2):
            s = stride if bi == 0 else 1
            out_c, mid_c = _w(w, f"s{si}"), _w(w, f"s{si}b{bi}")
            body = seq(
                C(mid_c, k=3, stride=s, group=f"s{si}b{bi}"),
                C(out_c, k=3, act="none", group=f"s{si}" if bi == 0 else None),
            )
            need_proj = s != 1 or _w(w, in_group) != out_c
            sc = C(out_c, k=1, stride=s, act="none") if need_proj else None
            nodes.append(Residual(body, sc))
            in_group = f"s{si}"
    nodes += [GlobalAvgPool(), Dense(NUM_CLASSES)]
    return CNNModel("resnet18", "resnet", seq(*nodes), dict(w), input_hw)


def _resnet50_widths() -> dict[str, int]:
    w = {"stem": 64}
    blocks = [3, 4, 6, 3]
    for si, (c_out, c_mid) in enumerate(zip([256, 512, 1024, 2048], [64, 128, 256, 512])):
        w[f"s{si}"] = c_out
        for bi in range(blocks[si]):
            w[f"s{si}b{bi}"] = c_mid
    return w


def build_resnet50(widths=None, width_mult=1.0, input_hw=32) -> CNNModel:
    w = widths or _scale_widths(_resnet50_widths(), width_mult)
    blocks = [3, 4, 6, 3]
    nodes: list[Node] = [C(_w(w, "stem"), k=3, group="stem")]
    in_group = "stem"
    for si in range(4):
        stride = 1 if si == 0 else 2
        for bi in range(blocks[si]):
            s = stride if bi == 0 else 1
            out_c, mid_c = _w(w, f"s{si}"), _w(w, f"s{si}b{bi}")
            body = seq(
                C(mid_c, k=1, group=f"s{si}b{bi}"),
                C(mid_c, k=3, stride=s),
                C(out_c, k=1, act="none", group=f"s{si}" if bi == 0 else None),
            )
            need_proj = s != 1 or _w(w, in_group) != out_c
            sc = C(out_c, k=1, stride=s, act="none") if need_proj else None
            nodes.append(Residual(body, sc))
            in_group = f"s{si}"
    nodes += [GlobalAvgPool(), Dense(NUM_CLASSES)]
    return CNNModel("resnet50", "resnet", seq(*nodes), dict(w), input_hw)


# ---------------------------------------------------------------------------
# MobileNetV2 / MnasNet  (depthwise-separable inverted residuals, App. C)
# ---------------------------------------------------------------------------

_MBV2_SETTINGS = [  # (expansion t, out c, repeats n, stride s) — ImageNet strides
    (1, 16, 1, 1), (6, 24, 2, 2), (6, 32, 3, 2), (6, 64, 4, 2),
    (6, 96, 3, 1), (6, 160, 3, 2), (6, 320, 1, 1),
]


def _mbnet_widths(settings, stem=32, head=1280) -> dict[str, int]:
    w = {"stem": stem, "head": head}
    idx = 0
    for t, c, n, s in settings:
        for bi in range(n):
            w[f"b{idx}_out"] = c
            if t > 1:
                w[f"b{idx}_exp"] = t * (stem if idx == 0 else settings_in(settings, idx))
            idx += 1
    return w


def settings_in(settings, flat_idx):
    """Input channels of flattened block ``flat_idx`` under canonical widths."""
    idx = 0
    prev_c = None
    for t, c, n, s in settings:
        for bi in range(n):
            if idx == flat_idx:
                return prev_c if prev_c is not None else c
            prev_c = c
            idx += 1
    raise IndexError(flat_idx)


def _build_mbnet(name, settings, widths, width_mult, input_hw, kernel_per_stage=None):
    canonical = _mbnet_widths(settings)
    w = widths or _scale_widths(canonical, width_mult)
    nodes: list[Node] = [C(_w(w, "stem"), k=3, stride=2, act="relu6", group="stem")]
    in_c = _w(w, "stem")
    idx = 0
    for stage_i, (t, c, n, s) in enumerate(settings):
        k = 3 if kernel_per_stage is None else kernel_per_stage[stage_i]
        for bi in range(n):
            stride = s if bi == 0 else 1
            out_c = _w(w, f"b{idx}_out")
            inner: list[Node] = []
            if t > 1:
                inner.append(C(_w(w, f"b{idx}_exp"), k=1, act="relu6", group=f"b{idx}_exp"))
            inner.append(C(0, k=k, stride=stride, depthwise=True, act="relu6"))
            inner.append(C(out_c, k=1, act="none", group=f"b{idx}_out"))
            body = seq(*inner)
            if stride == 1 and in_c == out_c:
                nodes.append(Residual(body, None, act="none"))
            else:
                nodes.append(body)
            in_c = out_c
            idx += 1
    nodes += [C(_w(w, "head"), k=1, act="relu6", group="head"), GlobalAvgPool(), Dense(NUM_CLASSES)]
    return CNNModel(name, "mbnet", seq(*nodes), dict(w), input_hw)


def build_mobilenetv2(widths=None, width_mult=1.0, input_hw=32) -> CNNModel:
    return _build_mbnet("mobilenetv2", _MBV2_SETTINGS, widths, width_mult, input_hw)


_MNAS_SETTINGS = [  # MnasNet-B1-ish, ImageNet strides
    (1, 16, 1, 1), (3, 24, 3, 2), (3, 40, 3, 2), (6, 80, 3, 2),
    (6, 96, 2, 1), (6, 192, 4, 2), (6, 320, 1, 1),
]
_MNAS_KERNELS = [3, 3, 5, 5, 3, 5, 3]


def build_mnasnet(widths=None, width_mult=1.0, input_hw=32) -> CNNModel:
    return _build_mbnet(
        "mnasnet", _MNAS_SETTINGS, widths, width_mult, input_hw, _MNAS_KERNELS
    )


# ---------------------------------------------------------------------------
# SqueezeNet (fire modules) / GoogLeNet (inception modules) — App. C
# ---------------------------------------------------------------------------

_FIRE_SETTINGS = [(16, 64, 64), (16, 64, 64), (32, 128, 128), (32, 128, 128),
                  (48, 192, 192), (48, 192, 192), (64, 256, 256), (64, 256, 256)]


def _squeezenet_widths() -> dict[str, int]:
    w = {"stem": 64}
    for i, (sq, e1, e3) in enumerate(_FIRE_SETTINGS):
        w[f"f{i}_sq"], w[f"f{i}_e1"], w[f"f{i}_e3"] = sq, e1, e3
    return w


def build_squeezenet(widths=None, width_mult=1.0, input_hw=32) -> CNNModel:
    w = widths or _scale_widths(_squeezenet_widths(), width_mult)
    nodes: list[Node] = [
        C(_w(w, "stem"), k=3, stride=2, bn=False, bias=True, group="stem"),
        Pool("max", 2, 2),
    ]
    for i in range(len(_FIRE_SETTINGS)):
        fire = seq(
            C(_w(w, f"f{i}_sq"), k=1, bn=False, bias=True, group=f"f{i}_sq"),
            Concat((
                C(_w(w, f"f{i}_e1"), k=1, bn=False, bias=True, group=f"f{i}_e1"),
                C(_w(w, f"f{i}_e3"), k=3, bn=False, bias=True, group=f"f{i}_e3"),
            )),
        )
        nodes.append(fire)
        if i in (1, 3):
            nodes.append(Pool("max", 2, 2))
    nodes += [C(NUM_CLASSES, k=1, bn=False, bias=True), GlobalAvgPool(), Dense(NUM_CLASSES)]
    return CNNModel("squeezenet", "squeezenet", seq(*nodes), dict(w), input_hw)


_INCEPTION_SETTINGS = {  # name: (#1x1, #3x3red, #3x3, #5x5red, #5x5, pool-proj)
    "3a": (64, 96, 128, 16, 32, 32),
    "3b": (128, 128, 192, 32, 96, 64),
    "4a": (192, 96, 208, 16, 48, 64),
    "4b": (160, 112, 224, 24, 64, 64),
    "4c": (128, 128, 256, 24, 64, 64),
    "4d": (112, 144, 288, 32, 64, 64),
    "4e": (256, 160, 320, 32, 128, 128),
    "5a": (256, 160, 320, 32, 128, 128),
    "5b": (384, 192, 384, 48, 128, 128),
}


def _googlenet_widths() -> dict[str, int]:
    w = {"stem1": 64, "stem2": 64, "stem3": 192}
    for name, (b1, r3, b3, r5, b5, pp) in _INCEPTION_SETTINGS.items():
        w.update({
            f"i{name}_1": b1, f"i{name}_3r": r3, f"i{name}_3": b3,
            f"i{name}_5r": r5, f"i{name}_5": b5, f"i{name}_p": pp,
        })
    return w


def build_googlenet(widths=None, width_mult=1.0, input_hw=32) -> CNNModel:
    w = widths or _scale_widths(_googlenet_widths(), width_mult)
    nodes: list[Node] = [
        C(_w(w, "stem1"), k=3, stride=2, group="stem1"),
        C(_w(w, "stem2"), k=1, group="stem2"),
        C(_w(w, "stem3"), k=3, group="stem3"),
        Pool("max", 2, 2),
    ]
    for name in _INCEPTION_SETTINGS:
        inc = Concat((
            C(_w(w, f"i{name}_1"), k=1, group=f"i{name}_1"),
            seq(C(_w(w, f"i{name}_3r"), k=1, group=f"i{name}_3r"),
                C(_w(w, f"i{name}_3"), k=3, group=f"i{name}_3")),
            seq(C(_w(w, f"i{name}_5r"), k=1, group=f"i{name}_5r"),
                C(_w(w, f"i{name}_5"), k=5, group=f"i{name}_5")),
            seq(Pool("max", 3, 1, 1), C(_w(w, f"i{name}_p"), k=1, group=f"i{name}_p")),
        ))
        nodes.append(inc)
        if name in ("3b", "4e"):
            nodes.append(Pool("max", 2, 2))
    nodes += [GlobalAvgPool(), Dense(NUM_CLASSES)]
    return CNNModel("googlenet", "googlenet", seq(*nodes), dict(w), input_hw)


# ---------------------------------------------------------------------------
# Registry
# ---------------------------------------------------------------------------

CNN_BUILDERS = {
    "alexnet": build_alexnet,
    "resnet18": build_resnet18,
    "resnet50": build_resnet50,
    "mobilenetv2": build_mobilenetv2,
    "squeezenet": build_squeezenet,
    "mnasnet": build_mnasnet,
    "googlenet": build_googlenet,
}


def canonical_widths(family: str, width_mult: float = 1.0) -> dict[str, int]:
    """Canonical (unpruned) channel-group widths for a network family."""
    model = CNN_BUILDERS[family](width_mult=width_mult)
    return dict(model.widths)


def iter_tagged(node: Node, params: dict):
    """Yield (group, node, node_params) for every group-tagged C/Dense node,
    walking the graph and the params pytree in lockstep."""
    if isinstance(node, (C, Dense)):
        if node.group is not None:
            yield node.group, node, params
    elif isinstance(node, Seq):
        for i, n in enumerate(node.nodes):
            yield from iter_tagged(n, params[str(i)])
    elif isinstance(node, Residual):
        yield from iter_tagged(node.body, params["body"])
        if node.shortcut is not None:
            yield from iter_tagged(node.shortcut, params["shortcut"])
    elif isinstance(node, Concat):
        for i, b in enumerate(node.branches):
            yield from iter_tagged(b, params[str(i)])
    # Pool / GlobalAvgPool: no params, nothing to yield
