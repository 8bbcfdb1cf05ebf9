"""Analytical feature extraction — paper §5.2.1 / Appendix B, exact formulas.

(Copy of ``repro/core/features.py``: framework-free, so the port's
features equal the reference's exactly; kept here so that the port
imports nothing of ``repro``.)

For every convolution layer the paper models the memory consumption and
operation counts of the three cuDNN convolution algorithms (matrix
multiplication / im2col, FFT, Winograd) for each of the three training
computations:

    Eq.1 (fwd):    y = x * w
    Eq.2 (bwd_x):  dL/dx = dL/dy * rot180(w)
    Eq.3 (bwd_w):  dL/dw = x * dL/dy

plus algorithm-independent tensor allocations.  Features are computed
per-layer and summed across all layers of the network (paper §5.3), giving a
single 42-dimensional vector per (network topology, batch size) datapoint.

Notation (paper §5.2.1):
    n_l  : number of filters (output channels)
    m_l  : input channels
    k_l  : kernel spatial size (k x k)
    s_l  : stride,  p_l : padding,  g_l : groups
    ip_l : input spatial size (ip x ip)
    op_l : output spatial size, op = 1 + floor((ip + 2p - k) / s)
    bs   : training batch size

The Winograd features (App. B items 29-42) are "applied twice for (q x r) of
(4 x 3) and (3 x 2)".  To preserve the paper's stated 42-feature count, the
default mode sums the two (q, r) instantiations per feature; ``qr_mode=
"concat"`` exposes the 56-dim variant instead (14 extra winograd features).
Forests are insensitive to this monotone choice; both are tested.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field, replace

import numpy as np

__all__ = [
    "ConvLayerSpec",
    "NetworkSpec",
    "FEATURE_NAMES",
    "layer_features",
    "network_features",
    "feature_matrix",
    "batch_network_features",
]

# Winograd (q, r) output-tile / filter-tap sizes most used by cuDNN (paper
# App. B.2.4, citing Jorda et al.).
WINOGRAD_QR = ((4, 3), (3, 2))


@dataclass(frozen=True)
class ConvLayerSpec:
    """Geometry of a single convolution layer (paper §5.2.1 notation)."""

    n: int          # filters / output channels (n_l)
    m: int          # input channels (m_l)
    k: int          # kernel size (k_l)
    stride: int = 1
    padding: int = 0
    groups: int = 1
    ip: int = 1     # input spatial size (ip_l)

    def __post_init__(self):
        if self.n <= 0 or self.m <= 0 or self.k <= 0:
            raise ValueError(f"degenerate conv layer: {self}")
        if self.m % self.groups != 0 or self.n % self.groups != 0:
            raise ValueError(f"channels not divisible by groups: {self}")

    @property
    def op(self) -> int:
        """Output spatial size: op = 1 + floor((ip + 2p - k) / s)."""
        o = 1 + (self.ip + 2 * self.padding - self.k) // self.stride
        if o <= 0:
            raise ValueError(f"non-positive OFM size for {self}")
        return o

    @property
    def m_per_group(self) -> float:
        return self.m / self.groups


@dataclass(frozen=True)
class NetworkSpec:
    """A network as the ordered list of its conv layers (the paper models
    only convolution layers; FC layers may be encoded as 1x1 convs on a 1x1
    feature map, which makes their allocation terms exact and their op terms
    the matmul op count)."""

    name: str
    layers: tuple[ConvLayerSpec, ...] = field(default_factory=tuple)

    def scaled(self, name: str, keep: "np.ndarray | list") -> "NetworkSpec":
        """Return a copy with per-layer filter counts replaced (used by the
        pruning process to derive topologies)."""
        keep = list(keep)
        if len(keep) != len(self.layers):
            raise ValueError("keep vector length mismatch")
        new_layers = []
        prev_out = None
        for layer, n_new in zip(self.layers, keep):
            new_layers.append(replace(layer, n=int(n_new)))
        return NetworkSpec(name=name, layers=tuple(new_layers))


# ---------------------------------------------------------------------------
# Per-layer feature terms.  Names follow Appendix B numbering.
# ---------------------------------------------------------------------------


def _tensor_allocations(l: ConvLayerSpec, bs: int) -> dict[str, float]:
    """App. B.2.1 items 1-5: algorithm-independent tensor allocations."""
    mem_w = l.n * l.m_per_group * l.k**2                       # (1)
    mem_w_grad = bs * l.n * l.m_per_group * l.k**2             # (2)
    mem_ifm_grad = bs * l.m * l.ip**2                          # (3)
    mem_ofm_grad = bs * l.n * l.op**2                          # (4)
    return {
        "mem_w": mem_w,
        "mem_w_grad": mem_w_grad,
        "mem_ifm_grad": mem_ifm_grad,
        "mem_ofm_grad": mem_ofm_grad,
        "mem_alloc_total": mem_w + mem_w_grad + mem_ifm_grad + mem_ofm_grad,  # (5)
    }


def _matmul_features(l: ConvLayerSpec, bs: int) -> dict[str, float]:
    """App. B.2.2 items 6-15: im2col / matrix-multiplication algorithm."""
    op2, ip2, k2 = l.op**2, l.ip**2, l.k**2
    i2c_fwd_total = bs * op2 * k2 * l.m                        # (6)
    i2c_bwdw_total = bs * op2 * k2 * l.m_per_group             # (7)
    i2c_fwd_index = bs * op2                                   # (8) fwd == bwd_w
    i2c_bwdx_total = bs * ip2 * k2 * l.m                       # (9)
    i2c_bwdx_index = bs * ip2                                  # (10)
    ops_fwd = bs * l.n * op2 * k2 * l.m_per_group              # (13) fwd == bwd_w
    ops_bwdx = bs * l.m * ip2 * k2 * l.n                       # (14)
    return {
        "mm_i2c_fwd_total": i2c_fwd_total,
        "mm_i2c_bwdw_total": i2c_bwdw_total,
        "mm_i2c_fwd_index": i2c_fwd_index,
        "mm_i2c_bwdx_total": i2c_bwdx_total,
        "mm_i2c_bwdx_index": i2c_bwdx_index,
        "mm_i2c_total_sum": i2c_fwd_total + i2c_bwdx_total + i2c_bwdw_total,   # (11)
        "mm_i2c_index_sum": 2 * i2c_fwd_index + i2c_bwdx_index,               # (12)
        "mm_ops_fwd": ops_fwd,
        "mm_ops_bwdx": ops_bwdx,
        "mm_ops_sum": 2 * ops_fwd + ops_bwdx,                                  # (15)
    }


def _log(v: float) -> float:
    # Natural log; paper writes log() unqualified.  log(1) = 0 handles ip=1.
    return math.log(v) if v > 1 else 0.0


def _fft_features(l: ConvLayerSpec, bs: int) -> dict[str, float]:
    """App. B.2.3 items 16-28: FFT algorithm (after Mathieu et al.)."""
    n, m, g, ip, op = l.n, l.m, l.groups, l.ip, l.op
    mpg = l.m_per_group
    w_fwd = n * mpg * ip * (1 + ip)                            # (16)
    ifm_fwd = bs * m * ip * (1 + ip)                           # (17) fwd == bwd_w ifm
    ofm_bwdw = bs * n * ip * (1 + ip)                          # (18)
    w_bwdx = n * mpg * op * (1 + op)                           # (19)
    ofm_bwdx = bs * n * op * (1 + op)                          # (20)
    s21 = w_fwd + ifm_fwd                                      # (21)
    s22 = ofm_bwdx + w_bwdx                                    # (22)  (bwd_x terms)
    s23 = ofm_bwdw + ifm_fwd                                   # (23)
    common = bs * (m + n) + n * mpg
    ops_fwd = ip**2 * _log(ip) * common + bs * n * m * ip**2   # (25)
    ops_bwdx = op**2 * _log(op) * common + bs * n * m * op**2  # (26)
    ops_bwdw = ip * _log(ip**2) * common + bs * n * m * ip**2  # (27)
    return {
        "fft_w_fwd": w_fwd,
        "fft_ifm_fwd": ifm_fwd,
        "fft_ofm_bwdw": ofm_bwdw,
        "fft_w_bwdx": w_bwdx,
        "fft_ofm_bwdx": ofm_bwdx,
        "fft_mem_fwd_sum": s21,
        "fft_mem_bwdx_sum": s22,
        "fft_mem_bwdw_sum": s23,
        "fft_mem_total": s21 + s22 + s23,                      # (24)
        "fft_ops_fwd": ops_fwd,
        "fft_ops_bwdx": ops_bwdx,
        "fft_ops_bwdw": ops_bwdw,
        "fft_ops_sum": ops_fwd + ops_bwdx + ops_bwdw,          # (28)
    }


def _winograd_features_qr(l: ConvLayerSpec, bs: int, q: int, r: int) -> dict[str, float]:
    """App. B.2.4 items 29-42 for a single (q, r) instantiation."""
    n, m, g, ip, op, k = l.n, l.m, l.groups, l.ip, l.op, l.k
    mpg = l.m_per_group
    tiles_ip = math.ceil(ip / q) ** 2
    tiles_op = math.ceil(op / q) ** 2
    tiles_k = math.ceil(k / r) ** 2
    tiles_op_r = math.ceil(op / r) ** 2
    had = (q + r - 1) ** 2                       # Hadamard product size
    mem_fwd = bs * n * tiles_ip * 3 * had                      # (29)
    mem_bwdx = bs * m * tiles_op * 3 * had                     # (30)
    mem_bwdw = bs * n * mpg * tiles_ip * 3 * had               # (31)
    ops_fwd = bs * n * mpg * tiles_ip * tiles_k * had          # (36)
    ops_bwdx = bs * m * n * tiles_op * tiles_k * had           # (37)
    ops_bwdw = bs * n * mpg * mpg * tiles_ip * tiles_op_r * had  # (38)
    s32 = mem_fwd + mem_bwdx                                   # (32)
    s33 = mem_fwd + mem_bwdw                                   # (33)
    s34 = mem_bwdw + mem_bwdx                                  # (34)
    s39 = ops_fwd + ops_bwdx                                   # (39)
    s40 = ops_fwd + ops_bwdw                                   # (40)
    s41 = ops_bwdx + ops_bwdw                                  # (41)
    return {
        "wino_mem_fwd": mem_fwd,
        "wino_mem_bwdx": mem_bwdx,
        "wino_mem_bwdw": mem_bwdw,
        "wino_mem_fwd_bwdx": s32,
        "wino_mem_fwd_bwdw": s33,
        "wino_mem_bwdw_bwdx": s34,
        "wino_mem_total": s32 + s33 + s34,                     # (35)
        "wino_ops_fwd": ops_fwd,
        "wino_ops_bwdx": ops_bwdx,
        "wino_ops_bwdw": ops_bwdw,
        "wino_ops_fwd_bwdx": s39,
        "wino_ops_fwd_bwdw": s40,
        "wino_ops_bwdx_bwdw": s41,
        "wino_ops_total": s39 + s40 + s41,                     # (42)
    }


def _winograd_features(l: ConvLayerSpec, bs: int, qr_mode: str) -> dict[str, float]:
    per_qr = [_winograd_features_qr(l, bs, q, r) for q, r in WINOGRAD_QR]
    if qr_mode == "sum":
        return {k: sum(d[k] for d in per_qr) for k in per_qr[0]}
    if qr_mode == "concat":
        out: dict[str, float] = {}
        for (q, r), d in zip(WINOGRAD_QR, per_qr):
            out.update({f"{k}_q{q}r{r}": v for k, v in d.items()})
        return out
    raise ValueError(f"unknown qr_mode {qr_mode!r}")


def layer_features(l: ConvLayerSpec, bs: int, qr_mode: str = "sum") -> dict[str, float]:
    """All Appendix-B features for one layer at batch size ``bs``."""
    out: dict[str, float] = {}
    out.update(_tensor_allocations(l, bs))
    out.update(_matmul_features(l, bs))
    out.update(_fft_features(l, bs))
    out.update(_winograd_features(l, bs, qr_mode))
    return out


def _names(qr_mode: str) -> list[str]:
    probe = ConvLayerSpec(n=1, m=1, k=1, ip=1)
    return list(layer_features(probe, 1, qr_mode).keys())


FEATURE_NAMES: list[str] = _names("sum")           # 42 features (paper count)
FEATURE_NAMES_CONCAT: list[str] = _names("concat")  # 56-dim variant


def network_features(net: NetworkSpec, bs: int, qr_mode: str = "sum") -> np.ndarray:
    """Sum the per-layer features across all layers (paper §5.3)."""
    names = FEATURE_NAMES if qr_mode == "sum" else FEATURE_NAMES_CONCAT
    acc = np.zeros(len(names), dtype=np.float64)
    for l in net.layers:
        f = layer_features(l, bs, qr_mode)
        acc += np.array([f[k] for k in names], dtype=np.float64)
    return acc


# ---------------------------------------------------------------------------
# Vectorized batch path.  The scalar functions above are the reference
# implementation (hand-checked against Appendix B in tests); the batch path
# computes the same formulas over flat numpy arrays covering every layer of
# every datapoint at once, then segment-sums per datapoint.  This is what
# makes population-scale prediction (engine.ForestBackend, core/search.py)
# fast: one array program instead of N_python round-trips.
# ---------------------------------------------------------------------------


def _vlog(v: np.ndarray) -> np.ndarray:
    # vectorized twin of _log: natural log, 0 for v <= 1
    return np.where(v > 1, np.log(np.maximum(v, 1.0)), 0.0)


def _batch_layer_features(cols: dict[str, np.ndarray], qr_mode: str) -> dict[str, np.ndarray]:
    """All Appendix-B features for a flat array of layers (one row each)."""
    n, m, g, ip, op, k, bs = (cols[c] for c in ("n", "m", "g", "ip", "op", "k", "bs"))
    mpg = m / g
    k2, ip2, op2 = k * k, ip * ip, op * op
    f: dict[str, np.ndarray] = {}

    # App. B.2.1 tensor allocations
    f["mem_w"] = n * mpg * k2
    f["mem_w_grad"] = bs * n * mpg * k2
    f["mem_ifm_grad"] = bs * m * ip2
    f["mem_ofm_grad"] = bs * n * op2
    f["mem_alloc_total"] = f["mem_w"] + f["mem_w_grad"] + f["mem_ifm_grad"] + f["mem_ofm_grad"]

    # App. B.2.2 im2col / matmul
    i2c_fwd_total = bs * op2 * k2 * m
    i2c_bwdw_total = bs * op2 * k2 * mpg
    i2c_fwd_index = bs * op2
    i2c_bwdx_total = bs * ip2 * k2 * m
    i2c_bwdx_index = bs * ip2
    ops_fwd = bs * n * op2 * k2 * mpg
    ops_bwdx = bs * m * ip2 * k2 * n
    f["mm_i2c_fwd_total"] = i2c_fwd_total
    f["mm_i2c_bwdw_total"] = i2c_bwdw_total
    f["mm_i2c_fwd_index"] = i2c_fwd_index
    f["mm_i2c_bwdx_total"] = i2c_bwdx_total
    f["mm_i2c_bwdx_index"] = i2c_bwdx_index
    f["mm_i2c_total_sum"] = i2c_fwd_total + i2c_bwdx_total + i2c_bwdw_total
    f["mm_i2c_index_sum"] = 2 * i2c_fwd_index + i2c_bwdx_index
    f["mm_ops_fwd"] = ops_fwd
    f["mm_ops_bwdx"] = ops_bwdx
    f["mm_ops_sum"] = 2 * ops_fwd + ops_bwdx

    # App. B.2.3 FFT
    w_fwd = n * mpg * ip * (1 + ip)
    ifm_fwd = bs * m * ip * (1 + ip)
    ofm_bwdw = bs * n * ip * (1 + ip)
    w_bwdx = n * mpg * op * (1 + op)
    ofm_bwdx = bs * n * op * (1 + op)
    s21 = w_fwd + ifm_fwd
    s22 = ofm_bwdx + w_bwdx
    s23 = ofm_bwdw + ifm_fwd
    common = bs * (m + n) + n * mpg
    fft_ops_fwd = ip2 * _vlog(ip) * common + bs * n * m * ip2
    fft_ops_bwdx = op2 * _vlog(op) * common + bs * n * m * op2
    fft_ops_bwdw = ip * _vlog(ip2) * common + bs * n * m * ip2
    f["fft_w_fwd"] = w_fwd
    f["fft_ifm_fwd"] = ifm_fwd
    f["fft_ofm_bwdw"] = ofm_bwdw
    f["fft_w_bwdx"] = w_bwdx
    f["fft_ofm_bwdx"] = ofm_bwdx
    f["fft_mem_fwd_sum"] = s21
    f["fft_mem_bwdx_sum"] = s22
    f["fft_mem_bwdw_sum"] = s23
    f["fft_mem_total"] = s21 + s22 + s23
    f["fft_ops_fwd"] = fft_ops_fwd
    f["fft_ops_bwdx"] = fft_ops_bwdx
    f["fft_ops_bwdw"] = fft_ops_bwdw
    f["fft_ops_sum"] = fft_ops_fwd + fft_ops_bwdx + fft_ops_bwdw

    # App. B.2.4 Winograd, per (q, r) instantiation
    per_qr: list[dict[str, np.ndarray]] = []
    for q, r in WINOGRAD_QR:
        tiles_ip = np.ceil(ip / q) ** 2
        tiles_op = np.ceil(op / q) ** 2
        tiles_k = np.ceil(k / r) ** 2
        tiles_op_r = np.ceil(op / r) ** 2
        had = (q + r - 1) ** 2
        mem_fwd = bs * n * tiles_ip * 3 * had
        mem_bwdx = bs * m * tiles_op * 3 * had
        mem_bwdw = bs * n * mpg * tiles_ip * 3 * had
        wops_fwd = bs * n * mpg * tiles_ip * tiles_k * had
        wops_bwdx = bs * m * n * tiles_op * tiles_k * had
        wops_bwdw = bs * n * mpg * mpg * tiles_ip * tiles_op_r * had
        s32 = mem_fwd + mem_bwdx
        s33 = mem_fwd + mem_bwdw
        s34 = mem_bwdw + mem_bwdx
        s39 = wops_fwd + wops_bwdx
        s40 = wops_fwd + wops_bwdw
        s41 = wops_bwdx + wops_bwdw
        per_qr.append({
            "wino_mem_fwd": mem_fwd,
            "wino_mem_bwdx": mem_bwdx,
            "wino_mem_bwdw": mem_bwdw,
            "wino_mem_fwd_bwdx": s32,
            "wino_mem_fwd_bwdw": s33,
            "wino_mem_bwdw_bwdx": s34,
            "wino_mem_total": s32 + s33 + s34,
            "wino_ops_fwd": wops_fwd,
            "wino_ops_bwdx": wops_bwdx,
            "wino_ops_bwdw": wops_bwdw,
            "wino_ops_fwd_bwdx": s39,
            "wino_ops_fwd_bwdw": s40,
            "wino_ops_bwdx_bwdw": s41,
            "wino_ops_total": s39 + s40 + s41,
        })
    if qr_mode == "sum":
        for key in per_qr[0]:
            f[key] = sum(d[key] for d in per_qr)
    elif qr_mode == "concat":
        for (q, r), d in zip(WINOGRAD_QR, per_qr):
            for key, v in d.items():
                f[f"{key}_q{q}r{r}"] = v
    else:
        raise ValueError(f"unknown qr_mode {qr_mode!r}")
    return f


def batch_network_features(
    nets_and_bs: list[tuple[NetworkSpec, int]], qr_mode: str = "sum"
) -> np.ndarray:
    """Feature matrix (N, F) for N (network, batch size) datapoints in one
    vectorized pass: flatten every layer of every network into flat arrays,
    evaluate all Appendix-B formulas once, segment-sum per network."""
    names = FEATURE_NAMES if qr_mode == "sum" else FEATURE_NAMES_CONCAT
    out = np.zeros((len(nets_and_bs), len(names)), dtype=np.float64)
    if not nets_and_bs:
        return out
    seg, rows = [], {c: [] for c in ("n", "m", "g", "ip", "op", "k", "bs")}
    for i, (net, bs) in enumerate(nets_and_bs):
        for l in net.layers:
            seg.append(i)
            rows["n"].append(l.n)
            rows["m"].append(l.m)
            rows["g"].append(l.groups)
            rows["ip"].append(l.ip)
            rows["op"].append(l.op)
            rows["k"].append(l.k)
            rows["bs"].append(bs)
    cols = {c: np.asarray(v, dtype=np.float64) for c, v in rows.items()}
    f = _batch_layer_features(cols, qr_mode)
    per_layer = np.stack([f[k] for k in names], axis=1)      # (L_total, F)
    # explicit int dtype: an all-empty batch gives an empty seg list, which
    # np.asarray would default to float64 — an invalid index array
    np.add.at(out, np.asarray(seg, dtype=np.int64), per_layer)
    return out


def feature_matrix(nets_and_bs: list[tuple[NetworkSpec, int]], qr_mode: str = "sum") -> np.ndarray:
    """Stack feature vectors for a list of (network, batch size) datapoints
    (vectorized — see batch_network_features)."""
    return batch_network_features(nets_and_bs, qr_mode)
