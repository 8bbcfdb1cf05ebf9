"""Port of the SSD (Mamba-2) scan against the reference: the port's plain
intra-chunk version (``ssd_chunk_ref``) against the Pallas
``ssd_chunk_kernel`` in interpret mode; the port's ``ops.ssd`` (plain
intra-chunk pass + the PyTorch inter-chunk recurrence) against the
reference's ``ssd(interpret=True)``, ``ssd_ref`` and ``ssd_naive``; and
``models.layers.ssd_scan`` against the reference's, on identical
numpy-made inputs.

Tolerances: f32 at 1e-4 (rtol and atol; chunked and sequential sums in
other orders); bf16 at 5e-2, the reference's own
``tests/test_kernels.py::test_ssd_bf16_tolerance``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ssm_scan.kernel import ssd_chunk_kernel
from repro.kernels.ssm_scan.ops import ssd as jax_ssd
from repro.kernels.ssm_scan.ref import ssd_naive as jax_naive
from repro.kernels.ssm_scan.ref import ssd_ref as jax_ssd_ref
from repro.models.layers import ssd_scan as jax_ssd_scan
from repro_torch.kernels.autotune import KernelTuner, set_tuner, smem_ok
from repro_torch.kernels.ssm_scan import ssd, ssd_chunk_ref, ssd_naive, ssd_ref, tiling
from repro_torch.models.layers import ssd_scan
from tests._torch_host import port_host_share  # noqa: F401 (autouse)


F32 = dict(rtol=1e-4, atol=1e-4)
TORCH_DT = {jnp.float32: torch.float32, jnp.bfloat16: torch.bfloat16}

SSD_SHAPES = [
    # (B, S, H, P, N, chunk)
    (1, 64, 2, 16, 16, 16),
    (2, 128, 4, 32, 32, 32),
    (1, 96, 1, 8, 64, 32),
    (1, 64, 3, 8, 8, 64),          # one chunk spans the sequence
]


@pytest.fixture(autouse=True)
def _isolated_default_tuner(tmp_path):
    set_tuner(KernelTuner(device="tpu_v5e", cache=str(tmp_path / "tune.json"),
                          measure=False))
    yield
    set_tuner(None)


def _inputs(rng, B, S, H, P, N, dtype=jnp.float32, decay=0.3):
    """The reference's ``_ssd_inputs`` (tests/test_kernels.py), handed to
    both packages with the same values."""
    xh = jnp.asarray(rng.standard_normal((B, S, H, P)), dtype) * 0.5
    a = -jnp.abs(jnp.asarray(rng.standard_normal((B, S, H)), jnp.float32)) * decay
    Bm = jnp.asarray(rng.standard_normal((B, S, N)), dtype) * 0.5
    Cm = jnp.asarray(rng.standard_normal((B, S, N)), dtype) * 0.5
    j = (xh, a, Bm, Cm)
    t = tuple(torch.from_numpy(np.array(x.astype(jnp.float32))).to(TORCH_DT[x.dtype.type])
              for x in j)
    return j, t


def _np(x):
    return np.asarray(x.float() if torch.is_tensor(x) else x.astype(jnp.float32))


@pytest.mark.parametrize("spec", SSD_SHAPES, ids=str)
def test_chunk_plain_version_matches_pallas_kernel(spec):
    B, S, H, P, N, chunk = spec
    j, t = _inputs(np.random.default_rng(5), B, S, H, P, N)
    want = ssd_chunk_kernel(*j, chunk=chunk, interpret=True)
    got = ssd_chunk_ref(*t, chunk=chunk)
    for g, w in zip(got, want):
        assert tuple(g.shape) == tuple(w.shape)
        np.testing.assert_allclose(_np(g), _np(w), **F32)


@pytest.mark.parametrize("spec", SSD_SHAPES, ids=str)
def test_ops_match_reference_op_ref_and_naive(spec):
    B, S, H, P, N, chunk = spec
    j, t = _inputs(np.random.default_rng(5), B, S, H, P, N)
    y, st = ssd(*t, chunk=chunk)
    for want_y, want_st in (jax_ssd(*j, chunk=chunk, interpret=True),
                            jax_ssd_ref(*j, chunk=chunk),
                            jax_naive(*j)):
        np.testing.assert_allclose(_np(y), _np(want_y), **F32)
        np.testing.assert_allclose(_np(st), _np(want_st), **F32)
    y_ref, st_ref = ssd_ref(*t, chunk=chunk)
    y_naive, st_naive = ssd_naive(*t)
    for a, b in ((y, y_ref), (st, st_ref), (y, y_naive), (st, st_naive)):
        np.testing.assert_allclose(_np(a), _np(b), **F32)


def test_initial_state_continuation():
    """Splitting a sequence in half and passing the state equals the full
    scan, in the port's op, against the reference's op on the same split."""
    j, t = _inputs(np.random.default_rng(7), 1, 64, 2, 8, 16)
    y_full, st_full = ssd(*t, chunk=16)
    y1, st1 = ssd(*(x[:, :32] for x in t), chunk=16)
    y2, st2 = ssd(*(x[:, 32:] for x in t), chunk=16, initial_state=st1)
    np.testing.assert_allclose(_np(torch.cat([y1, y2], 1)), _np(y_full), **F32)
    np.testing.assert_allclose(_np(st2), _np(st_full), **F32)
    _, jst1 = jax_ssd(*(x[:, :32] for x in j), chunk=16, interpret=True)
    jy2, jst2 = jax_ssd(*(x[:, 32:] for x in j), chunk=16, initial_state=jst1,
                        interpret=True)
    np.testing.assert_allclose(_np(y2), _np(jy2), **F32)
    np.testing.assert_allclose(_np(st2), _np(jst2), **F32)
    y_naive, st_naive = ssd_naive(*(x[:, 32:] for x in t), initial_state=st1)
    np.testing.assert_allclose(_np(y2), _np(y_naive), **F32)
    np.testing.assert_allclose(_np(st2), _np(st_naive), **F32)


def test_bf16_tolerance():
    j, t = _inputs(np.random.default_rng(8), 1, 64, 2, 16, 16, jnp.bfloat16)
    y, st = ssd(*t, chunk=16)
    assert y.dtype == torch.bfloat16 and st.dtype == torch.float32
    jy, jst = jax_ssd(*j, chunk=16, interpret=True)
    jy_ref, _ = jax_ssd_ref(*j, chunk=16)
    for want in (jy, jy_ref):
        np.testing.assert_allclose(_np(y), _np(want), rtol=5e-2, atol=5e-2)
    np.testing.assert_allclose(_np(st), _np(jst), rtol=5e-2, atol=5e-2)


def test_strong_decay_selects_zero_above_the_diagonal():
    """With |a| large, exp(cum_i - cum_j) overflows to inf for j > i; the
    plain version selects 0 there (as the reference's jnp.where does), so
    nothing turns into NaN."""
    j, t = _inputs(np.random.default_rng(9), 1, 64, 2, 8, 8, decay=40.0)
    got = ssd_chunk_ref(*t, chunk=64)
    assert all(torch.isfinite(g).all() for g in got)
    want = ssd_chunk_kernel(*j, chunk=64, interpret=True)
    np.testing.assert_allclose(_np(got[0]), _np(want[0]), **F32)


@pytest.mark.parametrize("G,S,chunk", [(1, 64, 16), (2, 60, 16), (4, 48, 32)])
def test_layers_ssd_scan_matches_reference(G, S, chunk):
    """Groups broadcast over heads and a length that pads to whole chunks."""
    rng = np.random.default_rng(11)
    B, H, P, N = 2, 4, 8, 16
    arrays = (rng.standard_normal((B, S, H, P)) * 0.5,
              -np.abs(rng.standard_normal((B, S, H))) * 0.3,
              rng.standard_normal((B, S, G, N)) * 0.5,
              rng.standard_normal((B, S, G, N)) * 0.5,
              rng.standard_normal((B, H, P, N)) * 0.1)
    j = [jnp.asarray(a, jnp.float32) for a in arrays]
    t = [torch.from_numpy(a.astype(np.float32)) for a in arrays]
    jy, jst = jax_ssd_scan(*j[:4], chunk, initial_state=j[4])
    y, st = ssd_scan(*t[:4], chunk, initial_state=t[4])
    np.testing.assert_allclose(_np(y), _np(jy), **F32)
    np.testing.assert_allclose(_np(st), _np(jst), **F32)


def test_ops_consults_the_tuner_for_a_missing_chunk():
    tuner = KernelTuner(device="tpu_v5e", cache=None, measure=False)
    set_tuner(tuner)
    _, t = _inputs(np.random.default_rng(5), 1, 64, 2, 16, 16)
    y, _ = ssd(*t)
    y16, _ = ssd(*t, chunk=16)
    assert tuner.misses == 1
    np.testing.assert_allclose(_np(y), _np(y16), **F32)


@pytest.mark.parametrize("l,N,P,want", [
    (16, 128, 64, 19_968),
    (64, 128, 64, 92_160),
    (128, 128, 64, 217_088),
    (256, 128, 64, 565_248),
    (100, 100, 50, 175_616),       # padded to 112, 112 and 64
])
def test_smem_bytes_formula(l, N, P, want):
    """Shared memory of one block of the CUDA kernel (``ssd_chunk_smem_bytes``
    in the source): B and C B^T of the chunk, cum and weights of the block's
    6 heads, and C or two x buffers in one region, all f32 with padded rows.
    At mamba2-780m's shape the h100 tuner admits chunks up to 128 and
    rejects 256 and up, as before the kernel took the tensor cores."""
    assert tiling.smem_bytes(l, N, P) == want
    shape = tiling.shape_key((1, 2048, 48, P), N, dtype=torch.float32)
    cost = tiling.cost(shape, {"chunk": l})
    if 2048 % l == 0:
        assert cost.smem_bytes == want
    if (N, P) == (128, 64):
        assert smem_ok(cost) == (l <= 128)


def _tf32(x):
    """TF32 rounding as the kernel does it: round to nearest, then clear the
    low 13 mantissa bits."""
    return ((x.view(torch.int32) + 0x1000) & -8192).view(torch.float32)


def _mm_3xtf32(a, b):
    a_hi, b_hi = _tf32(a), _tf32(b)
    a_lo, b_lo = _tf32(a - a_hi), _tf32(b - b_hi)
    return a_lo @ b_hi + a_hi @ b_lo + a_hi @ b_hi


def _mm_tf32(a, b):
    return _tf32(a) @ _tf32(b)


def _chunk_products(mm, xh, a, Bm, Cm, l):
    """y_diag and the states of the plain SSD chunk (``ssd_chunk_ref``, one
    batch row), every product through ``mm``."""
    S, H, _ = xh.shape
    tril = torch.tril(torch.ones(l, l, dtype=torch.bool))
    ys, states = [], []
    for c0 in range(0, S, l):
        x, Bc, Cc = xh[c0:c0 + l], Bm[c0:c0 + l], Cm[c0:c0 + l]
        cum = torch.cumsum(a[c0:c0 + l], 0)                       # (l, H)
        G = mm(Cc, Bc.T)
        y = []
        for h in range(H):
            L = torch.where(tril, torch.exp(cum[:, h, None] - cum[None, :, h]), 0.0)
            y.append(mm(G * L, x[:, h]))
            w = torch.exp(cum[-1, h] - cum[:, h])
            states.append(mm((Bc * w[:, None]).T, x[:, h]))
        ys.append(torch.stack(y, 1))
    return torch.cat(ys), torch.stack(states)


def test_3xtf32_products_keep_f32_accuracy():
    """The CUDA kernel runs every product of the SSD chunk in 3xTF32 on the
    tensor cores: each f32 operand split into hi = tf32(v) and lo = tf32(v -
    hi), and hi·lo + lo·hi + hi·hi summed in f32.  Emulated here on the plain
    chunk at chunk 128, N 128, P 64 (inputs N(0, 1), a = -0.1·|N(0, 1)|, as
    chip_smoke.py draws them, so |y| is of order 10), it stays within
    chip_smoke.py's SSD_TOL = 1e-3 of the f32 plain version; one TF32 product
    a term does not."""
    rng = np.random.default_rng(4)
    S, H, P, N, l = 256, 2, 64, 128, 128
    xh = torch.from_numpy(rng.standard_normal((S, H, P)).astype(np.float32))
    a = torch.from_numpy(-np.abs(rng.standard_normal((S, H))).astype(np.float32) * 0.1)
    Bm = torch.from_numpy(rng.standard_normal((S, N)).astype(np.float32))
    Cm = torch.from_numpy(rng.standard_normal((S, N)).astype(np.float32))
    y_f32, st_f32, *_ = ssd_chunk_ref(xh[None], a[None], Bm[None], Cm[None], chunk=l)
    y_f32, st_f32 = y_f32[0], st_f32[0].reshape(-1, N, P)
    assert 10 <= float(y_f32.abs().max()) <= 1000
    y3, st3 = _chunk_products(_mm_3xtf32, xh, a, Bm, Cm, l)
    y1, st1 = _chunk_products(_mm_tf32, xh, a, Bm, Cm, l)
    assert float((y3 - y_f32).abs().max()) <= 1e-3
    assert float((st3 - st_f32).abs().max()) <= 1e-3
    assert float((y1 - y_f32).abs().max()) > 1e-3

