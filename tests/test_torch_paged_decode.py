"""Port of paged decode attention against the reference: the port's plain
``paged_decode_ref`` / ``combine_splits`` against the JAX
``paged_decode_ref`` and the Pallas ``paged_decode_kernel`` run in
interpret mode, on identical numpy-made inputs.

Tolerances: f32 at atol 1e-5 (summation order differs between the
frameworks and between a full and an online softmax); bf16 outputs at
atol 1e-2, about one bf16 ulp at |x| ≤ 2, since both sides compute in f32
and round once to bf16 and that rounding may land on either neighbour.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.paged_decode import paged_decode_ref as jax_ref
from repro.kernels.paged_decode.kernel import combine_splits as jax_combine
from repro.kernels.paged_decode.kernel import paged_decode_kernel
from repro_torch.kernels.paged_decode import paged_decode_attention
from repro_torch.kernels.paged_decode.ref import NEG_INF, combine_splits
from repro_torch.kernels.paged_decode.ref import paged_decode_ref

TOL = {"float32": 1e-5, "bfloat16": 1e-2}
TORCH_DT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _case(B, H, Hkv, Dh, NB, bs, dtype, cache_lens, seed=0):
    """Inputs made with numpy, rounded once to ``dtype`` by JAX and handed
    to both packages (torch gets the exact same values)."""
    rng = np.random.default_rng(seed)
    P = B * NB + 1                       # block 0 = scratch, like the pool
    arrays = {
        "q": rng.standard_normal((B, H, Dh)),
        "k": rng.standard_normal((P, bs, Hkv, Dh)),
        "v": rng.standard_normal((P, bs, Hkv, Dh)),
    }
    j = {n: jnp.asarray(a, dtype) for n, a in arrays.items()}
    j["bt"] = jnp.asarray(rng.permutation(B * NB).reshape(B, NB) + 1, jnp.int32)
    j["cl"] = jnp.asarray(cache_lens, jnp.int32)
    t = {n: torch.from_numpy(np.array(a, np.float32)).to(TORCH_DT[dtype])
         for n, a in j.items() if n in arrays}
    t["bt"] = torch.from_numpy(np.array(j["bt"]))
    t["cl"] = torch.from_numpy(np.array(j["cl"]))
    return j, t


def _args(d):
    return d["q"], d["k"], d["v"], d["bt"], d["cl"]


def _close(torch_out, jax_out, tol):
    np.testing.assert_allclose(torch_out.float().numpy(),
                               np.asarray(jax_out, np.float32),
                               rtol=0, atol=tol)


def _split_partials(q, k, v, bt, cl, n_splits):
    """Plain model of the kernel's split path: per split of the table's
    blocks, the unnormalised (acc, m, l) over live positions."""
    B, H, Dh = q.shape
    bs, Hkv = k.shape[1], k.shape[2]
    NB = bt.shape[1]
    rep = H // Hkv
    npb = -(-NB // n_splits)
    kg = k[bt.long()].reshape(B, NB * bs, Hkv, Dh).float()
    vg = v[bt.long()].reshape(B, NB * bs, Hkv, Dh).float()
    qr = (q.float() / math.sqrt(Dh)).reshape(B, Hkv, rep, Dh)
    s = torch.einsum("bgrd,bkgd->bgrk", qr, kg)
    pos = torch.arange(NB * bs)
    acc = torch.zeros(B, Hkv, n_splits, rep, Dh)
    m = torch.full((B, Hkv, n_splits, rep), NEG_INF)
    l = torch.zeros(B, Hkv, n_splits, rep)
    for sp in range(n_splits):
        live = ((pos >= sp * npb * bs) & (pos < (sp + 1) * npb * bs)
                & (pos[None] <= cl[:, None].long()))             # (B, L)
        for b in range(B):
            idx = torch.nonzero(live[b])[:, 0]
            if len(idx) == 0:
                continue                 # dead split: (0, NEG_INF, 0)
            sb = s[b][..., idx]                                  # (Hkv, rep, n)
            m[b, :, sp] = sb.amax(-1)
            p = torch.exp(sb - m[b, :, sp, :, None])
            l[b, :, sp] = p.sum(-1)
            acc[b, :, sp] = torch.einsum("grn,ngd->grd", p, vg[b][idx])
    return acc, m, l


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("H,Hkv", [(4, 4), (8, 2), (8, 1)])
@pytest.mark.parametrize("n_splits", [1, 2, 4])
def test_ref_matches_jax_ref_and_kernel(dtype, H, Hkv, n_splits):
    # ragged fills incl. 0 and the block edges bs-1, bs, 2·bs
    j, t = _case(4, H, Hkv, 64, 4, 16, dtype, [0, 15, 16, 32])
    out = paged_decode_ref(*_args(t))
    assert out.dtype == TORCH_DT[dtype] and out.shape == (4, H, 64)
    _close(out, jax_ref(*_args(j)), TOL[dtype])
    _close(out, paged_decode_kernel(*_args(j), n_splits=n_splits,
                                    interpret=True), TOL[dtype])
    # the split path: per-split partials merged by combine_splits
    parts = _split_partials(*_args(t), n_splits)
    _close(combine_splits(*parts, TORCH_DT[dtype]),
           jax_combine(*(jnp.asarray(p.numpy()) for p in parts),
                       jnp.dtype(dtype)), TOL[dtype])
    _close(combine_splits(*parts, torch.float32), out.float(), TOL[dtype])


def test_combine_splits_dead_split_and_idle_row():
    """A dead split (acc 0, m NEG_INF, l 0) vanishes; a row with no live
    split at all (l == 0) divides by 1 instead of producing NaN."""
    rng = np.random.default_rng(5)
    acc = rng.standard_normal((2, 2, 3, 2, 8)).astype(np.float32)
    m = rng.standard_normal((2, 2, 3, 2)).astype(np.float32)
    l = rng.uniform(0.5, 2.0, (2, 2, 3, 2)).astype(np.float32)
    acc[:, :, 2], m[:, :, 2], l[:, :, 2] = 0.0, NEG_INF, 0.0   # dead split
    acc[1], m[1], l[1] = 0.0, NEG_INF, 0.0                     # idle row
    got = combine_splits(*map(torch.from_numpy, (acc, m, l)), torch.float32)
    want = jax_combine(jnp.asarray(acc), jnp.asarray(m), jnp.asarray(l),
                       jnp.float32)
    assert torch.isfinite(got).all()
    assert float(got[1].abs().max()) == 0.0
    _close(got, want, 1e-5)


def test_scatter_mask_boundary_off_by_one():
    """The freshly written token at ``cache_len`` sitting exactly on a
    block boundary (off == 0, first slot of a new block) is attended; the
    position one past the fill is not.  A huge-norm K marker makes
    attention collapse onto its V iff the marker position is <= cache_len
    (the reference's test of the same name)."""
    B, H, Hkv, Dh, NB, bs = 1, 4, 2, 32, 3, 16
    j, t = _case(B, H, Hkv, Dh, NB, bs, "float32", [0])
    cl_val = bs                                  # block 1, offset 0
    phys = int(t["bt"][0, cl_val // bs])
    t["q"] = torch.ones_like(t["q"])
    t["k"][phys, cl_val % bs] = 100.0 * math.sqrt(Dh)
    marker_v = t["v"][phys, cl_val % bs]         # (Hkv, Dh)
    want = marker_v[:, None].expand(Hkv, H // Hkv, Dh).reshape(1, H, Dh)
    j["q"], j["k"] = jnp.asarray(t["q"].numpy()), jnp.asarray(t["k"].numpy())

    t["cl"] = torch.tensor([cl_val], dtype=torch.int32)
    j["cl"] = jnp.asarray([cl_val], jnp.int32)
    out = paged_decode_ref(*_args(t))
    np.testing.assert_allclose(out.numpy(), want.numpy(), rtol=1e-2, atol=1e-2)
    _close(out, jax_ref(*_args(j)), 1e-5)

    # one before the marker: it must be invisible
    t["cl"] = torch.tensor([cl_val - 1], dtype=torch.int32)
    j["cl"] = jnp.asarray([cl_val - 1], jnp.int32)
    out = paged_decode_ref(*_args(t))
    assert float((out - want).abs().max()) > 0.1        # didn't collapse
    _close(out, jax_ref(*_args(j)), 1e-5)
    _close(out, paged_decode_kernel(*_args(j), interpret=True), 1e-5)


def test_wrapper_routes_cpu_tensors_to_plain_version():
    _, t = _case(2, 8, 2, 64, 3, 16, "float32", [10, 40])
    out = paged_decode_attention(*_args(t), n_splits=2, block_kv=8)
    assert torch.equal(out, paged_decode_ref(*_args(t)))
