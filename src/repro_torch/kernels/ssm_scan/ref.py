"""Plain PyTorch versions for the SSD kernel (port of
``repro/kernels/ssm_scan/ref.py``).

* :func:`ssd_chunk_ref` — the plain version of the CUDA kernel: the same
  four outputs as ``csrc/ssd_chunk.cu`` (and the reference's
  ``ssd_chunk_kernel``), computed as ``_ssd_body`` does for every
  (b, chunk, head) at once.  ``ops.ssd`` runs it for CPU tensors;
  ``chip_smoke.py`` holds the kernel against it on the card.
* :func:`ssd_ref` — the chunked scan of ``models.layers.ssd_scan``
  restricted to a single B/C group.
* :func:`ssd_naive` — the token-by-token recurrence, O(S) sequential.
"""

from __future__ import annotations

import torch

from repro_torch.models.layers import ssd_scan

__all__ = ["ssd_chunk_ref", "ssd_ref", "ssd_naive"]


def ssd_chunk_ref(xh, a, Bm, Cm, *, chunk: int):
    """Intra-chunk SSD.  xh: (B, S, H, P); a: (B, S, H); Bm, Cm: (B, S, N);
    ``chunk`` divides S.  Returns (y_diag (B,S,H,P) in xh's dtype, states
    (B,nc,H,N,P), chunk_decay (B,nc,H), cum (B,nc,H,chunk)), all f32 but
    y_diag."""
    B, S, H, P = xh.shape
    N = Bm.shape[-1]
    nc, l = S // chunk, chunk
    x = xh.float().reshape(B, nc, l, H, P)
    Bc = Bm.float().reshape(B, nc, l, N)
    Cc = Cm.float().reshape(B, nc, l, N)
    cum = torch.cumsum(a.float().reshape(B, nc, l, H).movedim(-1, 2), dim=-1)
    last = cum[..., -1]                                        # (B, nc, H)
    # L[i, j] = exp(cum_i - cum_j) for j <= i, else 0: select, never multiply
    # by a 0/1 mask, since exp overflows to inf above the diagonal
    tril = torch.tril(torch.ones(l, l, dtype=torch.bool, device=xh.device))
    L = torch.where(tril, torch.exp(cum[..., :, None] - cum[..., None, :]), 0.0)
    s = torch.einsum("bcin,bcjn->bcij", Cc, Bc)                # (B, nc, l, l)
    y = torch.einsum("bchij,bcjhp->bcihp", s[:, :, None] * L, x)
    states = torch.einsum("bcin,bchi,bcihp->bchnp", Bc,
                          torch.exp(last[..., None] - cum), x)
    return y.reshape(B, S, H, P).to(xh.dtype), states, torch.exp(last), cum


def ssd_ref(xh, a, Bm, Cm, *, chunk: int = 128, initial_state=None):
    """xh: (B,S,H,P); a: (B,S,H); Bm/Cm: (B,S,N) → (y, final_state)."""
    return ssd_scan(xh, a, Bm[:, :, None, :], Cm[:, :, None, :], chunk,
                    initial_state=initial_state)


def ssd_naive(xh, a, Bm, Cm, initial_state=None):
    """Token-by-token recurrence (the SSM definition, no chunking)."""
    B, S, H, P = xh.shape
    N = Bm.shape[-1]
    st = (initial_state.float() if initial_state is not None
          else torch.zeros(B, H, P, N, device=xh.device))
    ys = []
    for t in range(S):
        dec = torch.exp(a[:, t].float())                        # (B,H)
        upd = torch.einsum("bhp,bn->bhpn", xh[:, t].float(), Bm[:, t].float())
        st = st * dec[..., None, None] + upd
        ys.append(torch.einsum("bhpn,bn->bhp", st, Cm[:, t].float()))
    return torch.stack(ys, dim=1).to(xh.dtype), st
