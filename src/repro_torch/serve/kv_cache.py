"""Paged KV cache: a block pool + host-side allocator for the serve path
(port of ``repro/serve/kv_cache.py``).

The pool holds a *budget* of fixed-size KV blocks
(``paged_cache_shapes``); each running request owns a list of physical
blocks, and the decode step routes reads and writes through a per-slot
block table (``decode_step``'s ``block_table``).  Physical block 0 is
reserved as scratch: idle slots point every table entry (and their
single-token write) at it.

The block size is resolved through the kernel autotuner's ``serve_kv``
tiling model, which prices each candidate through the ``paged_decode``
kernel's own cost model (joint resolution), as in the reference.  The
continuous engine then fits the tuner's pick to its pool
(:func:`fit_block_size`), which the reference does not: under a TPU or
GPU spec the model picks a block of a whole ``max_len`` at small
windows, which leaves the default pool fewer blocks than slots.

Prefill packing: prompts prefill through the dense path (at a bucketed
length, left-padded), then ``pack_prefill`` rolls the padding off, chops
the sequence into blocks and writes them into the pool in place (the
reference donates the pool to a jitted scatter instead).
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.device import resolve_device
from repro_torch.kernels.autotune import tuned_config
from repro_torch.kernels.serve_kv.tiling import _BLOCK_SEEDS, shape_key
from repro_torch.kernels.serve_kv.tiling import default as _default_config
from repro_torch.models import transformer as T

__all__ = ["PagedKVCache", "fit_block_size", "pool_tokens_for", "resolve_block_size"]


def resolve_block_size(cfg: ArchConfig, *, n_slots: int, max_len: int,
                       tuner=None) -> int:
    """KV block size for this serving cell, via the ``serve_kv`` tiling
    model.  With an explicit ``tuner`` the lookup is authoritative;
    otherwise it goes through the process-default tuner
    (:func:`~repro_torch.kernels.autotune.tuned_config`), which falls back
    to the model's default config."""
    shape = shape_key(n_slots, max_len, cfg.n_kv_heads, cfg.head_dim_,
                      T.DTYPE, n_heads=cfg.n_heads)
    if tuner is not None:
        config = tuner.tune("serve_kv", shape)
    else:
        config = tuned_config("serve_kv", shape, _default_config(shape))
    return int(config["block_size"])


def pool_tokens_for(n_slots: int, max_len: int, pool_tokens: int | None = None) -> int:
    """The pool's token budget: ``pool_tokens`` as given, else the expected
    steady-state occupancy, half the dense footprint."""
    if pool_tokens is not None:
        return int(pool_tokens)
    return max((int(n_slots) * int(max_len)) // 2, int(max_len))


def fit_block_size(block_size: int, *, n_slots: int, max_len: int,
                   pool_tokens: int | None = None) -> int:
    """Halve the tuner's ``block_size`` until the pool holds a block for
    every slot, stopping at the ``serve_kv`` model's smallest candidate.
    A pool of fewer blocks than slots leaves slots idle under any load: at
    a block of ``max_len`` the default pool has ``n_slots / 2`` blocks.
    Not in the reference, whose engine takes the tuner's pick as it is."""
    pool = pool_tokens_for(n_slots, max_len, pool_tokens)
    bs = max(1, int(block_size))
    while bs > _BLOCK_SEEDS[0] and bs % 2 == 0 and -(-max(pool, bs) // bs) < n_slots:
        bs //= 2
    return bs


class PagedKVCache:
    def __init__(self, cfg: ArchConfig, *, n_slots: int, max_len: int,
                 block_size: int | None = None, pool_tokens: int | None = None,
                 faults=None, device="cuda"):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.n_slots = int(n_slots)
        self.max_len = int(max_len)
        if block_size is None:
            block_size = resolve_block_size(cfg, n_slots=n_slots,
                                            max_len=max_len)
        self.block_size = bs = max(1, int(block_size))
        pool_tokens = pool_tokens_for(self.n_slots, self.max_len, pool_tokens)
        # An explicit pool_tokens is honoured as given: requests whose
        # lifetime footprint cannot fit the pool are the engine's job to
        # REFUSE with a pool-capacity reason.
        pool_tokens = max(int(pool_tokens), bs)
        self.n_blocks = 1 + -(-pool_tokens // bs)      # +1: scratch block 0
        self.blocks_per_seq = -(-self.max_len // bs)   # table width ceiling
        self.pool = T.init_paged_cache(cfg, self.n_blocks, bs,
                                       device=self.device)
        self._free = list(range(self.n_blocks - 1, 0, -1))
        self._allocated: set[int] = set()
        self.faults = faults               # FaultPlan: injected alloc failures

    # ------------------------------------------------------------------
    # host-side block accounting

    @property
    def n_free_blocks(self) -> int:
        return len(self._free)

    @property
    def usable_blocks(self) -> int:
        """Total allocatable blocks (pool minus the reserved scratch) —
        the hard ceiling on any single request's lifetime footprint."""
        return self.n_blocks - 1

    def blocks_for(self, n_tokens: int) -> int:
        return -(-max(1, int(n_tokens)) // self.block_size)

    def alloc(self, n: int) -> list[int] | None:
        """n physical blocks, or None if the pool can't cover them now
        (nothing is allocated partially).  An injected ``"alloc"`` fault
        denies the request exactly as an empty free list would."""
        if self.faults is not None and self.faults.fire("alloc"):
            return None
        if n > len(self._free):
            return None
        taken = self._free[-n:]
        del self._free[-n:]
        self._allocated.update(taken)
        return taken

    def free(self, blocks: list[int]) -> None:
        """Return blocks to the pool; a double free or a foreign block is
        an error, not a silent free-list corruption."""
        if 0 in blocks:
            raise ValueError("physical block 0 is reserved scratch")
        bad = [b for b in blocks if b not in self._allocated]
        if bad:
            raise ValueError(f"free of unallocated block(s) {bad} "
                             f"(double free or foreign block)")
        self._allocated.difference_update(blocks)
        self._free.extend(blocks)

    @property
    def bytes(self) -> int:
        return sum(leaf.numel() * leaf.element_size()
                   for leaves in self.pool.values() for leaf in leaves.values())

    @property
    def dense_bytes(self) -> int:
        """What the dense ``(n_slots, max_len)`` layout would have cost."""
        per_token = self.bytes / (self.n_blocks * self.block_size)
        return int(per_token * self.n_slots * self.max_len)

    def table_array(self, block_lists: list[list[int]], width: int) -> torch.Tensor:
        """(n_slots, width) int32 block table on the pool's device; short
        rows and idle slots pad with scratch block 0."""
        table = np.zeros((self.n_slots, width), np.int32)
        for row, blocks in enumerate(block_lists):
            if blocks:
                table[row, : len(blocks)] = blocks[:width]
        return torch.from_numpy(table).to(self.device)

    # ------------------------------------------------------------------
    # prefill → pool packing

    @torch.no_grad()
    def pack_prefill(self, dense_cache, blocks: list[int], *,
                     prompt_len: int, pad: int) -> None:
        """Write a B=1 dense prefill cache into the pool at ``blocks``.

        ``dense_cache`` comes from ``T.prefill(..., max_len=L)`` with L a
        multiple of the block size; the prompt sits left-padded by
        ``pad``.  Only the first ``ceil(prompt_len/block_size)`` blocks
        carry prompt KV; the request's remaining blocks fill during decode.
        """
        bs = self.block_size
        leaf = next(iter(dense_cache.values()))["k"]
        cache_len_dim = leaf.shape[2]
        if cache_len_dim % bs:
            raise ValueError(f"dense cache length {cache_len_dim} is not a "
                             f"multiple of the block size {bs}")
        used = min(self.blocks_for(prompt_len), len(blocks), cache_len_dim // bs)
        phys = torch.as_tensor(blocks[:used], dtype=torch.long,
                               device=self.device)
        for sub, leaves in self.pool.items():
            for pool_name, dense_name in (("k_pool", "k"), ("v_pool", "v")):
                # drop the B=1 axis, roll the left-padding off so real
                # token i lands at slot i
                d = torch.roll(dense_cache[sub][dense_name][:, 0], -pad, dims=1)
                d = d[:, : used * bs].reshape(d.shape[0], used, bs, *d.shape[2:])
                leaves[pool_name][:, phys] = d.to(leaves[pool_name].dtype)
