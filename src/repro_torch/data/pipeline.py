"""Synthetic-token data pipeline (port of ``repro/data/pipeline.py``).

Deterministic per (seed, step): any process can regenerate any batch,
which is what makes checkpoint-resume exact — the pipeline has no state
beyond the step counter.  ``make_batch`` is the reference's numpy code,
so both packages draw the same tokens (int32) for the same
(cfg, shape, step, seed).

A background prefetch thread keeps ``prefetch`` batches ready so host-side
generation overlaps device compute (the paper's Φ excludes data
preparation for the same reason — PyTorch overlaps it; §4).  Where the
reference places batches with ``shardings``, :class:`TokenPipeline`
takes a ``device`` and returns tensors there.
"""

from __future__ import annotations

import queue
import threading
from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig, ShapeSpec
from repro_torch.device import resolve_device

__all__ = ["PipelineConfig", "TokenPipeline", "make_batch", "batch_to_device"]


@dataclass(frozen=True)
class PipelineConfig:
    vocab: int
    global_batch: int
    seq_len: int
    seed: int = 0
    # mixture of synthetic "domains" with different token distributions —
    # exercises the data-distribution-shift scenario from the paper's §6.4
    mixture_weights: tuple[float, ...] = (1.0,)


def make_batch(cfg: ArchConfig, shape: ShapeSpec, step: int, seed: int = 0) -> dict:
    """One deterministic batch for (arch, shape, step), numpy arrays."""
    rng = np.random.default_rng(np.random.SeedSequence([seed, step]))
    B, S = shape.global_batch, shape.seq_len
    batch = {"tokens": rng.integers(0, cfg.vocab, (B, S), dtype=np.int32)}
    if cfg.n_prefix:
        batch["patches"] = rng.standard_normal(
            (B, cfg.n_prefix, cfg.d_model)).astype(np.float32)
    if cfg.n_encoder_layers:
        batch["frames"] = rng.standard_normal(
            (B, cfg.n_audio_frames, cfg.d_model)).astype(np.float32)
    return batch


def batch_to_device(batch: dict, device: torch.device) -> dict:
    """A numpy batch as tensors on ``device`` (dtypes kept)."""
    return {k: torch.from_numpy(a).to(device) for k, a in batch.items()}


class TokenPipeline:
    """Iterator of training batches with background prefetch and exact resume.

    ``start_step`` resumes mid-stream; ``__next__`` returns
    ``(step, batch)`` with the batch's tensors on ``device`` (default the
    card; raises without one unless given ``device="cpu"``).
    """

    def __init__(self, cfg: ArchConfig, shape: ShapeSpec, *, seed: int = 0,
                 start_step: int = 0, prefetch: int = 2, device="cuda"):
        self.device = resolve_device(device)
        self.cfg, self.shape, self.seed = cfg, shape, seed
        self.step = start_step
        self._q: queue.Queue = queue.Queue(maxsize=max(prefetch, 1))
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._producer, daemon=True)
        self._thread.start()

    def _producer(self) -> None:
        step = self.step
        while not self._stop.is_set():
            batch = make_batch(self.cfg, self.shape, step, self.seed)
            try:
                self._q.put((step, batch), timeout=0.5)
                step += 1
            except queue.Full:
                continue

    def __iter__(self):
        return self

    def __next__(self) -> tuple[int, dict]:
        while True:
            step, batch = self._q.get()
            if step < self.step:
                continue  # stale after a resume seek
            self.step = step + 1
            return step, batch_to_device(batch, self.device)

    def close(self) -> None:
        self._stop.set()
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
        self._thread.join(timeout=2)
