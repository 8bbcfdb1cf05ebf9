"""Lockstep serving engine: prefill + dense-cache decode (port of
``repro/serve/engine.py``).

One fixed batch prefills together and decodes until every member
finishes; it is the baseline the continuous-batching engine is compared
with.  Ragged (mixed-length) prompts are left-padded with a per-row
offset.  Sampling is greedy at temperature 0, else ``torch.multinomial``
driven by a ``torch.Generator`` seeded from ``ServeConfig.seed``.

Not in this slice: placement admission through the cost engine
(``ServeConfig.device`` / ``gamma_budget_mb`` in the reference) — passing
``cost_engine`` raises ``NotImplementedError``.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.device import resolve_device
from repro_torch.models import transformer as T
from repro_torch.serve.continuous import COST_ENGINE_TODO
from repro_torch.serve.scheduler import PlacementRefused

__all__ = ["ServeConfig", "ServeEngine", "PlacementRefused", "pad_ragged"]


@dataclass
class ServeConfig:
    max_len: int = 512
    n_slots: int = 8
    temperature: float = 0.0     # 0 = greedy
    eos_id: int = 1
    seed: int = 0


def pad_ragged(prompts) -> tuple[np.ndarray, np.ndarray]:
    """Left-pad a list of 1-D prompts (or a (B, S) array) to a common
    width.  Returns (tokens (B, S0), lens (B,)).  Left padding keeps the
    prefill's last column = every row's final prompt token."""
    if isinstance(prompts, np.ndarray) and prompts.ndim == 2:
        B, S0 = prompts.shape
        return prompts.astype(np.int32), np.full(B, S0, np.int64)
    rows = [np.asarray(p, np.int32).reshape(-1) for p in prompts]
    lens = np.array([len(r) for r in rows], np.int64)
    if lens.min() <= 0:
        raise ValueError("empty prompt")
    S0 = int(lens.max())
    tokens = np.zeros((len(rows), S0), np.int32)
    for i, r in enumerate(rows):
        tokens[i, S0 - len(r):] = r
    return tokens, lens


class ServeEngine:
    def __init__(self, cfg: ArchConfig, params, scfg: ServeConfig | None = None,
                 cost_engine=None, *, device="cuda"):
        if cost_engine is not None:
            raise NotImplementedError(COST_ENGINE_TODO)
        self.device = resolve_device(device)
        if params.embed.device.type != self.device.type:
            raise ValueError(f"params live on {params.embed.device}, engine "
                             f"device is {self.device}")
        self.cfg = cfg
        self.scfg = scfg or ServeConfig()
        self.params = params
        self._gen = torch.Generator(device=self.device).manual_seed(
            self.scfg.seed)

    def _sample(self, logits) -> np.ndarray:
        z = logits[:, -1].float()
        if self.scfg.temperature <= 0:
            ids = torch.argmax(z, dim=-1)
        else:
            probs = torch.softmax(z / self.scfg.temperature, dim=-1)
            ids = torch.multinomial(probs, 1, generator=self._gen)[:, 0]
        return ids.to(torch.int32).cpu().numpy()

    def generate(self, prompts, max_new_tokens: int = 32) -> dict:
        """prompts: (B, S0) int32 array, or a list of 1-D ragged prompts
        (left-padded internally; B ≤ n_slots).

        Returns dict with ``tokens`` (B, T) raw samples, EOS-trimmed
        per-request ``outputs`` / ``token_counts``, and stats.
        """
        tokens, lens = pad_ragged(prompts)
        B, S0 = tokens.shape
        if B > self.scfg.n_slots:
            raise ValueError(f"{B} prompts > n_slots={self.scfg.n_slots}")
        batch = {"tokens": torch.from_numpy(tokens).to(self.device)}
        pad = S0 - lens
        pos_offset = None
        if pad.any():
            pos_offset = torch.from_numpy(pad.astype(np.int32)).to(self.device)
            batch["pos_offset"] = pos_offset
        out = T.prefill(self.params, batch, self.cfg, max_len=self.scfg.max_len)
        cache, cache_len = out["cache"], out["cache_len"]
        tok = self._sample(out["logits"])
        generated = [tok]
        finished = tok == self.scfg.eos_id
        steps = 0
        for _ in range(max_new_tokens - 1):
            batch = {"tokens": torch.from_numpy(tok[:, None]).to(self.device),
                     "cache_len": cache_len}
            if pos_offset is not None:
                batch["pos_offset"] = pos_offset
            logits, cache = T.decode_step(self.params, cache, batch, self.cfg)
            cache_len += 1
            steps += 1
            tok = self._sample(logits)
            tok = np.where(finished, self.scfg.eos_id, tok).astype(np.int32)
            finished |= tok == self.scfg.eos_id
            generated.append(tok)
            if finished.all() or cache_len >= self.scfg.max_len - 1:
                break
        stacked = np.stack(generated, axis=1)
        outputs, counts = [], np.zeros(B, np.int64)
        for i in range(B):
            row = stacked[i]
            hits = np.flatnonzero(row == self.scfg.eos_id)
            trimmed = row[: hits[0]] if len(hits) else row
            outputs.append(trimmed)
            counts[i] = len(trimmed)
        return {
            "tokens": stacked,
            "outputs": outputs,
            "token_counts": counts,
            "prompt_lens": lens,
            "decode_steps": steps + 1,
            "finished": finished,
        }
