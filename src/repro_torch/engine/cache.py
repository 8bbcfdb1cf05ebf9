"""Content-keyed on-disk cache of cost estimates (port of
``repro/engine/cache.py``; the file format is the reference's, so a cache
written by either package loads in the other).

Same idiom as ``core/dataset.py``'s profiling cache: one JSON file, loaded
eagerly, written atomically (tempfile in the target directory + fsync +
``os.replace``), tolerant of a corrupt file left by earlier non-atomic
writers.  Keys are :meth:`CostQuery.key` content hashes, so estimates are
shared across processes, runs, and differently-named specs with identical
geometry.
"""

from __future__ import annotations

import copy

from repro_torch.core.fileio import atomic_write_json, load_json_tolerant
from repro_torch.engine.types import CostEstimate

__all__ = ["EstimateCache"]


class EstimateCache:
    def __init__(self, path: str):
        self.path = path
        self._data: dict[str, dict] = load_json_tolerant(path)

    def get(self, key: str) -> CostEstimate | None:
        d = self._data.get(key)
        if not d:
            return None
        est = CostEstimate.from_dict(d)
        est.detail = dict(est.detail)   # callers may annotate their copy
        return est

    def put(self, key: str, est: CostEstimate) -> None:
        # Deep-copy the detail dict: the estimate object stays live with the
        # caller, and post-call annotations (possibly non-JSON values) must
        # not leak into — or break the flush of — the on-disk cache.
        d = est.to_dict()
        d["detail"] = copy.deepcopy(d["detail"])
        self._data[key] = d

    def flush(self) -> None:
        atomic_write_json(self.path, self._data)

    def __len__(self) -> int:
        return len(self._data)

    def __contains__(self, key: str) -> bool:
        return key in self._data
