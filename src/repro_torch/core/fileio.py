"""Shared atomic-file idioms for the on-disk caches and model files.

(Copy of ``repro/core/fileio.py``: numpy and the standard library
only, kept in the port so that it imports nothing of ``repro``.)

Every persistent artifact in this repo (profiling cache, estimate cache,
fitted predictors) follows the same contract: writes go to a tempfile in
the target directory, are fsync'd, then ``os.replace``d over the target —
an interrupted run can never leave a truncated file; and a corrupt file
(pre-atomic writer, torn disk) is quarantined to ``<path>.corrupt`` so the
caller restarts from empty instead of crashing.
"""

from __future__ import annotations

import json
import os
import tempfile
from typing import Callable

__all__ = [
    "load_json_tolerant",
    "atomic_write_json",
    "atomic_write_bytes",
    "append_jsonl",
    "load_jsonl_tolerant",
]


def load_json_tolerant(path: str) -> dict:
    """Load a JSON dict; quarantine an unreadable/corrupt/non-dict file and
    return {} (valid JSON that is not an object would crash callers just as
    surely as a parse error)."""
    if not os.path.exists(path):
        return {}
    try:
        with open(path) as f:
            data = json.load(f)
        if isinstance(data, dict):
            return data
    except (json.JSONDecodeError, UnicodeDecodeError):
        pass
    except OSError:
        # Transient read failure (permissions, I/O hiccup) is NOT evidence
        # of corruption — never rename a possibly-valid cache away.
        return {}
    try:
        os.replace(path, path + ".corrupt")
    except OSError:
        pass
    return {}


def _atomic_write(path: str, mode: str, write_fn: Callable, suffix: str = "") -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=os.path.dirname(path) or ".", suffix=suffix)
    try:
        with os.fdopen(fd, mode) as f:
            write_fn(f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)  # atomic on POSIX
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise


def atomic_write_json(path: str, obj) -> None:
    _atomic_write(path, "w", lambda f: json.dump(obj, f))


def atomic_write_bytes(path: str, write_fn: Callable, suffix: str = "") -> None:
    """Atomic binary write; ``write_fn(file)`` produces the content (e.g.
    ``lambda f: np.savez_compressed(f, **arrays)``)."""
    _atomic_write(path, "wb", write_fn, suffix=suffix)


# ---------------------------------------------------------------------------
# Append-only JSONL ledgers (profiling campaigns, dry-run reports).
#
# The whole-file atomic rewrite above is wrong for a ledger shared by many
# workers: two concurrent rewrites lose each other's records.  An O_APPEND
# write of complete ``record\n`` lines in a single ``os.write`` call never
# interleaves with another appender's lines on POSIX, and the fsync makes a
# recorded cell durable before the runner moves to the next one.  A crash
# can at worst leave one torn *final* line, which the tolerant loader drops
# — so restart logic re-runs only the cell whose record was torn.
# ---------------------------------------------------------------------------


def append_jsonl(path: str, records: list | dict) -> int:
    """Durably append record dict(s) as JSONL; returns the number written."""
    if isinstance(records, dict):
        records = [records]
    if not records:
        return 0
    payload = "".join(
        json.dumps(r, sort_keys=True, default=str) + "\n" for r in records
    )
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    # O_RDWR (not O_WRONLY) so the pread below can heal a torn tail: if a
    # crashed writer left the file without a trailing newline, start this
    # append on a fresh line — otherwise the first new record glues onto
    # the torn fragment and BOTH lines are lost to the tolerant loader.
    fd = os.open(path, os.O_RDWR | os.O_CREAT | os.O_APPEND, 0o644)
    try:
        size = os.fstat(fd).st_size
        if size > 0 and os.pread(fd, 1, size - 1) != b"\n":
            payload = "\n" + payload
        os.write(fd, payload.encode())
        os.fsync(fd)
    finally:
        os.close(fd)
    return len(records)


def load_jsonl_tolerant(path: str) -> list[dict]:
    """Load JSONL records, skipping anything unparsable.

    Blank lines and non-dict rows are ignored; a torn final line (a crash
    mid-append) parses as garbage and is silently dropped — the caller's
    resume logic treats that cell as never recorded.  Unlike
    :func:`load_json_tolerant` the file is NOT quarantined: every intact
    line is an independent record and stays usable."""
    if not os.path.exists(path):
        return []
    out: list[dict] = []
    try:
        with open(path, errors="replace") as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                try:
                    rec = json.loads(line)
                except json.JSONDecodeError:
                    continue
                if isinstance(rec, dict):
                    out.append(rec)
    except OSError:
        return out
    return out
