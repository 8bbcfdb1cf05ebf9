"""Fault-tolerant checkpointing (port of ``repro/train/checkpoint.py``).

The on-disk layout is the reference's own, so a checkpoint written by
either package restores in the other::

    <dir>/step_000000100.tmp/   — written first
        shard_00000.npz         — up to 64 leaves, key "a/b/c" stored as "a__b__c"
        manifest.json           — step, n_shards, leaves {key: shape, dtype, shard[, bf16]}
    <dir>/step_000000100/       — atomic rename when complete

Keys are the ``/``-joined paths of a tree of nested dicts (and lists, by
index), written in sorted order; bfloat16 leaves are stored as a uint16
view (npz has no bfloat16) and flagged ``bf16`` in the manifest.

Properties, all tested: atomic visibility (a crash mid-write leaves a
``.tmp`` directory, which ``latest_step`` ignores), keep-N garbage
collection, and exact resume (the step is in the manifest).  Leaves may
be tensors on any device or numpy arrays; they restore as CPU tensors in
a tree of nested dicts, one level for each ``/`` of the key.
"""

from __future__ import annotations

import json
import os
import re
import shutil

import numpy as np
import torch

__all__ = ["save_checkpoint", "restore_checkpoint", "latest_step", "list_steps"]

_STEP_RE = re.compile(r"^step_(\d{9})$")
_SHARD_LEAVES = 64  # leaves per npz shard file


def _paths(tree, prefix=()):
    """(path, leaf) of every leaf of nested dicts, lists and tuples."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        yield prefix, tree
        return
    for k, v in items:
        yield from _paths(v, prefix + (str(k),))


def _to_numpy(leaf) -> tuple[np.ndarray, bool]:
    """(array to store, whether it is a bf16 leaf stored as uint16)."""
    if torch.is_tensor(leaf):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16), True
        return t.numpy(), False
    a = np.asarray(leaf)
    if str(a.dtype) == "bfloat16":          # the reference's ml_dtypes leaves
        return a.view(np.uint16), True
    return a, False


def save_checkpoint(directory: str, step: int, state, *, keep: int = 3) -> str:
    os.makedirs(directory, exist_ok=True)
    name = f"step_{step:09d}"
    tmp = os.path.join(directory, name + ".tmp")
    final = os.path.join(directory, name)
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)

    flat = {"/".join(path): leaf for path, leaf in _paths(state)}
    keys = sorted(flat)
    manifest = {"step": step, "leaves": {}, "n_shards": 0}
    shard, shard_idx = {}, 0
    for i, k in enumerate(keys):
        a, bf16 = _to_numpy(flat[k])
        entry = {"shape": list(a.shape),
                 "dtype": "bfloat16" if bf16 else str(a.dtype), "shard": shard_idx}
        if bf16:
            entry["bf16"] = True
        manifest["leaves"][k] = entry
        shard[k.replace("/", "__")] = a
        if len(shard) >= _SHARD_LEAVES or i == len(keys) - 1:
            np.savez(os.path.join(tmp, f"shard_{shard_idx:05d}.npz"), **shard)
            shard, shard_idx = {}, shard_idx + 1
    manifest["n_shards"] = shard_idx
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.replace(tmp, final)  # atomic commit

    # keep-N GC (never deletes the one just written)
    steps = list_steps(directory)
    for s in steps[:-keep] if keep else []:
        shutil.rmtree(os.path.join(directory, f"step_{s:09d}"), ignore_errors=True)
    return final


def list_steps(directory: str) -> list[int]:
    if not os.path.isdir(directory):
        return []
    out = []
    for n in os.listdir(directory):
        m = _STEP_RE.match(n)
        if m and os.path.exists(os.path.join(directory, n, "manifest.json")):
            out.append(int(m.group(1)))
    return sorted(out)


def latest_step(directory: str) -> int | None:
    steps = list_steps(directory)
    return steps[-1] if steps else None


def restore_checkpoint(directory: str, step: int | None = None):
    """Load a checkpoint → (step, tree): nested dicts keyed by the parts of
    each ``/``-joined key, with CPU tensor leaves in their stored dtypes."""
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {directory}")
    path = os.path.join(directory, f"step_{step:09d}")
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)

    tree: dict = {}
    for si in range(manifest["n_shards"]):
        with np.load(os.path.join(path, f"shard_{si:05d}.npz")) as shard:
            for key, entry in manifest["leaves"].items():
                if entry["shard"] != si:
                    continue
                a = shard[key.replace("/", "__")]
                *parents, name = key.split("/")
                node = tree
                for k in parents:
                    node = node.setdefault(k, {})
                node[name] = (torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
                              if entry.get("bf16") else torch.from_numpy(a))
    return manifest["step"], tree
