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
be tensors on any device, ``DTensor``s (saved whole: every rank gathers
each one) or numpy arrays; in a process group rank 0 writes and the ranks
meet at a barrier; they restore as CPU tensors in a tree of nested dicts, one level
for each ``/`` of the key.  Given a ``template`` (the target tree) and
``shardings`` (a matching tree of ``distributed.sharding.NamedSharding``),
``restore_checkpoint`` is the reference's elastic restore: a state saved
from one mesh is placed on another mesh's placements.
"""

from __future__ import annotations

import json
import os
import re
import shutil

import numpy as np
import torch

from repro_torch.launch.mesh import is_dtensor, is_rank0

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
        if is_dtensor(leaf):
            leaf = leaf.full_tensor()
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16), True
        return t.numpy(), False
    a = np.asarray(leaf)
    if str(a.dtype) == "bfloat16":          # the reference's ml_dtypes leaves
        return a.view(np.uint16), True
    return a, False


def save_checkpoint(directory: str, step: int, state, *, keep: int = 3) -> str:
    name = f"step_{step:09d}"
    final = os.path.join(directory, name)
    flat = {"/".join(path): _to_numpy(leaf) for path, leaf in _paths(state)}
    if is_rank0():                      # every rank gathered; rank 0 writes
        _write(directory, step, flat, keep)
    if torch.distributed.is_available() and torch.distributed.is_initialized():
        torch.distributed.barrier()
    return final


def _write(directory: str, step: int, flat: dict, keep: int) -> None:
    """Write ``{key: (array, bf16)}`` as the step's directory, atomically,
    then keep the newest ``keep``."""
    os.makedirs(directory, exist_ok=True)
    name = f"step_{step:09d}"
    tmp = os.path.join(directory, name + ".tmp")
    final = os.path.join(directory, name)
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)

    keys = sorted(flat)
    manifest = {"step": step, "leaves": {}, "n_shards": 0}
    shard, shard_idx = {}, 0
    for i, k in enumerate(keys):
        a, bf16 = flat[k]
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


def restore_checkpoint(directory: str, step: int | None = None, *,
                       template=None, shardings=None):
    """Load a checkpoint → (step, tree): nested dicts keyed by the parts of
    each ``/``-joined key, with CPU tensor leaves in their stored dtypes.
    ``template`` (a tree of nested dicts and lists with the target
    structure) rebuilds that tree from the keys of its leaves;
    ``shardings`` (a matching tree of ``NamedSharding``) re-places every
    leaf as a ``DTensor`` on a possibly different mesh (elastic
    restore)."""
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
    if template is None:
        return manifest["step"], tree

    def rebuild(t, path=()):
        if isinstance(t, dict):
            return {k: rebuild(v, path + (str(k),)) for k, v in t.items()}
        if isinstance(t, (list, tuple)):
            return type(t)(rebuild(v, path + (str(i),)) for i, v in enumerate(t))
        node = tree
        for k in path:
            if not isinstance(node, dict) or k not in node:
                raise KeyError(f"checkpoint missing leaf {'/'.join(path)}")
            node = node[k]
        return node

    out = rebuild(template)
    if shardings is not None:
        from repro_torch.distributed.sharding import distribute_tree

        out = distribute_tree(out, shardings)
    return manifest["step"], out
