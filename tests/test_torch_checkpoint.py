"""The port's checkpoints: the reference's five cases (bf16 round trip,
keep-N GC, a partial ``.tmp`` ignored, a missing directory or leaf raises, a
specific step restores), the on-disk layout, and checkpoints across the
two packages in both directions: one written by ``repro.train.checkpoint``
from a reference ``Trainer`` state restores in the port's ``Trainer`` to
identical values, and one the port writes restores in the reference."""

import json
import os

import jax
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.configs.base import ShapeSpec as JShapeSpec
from repro.configs.registry import get_config as jax_config
from repro.optim.optimizer import OptimizerConfig as JOptimizerConfig
from repro.train import checkpoint as jax_ckpt
from repro.train.trainer import Trainer as JTrainer
from repro.train.trainer import TrainerConfig as JTrainerConfig
from repro_torch.configs.base import ShapeSpec
from repro_torch.configs.registry import get_config
from repro_torch.convert import train_state_to_numpy
from repro_torch.optim.optimizer import OptimizerConfig
from repro_torch.train import checkpoint as ckpt
from repro_torch.train.trainer import Trainer, TrainerConfig
from tests._torch_host import port_host_share  # noqa: F401 (autouse)


def _state(seed=0):
    g = torch.Generator().manual_seed(seed)
    return {
        "params": {"w": torch.randn(4, 8, generator=g),
                   "b": torch.randn(8, generator=g).to(torch.bfloat16)},
        "opt": {"step": torch.tensor(7, dtype=torch.int32),
                "m": {"w": torch.randn(4, 8, generator=g)}},
    }


def test_roundtrip_with_bf16(tmp_path):
    d = str(tmp_path / "ck")
    s = _state()
    ckpt.save_checkpoint(d, 10, s)
    step, restored = ckpt.restore_checkpoint(d)
    assert step == 10
    for got, want in ((restored["params"]["w"], s["params"]["w"]),
                      (restored["params"]["b"], s["params"]["b"]),
                      (restored["opt"]["step"], s["opt"]["step"]),
                      (restored["opt"]["m"]["w"], s["opt"]["m"]["w"])):
        assert got.dtype == want.dtype and torch.equal(got, want)


def test_keep_n_gc(tmp_path):
    d = str(tmp_path / "ck")
    s = _state()
    for step in range(5):
        ckpt.save_checkpoint(d, step, s, keep=2)
    assert ckpt.list_steps(d) == [3, 4]


def test_latest_ignores_partial_tmp(tmp_path):
    d = str(tmp_path / "ck")
    ckpt.save_checkpoint(d, 1, _state())
    # a crash mid-write: a tmp dir without manifest
    os.makedirs(os.path.join(d, "step_000000002.tmp"))
    # and a committed-looking dir without manifest (unreadable)
    os.makedirs(os.path.join(d, "step_000000003"))
    assert ckpt.latest_step(d) == 1


def test_restore_missing_raises(tmp_path):
    with pytest.raises(FileNotFoundError):
        ckpt.restore_checkpoint(str(tmp_path / "none"))
    # a checkpoint without the error state, resumed with compression on
    d = str(tmp_path / "ck")
    _trainer(ckpt_dir=d, ckpt_every=100).train(1)
    with pytest.raises(KeyError, match="missing leaf err"):
        _trainer(ckpt_dir=d, grad_compression=0.25).restore_or_init()


def test_restore_specific_step(tmp_path):
    d = str(tmp_path / "ck")
    s1, s2 = _state(1), _state(2)
    ckpt.save_checkpoint(d, 1, s1, keep=5)
    ckpt.save_checkpoint(d, 2, s2, keep=5)
    _, r1 = ckpt.restore_checkpoint(d, step=1)
    assert torch.equal(r1["params"]["w"], s1["params"]["w"])


def test_layout_is_the_references(tmp_path):
    """Manifest, shard files and keys as ``repro.train.checkpoint`` writes
    them for the same tree: 64 leaves to a shard, sorted ``/`` keys stored
    with ``__``, bf16 as a flagged uint16 view."""
    rng = np.random.default_rng(0)
    tree = {f"l{i:03d}": rng.standard_normal((3, i % 5 + 1)).astype(np.float32)
            for i in range(70)}
    tree["nested"] = {"bf": rng.standard_normal((2, 2)).astype(ml_dtypes.bfloat16),
                      "step": np.int32(3)}
    ckpt.save_checkpoint(str(tmp_path / "port"), 4, tree)
    jax_ckpt.save_checkpoint(str(tmp_path / "ref"), 4, tree)
    man = {}
    for side in ("port", "ref"):
        step_dir = tmp_path / side / "step_000000004"
        man[side] = json.loads((step_dir / "manifest.json").read_text())
        assert sorted(os.listdir(step_dir)) == ["manifest.json", "shard_00000.npz",
                                                "shard_00001.npz"]
    assert man["port"] == man["ref"]
    assert man["port"]["leaves"]["nested/bf"] == {"shape": [2, 2], "dtype": "bfloat16",
                                                  "shard": 1, "bf16": True}
    for si in range(2):
        name = f"step_000000004/shard_{si:05d}.npz"
        with np.load(tmp_path / "port" / name) as a, np.load(tmp_path / "ref" / name) as b:
            assert sorted(a.files) == sorted(b.files)
            for k in a.files:
                assert a[k].dtype == b[k].dtype
                np.testing.assert_array_equal(a[k], b[k])


# -- across the two packages -----------------------------------------------

SHAPE, JSHAPE = ShapeSpec("ck", 16, 2, "train"), JShapeSpec("ck", 16, 2, "train")


def _ref_trainer(**kw):
    return JTrainer(jax_config("internlm2-1.8b", reduced=True), JSHAPE,
                    JOptimizerConfig(warmup_steps=2, total_steps=50), JTrainerConfig(**kw))


def _trainer(**kw):
    return Trainer(get_config("internlm2-1.8b", reduced=True), SHAPE,
                   OptimizerConfig(warmup_steps=2, total_steps=50), TrainerConfig(**kw),
                   device="cpu")


def _flat(tree):
    return {jax.tree_util.keystr(p): np.asarray(a) for p, a in
            jax.tree_util.tree_leaves_with_path(tree)}


def test_reference_checkpoint_restores_in_the_port(tmp_path):
    d = str(tmp_path / "ck")
    state = _ref_trainer(grad_compression=0.25).init_state()
    rng = np.random.default_rng(5)
    fill = lambda a: rng.standard_normal(a.shape).astype(np.float32)  # noqa: E731
    state["opt"] = {"step": np.int32(9), "m": jax.tree.map(fill, state["opt"]["m"]),
                    "v": jax.tree.map(fill, state["opt"]["v"])}
    state["err"] = jax.tree.map(fill, state["err"])
    jax_ckpt.save_checkpoint(d, 9, state)

    start, ours = _trainer(ckpt_dir=d, grad_compression=0.25).restore_or_init()
    assert start == 10
    assert ours["params"].embed.dtype == torch.bfloat16
    assert ours["opt"]["step"].dtype == torch.int32
    assert all(p.requires_grad and p.grad is not None for p in ours["params"].parameters())
    got, want = _flat(train_state_to_numpy(ours, _trainer().cfg)), _flat(state)
    assert sorted(got) == sorted(want)
    for k, a in want.items():
        np.testing.assert_array_equal(got[k], np.asarray(a, got[k].dtype), err_msg=k)


def test_port_checkpoint_restores_in_the_reference(tmp_path):
    d = str(tmp_path / "ck")
    tr = _trainer(ckpt_dir=d, ckpt_every=100)
    out = tr.train(2)                      # two port steps, saved at step 1
    assert ckpt.list_steps(d) == [1]
    ref = _ref_trainer(ckpt_dir=d)
    step, restored = jax_ckpt.restore_checkpoint(d, template=ref.init_state())
    assert step == 1
    assert restored["params"]["embed"].dtype == ml_dtypes.bfloat16
    assert restored["opt"]["m"]["embed"].dtype == np.float32
    assert restored["opt"]["step"].dtype == np.int32 and int(restored["opt"]["step"]) == 2
    got, want = _flat(restored), _flat(train_state_to_numpy(out["state"], tr.cfg))
    assert sorted(got) == sorted(want)
    for k, a in want.items():
        np.testing.assert_array_equal(np.asarray(got[k], a.dtype), a, err_msg=k)
    # and the reference's own resume path reads it
    assert ref.restore_or_init()[0] == 2
