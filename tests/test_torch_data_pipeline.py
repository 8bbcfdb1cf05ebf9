"""The port's data pipeline against the reference's: ``make_batch`` draws
the same arrays, dtypes included, for every (cfg, shape, step, seed);
``TokenPipeline`` resumes exactly, its steps are monotone and its batches
land on the requested device as tensors."""

import numpy as np
import pytest
import torch

from repro.configs.base import ShapeSpec as JShapeSpec
from repro.configs.registry import get_config as jax_config
from repro.data import pipeline as jax_pipeline
from repro_torch.configs.base import ShapeSpec
from repro_torch.configs.registry import get_config
from repro_torch.data.pipeline import TokenPipeline, make_batch
from tests._torch_host import port_host_share  # noqa: F401 (autouse)

SHAPE = ShapeSpec("t", seq_len=16, global_batch=4, kind="train")


@pytest.mark.parametrize("arch", ["qwen3-4b", "internlm2-1.8b", "paligemma-3b",
                                  "whisper-tiny"])
@pytest.mark.parametrize("step, seed", [(0, 0), (7, 3), (1234, 99)])
def test_make_batch_equals_reference(arch, step, seed):
    for reduced in (True, False):
        ours = make_batch(get_config(arch, reduced=reduced), SHAPE, step, seed)
        ref = jax_pipeline.make_batch(jax_config(arch, reduced=reduced),
                                      JShapeSpec("t", 16, 4, "train"), step, seed)
        assert sorted(ours) == sorted(ref)
        for k in ref:
            assert ours[k].dtype == ref[k].dtype
            np.testing.assert_array_equal(ours[k], ref[k])
    assert ours["tokens"].dtype == np.int32


def test_make_batch_deterministic():
    cfg = get_config("qwen3-4b", reduced=True)
    a = make_batch(cfg, SHAPE, step=7, seed=3)
    b = make_batch(cfg, SHAPE, step=7, seed=3)
    np.testing.assert_array_equal(a["tokens"], b["tokens"])
    c = make_batch(cfg, SHAPE, step=8, seed=3)
    assert not np.array_equal(a["tokens"], c["tokens"])


def test_pipeline_resume_matches_fresh():
    cfg = get_config("qwen3-4b", reduced=True)
    p1 = TokenPipeline(cfg, SHAPE, seed=0, device="cpu")
    seen = [next(p1) for _ in range(5)]
    p1.close()
    p2 = TokenPipeline(cfg, SHAPE, seed=0, start_step=3, device="cpu")
    s, b = next(p2)
    p2.close()
    assert s == 3
    assert torch.equal(b["tokens"], seen[3][1]["tokens"])
    np.testing.assert_array_equal(b["tokens"].numpy(),
                                  make_batch(cfg, SHAPE, 3)["tokens"])


def test_pipeline_monotone_steps():
    cfg = get_config("qwen3-4b", reduced=True)
    p = TokenPipeline(cfg, SHAPE, seed=0, device="cpu")
    steps = [next(p)[0] for _ in range(6)]
    p.close()
    assert steps == list(range(6))
    p._thread.join(timeout=30)     # close() stops the producer
    assert not p._thread.is_alive()


def test_pipeline_places_batches_on_the_device():
    cfg = get_config("whisper-tiny", reduced=True)
    p = TokenPipeline(cfg, SHAPE, seed=1, device="cpu")
    step, batch = next(p)
    p.close()
    want = make_batch(cfg, SHAPE, step, 1)
    assert sorted(batch) == sorted(want) == ["frames", "tokens"]
    for k, t in batch.items():
        assert torch.is_tensor(t) and t.device == torch.device("cpu")
        np.testing.assert_array_equal(t.numpy(), want[k])
    assert batch["tokens"].dtype == torch.int32
    assert batch["frames"].dtype == torch.float32
