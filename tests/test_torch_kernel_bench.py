"""The port's kernel benchmark (``repro_torch.bench.kernel_bench``) against
the reference's (``benchmarks/kernel_bench.py``) on the CPU.

The model rows (``model_default_us``, ``model_tuned_us``,
``model_gather_us``, the ``serve_kv`` joint block and the tuner's
second-pass hits, all under ``tpu_v5e`` with ``measure=False``) are
framework-free: equal to the reference's, line for line.  The ``ref_us``
rows time each package's plain version on its own device, so only their
names are held, and the port's names the spec its roofline read.  The
``card_us`` rows need the card: ``run`` on the CPU prints none, and
``card_rows`` refuses a CPU device.
"""

import pytest
import torch

from benchmarks import kernel_bench as ref_bench
from repro_torch.bench import kernel_bench
from tests._torch_host import port_host_share  # noqa: F401 (autouse)


@pytest.fixture(scope="module")
def runs():
    mine, ref = [], []
    out = kernel_bench.run(mine.append, device="cpu")
    ref_out = ref_bench.run(ref.append)
    return out, mine, ref_out, ref


def test_model_rows_equal_the_reference(runs):
    out, mine, ref_out, ref = runs
    model = [ln for ln in ref if "/ref_us," not in ln]
    assert [ln for ln in mine if "/ref_us," not in ln] == model
    assert len(model) == 13
    for name in ("flash_attention", "conv_mm", "ssm_scan", "moe_dispatch",
                 "paged_decode"):
        assert out[name] == ref_out[name], name
        assert out[name]["tuned_us"] <= out[name]["default_us"]
    assert out["serve_kv_joint"] == ref_out["serve_kv_joint"]
    assert out["paged_decode"]["vs_gather"] >= 1.0
    assert (out["second_call_hits"], out["second_call_misses"]) == (6, 0)
    assert "card" not in out


def test_ref_rows_name_the_device_they_ran_on(runs):
    _, mine, _, ref = runs
    names = [ln.split(",")[0] for ln in mine if "/ref_us," in ln]
    assert names == [ln.split(",")[0] for ln in ref if "/ref_us," in ln]
    assert names == ["kernel/flash_attn/ref_us", "kernel/conv_mm/ref_us", "kernel/ssd/ref_us"]
    for ln in mine:
        if "/ref_us," in ln:
            assert float(ln.split(",")[1]) > 0
            assert "roofline_us=" in ln and "(torch_cpu)" in ln
            assert "tpu_roofline_us" not in ln


def test_default_device_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        kernel_bench.run(lambda *_: None)


def test_card_rows_refuse_the_cpu():
    with pytest.raises(ValueError, match="CUDA device"):
        kernel_bench.card_rows(lambda *_: None, device="cpu")
