"""The ``mobilenetv2-224-train-bs256`` cell on the CPU: its files are the
ones the reference tests read, its per-layer reader ``dw_conv.roofline_pct``
prices the depthwise passes over the device time under the program's
depthwise spans, and the harness's and the check's tests hold for it at
width 0.25, 32 x 32, batch 8.  (MobileNetV2 halves the input five times:
at 16 x 16 and batch 4 its last BatchNorms normalise 4 numbers a channel
and the steps after the checked ones overflow.)"""

import json

import pytest

from perfbench import counts, faults, spec
from perfbench.reference import cnn as ref
from perfbench.run import LayerContext
from perfbench.tracing import TraceSummary

from . import test_perfbench_check as check
from . import test_perfbench_harness as harness
from .conftest import small_cell

MBV2 = "mobilenetv2-224-train-bs256"
READER = "dw_conv.roofline_pct"


@pytest.fixture
def at_32(monkeypatch):
    """The harness's and the check's tests take the cell at 32 x 32, batch 8."""
    def small(workload, **_):
        return small_cell(workload, hw=32, bs=8)

    monkeypatch.setattr(harness, "small_cell", small)
    monkeypatch.setattr(check, "small_cell", small)
    monkeypatch.setitem(check.CONTROL_FAILS, MBV2, "grad_gap")


def test_the_cell_reads_the_tested_files():
    cell = spec.resolve(MBV2)
    tests = spec.HERE / "tests"
    assert cell.config == json.loads((tests / "configs" / "mobilenetv2-224-c100.json").read_text())
    assert cell.limits == json.loads((tests / "limits" / f"{MBV2}.json").read_text())
    assert cell.config["block"] == "inverted_residual" and cell.chips == 1
    assert cell.traffic["entry"] == "cnn_train" and cell.traffic["batch_size"] == 256
    assert [m["name"] for m in cell.per_layer] == [READER]
    assert {m["name"] for m in cell.end_to_end} >= {"setup_s", "images_per_s"}
    for other in ("resnet50-train-bs256", "resnet18-train-bs512", "resnet50-infer-bs512"):
        assert READER not in [m["name"] for m in spec.resolve(other).per_layer]


def _ctx(under: dict, config: str = "mobilenetv2-224-c100", steps: int = 6):
    p = ref.plan(json.loads((spec.HERE / "configs" / f"{config}.json").read_text()))
    peaks = json.loads((spec.HERE / "peaks.json").read_text())["NVIDIA H100 80GB HBM3"]
    trace = TraceSummary(steps, 1.0, 1.0, {"k": 1.0}, [], dict(under))
    return LayerContext(trace, counts.cnn_step_costs(p, 256, train=True),
                        peaks["flops"]["float32"], peaks["bytes_per_s"], spec.HERE)


@pytest.mark.parametrize("under", [
    {"repro.dw_conv": 0.013, "repro.dw_conv.backward": 0.079, "repro.conv_backward": 0.2},
    {"repro.dw_conv": 0.013},
])
def test_dw_conv_reader_prices_the_spans(under):
    ctx = _ctx(under)
    dw = ctx.costs.dw
    assert len(dw) == 3 * 17 and {c.kind for c in dw} == {"fwd", "dgrad", "wgrad"}
    t = sum(v for k, v in under.items() if k.startswith("repro.dw_conv"))
    bound = counts.bound_s(dw, ctx.peak_flops, ctx.peak_bytes)
    # every depthwise pass is bound by its bytes
    assert bound == pytest.approx(sum(c.bytes for c in dw) / ctx.peak_bytes)
    got = spec.reader("metrics", READER).read(ctx)
    assert got == pytest.approx(100.0 * bound * 6 / t)


@pytest.mark.parametrize("under, config", [
    ({"repro.conv_backward": 0.2, "aten::convolution_backward": 0.2}, "mobilenetv2-224-c100"),
    ({}, "mobilenetv2-224-c100"),
    ({"repro.dw_conv": 0.01, "repro.dw_conv.backward": 0.02}, "resnet50-cifar100"),
])
def test_dw_conv_reader_reads_none_without_spans_or_passes(under, config):
    """A program without the depthwise spans (the parent commit's), or a
    network without grouped convolutions, gives no reading."""
    assert spec.reader("metrics", READER).read(_ctx(under, config)) is None


@pytest.mark.parametrize("trace", [False, True])
def test_last_line_shape(trace, capsys, at_32):
    harness.test_last_line_shape(MBV2, trace, capsys)


def test_sound_run_is_correct(float64, capsys, at_32):
    check.test_sound_run_is_correct(MBV2, float64, capsys)


@pytest.mark.parametrize("fault", sorted(faults.FAULTS))
def test_fault_is_not_correct(fault, float64, capsys, at_32):
    check.test_fault_is_not_correct(MBV2, fault, float64, capsys)


def test_control_is_not_correct(capsys, at_32):
    check.test_control_is_not_correct(MBV2, capsys)
