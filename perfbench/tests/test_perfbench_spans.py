"""The benchmark's reading of the program's spans on the CPU: the idle
split by span, device time under a span or an operator without CUPTI's
overhead events (``TraceSummary.under``),
the share of spans that waited, and ``conv_mm.host_us_per_call`` on a CPU
trace of the program's step and on a program without spans."""

import dataclasses
import statistics
import sys
from types import SimpleNamespace

import pytest
from torch.profiler import ProfilerActivity, profile

from perfbench import spans as bench_spans
from perfbench import spec, tracing
from perfbench.run import LayerContext

from .conftest import small_cell

HOST_US = "conv_mm.host_us_per_call"


def _ev(name, start, end, device="CPU"):
    return SimpleNamespace(name=name, device_type=SimpleNamespace(name=device),
                           time_range=SimpleNamespace(start=start, end=end))


def _host_ev(name, kernels_us=(), children=()):
    e = _ev(name, 0, 1)
    e.kernels = [SimpleNamespace(duration=d) for d in kernels_us]
    e.cpu_children, e.cpu_parent = list(children), None
    for c in children:
        c.cpu_parent = e
    return e


def _tree(root):
    out, stack = [], [root]
    while stack:
        e = stack.pop()
        out.append(e)
        stack.extend(e.cpu_children)
    return out


def test_idle_by_span_takes_the_innermost_open_span():
    dev = [(0, 10), (20, 30), (31, 40), (60, 70), (110, 120), (200, 210)]
    mirrored = _ev("repro.step", 0, 210, "CUDA")
    mirrored.is_user_annotation = True
    events = [_ev("k", s, t, "CUDA") for s, t in dev] + [
        mirrored, _ev("repro.step", 0, 100), _ev("repro.bn", 12, 25),
        _ev("repro.conv_backward", 50, 65), _ev("aten::add", 14, 16),
        _ev("repro.empty", 5, 5)]
    got = bench_spans.idle_by_span(events)
    want = {"repro.bn": 10e-6, "repro.step": 41e-6, "repro.conv_backward": 20e-6,
            bench_spans.OUTSIDE: 80e-6}
    assert got == pytest.approx(want)
    assert list(got) == sorted(got, key=lambda k: -got[k])
    assert bench_spans.idle_by_span([_ev("k", 0, 1, "CUDA")]) == {}


def _overhead_tree():
    """Kernels hung on CUPTI overhead events (a wait for room in the
    queue, a buffer flush) at any depth, beside an operator's own."""
    wait = _host_ev(bench_spans.WAIT, [400.0])        # carries another operator's kernel
    flush = _host_ev("Buffer Flush", [], [_host_ev("aten::copy_", [7.0])])
    mm = _host_ev("aten::mm", [30.0], [_host_ev("Command Buffer Full", [90.0])])
    bwd = _host_ev("aten::convolution_backward", [50.0], [mm, wait, flush])
    step = _host_ev("repro.step", [1.0], [bwd, _host_ev("repro.bn", [], [_host_ev("aten::add", [5.0])])])
    return step, {"aten::convolution_backward": 80e-6, "repro.step": 86e-6, "aten::mm": 30e-6,
                  "repro.bn": 5e-6, bench_spans.WAIT: 0.0, "Buffer Flush": 0.0}


def _nested_tree():
    """A wait under an operator inside one span, and a span nested in a
    span of its own name (counted once, by its outermost call)."""
    wait = _host_ev(bench_spans.WAIT, [400.0])
    var = _host_ev("aten::var", [30.0], [wait])
    bn = _host_ev("repro.bn", [], [_host_ev("aten::mean", [20.0]), var])
    inner = _host_ev("repro.bn", [], [_host_ev("aten::sub", [5.0])])
    step = _host_ev("repro.step", [1.0], [bn, _host_ev("repro.bn", [], [inner])])
    return step, {"repro.bn": 55e-6, "repro.step": 56e-6, "aten::var": 30e-6}


@pytest.mark.parametrize("tree", [_overhead_tree, _nested_tree])
def test_under_counts_no_kernel_on_an_overhead_event(tree):
    """``TraceSummary.under``: a kernel that the profiler hangs on a CUPTI
    overhead event is not counted, one on an operator is, and an operator
    counts by its outermost calls."""
    root, want = tree()
    summary = tracing.summarize(_tree(root) + [_ev("k", 0, 1, "CUDA")], 1, 1.0)
    assert {op: summary.under(op) for op in want} == pytest.approx(want)
    assert summary.under("none") is None
    assert bench_spans.WAIT in tracing.OVERHEAD


def test_waited_share_finds_a_wait_at_any_depth():
    root, _ = _nested_tree()
    events = _tree(root) + [_ev("k", 0, 1, "CUDA")]
    # one of the three BatchNorm spans holds a wait, at any depth
    assert bench_spans.waited_share(events, "repro.bn") == pytest.approx(1 / 3)
    assert bench_spans.waited_share(events, "repro.step") == 1.0
    assert bench_spans.waited_share(events, "none") is None


def _cpu_trace():
    """A CPU trace of one small ResNet-18 training step through the
    program, its summary, and the costs the readers price."""
    from perfbench.entries.cnn_train import Entry
    from repro_torch.core import spans

    cell = small_cell("resnet18-train-bs512")
    entry = Entry(cell, 5, "cpu")
    entry.setup()
    spans.clear()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        entry.call(0)
    summary = tracing.summarize(prof.events(), 1, 1.0)
    return cell, summary, entry.costs(), spans.host_seconds()


def _read(cell, summary, costs):
    ctx = LayerContext(summary, costs, None, None, cell.root)
    return spec.reader("metrics", HOST_US, cell.root).read(ctx)


def test_host_reader_on_a_cpu_trace():
    cell, summary, costs, host = _cpu_trace()
    assert len(host["repro.step"]) == 1 and len(host["repro.conv_mm"]) == 20
    (m,) = [m for m in spec.resolve(cell.name).per_layer if m["name"] == HOST_US]
    # the metric names only cells that exist, and the three it was given; a
    # cell added later may report metrics of its own in its place
    assert set(m["workloads"]) <= {w["name"] for w in spec.load_benchmark()["workloads"]}
    assert set(m["workloads"]) >= {"resnet50-train-bs256", "resnet18-train-bs512",
                                   "resnet50-infer-bs512"}
    # the CPU trace holds no device operation (and the span holds the plain
    # convolution itself): nothing to read
    assert _read(cell, summary, costs) is None
    seen = dataclasses.replace(summary, busy_s=1.0)
    assert _read(cell, seen, costs) == pytest.approx(1e6 * statistics.median(host["repro.conv_mm"]))


def test_host_reader_without_the_programs_spans(monkeypatch):
    """A program that has no span module (the parent of the spans): the
    reader returns nothing and raises nothing."""
    cell, summary, costs, _ = _cpu_trace()
    monkeypatch.setitem(sys.modules, "repro_torch.core.spans", None)
    assert bench_spans.program_host_s("repro.conv_mm") == []
    assert _read(cell, dataclasses.replace(summary, busy_s=1.0), costs) is None
