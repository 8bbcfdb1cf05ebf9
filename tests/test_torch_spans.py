"""The CNN step's spans (``repro_torch.core.spans``) on the CPU: off and
free while no profiler collects; under ``torch.profiler`` one
``repro.step`` a call with its phases inside, one ``repro.conv_mm`` per
groups-1 convolution, one ``repro.dw_conv`` and one
``repro.dw_conv.backward`` per depthwise convolution, one
``repro.conv_backward`` per convolution of either kind, one ``repro.bn``
per BatchNorm, their host durations kept; and the step's numbers bitwise
the same with the profiler on."""

import dataclasses

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch.convert import cnn_params_from_numpy, tree_leaves, tree_map
from repro_torch.core import profiler, spans
from repro_torch.models import cnn
from tests._torch_host import port_host_share  # noqa: F401 (autouse)

WIDTH, BS = 0.25, 4
# MobileNetV2 halves its input five times: at 32 x 32 its last maps are 1 x 1
HW = {"resnet18": 16, "resnet50": 16, "mobilenetv2": 32}
MODELS = list(HW)


def _setup(family):
    hw = HW[family]
    model = cnn.CNN_BUILDERS[family](width_mult=WIDTH, input_hw=hw)
    params = cnn_params_from_numpy(model.init(0), device="cpu")
    mom = tree_map(torch.zeros_like, params)
    rng = np.random.default_rng(1)
    x = torch.tensor(rng.standard_normal((BS, hw, hw, 3)).astype(np.float32))
    y = torch.tensor(rng.integers(0, model.num_classes, BS).astype(np.int32))
    return model, params, mom, x, y


def _nodes(node):
    yield node
    for f in dataclasses.fields(node):
        v = getattr(node, f.name)
        for child in (v if isinstance(v, tuple) else (v,)):
            if isinstance(child, cnn.Node):
                yield from _nodes(child)


def _counts(model):
    """(groups-1 convolutions, depthwise convolutions, BatchNorms) of
    ``model``'s graph."""
    cs = [n for n in _nodes(model.graph) if isinstance(n, cnn.C)]
    convs = sum(1 for n in cs if not n.depthwise)
    dws = sum(1 for n in cs if n.depthwise)
    # conv_specs() records every convolution and, as a 1x1 convolution, the Dense head
    layers = model.conv_specs().layers
    assert convs == sum(1 for l in layers if l.groups == 1) - 1
    assert dws == sum(1 for l in layers if l.groups > 1)
    return convs, dws, sum(1 for n in cs if n.bn)


def _traced(fn):
    spans.clear()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    return out, [e for e in prof.events() if e.name.startswith("repro.")], spans.host_seconds()


def _names(events):
    return [e.name for e in events]


def _inside(inner, outer) -> bool:
    return (outer.time_range.start <= inner.time_range.start
            and inner.time_range.end <= outer.time_range.end)


def test_no_profiler_builds_no_range(monkeypatch):
    built = []
    spans.clear()
    for mod, attr in ((torch.profiler, "record_function"),
                      (torch._C._profiler, "_RecordFunctionFast")):
        monkeypatch.setattr(mod, attr, lambda name, _a=attr: built.append((_a, name)))
    model, params, mom, x, y = _setup("resnet18")
    profiler.make_train_step(model)(params, mom, x, y)
    profiler.make_infer_fn(model)(params, x)
    assert built == []
    assert spans.span("repro.step") is spans.span("repro.bn")
    assert spans.host_seconds() == {}


@pytest.mark.parametrize("family", MODELS)
def test_train_step_spans(family):
    model, params, mom, x, y = _setup(family)
    step = profiler.make_train_step(model)
    _, events, host = _traced(lambda: step(params, mom, x, y))
    names = _names(events)
    convs, dws, bns = _counts(model)
    assert names.count("repro.step") == 1
    outer = next(e for e in events if e.name == "repro.step")
    for phase in ("forward", "backward", "update"):
        (e,) = [e for e in events if e.name == f"repro.step.{phase}"]
        assert _inside(e, outer)
    assert names.count("repro.conv_mm") == convs
    assert names.count("repro.dw_conv") == dws
    assert names.count("repro.dw_conv.backward") == dws
    assert names.count("repro.conv_backward") == convs + dws
    for e in events:
        if e.name == "repro.dw_conv.backward":
            inner = [c for c in events if c.name == "repro.conv_backward" and _inside(c, e)]
            assert len(inner) == 1
    assert names.count("repro.bn") == bns
    assert not any(e.is_user_annotation for e in events)
    counts = {n: names.count(n) for n in set(names)}
    assert {n: len(v) for n, v in host.items()} == counts
    assert all(t > 0 for v in host.values() for t in v)


@pytest.mark.parametrize("family", MODELS)
def test_infer_spans(family):
    model, params, _, x, _ = _setup(family)
    infer = profiler.make_infer_fn(model)
    _, events, _ = _traced(lambda: infer(params, x))
    names = _names(events)
    convs, dws, bns = _counts(model)
    assert names.count("repro.step") == 1
    assert not any(n.startswith("repro.step.") for n in names)
    assert names.count("repro.conv_mm") == convs and names.count("repro.bn") == bns
    assert names.count("repro.dw_conv") == dws
    assert "repro.conv_backward" not in names and "repro.dw_conv.backward" not in names


@pytest.mark.parametrize("family", MODELS)
def test_step_bitwise_equal_with_profiler(family):
    model, params, mom, x, y = _setup(family)
    _, p2, m2, _, _ = _setup(family)
    step = profiler.make_train_step(model)
    _, _, loss = step(params, mom, x, y)
    (_, _, loss2), _, _ = _traced(lambda: step(p2, m2, x, y))
    assert torch.equal(loss, loss2)
    for a, b in zip(tree_leaves(params) + tree_leaves(mom), tree_leaves(p2) + tree_leaves(m2)):
        assert torch.equal(a, b)
