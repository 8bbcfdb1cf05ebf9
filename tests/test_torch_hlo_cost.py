"""The port's cost-ledger producer (``repro_torch.core.hlo_cost``) and its
``CostLedger`` against the reference's (``repro.core.hlo_cost``, which
parses the HLO of an XLA-compiled program).

* the ledger's aggregates are its left-to-right sums, bit for bit, and
  its class sums re-sum to them;
* every record's class is in the closed ``OP_CLASSES`` vocabulary, and a
  view moves 0 bytes;
* a ``CostLedger`` saved by either package loads in the other and
  compares equal (JSON and ``.npz``);
* matrix-product (and convolution) FLOPs of the same step on the same
  shapes: the port's trace against ``parse_hlo_cost`` of the reference's
  compiled program — engine_bench's scan-of-dots gradient within 1e-9
  relative, a reduced CNN's forward and training step within 1e-9 (the
  test says which convolutions the two count differently), reduced qwen3-4b
  prefill and a reduced internlm2-1.8b training step with remat within 2%.
  The bytes ratio (port / reference) is printed, not gated: XLA counts
  only buffers outside its fusions, eager PyTorch every op's operands.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.hlo_cost import parse_hlo_cost
from repro.costmodel import CostLedger as RefLedger
from repro.costmodel import OpCost as RefOpCost
from repro_torch.core.hlo_cost import HloCost, aten_opcode, trace_cost
from repro_torch.costmodel import OP_CLASSES, CostLedger, OpCost, classify_op
from tests._torch_host import port_host_share  # noqa: F401 (autouse)


@pytest.fixture(autouse=True)
def _pinned(monkeypatch):
    monkeypatch.setenv("REPRO_AUTOTUNE", "0")


def _meta(*shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device="meta")


def _ref_cost(fn, *args):
    return parse_hlo_cost(jax.jit(fn).lower(*args).compile().as_text())


def _matmul_flops(cost) -> float:
    sums = cost.by_class()
    return sum(sums.get(c, {}).get("flops", 0.0) for c in ("matmul", "conv"))


# ---------------------------------------------------------------------------
# the ledger's own contracts
# ---------------------------------------------------------------------------


def _prefill_cost():
    from repro_torch.configs.registry import get_config
    from repro_torch.models import transformer as T

    cfg = get_config("qwen3-4b", reduced=True)
    spec = T.input_specs(cfg, "prefill", batch_size=2, seq_len=32)
    return trace_cost(T.prefill, T.param_specs(cfg), spec["batch"], cfg, max_len=32)


def test_ledger_sums_are_the_aggregates_bit_for_bit():
    cost = _prefill_cost()
    assert isinstance(cost, HloCost) and len(cost.ledger) > 100
    for attr in ("flops", "hbm_bytes", "collective_bytes"):
        total = 0.0
        for r in cost.ledger:
            total += getattr(r, attr)
        assert getattr(cost, attr) == total == getattr(cost.ledger, attr)
    sums = cost.by_class()
    # integer-valued FLOPs and bytes: the class-wise re-sum is exact too
    assert sum(s["flops"] for s in sums.values()) == cost.flops
    assert sum(s["hbm_bytes"] for s in sums.values()) == cost.hbm_bytes
    assert sum(s["count"] for s in sums.values()) == len(cost.ledger)
    assert cost.collective_bytes == 0.0
    assert {r.origin for r in cost.ledger} == {"forward"}


def test_every_record_classifies_into_the_closed_vocabulary():
    cost = _prefill_cost()
    assert {r.op_class for r in cost.ledger} <= set(OP_CLASSES)
    assert {r.op_class for r in cost.ledger} >= {"matmul", "elementwise",
                                                  "data_movement", "reduction"}
    for r in cost.ledger:
        assert r.op_class == classify_op(r.op, dot_flops=r.flops if r.op == "dot" else 0.0,
                                         conv_flops=r.flops if r.op == "convolution" else 0.0)
        assert (r.flops > 0) == (r.op_class in ("matmul", "conv")), r


@pytest.mark.parametrize("op, opcode, cls", [
    (torch.ops.aten.mm.default, "dot", "matmul"),
    (torch.ops.aten.bmm.default, "dot", "matmul"),
    (torch.ops.aten.addmm.default, "dot", "matmul"),
    (torch.ops.aten.convolution.default, "convolution", "conv"),
    (torch.ops.aten.convolution_backward.default, "convolution", "conv"),
    (torch.ops.aten.sum.dim_IntList, "reduce", "reduction"),
    (torch.ops.aten.amax.default, "reduce", "reduction"),
    (torch.ops.aten.mean.dim, "reduce", "reduction"),
    (torch.ops.aten.sort.default, "sort", "reduction"),
    (torch.ops.aten.topk.default, "sort", "reduction"),
    (torch.ops.aten.cat.default, "concatenate", "data_movement"),
    (torch.ops.aten.index.Tensor, "gather", "data_movement"),
    (torch.ops.aten.gather.default, "gather", "data_movement"),
    (torch.ops.aten.scatter_add.default, "scatter", "data_movement"),
    (torch.ops.aten.index_put_.default, "scatter", "data_movement"),
    (torch.ops.aten.copy_.default, "copy", "data_movement"),
    (torch.ops.aten._to_copy.default, "copy", "data_movement"),
    (torch.ops.aten.clone.default, "copy", "data_movement"),
    (torch.ops.aten.constant_pad_nd.default, "pad", "data_movement"),
    (torch.ops.aten.view.default, "reshape", "data_movement"),
    (torch.ops.aten.add.Tensor, "add", "elementwise"),
    (torch.ops.aten.mul.Tensor, "mul", "elementwise"),
    (torch.ops.aten._softmax.default, "_softmax", "elementwise"),
])
def test_aten_ops_map_to_hlo_opcodes(op, opcode, cls):
    assert aten_opcode(op) == opcode
    assert classify_op(opcode) in OP_CLASSES
    assert classify_op(opcode, dot_flops=1.0 if cls == "matmul" else 0.0,
                       conv_flops=1.0 if cls == "conv" else 0.0) == cls


def test_an_op_of_another_namespace_is_other_not_dropped():
    lib = torch.library.Library("ledgertest", "DEF")
    lib.define("twice(Tensor x) -> Tensor")
    lib.impl("twice", lambda x: x * 2, "CompositeExplicitAutograd")
    lib.impl("twice", lambda x: torch.empty_like(x), "Meta")
    cost = trace_cost(torch.ops.ledgertest.twice, _meta(4, 8))
    recs = [r for r in cost.ledger if r.op == "custom-call"]
    assert len(recs) == 1 and recs[0].op_class == "other"
    assert recs[0].hbm_bytes == 2 * 4 * 8 * 4


def test_views_move_zero_bytes():
    x = _meta(4, 8, 16)

    def views(x):
        y = x.view(32, 16).t()
        z = x.permute(2, 0, 1).expand(16, 4, 8)
        w = x.detach().as_strided((4, 8), (128, 16))
        return torch.ops.aten._unsafe_view(x, (4, 128)), y, z, w

    cost = trace_cost(views, x)
    assert len(cost.ledger) >= 6
    assert all(r.hbm_bytes == 0.0 and r.op == "reshape" for r in cost.ledger)
    copy = trace_cost(lambda x: x.t().contiguous(), _meta(8, 16))
    assert copy.hbm_bytes == 2 * 8 * 16 * 4        # read once, written once


def _ledgers():
    """One ledger per package with the same records."""
    rows = [dict(op="dot", op_class="matmul", dtype="bf16", flops=2.5e9,
                 hbm_bytes=1.25e6, energy_j=0.125, origin="forward"),
            dict(op="add", op_class="elementwise", dtype="f32", hbm_bytes=3e5,
                 vmem_bytes=64.0, trip_multiplier=12.0, origin="backward"),
            dict(op="all-reduce", op_class="collective", collective_bytes=7e4,
                 count=3)]
    return CostLedger([OpCost(**r) for r in rows]), RefLedger([RefOpCost(**r) for r in rows])


@pytest.mark.parametrize("ext", ["json", "npz"])
@pytest.mark.parametrize("direction", ["port_to_reference", "reference_to_port"])
def test_cost_ledger_loads_across_packages(tmp_path, ext, direction):
    mine, ref = _ledgers()
    path = str(tmp_path / f"ledger.{ext}")
    if direction == "port_to_reference":
        mine.save(path)
        back = RefLedger.load(path)
        assert back == ref
    else:
        ref.save(path)
        back = CostLedger.load(path)
        assert back == mine
    assert back.totals() == ref.totals() == mine.totals()
    assert back.class_sums(keep_zero=True) == ref.class_sums(keep_zero=True)


def test_cost_ledger_views_match_the_reference():
    mine, ref = _ledgers()
    assert mine.class_sums() == ref.class_sums()
    assert mine.class_sums(keep_zero=True) == ref.class_sums(keep_zero=True)
    sums = [mine.class_sums(), ref.scaled(2.0).class_sums()]
    assert CostLedger.merge_class_sums(sums) == RefLedger.merge_class_sums(sums)
    for by in ("hbm_bytes", "flops", "collective_bytes"):
        assert [r.to_dict() for r in mine.top_k(2, by=by)] == \
            [r.to_dict() for r in ref.top_k(2, by=by)]
    assert [r.to_dict() for r in mine.scaled(0.5)] == [r.to_dict() for r in ref.scaled(0.5)]
    with pytest.raises(KeyError):
        mine.top_k(1, by="nope")
    mine2 = CostLedger()
    mine2.extend(list(mine))
    mine2.append(OpCost(op="x"))
    assert len(mine2) == 4 and mine2 != mine


# ---------------------------------------------------------------------------
# FLOPs against the reference's parse of its compiled program
# ---------------------------------------------------------------------------


def _report(label, mine, ref):
    print(f"{label}: matmul+conv flops port {_matmul_flops(mine):.6e} reference "
          f"{_matmul_flops(ref):.6e}; hbm bytes port / reference "
          f"{mine.hbm_bytes / ref.hbm_bytes:.3f} ({mine.hbm_bytes:.4e} / "
          f"{ref.hbm_bytes:.4e}); records {len(mine.ledger)} / {len(ref.ledger)}")


def test_scan_of_dots_gradient_flops_match():
    """benchmarks/engine_bench.py:138-144: 8 chained 64×64 dots and their
    gradient with respect to x (16 dots in all), within 1e-9 relative."""
    def f(x, ws):
        return jax.lax.scan(lambda c, w: (jnp.tanh(c @ w), None), x, ws)[0].sum()

    ref = _ref_cost(jax.grad(f), jnp.zeros((64, 64)), jnp.zeros((8, 64, 64)))

    def step(x, ws):
        c = x
        for w in ws:
            c = torch.tanh(c @ w)
        return torch.autograd.grad(c.sum(), x)

    x = _meta(64, 64).requires_grad_(True)
    mine = trace_cost(step, x, _meta(8, 64, 64))
    _report("scan of dots", mine, ref)
    assert _matmul_flops(mine) == 16 * 2 * 64 ** 3
    assert _matmul_flops(mine) == pytest.approx(_matmul_flops(ref), rel=1e-9)
    assert {r.origin for r in mine.ledger if r.op == "dot"} == {"forward", "backward"}


def _ref_conv_flops(text: str) -> float:
    """The reference's convolutions re-counted from its HLO text.

    ``parse_hlo_cost``'s ``_conv_flops`` reads the kernel's shape from the
    operands' inline types, which this XLA's HLO text no longer prints
    (``convolution(%x, %w)``), and then falls back to 2 × output numel: a
    ResNet-18 step parses to ~0.8 MFLOP.  Here each ``convolution`` takes
    its kernel's shape from the symbol table, as ``_dot_flops`` does for
    dots, and counts the reference's own formula: 2 × output numel × the
    kernel's spatial and input-feature extents (``dim_labels``)."""
    import re

    from repro.core.hlo_cost import _parse_module, _shape_numel

    comps, _ = _parse_module(text)
    total = 0.0
    for comp in comps.values():
        for ins in comp.instrs.values():
            if ins.opcode != "convolution":
                continue
            kdims = [int(d) for d in comp.instrs[ins.operands[1]].dtypes_dims[0][1].split(",")]
            labels = re.search(r"dim_labels=\w+_(\w+)->", ins.raw).group(1)
            k = np.prod([d for d, c in zip(kdims, labels) if c.isdigit() or c == "i"])
            total += 2.0 * _shape_numel(ins.dtypes_dims[0][1]) * k
    return float(total)


def _dilation_zeros(model, bs: int) -> float:
    """FLOPs that XLA's count of a training step spends on inserted zeros:
    it writes the input gradient of a stride-s convolution as an
    lhs-dilated convolution over the input's positions, so 2 × out × kernel
    counts s² × the forward's work, where ``flop_registry``'s
    ``convolution_backward`` counts the forward's work once."""
    extra = 0.0
    for layer in model.conv_specs().layers:
        if layer.stride > 1:
            o = (layer.ip + 2 * layer.padding - layer.k) // layer.stride + 1
            fwd = 2.0 * bs * o * o * layer.n * layer.m * layer.k ** 2 / layer.groups
            extra += (layer.stride ** 2 - 1) * fwd
    return extra


@pytest.mark.parametrize("stage", ["infer", "train"])
def test_cnn_step_flops_match(stage):
    """A reduced ResNet-18 (width 0.125, 16×16, batch 4): the inference
    forward (``make_infer_fn``) and the training step (forward, backward,
    SGD-momentum, ``make_train_step``) of each package; convolution +
    matmul FLOPs against the reference's dots as it parses them plus its
    convolutions re-counted from its HLO (:func:`_ref_conv_flops`), within
    1e-9 relative; in the training step less the inserted zeros that
    XLA's strided-convolution input gradients count
    (:func:`_dilation_zeros`).  At the models' own 32×32 input: below it
    XLA rewrites a 3×3 convolution over a 2×2 map into another form that
    skips the padding taps."""
    from repro.core import profiler as ref_profiler
    from repro.models import cnn as ref_cnn
    from repro_torch.convert import tree_map
    from repro_torch.core import profiler
    from repro_torch.models import cnn

    kw = dict(width_mult=0.125, input_hw=32)
    mine_model, ref_model = cnn.build_resnet18(**kw), ref_cnn.build_resnet18(**kw)
    params = ref_model.init(0)
    x = jnp.zeros((4, 32, 32, 3), jnp.float32)
    y = jnp.zeros((4,), jnp.int32)
    meta = tree_map(lambda a: _meta(*np.shape(a)), params)
    mx, my = _meta(4, 32, 32, 3), _meta(4, dtype=torch.int32)
    if stage == "train":
        fn = jax.jit(ref_profiler.make_train_step(ref_model))
        text = fn.lower(params, jax.tree.map(jnp.zeros_like, params), x, y).compile().as_text()
        mom = tree_map(lambda a: _meta(*np.shape(a)), params)
        mine = trace_cost(profiler.make_train_step(mine_model), meta, mom, mx, my)
    else:
        text = jax.jit(ref_profiler.make_infer_fn(ref_model)).lower(params, x).compile().as_text()
        mine = trace_cost(profiler.make_infer_fn(mine_model), meta, mx)
    ref = parse_hlo_cost(text)
    _report(f"resnet18 {stage}", mine, ref)
    ref_sums = ref.by_class()
    recount = _ref_conv_flops(text)
    want = ref_sums["matmul"]["flops"] + recount
    if stage == "train":
        want -= _dilation_zeros(mine_model, 4)
    print(f"resnet18 {stage} convolution + matmul flops: port {_matmul_flops(mine):.6e}, "
          f"reference re-counted {want:.6e} (its own parse {_matmul_flops(ref):.6e})")
    # the port's plain convolution forward is an implicit GEMM (``mm``), its
    # backward ``convolution_backward``: the two classes together are the
    # step's convolution and matrix-product work in both packages
    assert _matmul_flops(mine) == pytest.approx(want, rel=1e-9)


def test_qwen3_prefill_flops_match():
    """Reduced qwen3-4b prefill (batch 2, 64 tokens) through each package's
    ``transformer.prefill``: matmul FLOPs within 2%."""
    from repro.configs.registry import get_config as ref_config
    from repro.models import transformer as RT
    from repro_torch.configs.registry import get_config
    from repro_torch.models import transformer as T

    rcfg, cfg = ref_config("qwen3-4b", reduced=True), get_config("qwen3-4b", reduced=True)
    params = RT.init_params(rcfg, 0)
    tokens = jnp.zeros((2, 64), jnp.int32)
    ref = _ref_cost(lambda p, b: RT.prefill(p, b, rcfg, max_len=64), params,
                    {"tokens": tokens})
    spec = T.input_specs(cfg, "prefill", batch_size=2, seq_len=64)
    mine = trace_cost(T.prefill, T.param_specs(cfg), spec["batch"], cfg, max_len=64)
    _report("qwen3-4b reduced prefill", mine, ref)
    assert _matmul_flops(mine) == pytest.approx(_matmul_flops(ref), rel=0.02)


def test_internlm2_training_step_with_remat_flops_match():
    """Reduced internlm2-1.8b training step (batch 2, 64 tokens): the loss,
    its gradient with remat (the recompute is in both programs) and the
    AdamW update; matmul FLOPs within 2%."""
    from repro.configs.registry import get_config as ref_config
    from repro.models import transformer as RT
    from repro.optim.optimizer import OptimizerConfig as RefOpt
    from repro.optim.optimizer import apply_updates as ref_apply
    from repro.optim.optimizer import init_opt_state as ref_init_opt
    from repro_torch.configs.registry import get_config
    from repro_torch.models import transformer as T
    from repro_torch.optim.optimizer import OptimizerConfig, apply_updates, init_opt_state

    rcfg, cfg = ref_config("internlm2-1.8b", reduced=True), get_config("internlm2-1.8b",
                                                                        reduced=True)
    params = RT.init_params(rcfg, 0)
    batch = {"tokens": jnp.zeros((2, 64), jnp.int32)}

    def ref_train(params, opt, batch):
        (loss, _), g = jax.value_and_grad(RT.loss_fn, has_aux=True)(params, batch, rcfg)
        p2, o2, _ = ref_apply(params, g, opt, RefOpt())
        return p2, o2, loss

    ref = _ref_cost(ref_train, params, ref_init_opt(params, RefOpt()), batch)

    model = T.param_specs(cfg)
    named = dict(model.named_parameters())
    opt = init_opt_state(named, OptimizerConfig())
    for p in named.values():
        p.requires_grad_(True)
    mbatch = T.input_specs(cfg, "train", batch_size=2, seq_len=64)["batch"]

    def step(model, batch, opt):
        loss, _ = T.loss_fn(model, batch, cfg)
        loss.backward()
        apply_updates(named, {n: p.grad for n, p in named.items()}, opt, OptimizerConfig())
        return loss

    mine = trace_cost(step, model, mbatch, opt)
    _report("internlm2-1.8b reduced training step", mine, ref)
    assert {r.origin for r in mine.ledger} == {"forward", "backward"}
    assert _matmul_flops(mine) == pytest.approx(_matmul_flops(ref), rel=0.02)
