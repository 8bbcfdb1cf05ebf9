"""The port's roofline layer (``repro_torch.core.roofline``) and the Γ of a
traced step (``repro_torch.core.profiler.meta_memory``).

* ``model_flops_for_cell`` is config arithmetic: equal to the reference's
  exactly for every registry architecture and every shape kind;
* ``RooflineReport`` keeps the reference's fields; ``roofline_from_cost``
  derives its terms from a traced ledger and a required ``DeviceSpec``;
* Γ on meta tensors: every meta storage reports address 0, so two
  distinct saved tensors must still count as two; and the meta Γ of a
  reduced step equals the CPU ``_memory_step`` of the same step on real
  tensors, by the written definition (``core/profiler.py``), exactly.
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro.configs.base import ShapeSpec as RefShape
from repro.configs.registry import ARCH_IDS
from repro.configs.registry import get_config as ref_config
from repro.core.roofline import RooflineReport as RefReport
from repro.core.roofline import model_flops_for_cell as ref_model_flops
from repro_torch.configs.base import ShapeSpec
from repro_torch.configs.registry import get_config
from repro_torch.core import profiler
from repro_torch.core.hlo_cost import trace_cost
from repro_torch.core.roofline import RooflineReport, model_flops_for_cell, roofline_from_cost
from repro_torch.engine import get_device
from tests._torch_host import port_host_share  # noqa: F401 (autouse)


@pytest.fixture(autouse=True)
def _pinned(monkeypatch):
    monkeypatch.setenv("REPRO_AUTOTUNE", "0")


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_model_flops_for_cell_matches_the_reference(arch):
    for reduced in (False, True):
        for kind, seq, batch in (("train", 4096, 256), ("prefill", 2048, 8),
                                 ("decode", 1, 64)):
            mine = model_flops_for_cell(get_config(arch, reduced=reduced),
                                        ShapeSpec("c", seq, batch, kind))
            ref = ref_model_flops(ref_config(arch, reduced=reduced),
                                  RefShape("c", seq, batch, kind))
            assert mine == ref and isinstance(mine, float), (arch, kind)


def test_roofline_report_from_a_traced_cost():
    from repro_torch.models import transformer as T

    # the reference's fields in its order, then the port's "sp"
    assert [f.name for f in dataclasses.fields(RooflineReport)] == \
        [f.name for f in dataclasses.fields(RefReport)] + ["sp"]
    cfg = get_config("qwen3-4b", reduced=True)
    spec = T.input_specs(cfg, "prefill", batch_size=2, seq_len=32)
    cost = trace_cost(T.prefill, T.param_specs(cfg), spec["batch"], cfg, max_len=32)
    dev = get_device("h100")
    mf = model_flops_for_cell(cfg, ShapeSpec("p", 32, 2, "prefill"))
    rep = roofline_from_cost(cost, arch=cfg.name, shape="p", mesh_desc="1", n_devices=1,
                             model_flops_total=mf, hw=dev, plan_bytes=3e9, compile_s=0.5)
    assert rep.compute_s == cost.flops / dev.peak_flops
    assert rep.memory_s == cost.hbm_bytes / dev.hbm_bw
    assert rep.collective_s == 0.0 and rep.dominant == "memory"
    assert rep.step_s == max(rep.compute_s, rep.memory_s)
    assert rep.useful_ratio == mf / cost.flops
    assert rep.per_device_hbm_gb == 3.0 and rep.fits_hbm
    assert rep.class_breakdown == cost.by_class() and len(rep.top_ops) == 3
    assert rep.to_dict()["arch"] == cfg.name and "bytes by class" in rep.summary()
    assert rep.sp is False
    small = roofline_from_cost(cost, arch="a", shape="p", mesh_desc="1", n_devices=2,
                               model_flops_total=mf, hw=dev.hw_table(), plan_bytes=1e12)
    assert not small.fits_hbm and small.model_flops == mf / 2


def test_meta_gamma_counts_two_distinct_saved_tensors_as_two():
    """``a * b`` saves both factors for its backward; on meta both report
    ``data_ptr() == 0``, and a dedup by address would count one."""
    x = torch.empty(256, device="meta", requires_grad=True)

    def step(x):
        a, b = x * 2.0, x * 3.0
        loss = (a * b).sum()
        loss.backward()
        return loss.detach()

    a, b = torch.empty(4, device="meta"), torch.empty(4, device="meta")
    assert a.data_ptr() == b.data_ptr() == 0
    assert profiler._storage_key(a) != profiler._storage_key(b)
    assert profiler._storage_key(a) == profiler._storage_key(a.view(2, 2))
    mem = profiler.meta_memory(step, (x,), [x], grad_bytes=1024)
    # grads + a + b (x is resident: not counted again), out = the loss
    assert mem == {"arg": 1024.0, "temp": 1024.0 + 2 * 1024.0, "out": 4.0}


def _lm_step(device):
    """A reduced internlm2-1.8b training step as the port's Trainer runs it:
    loss_fn (with remat), backward into the .grad buffers, AdamW."""
    from repro_torch.convert import tree_leaves
    from repro_torch.models import transformer as T
    from repro_torch.optim.optimizer import OptimizerConfig, apply_updates, init_opt_state

    cfg = get_config("internlm2-1.8b", reduced=True)
    model = (T.param_specs(cfg) if device == "meta"
             else T.init_params(cfg, 0, device="cpu", dtype=torch.float32))
    if device == "meta":
        model = model.float()
    named = dict(model.named_parameters())
    opt = init_opt_state(named, OptimizerConfig())
    for p in named.values():
        p.requires_grad_(True)
        p.grad = torch.zeros_like(p)
    rng = np.random.default_rng(0)
    tokens = torch.tensor(rng.integers(2, cfg.vocab, (2, 32)), dtype=torch.int32,
                          device=device)

    def step(model, batch, opt):
        for p in named.values():
            p.grad.zero_()
        loss, _ = T.loss_fn(model, batch, cfg)
        loss.backward()
        apply_updates(named, {n: p.grad for n, p in named.items()}, opt, OptimizerConfig())
        return loss.detach()

    args = (model, {"tokens": tokens}, opt)
    resident = list(named.values()) + tree_leaves(opt) + [tokens]
    grads = sum(p.numel() * p.element_size() for p in named.values())
    return step, args, resident, grads


def _cnn_step(device):
    """A reduced SqueezeNet training step through ``make_train_step``."""
    from repro_torch.convert import cnn_params_from_numpy, tree_leaves, tree_map
    from repro_torch.models import cnn

    model = cnn.build_squeezenet(width_mult=0.125, input_hw=16)
    params = cnn_params_from_numpy(model.init(0), device="cpu")
    if device == "meta":
        params = tree_map(lambda t: torch.empty_like(t, device="meta"), params)
    mom = tree_map(torch.zeros_like, params)
    x = torch.zeros((2, 16, 16, 3), device=device)
    y = torch.zeros((2,), dtype=torch.int32, device=device)
    leaves = tree_leaves(params)
    return (profiler.make_train_step(model), (params, mom, x, y),
            leaves + tree_leaves(mom) + [x, y], profiler._nbytes(leaves))


@pytest.mark.parametrize("build", [_lm_step, _cnn_step], ids=["lm", "cnn"])
def test_meta_gamma_equals_the_cpu_memory_step(build):
    fn, args, resident, grads = build("meta")
    meta = profiler.meta_memory(fn, args, resident, grad_bytes=grads)
    fn, args, resident, grads = build("cpu")
    temp, out = profiler._memory_step(fn, args, resident, grads, torch.device("cpu"))
    cpu = {"arg": float(profiler._nbytes(resident)), "temp": float(temp), "out": float(out)}
    assert meta == cpu
    assert meta["temp"] > grads            # autograd saved something beside them


def test_meta_gamma_of_a_forward():
    """Inference: arg (resident) + out (outputs not resident) + the largest
    single tensor an op writes."""
    w = torch.empty(64, 32, device="meta")
    x = torch.empty(8, 64, device="meta")

    def fwd(w, x):
        h = torch.relu(x @ w)                       # (8, 32)
        big = h.repeat(4, 1)                        # (32, 32): the largest
        return {"y": big.sum(0), "n": 3}

    mem = profiler.meta_memory(fwd, (w, x), [w, x], train=False)
    assert mem == {"arg": (64 * 32 + 8 * 64) * 4.0, "temp": 32 * 32 * 4.0, "out": 32 * 4.0}
