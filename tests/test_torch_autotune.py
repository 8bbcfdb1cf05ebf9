"""The port's kernel autotuner against the reference's: under the TPU and
host-CPU specs the two rank identically (configs, candidates, VMEM
rejections, modelled times, cache keys), fingerprints agree, one cache
file serves both tuners; the CUDA-spec rules (shared-memory budget, no
MXU term, every returned config launchable); error propagation from a
runner; and ``warm_autotune``'s meta-device trace, which tunes the same
(kernel, shape) set as the reference's ``jax.eval_shape`` trace.
"""

import json
import math
import os

import pytest

from repro.configs.registry import get_config as jax_get_config
from repro.engine import devices as jax_devices
from repro.kernels import autotune as jax_at
from repro.kernels.conv_mm import tiling as jax_conv
from repro.kernels.flash_attention import tiling as jax_flash
from repro.kernels.moe_dispatch import tiling as jax_moe
from repro.kernels.paged_decode import tiling as jax_pd
from repro.kernels.serve_kv import tiling as jax_kv
from repro.kernels.ssm_scan import tiling as jax_ssm
from repro.models import layers as jax_layers
from repro.models import transformer as jax_T
from repro.serve import kv_cache as jax_kv_cache
from repro_torch.configs.registry import get_config
from repro_torch.engine import devices
from repro_torch.kernels import autotune as at
from repro_torch.kernels.conv_mm import tiling as conv
from repro_torch.kernels.flash_attention import tiling as flash
from repro_torch.kernels.moe_dispatch import tiling as moe
from repro_torch.kernels.paged_decode import tiling as pd
from repro_torch.kernels.serve_kv import tiling as kv
from repro_torch.kernels.ssm_scan import tiling as ssm
from repro_torch.models import transformer as T
from repro_torch.serve import kv_cache

# (kernel, shape-key args): tests/test_autotune.py:38-44, then
# benchmarks/kernel_bench.py's shapes, then the shapes chip_smoke.py tunes
SHAPES = [
    ("conv_mm", "conv", ((2, 16, 16, 32), (3, 3, 32, 64)),
     dict(stride=1, padding=1, dtype="float32")),
    ("flash_attention", "flash", ((1, 4, 512, 64), (1, 2, 512, 64)),
     dict(causal=True, dtype="bfloat16")),
    ("ssm_scan", "ssm", ((1, 256, 4, 32), 32), dict(dtype="float32")),
    ("paged_decode", "pd", (4, 8, 2, 64, 8, 32), dict(dtype="bfloat16")),
    ("flash_attention", "flash", ((1, 8, 2048, 128), (1, 8, 2048, 128)),
     dict(causal=True, dtype="bfloat16")),
    ("conv_mm", "conv", ((8, 32, 32, 128), (3, 3, 128, 128)),
     dict(stride=1, padding=1, dtype="bfloat16")),
    ("ssm_scan", "ssm", ((1, 2048, 24, 64), 128), dict(dtype="float32")),
    ("moe_dispatch", "moe", (8, 2048, 2048, 128, 8, 768, 1.25, "bfloat16"), {}),
    ("paged_decode", "pd", (8, 32, 8, 128, 16, 256, "bfloat16"), {}),
    ("serve_kv", "kv", (8, 4096, 8, 128, "bfloat16"), dict(n_heads=32)),
    ("flash_attention", "flash", ((8, 32, 2048, 128), (8, 8, 2048, 128)),
     dict(causal=True, dtype="bfloat16")),
    ("flash_attention", "flash", ((8, 32, 1, 128), (8, 8, 2048, 128)),
     dict(causal=True, dtype="bfloat16")),
    ("ssm_scan", "ssm", ((1, 2048, 48, 64), 128), dict(dtype="float32")),
    ("serve_kv", "kv", (8, 2048, 8, 128, "bfloat16"), dict(n_heads=32)),
]
PORT = {"conv": conv, "flash": flash, "ssm": ssm, "pd": pd, "moe": moe, "kv": kv}
REF = {"conv": jax_conv, "flash": jax_flash, "ssm": jax_ssm, "pd": jax_pd,
       "moe": jax_moe, "kv": jax_kv}


def _keys(mod, args, kw):
    return mod.shape_key(*args, **kw)


@pytest.fixture(autouse=True)
def _isolated_default_tuners(tmp_path):
    at.set_tuner(at.KernelTuner(device="tpu_v5e", measure=False,
                                cache=str(tmp_path / "port_default.json")))
    jax_at.set_tuner(jax_at.KernelTuner(device="tpu_v5e", measure=False,
                                        cache=str(tmp_path / "ref_default.json")))
    yield
    at.set_tuner(None)
    jax_at.set_tuner(None)


def test_registry_lists_the_six_tilings():
    assert at.list_tilings() == jax_at.list_tilings() == [
        "conv_mm", "flash_attention", "moe_dispatch", "paged_decode",
        "serve_kv", "ssm_scan"]
    assert {n for n in at.list_tilings() if at.get_tiling(n).runner} == {
        "flash_attention", "ssm_scan", "paged_decode"}


@pytest.mark.parametrize("name", ["host_cpu", "tx2_like", "tpu_v5e"])
def test_fingerprints_equal_the_reference(name):
    ours, ref = devices.get_device(name), jax_devices.get_device(name)
    assert ours.fingerprint() == ref.fingerprint()
    assert devices.FITTED_FIELDS == jax_devices.FITTED_FIELDS
    for f in devices.FITTED_FIELDS:
        assert getattr(ours, f) == getattr(ref, f)


@pytest.mark.parametrize("device", ["tpu_v5e", "host_cpu"])
@pytest.mark.parametrize("kernel,mod,args,kw", SHAPES,
                         ids=[f"{k}-{i}" for i, (k, *_) in enumerate(SHAPES)])
def test_explain_equals_the_reference(device, kernel, mod, args, kw):
    shape = _keys(PORT[mod], args, kw)
    assert shape == _keys(REF[mod], args, kw)
    ours = at.KernelTuner(device=device, cache=None, measure=False)
    ref = jax_at.KernelTuner(device=device, cache=None, measure=False)
    assert ours.key(kernel, shape) == ref.key(kernel, shape)
    a, b = ours.explain(kernel, shape), ref.explain(kernel, shape)
    assert a.keys() == b.keys()
    for k in a:
        if isinstance(a[k], float):
            assert math.isclose(a[k], b[k], rel_tol=1e-12), k
        else:
            assert a[k] == b[k], k
    assert a["source"] == "model" and a["candidates"] > 0


def test_a_cache_written_by_one_tuner_is_a_hit_for_the_other(tmp_path):
    path = str(tmp_path / "shared.json")
    shapes = [(k, _keys(PORT[m], a, kw)) for k, m, a, kw in SHAPES[:4]]
    ref = jax_at.KernelTuner(device="tpu_v5e", cache=path, measure=False)
    for k, s in shapes:
        ref.tune(k, s)
    ours = at.KernelTuner(device="tpu_v5e", cache=path, measure=False)
    assert [ours.tune(k, s) for k, s in shapes] == [ref.tune(k, s) for k, s in shapes]
    assert (ours.hits, ours.misses) == (len(shapes), 0)
    # and the other way round, on the port's file
    path2 = str(tmp_path / "port.json")
    ours2 = at.KernelTuner(device="host_cpu", cache=path2, measure=False)
    for k, s in shapes:
        ours2.tune(k, s)
    ref2 = jax_at.KernelTuner(device="host_cpu", cache=path2, measure=False)
    for k, s in shapes:
        ref2.tune(k, s)
    assert (ref2.hits, ref2.misses) == (len(shapes), 0)


@pytest.fixture
def raising_tiling():
    def runner(shape, config):
        def launch():
            raise RuntimeError("kernel launch failed (cudaError 1)")
        return launch

    name = "raises_on_launch"
    at.register_tiling(at.TilingModel(
        name=name, candidates=lambda s: [{"block": 1}, {"block": 2}],
        cost=lambda s, c: at.KernelCost(flops=1e6 / c["block"]),
        default=lambda s: {"block": 1}, runner=runner), overwrite=True)
    yield name
    at._TILINGS.pop(name)


def test_runner_error_propagates_out_of_tune(raising_tiling):
    tuner = at.KernelTuner(device="h100", cache=None, measure=True)
    with pytest.raises(RuntimeError, match="kernel launch failed"):
        tuner.tune(raising_tiling, {"n": 1})
    assert not at.timing_launches()          # the timing scope was left
    # the implicit-lookup path does not swallow it either
    at.set_tuner(tuner)
    with pytest.raises(RuntimeError, match="kernel launch failed"):
        at.tuned_config(raising_tiling, {"n": 2}, {"block": 1})


def test_tuned_config_falls_back_only_when_the_cache_cannot_be_written(tmp_path):
    blocker = tmp_path / "a_file"
    blocker.write_text("")
    at.set_tuner(at.KernelTuner(device="tpu_v5e", measure=False,
                                cache=str(blocker / "sub" / "tune.json")))
    shape = _keys(flash, *SHAPES[1][2:])
    assert at.tuned_config("flash_attention", shape, {"block_q": 7}) == {"block_q": 7}


def test_autotune_disabled_returns_the_default(monkeypatch):
    monkeypatch.setenv("REPRO_AUTOTUNE", "0")
    tuner = at.get_tuner()
    assert at.tuned_config("flash_attention", {"x": 1}, {"block_q": 3}) == {"block_q": 3}
    assert tuner.misses == 0


def test_timing_scope_counts_launches_apart():
    seen = []
    name = "records_scope"
    at.register_tiling(at.TilingModel(
        name=name, candidates=lambda s: [{"b": 1}, {"b": 2}, {"b": 3}, {"b": 4}],
        cost=lambda s, c: at.KernelCost(flops=float(c["b"])),
        default=lambda s: {"b": 1},
        runner=lambda s, c: (lambda: seen.append(at.timing_launches()))),
        overwrite=True)
    try:
        tuner = at.KernelTuner(device="h100", cache=None, measure=True, top_k=3)
        entry = tuner.explain(name, {"n": 1})
    finally:
        at._TILINGS.pop(name)
    assert entry["source"] == "timed" and entry["measured_us"] >= 0
    assert seen == [True] * (3 * 4) and tuner.timed == 3
    assert not at.timing_launches()


# ---------------------------------------------------------------------------
# CUDA specs
# ---------------------------------------------------------------------------


def test_h100_spec_and_torch_derivation():
    h = devices.get_device("h100")
    assert (h.peak_flops, h.hbm_bw, h.hbm_bytes, h.peak_w) == (989e12, 3.35e12, 80e9, 700.0)
    assert at.is_cuda_spec(h)
    assert not any(at.is_cuda_spec(devices.get_device(n))
                   for n in ("host_cpu", "tx2_like", "tpu_v5e"))
    cpu = devices.from_torch_device("cpu")
    assert cpu.name == "torch_cpu" and not at.is_cuda_spec(cpu)
    assert cpu.fingerprint() == devices.get_device("host_cpu").fingerprint()
    assert devices.resolve_device("torch_cpu") is cpu


@pytest.mark.parametrize("ext", [".json", ".npz"])
def test_device_spec_round_trip_and_cross_load(tmp_path, ext):
    spec = devices.get_device("h100")
    path = str(tmp_path / f"spec{ext}")
    devices.save_device_spec(path, spec)
    back = devices.load_device_spec(path)
    assert back.fingerprint() == spec.fingerprint() and back.meta == spec.meta
    jax_devices.save_device_spec(str(tmp_path / f"ref{ext}"),
                                 jax_devices.get_device("tx2_like"))
    ref_back = devices.load_device_spec(str(tmp_path / f"ref{ext}"))
    assert ref_back.fingerprint() == jax_devices.get_device("tx2_like").fingerprint()


def test_cuda_spec_drops_the_mxu_term():
    cost = at.KernelCost(flops=1e12, hbm_bytes=1e6, mxu_min_dim=16, n_steps=10)
    h, tpu = devices.get_device("h100"), devices.get_device("tpu_v5e")
    assert at.roofline_seconds(cost, h) == pytest.approx(1e12 / 989e12 + 10 * 2e-7)
    assert at.roofline_seconds(cost, tpu) == pytest.approx(
        1e12 / (197e12 * 16 / 128) + 10 * 2e-7)


@pytest.mark.parametrize("kernel,mod,args,kw", SHAPES,
                         ids=[f"{k}-{i}" for i, (k, *_) in enumerate(SHAPES)])
def test_every_config_an_h100_tuner_returns_launches(kernel, mod, args, kw):
    """Under the h100 spec the budget is shared memory per block, and the
    winner's working set fits it; flash and SSD candidates that cannot be
    held are rejected rather than returned.  Flash runs on the tensor
    cores with its K/V tile capped (bf16 at 128 keys, f32 at 64), so each
    of its candidates fits (tests/test_torch_flash_attention.py::
    test_smem_formula_and_budget)."""
    shape = _keys(PORT[mod], args, kw)
    tuner = at.KernelTuner(device="h100", cache=None, measure=False)
    entry = tuner.explain(kernel, shape)
    tiling = at.get_tiling(kernel)
    cost = tiling.cost(shape, entry["config"])
    assert at.smem_ok(cost)
    assert entry["vmem_kb"] == cost.smem_bytes / 1024
    n_bad = sum(not at.smem_ok(tiling.cost(shape, c)) for c in tiling.candidates(shape))
    assert entry["rejected_vmem"] == n_bad
    if (kernel, args[0]) == ("ssm_scan", (1, 2048, 48, 64)):
        assert n_bad > 0          # chunk >= 256 cannot be held
    if kernel == "flash_attention":
        assert shape["dtype"] == "bfloat16" and n_bad == 0


@pytest.mark.parametrize("args", [(8, 32, 8, 128, 16, 256, "bfloat16"),
                                  (4, 8, 2, 64, 8, 32, "float32")])
def test_paged_decode_gather_cost_equals_the_reference(args):
    """The modelled XLA gather fallback, kernel_bench's baseline row."""
    ours, ref = pd.gather_cost(pd.shape_key(*args)), jax_pd.gather_cost(jax_pd.shape_key(*args))
    for f in ("flops", "hbm_bytes", "vmem_bytes", "n_steps", "mxu_min_dim", "op", "origin"):
        assert getattr(ours, f) == getattr(ref, f), f


def test_moe_capacity_equals_the_reference():
    for tokens, e, k, f in [(100, 8, 2, 1.25), (4096, 128, 8, 1.0), (3, 64, 1, 1.5)]:
        assert moe._capacity(tokens, e, k, f) == jax_layers.moe_capacity(tokens, e, k, f)


def test_resolve_block_size_equals_the_reference():
    cfg, jcfg = get_config("qwen3-4b"), jax_get_config("qwen3-4b")
    ours = at.KernelTuner(device="tpu_v5e", cache=None, measure=False)
    ref = jax_at.KernelTuner(device="tpu_v5e", cache=None, measure=False)
    for n_slots, max_len in [(8, 2048), (4, 512), (16, 4096)]:
        assert (kv_cache.resolve_block_size(cfg, n_slots=n_slots, max_len=max_len,
                                            tuner=ours)
                == jax_kv_cache.resolve_block_size(jcfg, n_slots=n_slots,
                                                   max_len=max_len, tuner=ref))


# ---------------------------------------------------------------------------
# warm_autotune
# ---------------------------------------------------------------------------


def _tuned_set(tuner):
    return sorted((e["kernel"], json.dumps(e["shape"], sort_keys=True),
                   json.dumps(e["config"], sort_keys=True))
                  for e in tuner._memo.values())


def test_warm_autotune_tunes_the_reference_set(tmp_path, monkeypatch):
    monkeypatch.setenv("REPRO_AUTOTUNE", "1")
    cfg, jcfg = get_config("qwen3-4b", reduced=True), jax_get_config("qwen3-4b", reduced=True)
    ours = at.KernelTuner(device="tpu_v5e", cache=None, measure=False)
    ref = jax_at.KernelTuner(device="tpu_v5e", cache=None, measure=False)
    at.set_tuner(ours)
    jax_at.set_tuner(ref)
    stages = ("prefill", "decode")
    got = T.warm_autotune(cfg, batch_size=2, seq_len=64, stages=stages)
    want = jax_T.warm_autotune(jcfg, batch_size=2, seq_len=64, stages=stages)
    assert got["misses"] == want["misses"] == 2
    assert _tuned_set(ours) == _tuned_set(ref)
    # the reference traces one lax.scan body; the port runs its layers in a
    # Python loop, and every layer after the first is a memo hit
    assert want["hits"] == 0
    assert got["hits"] == (cfg.n_layers - 1) * len(stages)
    # a second warm-up is pure hits
    again = T.warm_autotune(cfg, batch_size=2, seq_len=64, stages=stages)
    assert again["misses"] == 0 and again["hits"] == got["hits"] + got["misses"]


def test_warm_autotune_train_tunes_the_reference_set(tmp_path, monkeypatch):
    """The train stage traces ``loss_fn`` (the reference: ``jax.eval_shape``
    of it) and tunes the same (kernel, shape, config) set as the
    reference's, on fresh ``tpu_v5e`` tuners; reduced internlm2-1.8b
    (untied head, GQA) and reduced qwen3-4b."""
    monkeypatch.setenv("REPRO_AUTOTUNE", "1")
    for arch in ("internlm2-1.8b", "qwen3-4b"):
        cfg, jcfg = get_config(arch, reduced=True), jax_get_config(arch, reduced=True)
        ours = at.KernelTuner(device="tpu_v5e", cache=None, measure=False)
        ref = jax_at.KernelTuner(device="tpu_v5e", cache=None, measure=False)
        at.set_tuner(ours)
        jax_at.set_tuner(ref)
        got = T.warm_autotune(cfg, batch_size=4, seq_len=64, stages=("train",))
        want = jax_T.warm_autotune(jcfg, batch_size=4, seq_len=64, stages=("train",))
        assert got["misses"] == want["misses"] == 1
        assert _tuned_set(ours) == _tuned_set(ref)
        assert got["hits"] == cfg.n_layers - 1 and want["hits"] == 0


def test_warm_autotune_traces_on_meta_including_train(monkeypatch):
    monkeypatch.setenv("REPRO_AUTOTUNE", "1")
    cfg = get_config("qwen3-4b")                 # full width: meta only
    params = T.param_specs(cfg)
    assert all(p.device.type == "meta" for p in params.parameters())
    spec = T.input_specs(cfg, "decode", batch_size=8, seq_len=2048)
    assert spec["cache"]["sub0"]["k"].device.type == "meta"
    spec = T.input_specs(cfg, "train", batch_size=8, seq_len=2048)
    assert spec["batch"]["tokens"].device.type == "meta"
    # the training stage traces loss_fn on meta tensors: no allocation, no
    # backward, one lookup per layer (the first a miss)
    out = T.warm_autotune(cfg, batch_size=8, seq_len=2048, stages=("train",))
    assert out == {"hits": cfg.n_layers - 1, "misses": 1}


def test_default_cache_is_the_ports_own(monkeypatch):
    monkeypatch.delenv("REPRO_TORCH_TUNING_CACHE", raising=False)
    path = at._default_cache_path()
    assert path.endswith(os.path.join("build", "repro_torch", "kernel_tuning.json"))
    assert ".cache" not in path
