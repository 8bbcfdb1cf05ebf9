"""Every registry architecture's layer plan in the port against the
reference, at smoke size (``reduced()``).

For all 10 architectures: ``layer_plan`` is the reference's, and
``init_params(cfg, 0)`` draws the reference's values bit for bit (the
leaf order JAX's sorted keys give, ``A_log``'s uniform draw and the ones
of ``D`` included).  For one architecture of each non-dense family —
MoE (qwen3-moe-30b-a3b), SSM (mamba2-780m), hybrid (jamba-v0.1-52b, one
superblock of 8 sublayers), VLM (paligemma-3b, a patch prefix) and audio
(whisper-tiny, an encoder and cross-attention) — with the same f32
parameters in both packages: the converter's round trips (parameters,
and a training state with its slots), ``forward``
logits and aux, ``prefill`` then ``decode_step`` (logits and caches), and
``loss_fn`` with every gradient leaf against ``jax.value_and_grad``.
Then the port's own decode against its forward for the four
architectures of ``tests/test_lm_models.py``'s check, in bf16 with its
tolerance (rel 0.05); ``warm_autotune`` on the meta device tunes the
reference's (kernel, shape, config) set; paged pools refuse the same
plans.

Tolerances: where everything stays f32, logits within 1e-5 of the
largest logit and the loss within rtol 1e-6 (f32 sums in other orders);
each gradient leaf within 1e-5 of its largest entry (1e-4 for jamba's
8-sublayer superblock), but the cross-attention key bias, whose gradient
is zero (no RoPE, and softmax is shift-invariant), within 1e-6 of the
largest gradient entry in both packages.  After a prefill,
K/V sit in a bf16 cache in both packages (attention reads them back from
it in the prefill already), where f32 noise may round a value to the
other bf16 neighbour: prefill and decode logits of a plan with attention
are held to 2e-3 and K/V entries to one bf16 ulp (plus 1e-5 of the
largest entry: a tiny value may sit near a rounding boundary), as in
``tests/test_torch_transformer.py``; the SSD conv taps and state stay
f32, within 2e-3.
Routing is discrete; with tuning off (``REPRO_AUTOTUNE=0``) both
packages pick the same groups and capacity, and the f32 routers give
the same top-k on these inputs.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import ARCH_IDS
from repro.configs.registry import get_config as jax_config
from repro.kernels import autotune as jax_at
from repro.models import transformer as JT
from repro_torch.configs.registry import get_config
from repro_torch.convert import (
    grads_to_numpy,
    params_from_jax,
    params_to_numpy,
    train_state_from_jax,
    train_state_to_numpy,
)
from repro_torch.kernels import autotune as at
from repro_torch.models import transformer as T
from tests._torch_host import port_host_share  # noqa: F401 (autouse)

F32, LOSS_RTOL, GRAD_TOL, KV_BF16 = 1e-5, 1e-6, 1e-5, 2e-3
# jamba's one scan step runs 8 sublayers (4 of them MoE): f32 noise there
# reaches 3.2e-5 of a leaf's largest entry (blocks/sub6/ssm/A_log)
GRAD_TOLS = {"jamba-v0.1-52b-smoke": 1e-4}
FAMILIES = ["qwen3-moe-30b-a3b", "mamba2-780m", "jamba-v0.1-52b",
            "paligemma-3b", "whisper-tiny"]


@pytest.fixture(autouse=True)
def _pinned_tilings(monkeypatch):
    monkeypatch.setenv("REPRO_AUTOTUNE", "0")


def _leaf(tree, path):
    for key in path:
        tree = tree[key.key]
    return tree


def _batch(cfg, B, S, seed=1):
    """Numpy tokens [+ patches | frames] as the reference's tests make them."""
    rng = np.random.default_rng(seed)
    b = {"tokens": rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)}
    if cfg.n_prefix:
        b["patches"] = rng.standard_normal((B, cfg.n_prefix, cfg.d_model)).astype(np.float32)
    if cfg.n_encoder_layers:
        b["frames"] = rng.standard_normal((B, cfg.n_audio_frames, cfg.d_model)).astype(np.float32)
    return b


def _jb(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _tb(batch):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}


def _close(got, want, atol):
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(got.detach().float().numpy(), want, rtol=0,
                               atol=atol * max(1.0, float(np.abs(want).max())))


@pytest.fixture(scope="module", params=FAMILIES)
def model(request):
    arch = request.param
    jcfg, tcfg = jax_config(arch, reduced=True), get_config(arch, reduced=True)
    tree = JT.init_params(jcfg, 0)
    jp = jax.tree.map(lambda a: jnp.asarray(np.asarray(a, np.float32)), tree)
    tp = params_from_jax(tree, tcfg, device="cpu", dtype=torch.float32)
    return arch, jcfg, tcfg, tree, jp, tp


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_layer_plan_matches_reference(arch):
    for reduced in (False, True):
        jcfg, tcfg = jax_config(arch, reduced=reduced), get_config(arch, reduced=reduced)
        n, plan = T.layer_plan(tcfg)
        assert (n, [tuple(p) for p in plan]) == JT.layer_plan(jcfg)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_init_params_seed_identical(arch):
    """``init_params(cfg, 0)`` draws the reference's values bit for bit."""
    cfg = get_config(arch, reduced=True)
    tree = JT.init_params(jax_config(arch, reduced=True), 0)
    mine = params_to_numpy(T.init_params(cfg, 0, device="cpu"), cfg)
    leaves = jax.tree_util.tree_leaves_with_path(tree)
    assert [tuple(k.key for k in p) for p, _ in leaves] == \
        [p for p, _ in T.param_leaves(cfg)]
    for path, leaf in leaves:
        np.testing.assert_array_equal(_leaf(mine, path), np.asarray(leaf, np.float32),
                                      err_msg=jax.tree_util.keystr(path))


def test_converter_round_trip(model):
    _, _, tcfg, tree, _, tp = model
    back = params_to_numpy(tp, tcfg)
    for path, leaf in jax.tree_util.tree_leaves_with_path(tree):
        np.testing.assert_array_equal(_leaf(back, path), np.asarray(leaf, np.float32))


def test_train_state_round_trip(model):
    """A reference training state (parameters, AdamW slots, error
    feedback) → a port state → the reference's tree, every leaf equal: the
    slots key on the same names as the parameters, superblocks and the
    encoder included."""
    _, _, tcfg, tree, _, _ = model
    rng = np.random.default_rng(4)
    slots = {k: jax.tree.map(lambda a: rng.standard_normal(np.shape(a)).astype(np.float32),
                             tree) for k in ("m", "v", "err")}
    state = {"params": tree, "opt": {"step": np.int32(3), "m": slots["m"],
                                     "v": slots["v"]}, "err": slots["err"]}
    back = train_state_to_numpy(train_state_from_jax(state, tcfg, device="cpu",
                                                     dtype=torch.float32), tcfg)
    assert int(back["opt"]["step"]) == 3
    for path, leaf in jax.tree_util.tree_leaves_with_path(
            {"params": tree, "m": slots["m"], "v": slots["v"], "err": slots["err"]}):
        where = [path[0].key] if path[0].key in ("params", "err") else ["opt", path[0].key]
        got = back
        for key in where:
            got = got[key]
        np.testing.assert_array_equal(_leaf(got, path[1:]), np.asarray(leaf, np.float32))


def test_superblock_and_encoder_names():
    """A one-sublayer plan keeps the dense names; jamba's superblock adds
    the sublayer, whisper's encoder has its own stack."""
    jamba = dict(T.param_specs(get_config("jamba-v0.1-52b", reduced=True)).named_parameters())
    assert "blocks.0.4.attn.wq" in jamba and "blocks.0.5.moe.router" in jamba
    assert "blocks.0.0.ssm.A_log" in jamba and "blocks.0.0.mlp.gate" in jamba
    whisper = dict(T.param_specs(get_config("whisper-tiny", reduced=True)).named_parameters())
    assert {"blocks.1.cross.wq", "blocks.1.ln_cross", "encoder.1.attn.bq",
            "enc_final_norm"} <= set(whisper)
    mamba = dict(T.param_specs(get_config("mamba2-780m", reduced=True)).named_parameters())
    assert "blocks.1.ssm.w_x" in mamba and not any(".ln2" in n for n in mamba)


def test_forward_logits_and_aux(model):
    _, jcfg, tcfg, _, jp, tp = model
    batch = _batch(tcfg, 2, 17)
    t, t_aux = T.forward(tp, _tb(batch), tcfg)
    j, j_aux = jax.jit(lambda p, b: JT.forward(p, b, jcfg))(jp, _jb(batch))
    assert t.shape == (2, 17, tcfg.padded_vocab())
    _close(t, j, F32)
    np.testing.assert_allclose(float(t_aux), float(j_aux), rtol=F32, atol=1e-12)
    if tcfg.is_moe:
        assert float(t_aux) > 0


def test_prefill_and_decode(model):
    """Prefill over 16 tokens into a cache of 24, then three decode steps
    (with the encoder's memory for whisper)."""
    _, jcfg, tcfg, _, jp, tp = model
    batch = _batch(tcfg, 2, 16)
    L = 24 + tcfg.n_prefix
    t = T.prefill(tp, _tb(batch), tcfg, max_len=L)
    j = jax.jit(lambda p, b: JT.prefill(p, b, jcfg, max_len=L))(jp, _jb(batch))
    assert t["cache_len"] == int(j["cache_len"]) == 16 + tcfg.n_prefix
    assert ("memory" in t) == ("memory" in j) == bool(tcfg.n_encoder_layers)
    # attention reads K/V back from the bf16 cache already in the prefill
    attends = any(m.startswith("attn") for m, _ in T.layer_plan(tcfg)[1])
    _close(t["logits"], j["logits"], KV_BF16 if attends else F32)
    if "memory" in t:
        _close(t["memory"], j["memory"], F32)
    tc, jc, cl = t["cache"], j["cache"], t["cache_len"]
    step = jax.jit(lambda p, c, b: JT.decode_step(p, c, b, jcfg))
    rng = np.random.default_rng(5)
    for _ in range(3):
        tok = rng.integers(0, tcfg.vocab, (2, 1)).astype(np.int32)
        tbatch = {"tokens": torch.from_numpy(tok), "cache_len": cl}
        jbatch = {"tokens": jnp.asarray(tok), "cache_len": jnp.int32(cl)}
        if "memory" in t:
            tbatch["memory"], jbatch["memory"] = t["memory"], j["memory"]
        tl, tc = T.decode_step(tp, tc, tbatch, tcfg)
        jl, jc = step(jp, jc, jbatch)
        _close(tl, jl, KV_BF16)
        cl += 1
    for sub, leaves in tc.items():
        for name, leaf in leaves.items():
            want = np.asarray(jc[sub][name], np.float32)
            assert leaf.dtype == (torch.float32 if name in ("state", "conv")
                                  else torch.bfloat16), (sub, name)
            kv = name in ("k", "v")
            np.testing.assert_allclose(
                leaf.float().numpy(), want, rtol=2.0 ** -7 if kv else 0,
                atol=(F32 * float(np.abs(want).max())) if kv else KV_BF16,
                err_msg=f"{sub}/{name}")


def test_loss_and_every_gradient(model):
    _, jcfg, tcfg, _, jp, tp = model
    batch = _batch(tcfg, 2, 17, seed=2)
    (jl, jm), jg = jax.value_and_grad(
        lambda p, b: JT.loss_fn(p, b, jcfg), has_aux=True)(jp, _jb(batch))
    tp.requires_grad_(True)
    try:
        loss, m = T.loss_fn(tp, _tb(batch), tcfg)
        loss.backward()
        grads = grads_to_numpy(tp, tcfg)
    finally:
        tp.requires_grad_(False)
        for p in tp.parameters():
            p.grad = None
    np.testing.assert_allclose(float(loss.detach()), float(jl), rtol=LOSS_RTOL)
    np.testing.assert_allclose(float(m["ce"].detach()), float(jm["ce"]), rtol=LOSS_RTOL)
    np.testing.assert_allclose(float(m["aux"].detach()), float(jm["aux"]),
                               rtol=F32, atol=1e-12)
    leaves = [(p, np.asarray(w)) for p, w in jax.tree_util.tree_leaves_with_path(jg)]
    largest = max(float(np.abs(w).max()) for _, w in leaves)
    for path, want in leaves:
        got, key = _leaf(grads, path), jax.tree_util.keystr(path)
        if [k.key for k in path[-2:]] == ["cross", "bk"]:
            # with no RoPE a key bias shifts every score of a query row
            # alike: softmax makes its gradient zero, both give f32 noise
            assert max(np.abs(got).max(), np.abs(want).max()) <= 1e-6 * largest, key
            continue
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=GRAD_TOLS.get(tcfg.name, GRAD_TOL)
                                   * float(np.abs(want).max()), err_msg=key)


@pytest.mark.parametrize("arch", ["qwen3-4b", "mamba2-780m", "whisper-tiny",
                                  "llama4-scout-17b-a16e"])
def test_decode_matches_forward(arch):
    """``tests/test_lm_models.py::test_decode_matches_forward`` on the
    port: bf16 parameters, the last token's logits from prefill + one
    decode step against forward over the whole prompt, rel < 0.05."""
    cfg = get_config(arch, reduced=True)
    if cfg.is_moe:  # avoid capacity-drop mismatch noise (GShard semantics)
        cfg = dataclasses.replace(cfg, capacity_factor=8.0)
    params = T.init_params(cfg, 0, device="cpu")
    B, S = 2, 17
    batch = {k: torch.from_numpy(v).to(torch.bfloat16 if v.dtype == np.float32 else None)
             for k, v in _batch(cfg, B, S, seed=1).items()}
    with torch.no_grad():
        full, _ = T.forward(params, batch, cfg)
    ref = full[:, -1].float()
    pf = T.prefill(params, dict(batch, tokens=batch["tokens"][:, :-1]), cfg,
                   max_len=S + cfg.n_prefix)
    db = {"tokens": batch["tokens"][:, -1:], "cache_len": pf["cache_len"]}
    if "memory" in pf:
        db["memory"] = pf["memory"]
    dec, _ = T.decode_step(params, pf["cache"], db, cfg)
    rel = float((ref - dec[:, 0].float()).abs().max() / (ref.abs().max() + 1e-9))
    assert rel < 0.05, rel


def _tuned_set(tuner):
    return sorted((e["kernel"], repr(sorted(e["shape"].items())),
                   repr(sorted(e["config"].items())))
                  for e in tuner._memo.values())


@pytest.mark.parametrize("arch", FAMILIES + ["llama4-scout-17b-a16e"])
def test_warm_autotune_tunes_the_reference_set(arch, monkeypatch):
    """The meta-device trace reaches every tuned lookup of the plan (the
    MoE dispatch, the SSD chunk, attention blocks, cross-attention over
    the encoder's frames) with the reference's shapes."""
    monkeypatch.setenv("REPRO_AUTOTUNE", "1")
    cfg, jcfg = get_config(arch, reduced=True), jax_config(arch, reduced=True)
    # prefill at max_len=seq_len has no room for a VLM's patch prefix: both
    # packages raise there (a cache of 64 cannot take 8 + 64 positions)
    stages = ("train", "decode") if cfg.n_prefix else ("train", "prefill", "decode")
    ours = at.KernelTuner(device="tpu_v5e", cache=None, measure=False)
    ref = jax_at.KernelTuner(device="tpu_v5e", cache=None, measure=False)
    at.set_tuner(ours)
    jax_at.set_tuner(ref)
    try:
        got = T.warm_autotune(cfg, batch_size=2, seq_len=64, stages=stages)
        want = JT.warm_autotune(jcfg, batch_size=2, seq_len=64, stages=stages)
    finally:
        at.set_tuner(None)
        jax_at.set_tuner(None)
    assert got["misses"] == want["misses"] > 0
    assert _tuned_set(ours) == _tuned_set(ref)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_paged_pool_refuses_the_reference_plans(arch):
    jcfg, tcfg = jax_config(arch, reduced=True), get_config(arch, reduced=True)
    try:
        want = JT.paged_cache_shapes(jcfg, 4, 8)
    except ValueError as e:
        with pytest.raises(ValueError, match="pure self-attention stack"):
            T.paged_cache_shapes(tcfg, 4, 8)
        assert "self-attention" in str(e)
    else:
        assert T.paged_cache_shapes(tcfg, 4, 8) == want
