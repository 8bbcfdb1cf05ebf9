"""The port's training path against the reference's.

``loss_fn`` (loss, ce, aux) and every gradient leaf against
``jax.value_and_grad(repro.models.transformer.loss_fn)``, f32 parameters
from the same ``init_params`` draw: reduced qwen3-4b (tied embeddings,
``qk_norm``), reduced internlm2-1.8b (untied) and internlm2 with a vocab
that padding rounds up (500 → 512), each without ``seq_chunk``, with a
chunk that divides S − 1 = 24 and with one that does not.  Tolerance, f32
level: the loss within rtol 1e-6, each gradient leaf within 1e-5 of its
largest entry (both packages sum in f32 in different orders; the largest
deviation seen is 2e-6).

Then remat on and off give identical gradients; the port's ``Trainer``
starts from the reference ``Trainer``'s parameters bit for bit and its
first loss agrees in bf16; the reference trainer's behaviours
(``tests/test_trainer_serve.py``); and the launcher.
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import ShapeSpec as JShapeSpec
from repro.configs.registry import get_config as jax_config
from repro.models import transformer as JT
from repro.optim.optimizer import OptimizerConfig as JOptimizerConfig
from repro.train.trainer import Trainer as JTrainer
from repro.train.trainer import TrainerConfig as JTrainerConfig
from repro_torch.configs.base import ShapeSpec
from repro_torch.configs.registry import get_config
from repro_torch.convert import grads_to_numpy, params_from_jax, params_to_numpy
from repro_torch.launch import train as launch
from repro_torch.models import transformer as T
from repro_torch.optim.optimizer import OptimizerConfig
from repro_torch.train.trainer import StragglerMonitor, Trainer, TrainerConfig
from tests._torch_host import port_host_share  # noqa: F401 (autouse)

LOSS_RTOL, GRAD_TOL = 1e-6, 1e-5
SMOKE_SHAPE = ShapeSpec("smoke", seq_len=32, global_batch=4, kind="train")


@pytest.fixture(autouse=True)
def _pinned_tilings(monkeypatch):
    monkeypatch.setenv("REPRO_AUTOTUNE", "0")


def _configs(arch, vocab=None):
    jc, tc = jax_config(arch, reduced=True), get_config(arch, reduced=True)
    if vocab:
        jc, tc = dataclasses.replace(jc, vocab=vocab), dataclasses.replace(tc, vocab=vocab)
    return jc, tc


def _f32_model(arch, vocab=None):
    jc, tc = _configs(arch, vocab)
    tree = JT.init_params(jc, 0)
    jp = jax.tree.map(lambda a: jnp.asarray(np.asarray(a, np.float32)), tree)
    tp = params_from_jax(tree, tc, device="cpu", dtype=torch.float32)
    tp.requires_grad_(True)
    return jc, tc, jp, tp


def _tokens(vocab, B=2, S=25, seed=1):
    return np.random.default_rng(seed).integers(0, vocab, (B, S)).astype(np.int32)


def _port_loss_and_grads(tp, tc, toks, **kw):
    for p in tp.parameters():
        p.grad = None
    loss, m = T.loss_fn(tp, {"tokens": torch.from_numpy(toks)}, tc, **kw)
    loss.backward()
    return loss.detach(), {k: v.detach() for k, v in m.items()}, grads_to_numpy(tp, tc)


@pytest.mark.parametrize("arch, vocab, seq_chunk", [
    (arch, None, chunk) for arch in ("qwen3-4b", "internlm2-1.8b") for chunk in (None, 8, 5)
] + [("internlm2-1.8b", 500, None), ("internlm2-1.8b", 500, 5)])
def test_loss_and_every_gradient_match_reference(arch, vocab, seq_chunk):
    jc, tc, jp, tp = _f32_model(arch, vocab)
    assert tc.padded_vocab() > tc.vocab or not vocab
    toks = _tokens(tc.vocab)
    (jl, jm), jg = jax.value_and_grad(
        lambda p, b: JT.loss_fn(p, b, jc, seq_chunk=seq_chunk), has_aux=True)(
            jp, {"tokens": jnp.asarray(toks)})
    loss, m, grads = _port_loss_and_grads(tp, tc, toks, seq_chunk=seq_chunk)
    assert loss.dtype == m["ce"].dtype == torch.float32
    np.testing.assert_allclose(float(loss), float(jl), rtol=LOSS_RTOL)
    np.testing.assert_allclose(float(m["ce"]), float(jm["ce"]), rtol=LOSS_RTOL)
    assert float(m["aux"]) == float(jm["aux"]) == 0.0
    ref = jax.tree_util.tree_leaves_with_path(jg)
    assert len(ref) == len(T.param_leaves(tc))
    for path, want in ref:
        got = grads
        for key in path:
            got = got[key.key]
        want = np.asarray(want)
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=GRAD_TOL * float(np.abs(want).max()),
                                   err_msg=jax.tree_util.keystr(path))


def _vjp_both(ref_fn, port_fn, inputs, seed=0):
    """Gradients of <f(inputs), c> for a random cotangent c, through the
    reference (``jax.vjp``) and the port (``backward``)."""
    j_in = [jnp.asarray(a) for a in inputs]
    out, pull = jax.vjp(ref_fn, *j_in)
    c = np.random.default_rng(seed).standard_normal(out.shape).astype(np.float32)
    want = pull(jnp.asarray(c))
    t_in = [torch.tensor(a, requires_grad=True) for a in inputs]
    (port_fn(*t_in) * torch.from_numpy(c)).sum().backward()
    return [t.grad.numpy() for t in t_in], [np.asarray(w) for w in want]


@pytest.mark.parametrize("fn", ["rms_norm", "rope", "blocked_attention", "mlp_block"])
def test_layers_carry_the_references_gradients(fn):
    """Each function of the dense stack has a backward (no in-place write
    into a tensor autograd saved) and gives the reference's input
    gradients at f32 level (1e-5 of the largest entry)."""
    from types import SimpleNamespace

    from repro.models import layers as JL
    from repro_torch.models import layers as TL

    rng = np.random.default_rng(7)
    f32 = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    pos = np.arange(12)
    if fn == "rms_norm":
        inputs, ref, port = [f32(2, 12, 16), f32(16)], JL.rms_norm, TL.rms_norm
    elif fn == "rope":
        inputs = [f32(2, 12, 4, 16)]
        ref = lambda x: JL.rope(x, jnp.asarray(pos), 1e4)  # noqa: E731
        port = lambda x: TL.rope(x, torch.from_numpy(pos), 1e4)  # noqa: E731
    elif fn == "blocked_attention":
        inputs = [f32(2, 12, 4, 16), f32(2, 12, 2, 16), f32(2, 12, 2, 16)]
        ref = lambda q, k, v: JL.blocked_attention(  # noqa: E731
            q, k, v, q_positions=jnp.asarray(pos), k_positions=jnp.asarray(pos), block_q=4)
        port = lambda q, k, v: TL.blocked_attention(  # noqa: E731
            q, k, v, q_positions=torch.from_numpy(pos), k_positions=torch.from_numpy(pos),
            block_q=4)
    else:
        inputs = [f32(2, 12, 16), f32(16, 24), f32(16, 24), f32(24, 16)]
        ref = lambda x, g, u, d: JL.mlp_block(x, {"gate": g, "up": u, "down": d})  # noqa: E731
        port = lambda x, g, u, d: TL.mlp_block(  # noqa: E731
            x, SimpleNamespace(gate=g, up=u, down=d))
    got, want = _vjp_both(ref, port, inputs)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=0, atol=GRAD_TOL * float(np.abs(w).max()))


@pytest.mark.parametrize("seq_chunk", [None, 5])
def test_remat_on_and_off_give_identical_gradients(monkeypatch, seq_chunk):
    """Remat (a checkpoint per layer and, with ``seq_chunk``, per chunk)
    recomputes in backward exactly what the forward computed."""
    _, tc, _, tp = _f32_model("internlm2-1.8b")
    toks = _tokens(tc.vocab)
    calls = []
    checkpoint = T.checkpoint

    def counted(fn, *args, **kw):
        calls.append(fn.__name__)
        return checkpoint(fn, *args, **kw)

    monkeypatch.setattr(T, "checkpoint", counted)
    on = _port_loss_and_grads(tp, tc, toks, seq_chunk=seq_chunk)
    n_chunks = 0 if seq_chunk is None else -(-24 // seq_chunk)
    assert calls == ["_block"] * tc.n_layers + ["_chunk_ce"] * n_chunks
    monkeypatch.setattr(T, "checkpoint", lambda fn, *args, **kw: fn(*args))
    off = _port_loss_and_grads(tp, tc, toks, seq_chunk=seq_chunk)
    assert torch.equal(on[0], off[0])
    for got, want in zip(jax.tree_util.tree_leaves(off[2]), jax.tree_util.tree_leaves(on[2])):
        np.testing.assert_array_equal(got, want)


def test_seq_chunk_never_holds_the_whole_logits(monkeypatch):
    """With ``seq_chunk`` the vocab product runs per chunk, forward and
    (recomputed) backward: no (B, S, V) logits tensor is made."""
    _, tc, _, tp = _f32_model("internlm2-1.8b")
    V, seen = tc.padded_vocab(), []
    matmul = torch.Tensor.__matmul__

    def spy(a, b):
        out = matmul(a, b)
        if out.shape[-1] == V:
            seen.append(tuple(out.shape))
        return out

    monkeypatch.setattr(torch.Tensor, "__matmul__", spy)
    _port_loss_and_grads(tp, tc, _tokens(tc.vocab), seq_chunk=5)
    assert seen and set(seen) == {(2, 5, V)}
    seen.clear()
    _port_loss_and_grads(tp, tc, _tokens(tc.vocab))
    assert seen == [(2, 25, V)]


# -- the Trainer ----------------------------------------------------------------


def _opt():
    return OptimizerConfig(kind="adamw", lr=3e-3, warmup_steps=2,
                           total_steps=200, clip_norm=1.0)


def _trainer(tcfg=None, **kw):
    return Trainer(get_config("internlm2-1.8b", reduced=True), SMOKE_SHAPE, _opt(),
                   tcfg or TrainerConfig(), device="cpu", **kw)


def test_trainer_matches_reference_trainer():
    """Same seed, bf16: identical initial parameters; the first loss within
    bf16 rounding of the forward (rtol 2e-3: both packages round every
    layer's activations to bf16, at places that differ by an ulp)."""
    jcfg = jax_config("internlm2-1.8b", reduced=True)
    ref = JTrainer(jcfg, JShapeSpec("smoke", 32, 4, "train"),
                   JOptimizerConfig(kind="adamw", lr=3e-3, warmup_steps=2,
                                    total_steps=200, clip_norm=1.0), JTrainerConfig())
    tr = _trainer()
    ref_state, state = ref.init_state(), tr.init_state()
    mine = params_to_numpy(state["params"], tr.cfg)
    for path, want in jax.tree_util.tree_leaves_with_path(ref_state["params"]):
        got = mine
        for key in path:
            got = got[key.key]
        np.testing.assert_array_equal(got, np.asarray(want, np.float32))
    first = tr.train(1)["history"][0]
    ref_first = ref.train(1)["history"][0]
    np.testing.assert_allclose(first["loss"], ref_first["loss"], rtol=2e-3)
    np.testing.assert_allclose(first["ce"], ref_first["ce"], rtol=2e-3)


def test_loss_decreases_over_training():
    out = _trainer().train(25)
    first = np.mean([h["ce"] for h in out["history"][:5]])
    last = np.mean([h["ce"] for h in out["history"][-5:]])
    assert last < first - 0.1, (first, last)
    assert all(np.isfinite(h["loss"]) and h["dt"] > 0 for h in out["history"])


def test_crash_resume_continues_bit_exactly(tmp_path):
    d = str(tmp_path / "ck")
    tr = _trainer(TrainerConfig(ckpt_dir=d, ckpt_every=5, fail_at_step=12))
    with pytest.raises(RuntimeError, match="injected failure"):
        tr.train(20)
    # restart without failure injection: resumes from step 10
    out = _trainer(TrainerConfig(ckpt_dir=d, ckpt_every=5)).train(20)
    resumed = [h["step"] for h in out["history"]]
    assert resumed[0] == 10 and resumed[-1] == 19     # latest ckpt was step 9
    # bit-exact against an uninterrupted run (deterministic data, init, CPU)
    full = _trainer().train(20)
    assert [h["loss"] for h in out["history"]] == [h["loss"] for h in full["history"][10:]]
    for a, b in zip(out["state"]["params"].parameters(), full["state"]["params"].parameters()):
        assert torch.equal(a, b)
    for name in ("m", "v"):
        for k, t in out["state"]["opt"][name].items():
            assert torch.equal(t, full["state"]["opt"][name][k]), (name, k)


def test_grad_compression_path_trains():
    out = _trainer(TrainerConfig(grad_compression=0.25)).train(15)
    first = np.mean([h["ce"] for h in out["history"][:5]])
    last = np.mean([h["ce"] for h in out["history"][-5:]])
    assert last < first
    err = out["state"]["err"]
    assert all(e.dtype == torch.float32 for e in err.values())
    assert any(float(e.abs().sum()) > 0 for e in err.values())


def test_straggler_monitor_flags_outliers():
    m = StragglerMonitor(factor=2.0)
    for i in range(10):
        m.observe(i, 0.1)
    assert m.observe(10, 0.5) is True
    assert m.flagged and m.flagged[-1][0] == 10
    assert m.observe(11, 0.1) is False


def test_admission_gate_refuses():
    def deny(cfg, shape):
        return False, {"reason": "predicted OOM"}

    with pytest.raises(RuntimeError, match="admission denied"):
        _trainer(admission=deny)
    seen = []
    _trainer(admission=lambda cfg, shape: (seen.append(shape) or True, {}))
    assert seen == [SMOKE_SHAPE]


@pytest.mark.parametrize("kw", [{"mesh": object()}, {"state_shardings": {}}])
def test_sharded_training_names_its_roadmap_item(kw, tmp_path):
    """``Trainer(mesh=...)`` (and with explicit ``state_shardings``) over a
    one-rank ``gloo`` group on a (1, 1) mesh: the state lives as DTensors
    and the losses equal the unsharded trainer's exactly; a checkpoint is
    written.  ``state_shardings`` without a mesh is refused."""
    import torch.distributed as dist

    from repro_torch.distributed import sharding as sh
    from repro_torch.launch.mesh import make_mesh
    from torch.distributed.tensor import DTensor

    if "state_shardings" in kw:
        with pytest.raises(ValueError, match="pass mesh"):
            _trainer(**kw)
    want = [h["loss"] for h in _trainer().train(2)["history"]]
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/store",
                            rank=0, world_size=1)
    try:
        mesh = make_mesh((1, 1), ("data", "model"), device="cpu")
        cfg = get_config("internlm2-1.8b", reduced=True)
        extra = ({"state_shardings": sh.train_state_shardings(cfg, mesh)}
                 if "state_shardings" in kw else {})
        out = _trainer(TrainerConfig(ckpt_dir=str(tmp_path / "ck")), mesh=mesh,
                       **extra).train(2)
        assert isinstance(out["state"]["params"].embed, DTensor)
        assert [h["loss"] for h in out["history"]] == want
        assert (tmp_path / "ck" / "step_000000001" / "manifest.json").exists()
    finally:
        dist.destroy_process_group()


# -- the launcher -----------------------------------------------------------------


def test_launcher_trains_and_prints_the_reference_summary(capsys, tmp_path):
    out = launch.main(["--arch", "internlm2-1.8b", "--reduced", "--steps", "2",
                       "--batch", "2", "--seq", "16", "--torch-device", "cpu",
                       "--ckpt-dir", str(tmp_path / "ck")])
    printed = json.loads(capsys.readouterr().out)
    assert printed == out
    assert sorted(out) == ["arch", "first_loss", "last_loss", "mean_step_ms",
                           "steps", "stragglers"]
    assert out["arch"] == "internlm2-1.8b-smoke" and out["steps"] == 2
    assert np.isfinite(out["first_loss"]) and np.isfinite(out["last_loss"])
    assert (tmp_path / "ck" / "step_000000001" / "manifest.json").exists()


def test_launcher_lm_forest_loads_the_forest(tmp_path):
    """``--lm-forest`` no longer waits on a ROADMAP item: it loads the
    campaign-fitted forest, so a missing file raises before any parameter
    is drawn (the forest's admissions: ``tests/test_torch_campaign.py``)."""
    with pytest.raises(FileNotFoundError):
        launch.main(["--arch", "internlm2-1.8b", "--reduced", "--steps", "1",
                     "--torch-device", "cpu", "--lm-forest",
                     str(tmp_path / "missing.npz")])


_ADMIT_ARGV = ["--arch", "internlm2-1.8b", "--reduced", "--steps", "1", "--batch", "2",
               "--seq", "16"]


def _no_training(monkeypatch):
    """Both packages' trainers return an empty history: admission runs in
    the constructor, so the gate's decision shows without a step."""
    from repro.train import trainer as ref_trainer
    from repro_torch.train import trainer as port_trainer

    empty = lambda self, n: {"history": [], "stragglers": []}  # noqa: E731
    monkeypatch.setattr(ref_trainer.Trainer, "train", empty)
    monkeypatch.setattr(port_trainer.Trainer, "train", empty)


@pytest.mark.parametrize("flags, admits", [
    (["--memory-budget-gb", "0.001"], False),
    (["--memory-budget-gb", "4"], True),
    (["--energy-budget-j", "1e-9"], False),
    (["--energy-budget-j", "1e6", "--admission-margin", "0"], True),
    (["--device", "tpu_v5e"], True),
])
def test_launcher_admission_flags_as_reference(monkeypatch, capsys, flags, admits):
    """``--memory-budget-gb``, ``--energy-budget-j``, ``--device`` and the
    margin refuse or admit a reduced cell as the reference's launcher does
    (a refusal: ``PlacementRefused``, a ``RuntimeError`` "admission
    denied", raised before any parameter is drawn)."""
    import sys

    from repro.launch import train as ref_launch
    from repro_torch.serve import PlacementRefused

    monkeypatch.setenv("REPRO_AUTOTUNE", "0")
    _no_training(monkeypatch)
    draws = []
    monkeypatch.setattr(T, "init_params", lambda *a, **k: draws.append(1))
    monkeypatch.setattr(sys, "argv", ["train"] + _ADMIT_ARGV + flags)
    try:
        ref_launch.main()
        ref_admits = True
    except RuntimeError as e:
        assert "admission denied" in str(e)
        ref_admits = False
    try:
        launch.main(_ADMIT_ARGV + flags + ["--torch-device", "cpu"])
        port_admits = True
    except PlacementRefused as e:
        assert str(e).startswith("admission denied: ") and isinstance(e, RuntimeError)
        assert e.info["predicted_gb"] == e.info["gamma_mb"] / 1e3
        port_admits = False
    capsys.readouterr()
    assert port_admits == ref_admits == admits and not draws


def test_launcher_estimate_cache_readmits_without_a_trace(monkeypatch, capsys, tmp_path):
    from repro_torch.engine import AnalyticalBackend

    monkeypatch.setenv("REPRO_AUTOTUNE", "0")
    _no_training(monkeypatch)
    traces = []
    trace = AnalyticalBackend._trace_arch
    monkeypatch.setattr(AnalyticalBackend, "_trace_arch",
                        lambda self, q: traces.append(q) or trace(self, q))
    argv = _ADMIT_ARGV + ["--memory-budget-gb", "4", "--estimate-cache",
                          str(tmp_path / "est.json"), "--torch-device", "cpu"]
    launch.main(argv)
    assert len(traces) == 1 and (tmp_path / "est.json").exists()
    launch.main(argv)
    assert len(traces) == 1
    # --estimate-cache alone gates nothing, as in the reference
    launch.main(_ADMIT_ARGV + ["--estimate-cache", str(tmp_path / "other.json"),
                               "--torch-device", "cpu"])
    assert len(traces) == 1 and not (tmp_path / "other.json").exists()
    capsys.readouterr()
