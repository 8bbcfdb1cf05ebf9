"""Multi-device behaviour of the port against the reference (port of
``tests/test_multidevice.py``), on real ``gloo`` CPU ranks.

The reference forces 8 host devices in a subprocess; the port starts
``gloo`` ranks with ``torch.multiprocessing.spawn`` (``tests/
_torch_ranks.py``; a ``file://`` store under ``tmp_path``, a timeout on
every spawn).  Four ranks, a (2, 2) data × model mesh, where the
reference uses (2, 4): every rule its tests exercise — the batch over
data, heads, FFN, vocab and experts over model, the ZeRO slots over data
— already shards on two ranks an axis, at half the processes.

* The sharded train loss of the reduced internlm2 equals the port's
  unsharded loss within 1e-5 relative (f32), and that loss the JAX
  reference's within ``test_torch_train.py``'s 1e-6.
* The MoE arch (reduced qwen3-moe, capacity factor 8), sharded: experts
  over the model axis, the dispatch per group on the data axis.
* One AdamW step on the (2, 2) mesh, the slots ZeRO-sharded: the loss,
  the first moments and the updated parameters equal the unsharded
  step's within 1e-5 (of the largest entry; ``eps`` 1e-3, see
  ``_torch_ranks.adamw_step``).
* ``pipeline_apply`` over four stages against the sequential stages at
  rtol/atol 1e-5, and ``bubble_fraction(4, 8) == 3/11``.
* The campaign's ``2x1`` cell (compile-only, traced over a fake group)
  has collective bytes > 0 in its ``collective`` class, the ``1x1``
  cell exactly 0 (the reference's
  ``test_campaign_cell_collectives_on_2dev_mesh``).
* A checkpoint saved from a (2, 2) mesh restores onto a (4, 1) mesh.
* The training launcher's ``--auto-mesh 2`` on two ranks builds the
  planner's layout and trains on it: the state lives as DTensors and the
  losses equal the unsharded launcher's within rel 1e-3 (the parameters
  are bf16 and the sharded sums run in another order: 3e-5 at the first
  step, 2.8e-4 after one update, measured).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_config as jax_config
from repro.models import transformer as JT
from repro_torch.configs.registry import get_config
from repro_torch.distributed.pipeline_parallel import bubble_fraction
from repro_torch.models import transformer as T
from tests import _torch_ranks as ranks
from tests._torch_host import port_host_share  # noqa: F401 (autouse)

SHARDED_RTOL, LOSS_RTOL = 1e-5, 1e-6
B, S = 4, 16


@pytest.fixture(autouse=True)
def _pinned_tilings(monkeypatch):
    monkeypatch.setenv("REPRO_AUTOTUNE", "0")


def _cfgs(arch, factor=None):
    jc, tc = jax_config(arch, reduced=True), get_config(arch, reduced=True)
    if factor is not None:
        jc = dataclasses.replace(jc, capacity_factor=factor)
        tc = dataclasses.replace(tc, capacity_factor=factor)
    return jc, tc


def _unsharded(arch, factor=None):
    """(the port's unsharded f32 loss, the reference's) on the seed-0
    parameters and the ranks' tokens."""
    jc, tc = _cfgs(arch, factor)
    toks = ranks._tokens(tc.vocab, B, S)
    with torch.no_grad():
        mine, _ = T.loss_fn(T.init_params(tc, 0, device="cpu", dtype=torch.float32),
                            {"tokens": toks}, tc)
    jp = jax.tree.map(lambda a: jnp.asarray(np.asarray(a, np.float32)),
                      JT.init_params(jc, 0))
    ref, _ = JT.loss_fn(jp, {"tokens": jnp.asarray(toks.numpy())}, jc)
    return float(mine), float(ref)


@pytest.fixture(scope="module")
def sharded_losses(tmp_path_factory):
    specs = [["internlm2-1.8b", None, B, S], ["qwen3-moe-30b-a3b", 8.0, B, S]]
    out = ranks.spawn(ranks.losses, 4, tmp_path_factory.mktemp("losses"), specs,
                      timeout=120)
    assert all(o == out[0] for o in out)          # every rank gathers the same
    return out[0]


def test_sharded_train_step_matches_single_device(sharded_losses):
    mine, ref = _unsharded("internlm2-1.8b")
    np.testing.assert_allclose(mine, ref, rtol=LOSS_RTOL)
    np.testing.assert_allclose(sharded_losses["internlm2-1.8b"], mine, rtol=SHARDED_RTOL)


def test_moe_arch_sharded_matches(sharded_losses):
    mine, ref = _unsharded("qwen3-moe-30b-a3b", 8.0)
    np.testing.assert_allclose(mine, ref, rtol=LOSS_RTOL)
    np.testing.assert_allclose(sharded_losses["qwen3-moe-30b-a3b"], mine,
                               rtol=SHARDED_RTOL)


def test_adamw_step_on_a_2x2_mesh_matches_unsharded(tmp_path):
    from repro_torch.launch.lowering import make_train_step
    from repro_torch.optim.optimizer import OptimizerConfig, init_opt_state

    arch = "internlm2-1.8b"
    out = ranks.spawn(ranks.adamw_step, 4, tmp_path, arch, B, S, timeout=120)[0]
    cfg = get_config(arch, reduced=True)
    opt = OptimizerConfig(kind="adamw", warmup_steps=1, eps=1e-3)
    model = T.init_params(cfg, 0, device="cpu", dtype=torch.float32)
    model.requires_grad_(True)
    state = {"params": model, "opt": init_opt_state(dict(model.named_parameters()), opt)}
    state, metrics = make_train_step(cfg, opt)(
        state, {"tokens": ranks._tokens(cfg.vocab, B, S)})
    np.testing.assert_allclose(out["loss"], float(metrics["loss"]), rtol=SHARDED_RTOL)
    # embed (V, D): vocab over model, the slot's D over data (ZeRO)
    assert out["m_embed_placements"] == [["Shard", 1], ["Shard", 0]]
    assert set(out["params"]) == set(out["m"]) == set(ranks.CHECKED)
    for name in ranks.CHECKED:
        for got, want in ((out["params"][name], model.get_parameter(name)),
                          (out["m"][name], state["opt"]["m"][name])):
            want = want.detach().numpy()
            np.testing.assert_allclose(np.asarray(got, np.float32), want, rtol=0,
                                       atol=SHARDED_RTOL * float(np.abs(want).max()),
                                       err_msg=name)


def test_pipeline_parallel_matches_sequential(tmp_path):
    outs = ranks.spawn(ranks.pipeline, 4, tmp_path, timeout=120)
    rng = np.random.default_rng(0)
    ws = rng.standard_normal((4, 16, 16)) * 0.3
    x = rng.standard_normal((8, 2, 16))
    ref = torch.tensor(x, dtype=torch.float32)
    for s in range(4):
        ref = torch.tanh(ref @ torch.tensor(ws[s], dtype=torch.float32))
    for o in outs:                                # every stage holds the outputs
        np.testing.assert_allclose(np.asarray(o["out"]), ref.numpy(), rtol=1e-5,
                                   atol=1e-5)
    assert abs(bubble_fraction(4, 8) - 3 / 11) < 1e-9


def test_campaign_cell_collectives_on_2dev_mesh():
    """A data-parallel 2-device cell traced through ``launch/lowering``
    (compile-only: a fake group of two in this process) has collective
    bytes, carried whole by the collective class, while the same cell on
    1x1 has exactly none."""
    from repro_torch.campaign.plan import plan_grid
    from repro_torch.campaign.runner import measure_cell
    from repro_torch.engine.devices import get_device

    results = {}
    for mesh in ("1x1", "2x1"):
        plan = plan_grid(archs=("qwen3-4b",), shapes=("smoke_train_16x2",), meshes=(mesh,))
        assert len(plan.cells) == 1, (mesh, plan.skipped)
        results[mesh] = measure_cell(plan.cells[0], run=False, device="cpu")
    one, two = results["1x1"], results["2x1"]
    assert one["collective_bytes"] == 0.0, one["collective_bytes"]
    assert "collective" not in one["cost_classes"]
    assert two["collective_bytes"] > 0.0
    assert two["n_devices"] == 2
    assert "sp" not in one and two["sp"] is True     # the port's key, sharded cells
    classes = two["cost_classes"]
    coll = sum(s.get("collective_bytes", 0.0) for s in classes.values())
    assert coll == two["collective_bytes"]
    assert classes["collective"]["collective_bytes"] == coll
    assert classes["collective"]["count"] > 0
    for key in ("flops", "hbm_bytes"):
        assert sum(s.get(key, 0.0) for s in classes.values()) == two[key]
    # data parallel: each device runs half the batch's products
    assert two["flops"] == one["flops"] / 2
    assert two["device_fingerprint"] == get_device("host_cpu").fingerprint()


def test_elastic_checkpoint_restore_different_mesh(tmp_path):
    outs = ranks.spawn(ranks.elastic, 4, tmp_path, str(tmp_path / "ck"), timeout=120)
    w = np.arange(64, dtype=np.float32).reshape(8, 8)
    for o in outs:
        assert o["step"] == 3
        np.testing.assert_array_equal(np.asarray(o["full"], np.float32), w)
        assert o["mesh_shape"] == [4, 1]
        assert o["local_shape"] == [2, 8] and o["saved_local_shape"] == [4, 4]
        # the restored rows are a copy of this rank's slice, not a view of
        # the whole leaf
        assert o["local_storage"][0] == o["local_storage"][1] == 2 * 8 * 4


def test_launcher_auto_mesh_trains_on_the_job_s_ranks(tmp_path, monkeypatch):
    from repro_torch.launch import train as launch

    argv = ["--arch", "internlm2-1.8b", "--reduced", "--steps", "2", "--batch", "4",
            "--seq", "16", "--torch-device", "cpu"]
    want = launch.main(argv)
    outs = ranks.spawn(ranks.launcher, 2, tmp_path, argv + ["--auto-mesh", "2"],
                       timeout=120)
    for o in outs:
        assert o["line"].startswith("auto-mesh: built 1x") and o["embed"] == "DTensor"
        assert o["summary"]["steps"] == 2
        for key in ("first_loss", "last_loss"):
            np.testing.assert_allclose(o["summary"][key], want[key], rtol=1e-3)
    assert outs[0]["summary"]["first_loss"] == outs[1]["summary"]["first_loss"]
