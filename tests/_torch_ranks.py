"""Real ``gloo`` ranks for the port's multi-rank CPU tests.

:func:`spawn` starts ``nprocs`` processes with
``torch.multiprocessing.spawn``, each joining a ``gloo`` group through a
``file://`` store under the test's ``tmp_path`` (no port is chosen, so
parallel test workers never collide), and fails the test if they do not
all end within ``timeout`` seconds.  The rank programs live here, in a
module that imports only ``torch`` and ``repro_torch``, so that each
rank starts without the JAX package.  Each writes what it measured to
``<out>/rank<r>.json``; the test compares it with the reference.
"""

from __future__ import annotations

import json
import os
import time

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp


def spawn(fn, nprocs: int, tmp_path, *args, timeout: float = 120.0) -> list[dict]:
    """Run ``fn(rank, store, out, *args)`` on ``nprocs`` gloo ranks; return
    each rank's JSON results."""
    out = str(tmp_path / "ranks")
    os.makedirs(out, exist_ok=True)
    ctx = mp.spawn(_entry, args=(fn, nprocs, str(tmp_path / "store"), out, args),
                   nprocs=nprocs, join=False)
    deadline = time.monotonic() + timeout
    while not ctx.join(timeout=1.0):
        if time.monotonic() > deadline:
            for p in ctx.processes:
                p.kill()
            raise TimeoutError(f"{nprocs} ranks did not end within {timeout:.0f} s")
    return [json.load(open(os.path.join(out, f"rank{r}.json"))) for r in range(nprocs)]


def _entry(rank, fn, nprocs, store, out, args):
    torch.set_num_threads(1)
    os.environ["REPRO_AUTOTUNE"] = "0"
    dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank,
                            world_size=nprocs)
    try:
        result = fn(rank, out, *args)
    finally:
        dist.destroy_process_group()
    with open(os.path.join(out, f"rank{rank}.json"), "w") as f:
        json.dump(result, f)


def _tokens(vocab: int, B: int, S: int, seed: int = 0) -> torch.Tensor:
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.integers(0, vocab, (B, S)).astype(np.int32))


def _sharded_loss(cfg, mesh, B: int, S: int) -> float:
    """``loss_fn`` of the seed-0 f32 model over ``mesh``: parameters by
    ``param_pspecs``, the batch by ``batch_pspecs``, the hint mesh
    installed for the forward."""
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.configs.base import ShapeSpec
    from repro_torch.distributed import sharding as sh
    from repro_torch.models import layers as L
    from repro_torch.models import transformer as T

    model = T.init_params(cfg, 0, device="cpu", dtype=torch.float32)
    shape = ShapeSpec("t", S, B, "train")
    model = sh.distribute_tree(model, sh.to_named(
        mesh, sh.port_params(cfg, sh.param_pspecs(cfg, mesh))))
    batch = sh.distribute_tree({"tokens": _tokens(cfg.vocab, B, S)},
                               sh.to_named(mesh, sh.batch_pspecs(cfg, shape, mesh)))
    with torch.no_grad(), implicit_replication(), L.hint_mesh(mesh):
        loss, _ = T.loss_fn(model, batch, cfg)
    return float(loss.full_tensor())


def losses(rank, out, specs):
    """Sharded losses of the reduced archs in ``specs`` ([arch, capacity
    factor or None, B, S]) on a (2, 2) data × model mesh."""
    import dataclasses

    from repro_torch.configs.registry import get_config
    from repro_torch.launch.mesh import make_mesh

    mesh = make_mesh((2, 2), ("data", "model"), device="cpu")
    res = {}
    for arch, factor, B, S in specs:
        cfg = get_config(arch, reduced=True)
        if factor is not None:
            cfg = dataclasses.replace(cfg, capacity_factor=factor)
        res[arch] = _sharded_loss(cfg, mesh, B, S)
    return res


def adamw_step(rank, out, arch, B, S):
    """One AdamW step (``launch.lowering.make_train_step``) of the seed-0
    f32 model on a (2, 2) mesh, the state placed by
    ``train_state_shardings`` (ZeRO slots on the data axis): the loss and
    every updated parameter, gathered whole.  ``eps`` 1e-3: Adam's first
    update of a gradient entry near ``eps`` (``g / (|g| + eps)``) would
    amplify the order of the sharded sums by ``|g| / eps``."""
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.configs.registry import get_config
    from repro_torch.distributed import sharding as sh
    from repro_torch.launch.lowering import make_train_step, sharded
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import transformer as T
    from repro_torch.optim.optimizer import OptimizerConfig, init_opt_state

    cfg = get_config(arch, reduced=True)
    mesh = make_mesh((2, 2), ("data", "model"), device="cpu")
    opt = OptimizerConfig(kind="adamw", warmup_steps=1, eps=1e-3)
    model = T.init_params(cfg, 0, device="cpu", dtype=torch.float32)
    model.requires_grad_(True)
    state = {"params": model, "opt": init_opt_state(dict(model.named_parameters()), opt)}
    state = sh.distribute_tree(state, sh.train_state_shardings(cfg, mesh))
    batch = sh.distribute_tree({"tokens": _tokens(cfg.vocab, B, S)}, sh.to_named(
        mesh, sh.batch_pspecs(cfg, ShapeSpec("t", S, B, "train"), mesh)))
    state, metrics = sharded(make_train_step(cfg, opt), mesh)(state, batch)
    m = state["opt"]["m"]["embed"]
    return {"loss": float(metrics["loss"].full_tensor()),
            "m_embed_placements": [[type(p).__name__, getattr(p, "dim", None)]
                                   for p in m.placements],
            "params": {n: p.full_tensor().detach().numpy().tolist()
                       for n, p in state["params"].named_parameters() if n in CHECKED},
            "m": {n: state["opt"]["m"][n].full_tensor().numpy().tolist()
                  for n in CHECKED}}


CHECKED = ("embed", "blocks.0.attn.wq", "blocks.1.mlp.down", "final_norm")


def pipeline(rank, out):
    """``pipeline_apply`` over a 4-stage ``pipe`` mesh on the reference
    test's data: 8 microbatches of (2, 16), stages ``tanh(h @ w_s)``."""
    from repro_torch.distributed.pipeline_parallel import pipeline_apply
    from repro_torch.launch.mesh import make_mesh

    mesh = make_mesh((4,), ("pipe",), device="cpu")
    rng = np.random.default_rng(0)
    ws = torch.tensor(rng.standard_normal((4, 16, 16)) * 0.3, dtype=torch.float32)
    x = torch.tensor(rng.standard_normal((8, 2, 16)), dtype=torch.float32)
    got = pipeline_apply(lambda w, h: torch.tanh(h @ w), ws, x, mesh)
    return {"out": got.numpy().tolist()}


def elastic(rank, out, ckpt_dir):
    """Save an (8, 8) leaf sharded over a (2, 2) mesh, restore it onto a
    (4, 1) mesh's placements of the same spec."""
    from repro_torch.distributed import sharding as sh
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.train import checkpoint as ckpt

    w = torch.arange(64, dtype=torch.float32).reshape(8, 8)
    mesh1 = make_mesh((2, 2), ("data", "model"), device="cpu")
    saved = sh.distribute_tree({"w": w}, sh.to_named(mesh1, {"w": ("data", "model")}))
    ckpt.save_checkpoint(ckpt_dir, 3, saved)
    mesh2 = make_mesh((4, 1), ("data", "model"), device="cpu")
    step, restored = ckpt.restore_checkpoint(
        ckpt_dir, template={"w": w},
        shardings=sh.to_named(mesh2, {"w": ("data", "model")}))
    r = restored["w"]
    local = r.to_local()
    return {"step": step, "full": r.full_tensor().numpy().tolist(),
            "local_shape": list(local.shape),
            "local_storage": [local.untyped_storage().nbytes(),
                              local.numel() * local.element_size()],
            "mesh_shape": list(r.device_mesh.mesh.shape),
            "saved_local_shape": list(saved["w"].to_local().shape)}


def launcher(rank, out, argv):
    """The training launcher with ``--auto-mesh`` on this job's ranks (the
    group is up: the launcher builds the chosen mesh on it)."""
    import contextlib
    import io

    from repro_torch.launch import train as launch
    from repro_torch.train import trainer as tr

    seen = {}
    real = tr.Trainer.place

    def place(self, state):
        state = real(self, state)
        seen["embed"] = type(state["params"].embed).__name__
        return state

    tr.Trainer.place = place
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        summary = launch.main(argv)
    line = next((ln for ln in buf.getvalue().splitlines() if ln.startswith("auto-mesh:")), "")
    return {"summary": summary, "line": line, **seen}
