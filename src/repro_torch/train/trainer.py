"""Fault-tolerant training loop (port of ``repro/train/trainer.py``).

Behaviours, all exercised by tests:
  * auto-resume from the latest valid checkpoint (atomic dirs — a killed run
    restarts exactly; on the CPU the resumed run is bit-identical),
  * periodic checkpointing with keep-N GC, in the reference's layout
    (``repro_torch.convert.train_state_to_tree``), so either package
    restores the other's checkpoints,
  * straggler monitor: per-step wall-time EWMA; steps slower than
    ``straggler_factor``× the EWMA are logged and counted,
  * failure injection (``fail_at_step``) for crash/restart tests,
  * optional top-k gradient compression with error feedback,
  * an admission hook: refuse to build the step when a callable
    ``admission(cfg, shape) -> (ok, info)`` says no.

The step is eager: ``loss_fn`` → ``backward`` → optional
``compress_grads`` → ``apply_updates``.  With a ``mesh`` (a
``DeviceMesh`` of the process group's ranks) the state is placed on it as
``DTensor``s by ``state_shardings`` (default: the reference's
``state_pspecs`` for the optimizer, ``distributed.sharding
.train_state_shardings``), each step's batch by ``batch_pspecs``, and
the step runs on DTensors as ``launch.lowering.sharded`` runs it (the
activation hint mesh installed for the call, implicit replication; the
sequence-parallel hint said off where this torch cannot run it); the
device is the mesh's device type.  The state is
``{"params": LM, "opt": {"step", "m", "v"}, "err"}``, the slots keyed by
parameter name; the model's parameters require grad, and their
gradient buffers are allocated with the state and accumulated into in
place each step.  A step is timed on the host clock up to
``torch.cuda.synchronize`` (the reference's ``block_until_ready``).
"""

from __future__ import annotations

import time
from dataclasses import dataclass

import torch

from repro_torch.configs.base import ArchConfig, ShapeSpec
from repro_torch.convert import _host, train_state_from_jax, train_state_to_tree
from repro_torch.data.pipeline import batch_to_device, make_batch
from repro_torch.device import resolve_device
from repro_torch.models import transformer as T
from repro_torch.optim.compression import compress_grads, init_error_state
from repro_torch.optim.optimizer import OptimizerConfig, apply_updates, init_opt_state
from repro_torch.train import checkpoint as ckpt

__all__ = ["TrainerConfig", "Trainer", "StragglerMonitor"]

@dataclass
class TrainerConfig:
    ckpt_dir: str | None = None
    ckpt_every: int = 50
    keep: int = 3
    log_every: int = 10
    straggler_factor: float = 2.0
    grad_compression: float | None = None    # top-k ratio, None = off
    fail_at_step: int | None = None          # failure injection (tests)
    seed: int = 0


class StragglerMonitor:
    """EWMA step-time tracker; flags outlier steps (straggler mitigation's
    detection half — the mitigation itself is a scheduler action)."""

    def __init__(self, factor: float = 2.0, alpha: float = 0.2):
        self.factor, self.alpha = factor, alpha
        self.ewma: float | None = None
        self.flagged: list[tuple[int, float]] = []

    def observe(self, step: int, dt: float) -> bool:
        slow = self.ewma is not None and dt > self.factor * self.ewma
        if slow:
            self.flagged.append((step, dt))
        self.ewma = dt if self.ewma is None else (
            (1 - self.alpha) * self.ewma + self.alpha * dt
        )
        return slow


class Trainer:
    def __init__(
        self,
        cfg: ArchConfig,
        shape: ShapeSpec,
        opt_cfg: OptimizerConfig | None = None,
        tcfg: TrainerConfig | None = None,
        *,
        mesh=None,
        state_shardings=None,
        admission=None,   # callable(cfg, shape) -> (ok, info)
        device="cuda",
    ):
        if state_shardings is not None and mesh is None:
            raise ValueError("state_shardings place the state on a mesh: pass mesh")
        self.mesh = mesh
        self.device = resolve_device(mesh.device_type if mesh is not None else device)
        self.cfg = cfg
        self.shape = shape
        self.opt_cfg = opt_cfg or OptimizerConfig(kind="adamw", warmup_steps=10,
                                                  total_steps=1000)
        self.tcfg = tcfg or TrainerConfig()
        self.monitor = StragglerMonitor(self.tcfg.straggler_factor)
        self.history: list[dict] = []

        if admission is not None:
            ok, info = admission(cfg, shape)
            if not ok:
                raise RuntimeError(f"admission denied: {info}")

        self._compression = self.tcfg.grad_compression
        self.state_shardings = state_shardings
        if mesh is not None:
            from repro_torch.distributed import sharding as sh
            from repro_torch.launch.lowering import sharded

            if state_shardings is None:
                self.state_shardings = sh.train_state_shardings(
                    cfg, mesh, kind=self.opt_cfg.kind,
                    err=self._compression is not None)
            self._batch_shardings = sh.to_named(mesh, sh.batch_pspecs(cfg, shape, mesh))
            self._sharded_step = sharded(self._local_step, mesh)

    # ------------------------------------------------------------------

    def _step(self, state: dict, batch: dict) -> tuple[dict, dict]:
        if self.mesh is None:
            return self._local_step(state, batch)
        from repro_torch.distributed.sharding import distribute_tree

        state, metrics = self._sharded_step(
            state, distribute_tree(batch, self._batch_shardings))
        return state, {k: _host(v) for k, v in metrics.items()}

    def _local_step(self, state: dict, batch: dict) -> tuple[dict, dict]:
        model = state["params"]
        params = dict(model.named_parameters())
        for p in params.values():
            p.grad.zero_()
        loss, metrics = T.loss_fn(model, batch, self.cfg)
        loss.backward()
        grads = {n: p.grad for n, p in params.items()}
        if self._compression is not None:
            grads, state["err"] = compress_grads(grads, state["err"],
                                                 ratio=self._compression)
        _, state["opt"], om = apply_updates(params, grads, state["opt"], self.opt_cfg)
        return state, {"loss": loss.detach(), "ce": metrics["ce"].detach(), **om}

    def place(self, state: dict) -> dict:
        """Put a state on the trainer's mesh (the identity without one),
        then turn on the model's gradients and allocate their buffers."""
        if self.mesh is not None:
            from repro_torch.distributed.sharding import distribute_tree

            state = distribute_tree(state, self.state_shardings)
        return self._trainable(state)

    @staticmethod
    def _trainable(state: dict) -> dict:
        """Turn on the model's gradients and allocate their buffers."""
        for p in state["params"].parameters():
            p.requires_grad_(True)
            p.grad = torch.zeros_like(p)
        return state

    def init_state(self) -> dict:
        model = T.init_params(self.cfg, self.tcfg.seed, device=self.device)
        params = dict(model.named_parameters())
        state = {"params": model, "opt": init_opt_state(params, self.opt_cfg)}
        if self._compression is not None:
            state["err"] = init_error_state(params)
        return self.place(state)

    def restore_or_init(self) -> tuple[int, dict]:
        d = self.tcfg.ckpt_dir
        if d and ckpt.latest_step(d) is not None:
            step, tree = ckpt.restore_checkpoint(d)
            if self._compression is not None and "err" not in tree:
                raise KeyError("checkpoint missing leaf err (gradient compression "
                               "is on)")
            state = train_state_from_jax(tree, self.cfg, device=self.device,
                                         dtype=T.DTYPE)
            if self._compression is None:
                state.pop("err", None)
            return step + 1, self.place(state)
        return 0, self.init_state()

    def save(self, step: int, state: dict) -> str:
        return ckpt.save_checkpoint(self.tcfg.ckpt_dir, step,
                                    train_state_to_tree(state, self.cfg),
                                    keep=self.tcfg.keep)

    # ------------------------------------------------------------------

    def train(self, num_steps: int) -> dict:
        start, state = self.restore_or_init()
        cuda = self.device.type == "cuda"
        for step in range(start, num_steps):
            if self.tcfg.fail_at_step is not None and step == self.tcfg.fail_at_step:
                raise RuntimeError(f"injected failure at step {step}")
            batch = make_batch(self.cfg, self.shape, step, self.tcfg.seed)
            t0 = time.perf_counter()
            state, metrics = self._step(state, batch_to_device(batch, self.device))
            if cuda:
                torch.cuda.synchronize(self.device)
            dt = time.perf_counter() - t0
            slow = self.monitor.observe(step, dt)
            rec = {"step": step, "loss": float(metrics["loss"]),
                   "ce": float(metrics["ce"]), "dt": dt, "straggler": slow}
            self.history.append(rec)
            if self.tcfg.ckpt_dir and (step + 1) % self.tcfg.ckpt_every == 0:
                self.save(step, state)
        if self.tcfg.ckpt_dir and num_steps > start:
            self.save(num_steps - 1, state)
        return {"state": state, "history": self.history,
                "stragglers": self.monitor.flagged}
