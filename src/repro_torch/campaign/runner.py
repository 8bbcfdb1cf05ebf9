"""Resumable campaign execution over a durable JSONL ledger (port of
``repro/campaign/runner.py``, whole).

The runner is deliberately dumb-robust, in the way a long profiling
campaign on a flaky edge fleet has to be (paper §5.1.1's "profile once,
reuse forever" only works if "once" survives interruption):

* **Durable append-only ledger** — every measured cell is appended through
  ``core/fileio.append_jsonl`` (O_APPEND + fsync) the moment it finishes.
  A killed runner loses at most the cell in flight; a torn final line is
  dropped by the tolerant loader and simply re-measured.
* **Resume** — on start the runner loads the ledger and skips every cell
  already recorded (``ok`` *or* quarantined), so a restart continues where
  the previous run died instead of re-measuring the grid.
* **Quarantine, don't abort** — a cell whose lowering/measurement raises is
  recorded as ``status:"failed"`` with the error and the campaign moves
  on.  Failed cells are NOT retried on restart (the failure is almost
  always deterministic — an unlowerable layout); ``retry_failed=True``
  opts back in after a fix.  ``cell_timeout_s`` extends the same
  policy to cells that *hang* instead of raising: the measurement is
  fenced on a daemon thread and a blown budget quarantines the cell as
  ``error:"timeout"``.
* **Sharding** — ``shard_index/num_shards`` split cells by a stable hash
  of the cell key, so N workers given the same plan partition the grid
  without coordination and may share one ledger file (appends from
  different processes never interleave).

The default measurement (:func:`measure_cell`) builds the real step
through ``launch/lowering.compile_cell`` zero-filled on the card, times
it with CUDA events, measures its memory by the profiler's card
definition and traces its aten-op cost ledger on the meta device.  A
cell of several devices runs over that many ranks of the process group
(``torchrun``; every rank runs the same plan, rank 0 writes the
ledger), its step and its trace sharded (DTensors on a ``DeviceMesh``;
per-device numbers, collective bytes from the collectives the sharded
step runs); short of ranks it is quarantined (``MeshSpecError``).  A
compile-only cell (``run=False``) of several devices is traced in this
one process under ``launch.mesh.fake_world``.  A cell that runs out of
memory on the card is quarantined like any other failure.  The timeout fence cannot stop a CUDA call: an abandoned
measurement thread runs on and holds its memory until it ends.
"""

from __future__ import annotations

import threading
import time
import traceback
from dataclasses import dataclass, field

from repro_torch.campaign.plan import CampaignCell, CampaignPlan, mesh_dims
from repro_torch.core.fileio import append_jsonl, load_jsonl_tolerant
from repro_torch.launch.mesh import is_rank0

__all__ = ["CampaignLedger", "CampaignRunner", "CellTimeout", "measure_cell"]


class CellTimeout(RuntimeError):
    """A cell's measurement exceeded the runner's ``cell_timeout_s``."""

# v2: records carry ``cost_classes`` (the per-op-class ledger breakdown)
# and ``device_fingerprint`` (checked at fit time — campaign/fit.py).
# v3: executed records add ``watts_proxy`` / ``energy_j`` (the device
# envelope's modelled draw at the measured phi) and the ``cost_classes``
# buckets gain a per-class dynamic ``energy_j``.  Loads are tolerant:
# v2 records simply lack the columns and the energy fits skip them.
# v4: records carry the planner's ``layout`` block (per-class collective
# bytes + memory split predicted by the sharding rules for this cell's
# mesh — distributed/collectives.layout_collectives), so fitted
# collective coefficients can be audited against the byte model that
# will consume them.
LEDGER_SCHEMA_VERSION = 4


class CampaignLedger:
    """Read/append view of a campaign's JSONL ledger.

    One record per measured cell attempt; the *last* record per cell key
    wins (a ``--retry-failed`` re-measurement supersedes the quarantined
    one).  See docs/campaign.md for the record schema."""

    def __init__(self, path: str):
        self.path = path
        self._by_key: dict[str, dict] = {}
        for rec in load_jsonl_tolerant(path):
            key = rec.get("key")
            if key:
                self._by_key[key] = rec

    # -- queries -----------------------------------------------------------

    def get(self, key: str) -> dict | None:
        return self._by_key.get(key)

    def records(self, status: str | None = None) -> list[dict]:
        recs = list(self._by_key.values())
        return recs if status is None else [
            r for r in recs if r.get("status") == status]

    @property
    def ok_keys(self) -> set[str]:
        return {k for k, r in self._by_key.items() if r.get("status") == "ok"}

    @property
    def failed_keys(self) -> set[str]:
        """The quarantine list — persisted in the ledger itself."""
        return {k for k, r in self._by_key.items()
                if r.get("status") == "failed"}

    # -- writes ------------------------------------------------------------

    def append(self, record: dict) -> None:
        if is_rank0():          # in a process group, rank 0 writes the file
            append_jsonl(self.path, record)
        self._by_key[record["key"]] = record

    def __len__(self) -> int:
        return len(self._by_key)


def _run_on_device(cfg, shape, dims, device, repeats: int, warmup: int) -> dict:
    """Build the cell's step zero-filled on ``device``, call it once
    (``compile_s``), time it (the profiler's ``_time_calls``: CUDA events
    on the card, the median of ``repeats`` after ``warmup``) and measure
    one step's memory (the profiler's ``_memory_step``).  Returns plain
    numbers only, so nothing on the device outlives the call."""
    import torch

    from repro_torch.core.profiler import _memory_step, _nbytes, _sync, _time_calls
    from repro_torch.launch.lowering import compile_cell, tensors_of

    dev = torch.device(device)
    step, args, _ = compile_cell(cfg, shape, dims, device=dev)
    resident = tensors_of(list(args))
    grad_bytes = _nbytes(tensors_of(args[0]["params"])) if shape.kind == "train" else 0

    def fn(*a):                 # the step's outputs as a flat tensor list
        return tensors_of(step(*a))

    t0 = time.perf_counter()
    fn(*args)
    _sync(dev)
    compile_s = time.perf_counter() - t0
    phi_ms = _time_calls(fn, args, max(repeats, 1), max(warmup - 1, 0), dev)
    temp, out = _memory_step(fn, args, resident, grad_bytes, dev)
    return {"phi_ms": phi_ms, "compile_s": compile_s,
            "arg": float(_nbytes(resident)), "temp": float(temp), "out": float(out)}


def _trace(cfg, shape, dims, mesh_device: str = "cpu"):
    """The cell's step traced on meta tensors (nothing allocated or
    launched): its cost ledger and its Γ terms by the written definition
    of a traced step (``core/profiler.meta_memory``).  A cell of several
    devices is traced sharded over a ``mesh_device`` mesh of the group's
    ranks, or of a fake group of that many (``launch.mesh.fake_world``)
    when none is up: per-device numbers and collective bytes.  Returns
    ``(cost, mem, sp)``, ``sp`` the sequence-parallel hint of a sharded
    step (False on one device)."""
    import contextlib
    import math

    import torch.distributed as dist

    from repro_torch.core.hlo_cost import recording
    from repro_torch.core.profiler import _nbytes, meta_memory
    from repro_torch.kernels.autotune import untimed
    from repro_torch.launch.lowering import compile_cell, mesh_axes, tensors_of
    from repro_torch.launch.mesh import fake_world, make_mesh

    n = math.prod(dims)
    world = (contextlib.nullcontext() if n == 1 or dist.is_initialized()
             else fake_world(n))
    with world:
        mesh = dims if n == 1 else make_mesh(dims, mesh_axes(dims), device=mesh_device)
        step, args, _ = compile_cell(cfg, shape, mesh, device="meta")
        train = shape.kind == "train"
        grad_bytes = _nbytes(tensors_of(args[0]["params"])) if train else 0
        with untimed(), recording() as cost:
            mem = meta_memory(lambda *a: tensors_of(step(*a)), args,
                              tensors_of(list(args)), grad_bytes=grad_bytes,
                              train=train)
    return cost, mem, getattr(step, "sp", False)


def measure_cell(
    cell: CampaignCell,
    *,
    repeats: int = 2,
    warmup: int = 1,
    run: bool = True,
    device="cuda",
) -> dict:
    """Ground truth for one cell on ``device`` (default ``"cuda"``; raises
    without a card unless ``device="cpu"``).  The cell's own ``device``
    field stays the :class:`DeviceSpec` name it is featurized under.

    The reference compiles the step and reads XLA's buffer plan and HLO;
    the port builds the eager step zero-filled on ``device``
    (``launch/lowering.compile_cell``) and records, under the reference's
    keys:

    * ``phi_ms`` — the median of ``repeats`` CUDA-event step times after
      ``warmup`` calls (the first call included), as
      ``core/profiler._time_calls``;
    * ``gamma_mb`` / ``arg_mb`` / ``temp_mb`` — the profiler's written
      card definition: ``arg`` (parameters, optimizer slots, cache, batch)
      + the peak of ``max_memory_allocated`` over one step less what was
      allocated before it (``_memory_step``; on the CPU its stand-in);
    * ``compile_s`` — the seconds of the first call;
    * ``flops`` / ``hbm_bytes`` / ``collective_bytes`` / ``cost_classes``
      — the step's aten-op ledger traced on the meta device
      (``core/hlo_cost``), the energy bucket priced by the device
      envelope;
    * ``layout`` — ``layout_collectives`` on ``abstract_mesh(dims)``;
    * ``sp`` (the port's key, on a cell of several devices only) — the
      sequence-parallel hint the sharded step ran with
      (``layers.sequence_parallel``).

    ``run=False`` executes nothing (the reference's compile-only cell):
    ``phi_ms`` is 0 and Γ is the traced step's; a mesh of several devices
    is traced sharded in this process (collective bytes > 0).  A measured
    cell of more devices than the process group has ranks raises
    ``MeshSpecError`` (the runner quarantines it).  On the card the memory is released (``gc.collect``,
    ``empty_cache``) after the cell, also when it fails."""
    return _measure_cell(cell, repeats=repeats, warmup=warmup, run=run,
                         device=device)[0]


def _measure_cell(cell: CampaignCell, *, repeats: int, warmup: int, run: bool,
                  device) -> tuple[dict, dict]:
    """:func:`measure_cell`'s record and, beside it, the traced step's Γ
    terms (``arg``/``temp``/``out`` bytes, ``core/profiler.meta_memory``)."""
    import gc

    import torch

    from repro_torch.configs.registry import get_config
    from repro_torch.device import resolve_device as resolve_torch_device
    from repro_torch.distributed.collectives import abstract_mesh, layout_collectives
    from repro_torch.engine.decompose import price_ledger_energy, watts_proxy
    from repro_torch.engine.devices import resolve_device
    from repro_torch.launch.lowering import check_mesh, mesh_axes
    from repro_torch.launch.mesh import validate_mesh_spec

    torch_dev = resolve_torch_device(device)
    cfg = get_config(cell.arch, reduced=cell.reduced)
    dims = mesh_dims(cell.mesh)
    n_devices = (check_mesh(dims, torch_dev) if run
                 else validate_mesh_spec(dims, mesh_axes(dims)))

    mb = None
    if run:
        try:
            mb = _run_on_device(cfg, cell.shape, dims, torch_dev, repeats, warmup)
        except BaseException as e:
            # the failed step's frames hold its tensors: drop them so the
            # card is free for the next cell
            traceback.clear_frames(e.__traceback__)
            raise
        finally:
            if torch_dev.type == "cuda":
                gc.collect()
                torch.cuda.empty_cache()
    cost, mem, sp = _trace(cfg, cell.shape, dims, torch_dev.type)
    if mb is None:
        mb = {"phi_ms": 0.0, "compile_s": 0.0, **mem}
    phi_ms = mb["phi_ms"]

    # Watts proxy (schema v3): the device envelope's modelled average draw
    # at the measured wall time, and the step energy it implies.  Zero
    # when the cell didn't execute (no wall time to integrate over) or
    # the spec declares no envelope — fits skip zero energy columns.
    dev = resolve_device(cell.device)
    watts = float(watts_proxy(cost.flops, phi_ms / 1e3, dev)) if run else 0.0

    # Planner accounting for this cell: the per-class collective bytes and
    # memory split the sharding rules *predict* for this layout, logged
    # next to the measured ledger counts so the fitted collective
    # coefficient and the planner's byte model can be compared
    # cell-by-cell.
    layout = layout_collectives(cfg, cell.shape, abstract_mesh(dims)).to_dict()
    # the sequence-parallel hint a sharded cell ran with (the port's key)
    sharded = {"sp": sp} if int(n_devices) > 1 else {}
    return {
        "gamma_mb": (mb["arg"] + mb["out"] + mb["temp"]) / 1e6,
        "phi_ms": phi_ms,
        "compile_s": mb["compile_s"],
        "flops": cost.flops,
        "hbm_bytes": cost.hbm_bytes,
        "collective_bytes": cost.collective_bytes,
        "watts_proxy": watts,
        "energy_j": watts * phi_ms / 1e3,
        # Per-op-class ledger breakdown (sums reproduce the three scalars
        # above exactly — the costmodel parity contract; the energy bucket
        # is the envelope-priced per-op dynamic joules) + the fingerprint
        # of the device constants this cell was measured under, checked at
        # fit time against the spec that will featurize it.
        "cost_classes": price_ledger_energy(cost.ledger, dev).class_sums(),
        "layout": layout,
        "device_fingerprint": dev.fingerprint(),
        "temp_mb": mb["temp"] / 1e6,
        "arg_mb": mb["arg"] / 1e6,
        "n_devices": int(n_devices),
        "executed": bool(run),
        **sharded,
    }, mem


@dataclass
class CampaignRunner:
    """Drive a plan's cells through ``measure`` into the ledger.

    ``measure`` is injectable (tests use a deterministic fake); it takes a
    :class:`CampaignCell` and returns the measurement dict merged into the
    ledger record.  The default is :func:`measure_cell` on ``device``
    (the torch device the steps run on, ``"cuda"`` by default)."""

    plan: CampaignPlan
    ledger: "CampaignLedger | str"
    measure: "callable" = None
    repeats: int = 2
    warmup: int = 1
    run: bool = True
    retry_failed: bool = False
    cell_timeout_s: "float | None" = None
    extra_meta: dict = field(default_factory=dict)
    device: str = "cuda"

    def __post_init__(self):
        if isinstance(self.ledger, str):
            self.ledger = CampaignLedger(self.ledger)
        if self.measure is None:
            from repro_torch.device import resolve_device

            resolve_device(self.device)   # no card: raise here, not per cell
            self.measure = lambda cell: measure_cell(
                cell, repeats=self.repeats, warmup=self.warmup, run=self.run,
                device=self.device)

    # -- timeout fence -----------------------------------------------------

    def _measure_fenced(self, cell: CampaignCell) -> dict:
        """``measure(cell)`` under the per-cell wall-clock budget.

        A hung cell (a step that never returns, a wedged device)
        would otherwise stall the whole campaign — the one failure mode
        quarantine-on-exception can't catch.  The measurement runs on a
        daemon thread; past ``cell_timeout_s`` the runner abandons it
        (the thread can't be killed, but daemon threads don't block
        process exit) and raises :class:`CellTimeout`, which the loop
        quarantines like any other deterministic failure."""
        if self.cell_timeout_s is None:
            return self.measure(cell)
        box: dict = {}

        def work():
            try:
                box["result"] = self.measure(cell)
            except BaseException as e:          # noqa: BLE001 — re-raised below
                box["error"] = e

        t = threading.Thread(target=work, daemon=True,
                             name=f"cell-{cell.key[:8]}")
        t.start()
        t.join(self.cell_timeout_s)
        if t.is_alive():
            raise CellTimeout(
                f"cell {cell.key[:8]} ({cell.arch} × {cell.shape.name}) "
                f"exceeded {self.cell_timeout_s:.1f}s")
        if "error" in box:
            raise box["error"]
        return box["result"]

    # -- work selection ----------------------------------------------------

    def shard_cells(self, shard_index: int = 0, num_shards: int = 1) -> list[CampaignCell]:
        """Deterministic partition by cell-key hash: independent of ledger
        state, so workers never race for (or orphan) a cell."""
        if not (0 <= shard_index < num_shards):
            raise ValueError(f"shard {shard_index} outside 0..{num_shards - 1}")
        return [c for c in self.plan.cells
                if int(c.key[:8], 16) % num_shards == shard_index]

    def pending(self, shard_index: int = 0, num_shards: int = 1) -> list[CampaignCell]:
        done = self.ledger.ok_keys
        if not self.retry_failed:
            done = done | self.ledger.failed_keys
        return [c for c in self.shard_cells(shard_index, num_shards)
                if c.key not in done]

    # -- the loop ----------------------------------------------------------

    def run_campaign(
        self,
        shard_index: int = 0,
        num_shards: int = 1,
        *,
        max_cells: int | None = None,
        print_fn=None,
    ) -> dict:
        """Measure every pending cell of this shard; returns a summary.

        ``max_cells`` bounds the number of *measurements this call* makes
        (not the grid) — used by tests to simulate a mid-grid kill and by
        budgeted overnight runs."""
        say = print_fn or (lambda *_: None)
        shard = self.shard_cells(shard_index, num_shards)
        pending = self.pending(shard_index, num_shards)
        say(f"campaign {self.plan.plan_hash}: shard {shard_index + 1}/"
            f"{num_shards} has {len(shard)} cells, {len(pending)} pending, "
            f"{len(self.ledger.failed_keys)} quarantined")
        measured = failed = 0
        for cell in pending:
            if max_cells is not None and measured + failed >= max_cells:
                break
            base = {
                **cell.to_dict(),
                "key": cell.key,
                "plan_hash": self.plan.plan_hash,
                "schema": LEDGER_SCHEMA_VERSION,
                **self.extra_meta,
            }
            try:
                result = self._measure_fenced(cell)
            except KeyboardInterrupt:
                raise
            except Exception as e:
                failed += 1
                say(f"QUARANTINE {cell.arch} × {cell.shape.name} "
                    f"[{cell.mesh}]: {e}")
                # Timeouts get a stable machine-readable error tag (the
                # human detail lives in the trace) so downstream tooling
                # can count hung cells apart from crashed ones.
                err = ("timeout" if isinstance(e, CellTimeout)
                       else f"{type(e).__name__}: {e}")
                self.ledger.append({
                    **base, "status": "failed", "error": err,
                    "trace": (str(e) if isinstance(e, CellTimeout)
                              else traceback.format_exc(limit=5)),
                })
                continue
            measured += 1
            self.ledger.append({**base, "status": "ok", **result})
            say(f"ok {cell.arch} × {cell.shape.name} [{cell.mesh}]: "
                f"gamma={result['gamma_mb']:.1f}MB phi={result['phi_ms']:.2f}ms"
                f" (compile {result.get('compile_s', 0):.1f}s)")
        return {
            "shard_cells": len(shard),
            "measured": measured,
            "failed": failed,
            "remaining": len(self.pending(shard_index, num_shards)),
            "ledger_records": len(self.ledger),
        }
