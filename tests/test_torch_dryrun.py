"""The port's dry-run (``repro_torch.launch.dryrun``, ``launch/lowering
.lower_cell``) against the reference's, on the CPU at smoke size.

* The CLI on a reduced arch and a smoke shape over ``--mesh 2x4`` (a
  ``fake`` group of 8 ranks, meta tensors): one report per cell in the
  ``--out`` ledger with the reference's keys (its ``RooflineReport``
  fields), a second call prints ``DONE`` and appends nothing, ``SKIP``
  and ``FAILED`` records as the reference writes them, and the
  roofline table reads the ledger back.
* Per-device product FLOPs of the sharded train step within 5% of the
  reference's ``lower_cell`` on the same reduced cell and mesh — the
  reference compiled in a subprocess with 8 forced host devices, as its
  own multi-device tests run.  5%: both count matrix products only, but
  XLA's SPMD partitioner and DTensor's sharding propagation may lay a
  few small products out differently (the port replicates a GQA group
  it cannot split; XLA may split it).
* Collective bytes of the sharded cell are > 0; of the 1x1 cell,
  exactly 0.
"""

import dataclasses
import json
import os
import subprocess
import sys
import textwrap

import pytest

from repro.core.roofline import RooflineReport as RefReport
from repro_torch.bench import roofline_table
from repro_torch.campaign.plan import SMOKE_SHAPES
from repro_torch.configs import base, registry
from repro_torch.launch import dryrun
from tests._torch_host import port_host_share  # noqa: F401 (autouse)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARCH, SHAPE = "internlm2-1.8b", "smoke_train_16x2"


@pytest.fixture
def reduced(monkeypatch):
    """The dry-run over the reduced configs and the campaign's smoke
    shapes (the CLI reads ``registry.get_config`` and ``SHAPES``)."""
    get = registry.get_config
    monkeypatch.setattr(registry, "get_config", lambda a, reduced=False: get(a, reduced=True))
    monkeypatch.setattr(dryrun, "get_config", registry.get_config)
    for name, shape in SMOKE_SHAPES.items():
        monkeypatch.setitem(base.SHAPES, name, shape)
    monkeypatch.setenv("REPRO_AUTOTUNE", "0")


def _lines(capsys):
    return [ln for ln in capsys.readouterr().out.splitlines() if ln]


def test_cli_ledger_resume_skip_and_failed(reduced, tmp_path, capsys, monkeypatch):
    out = str(tmp_path / "dryrun.jsonl")
    argv = ["--arch", ARCH, "--mesh", "2x4", "--out", out, "--device", "cpu"]
    reps = dryrun.main(argv + ["--shape", SHAPE])
    lines = _lines(capsys)
    assert f"=== {ARCH} × {SHAPE} [2x4] ===" in lines
    assert lines[-1] == "1 cells traced OK" and len(reps) == 1
    (rec,) = [json.loads(ln) for ln in open(out)]
    # the reference's keys and the port's "sp": the hint the cell ran with
    assert set(rec) == {f.name for f in dataclasses.fields(RefReport)} | {"sp"}
    assert rec["sp"] is True
    assert rec["n_devices"] == 8 and rec["mesh"] == "2x4"
    assert rec["collective_bytes"] > 0 and rec["flops"] > 0
    assert sum(rec["bytes_by_kind"].values()) == pytest.approx(rec["collective_bytes"])
    assert rec["class_breakdown"]["collective"]["collective_bytes"] == \
        pytest.approx(rec["collective_bytes"])

    # resume: the cell is in the ledger
    assert dryrun.main(argv + ["--shape", SHAPE]) == []
    lines = _lines(capsys)
    assert lines[0] == f"DONE {ARCH} × {SHAPE} [2x4] (in ledger; --redo to retrace)"
    assert len(open(out).readlines()) == 1

    # SKIP: a full-attention arch at 500k decode
    dryrun.main(argv + ["--shape", "long_500k"])
    assert _lines(capsys)[0].startswith(f"SKIP {ARCH} × long_500k [2x4]: full-attention")

    # FAILED: a cell whose trace raises is recorded and the run goes on
    def boom(*a, **k):
        raise RuntimeError("planted")

    monkeypatch.setattr(dryrun, "lower_cell", boom)
    dryrun.main(argv + ["--shape", "smoke_prefill_32x2"])
    assert f"FAILED {ARCH} × smoke_prefill_32x2 [2x4]" in _lines(capsys)
    recs = [json.loads(ln) for ln in open(out)]
    assert recs[1] == {"arch": ARCH, "shape": "long_500k", "mesh": "2x4",
                       "skipped": recs[1]["skipped"]}
    assert recs[2] == {"arch": ARCH, "shape": "smoke_prefill_32x2", "mesh": "2x4",
                       "failed": True}

    rows = []
    roofline_table.run(rows.append, path=out)
    assert rows[0].split() == ["arch", "shape", "mesh", "C(ms)", "M(ms)", "X(ms)",
                               "dom", "useful", "HBM(GB)", "fit"]
    assert any(r.startswith(f"roofline/{ARCH}/{SHAPE}/2x4/step_ms,") for r in rows)
    assert any("SKIP:" in r for r in rows) and any(r.endswith("FAILED") for r in rows)


def test_sequence_parallel_off_is_said_and_recorded(reduced, tmp_path, capsys, monkeypatch):
    """Where this torch's DTensor cannot view a sequence-sharded activation
    (the probe ``layers.seq_shard_views`` says no), the SP hint is off: the
    run says so and the record holds ``sp`` false, and the cell traces;
    ``--no-sp`` turns it off without a word.  The probe's answer is
    planted: the installed torch can view the layout."""
    from repro_torch.models import layers as L

    argv = ["--arch", ARCH, "--shape", SHAPE, "--out", str(tmp_path / "d.jsonl"),
            "--device", "cpu"]
    probe = L.seq_shard_views
    monkeypatch.setattr(L, "seq_shard_views", lambda mesh: False)
    (rep,) = dryrun.main(argv + ["--mesh", "2x4"])
    lines = _lines(capsys)
    assert "sequence-parallel hint off on the 2x4 mesh ('data', 'model'): this torch's " \
        "DTensor cannot view a sequence-sharded activation" in lines
    assert rep.sp is False and rep.collective_bytes > 0 and L._HINT_MESH is None
    monkeypatch.setattr(L, "seq_shard_views", probe)
    (rep,) = dryrun.main(argv + ["--mesh", "4x2", "--no-sp"])
    assert not any("sequence-parallel" in ln for ln in _lines(capsys))
    recs = {r["mesh"]: r for r in map(json.loads, open(tmp_path / "d.jsonl"))}
    assert recs["2x4"]["sp"] is False and recs["4x2"]["sp"] is False


def test_recorded_cells_dedupe_and_tolerate_torn_lines(tmp_path):
    """The reference's ``TestDryrunLedger`` case: a re-run record, a skip
    and an unrelated line count once each; a torn last line is dropped."""
    from repro_torch.core.fileio import append_jsonl

    p = str(tmp_path / "dryrun.jsonl")
    append_jsonl(p, [
        {"arch": "a", "shape": "s", "mesh": "16x16", "step_s": 1.0},
        {"arch": "a", "shape": "s", "mesh": "16x16", "step_s": 2.0},  # re-run
        {"arch": "b", "shape": "s", "mesh": "16x16", "skipped": "why"},
        {"unrelated": True},
    ])
    with open(p, "a") as f:
        f.write('{"arch": "c", "shape": "torn"')
    cells = dryrun._recorded_cells(p)
    assert cells == {dryrun._cell_id("a", "s", "16x16"), dryrun._cell_id("b", "s", "16x16")}
    assert dryrun._recorded_cells(None) == set()


def test_cuda_default_raises_without_a_card(reduced, tmp_path, monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        dryrun.main(["--arch", ARCH, "--shape", SHAPE, "--mesh", "2x4",
                     "--out", str(tmp_path / "d.jsonl")])


_REF = """
import json, sys
from repro.campaign.plan import SMOKE_SHAPES
from repro.configs import base, registry
from repro.launch import lowering
from repro.launch.mesh import make_mesh
get = registry.get_config
lowering.get_config = lambda a, reduced=False: get(a, reduced=True)
base.SHAPES.update(SMOKE_SHAPES)
out = {}
for desc in ("2x4", "1x1"):
    dims = tuple(int(d) for d in desc.split("x"))
    rep = lowering.lower_cell(sys.argv[1], sys.argv[2], make_mesh(dims, ("data", "model")),
                              desc, print_analysis=False)
    out[desc] = {"flops": rep.flops, "collective_bytes": rep.collective_bytes,
                 "keys": sorted(rep.to_dict())}
print(json.dumps(out))
"""


def test_per_device_flops_within_5pct_of_the_reference(reduced, tmp_path):
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count=8",
               PYTHONPATH=os.path.join(ROOT, "src"), REPRO_AUTOTUNE="0",
               JAX_PLATFORMS="cpu")
    proc = subprocess.run([sys.executable, "-c", textwrap.dedent(_REF), ARCH, SHAPE],
                          capture_output=True, text=True, env=env, timeout=600, cwd=ROOT)
    assert proc.returncode == 0, proc.stderr[-3000:]
    ref = json.loads(proc.stdout.strip().splitlines()[-1])
    out = str(tmp_path / "d.jsonl")
    for desc in ("2x4", "1x1"):
        dryrun.main(["--arch", ARCH, "--shape", SHAPE, "--mesh", desc, "--out", out,
                     "--device", "cpu"])
    mine = {r["mesh"]: r for r in map(json.loads, open(out))}
    for desc in ("2x4", "1x1"):
        assert sorted(mine[desc]) == sorted(ref[desc]["keys"] + ["sp"])
        rel = abs(mine[desc]["flops"] - ref[desc]["flops"]) / ref[desc]["flops"]
        print(f"{desc}: port {mine[desc]['flops']:.6g} reference "
              f"{ref[desc]['flops']:.6g} FLOPs per device (rel {rel:.4f}); "
              f"collective bytes {mine[desc]['collective_bytes']:.6g} / "
              f"{ref[desc]['collective_bytes']:.6g}")
        assert rel <= 0.05
    assert mine["2x4"]["sp"] is True and mine["1x1"]["sp"] is False
    assert mine["1x1"]["collective_bytes"] == 0.0 == ref["1x1"]["collective_bytes"]
    assert mine["2x4"]["collective_bytes"] > 0 and ref["2x4"]["collective_bytes"] > 0
