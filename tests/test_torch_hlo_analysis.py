"""Per-collective bytes (``repro_torch.core.hlo_analysis``) and the
per-device cost of a sharded trace (``core/hlo_cost.trace_cost``,
``core/profiler.meta_memory``) against the reference.

* ``analyze_hlo_collectives`` is the reference's text parser, copied
  whole: on the same HLO lines (plain results, tuple results, ``-start``
  halves, iota and explicit ``replica_groups``) it returns the same
  ``CollectiveStats``, held exactly.
* A 2x4 ``fake``-group trace of a row-parallel matmul,
  ``relu(x @ w)`` with x ``[Shard(0), Shard(1)]`` (32, 128) and w
  ``[Replicate(), Shard(0)]`` (128, 64): the local ``mm`` on the
  (16, 32) × (32, 64) shards (FLOPs 2·16·32·64, the global product's
  1/8), the reduce-scatter DTensor inserts on its own, with the ring
  bytes the reference's parser gives the same op in HLO, and ``relu``
  on the (4, 64) shard; the ledger re-sums bit for bit.
* The same step on one device records exactly 0 collective bytes and no
  collective class; ``meta_memory`` of the sharded step counts the local
  shards.
"""

import pytest
import torch

from repro.core import hlo_analysis as ref
from repro_torch.core import hlo_analysis as port
from repro_torch.core import hlo_cost
from repro_torch.core.hlo_cost import recording, trace_cost
from repro_torch.core.profiler import meta_memory
from repro_torch.launch.mesh import fake_world, make_mesh
from tests._torch_host import port_host_share  # noqa: F401 (autouse)

HLO_LINES = {
    "plain": "%all-gather.3 = bf16[16,128]{1,0} all-gather(%param.1), "
             "channel_id=1, replica_groups={{0,1,2,3}}, dimensions={0}",
    "all-reduce": "%all-reduce.1 = f32[256]{0} all-reduce(%p), "
                  "replica_groups={{0,1},{2,3}}, to_apply=%add",
    "reduce-scatter": "%reduce-scatter.2 = f32[4,64]{1,0} reduce-scatter(%dot), "
                      "replica_groups={{0,1,2,3}}, dimensions={0}, to_apply=%add",
    "tuple": "%all-to-all.5 = (bf16[8,16]{1,0}, bf16[8,16]{1,0}) all-to-all("
             "%a, %b), replica_groups={{0,1,2,3,4,5,6,7}}",
    "start": "%all-reduce-start.7 = f32[1024]{0} all-reduce-start(%x), "
             "replica_groups={{0,1,2,3}}, to_apply=%add",
    "iota": "%all-gather.9 = bf16[32,64]{1,0} all-gather(%y), "
            "replica_groups=[16,16]<=[256], dimensions={0}",
    "permute": "%collective-permute.2 = f32[2,16]{1,0} collective-permute(%h), "
               "source_target_pairs={{0,1},{1,2},{2,3}}",
    "unknown-groups": "%all-gather.1 = s32[10]{0} all-gather(%z), dimensions={0}",
    "not-a-collective": "%add.4 = f32[8]{0} add(%a, %b)",
}


@pytest.mark.parametrize("name", list(HLO_LINES))
def test_parser_as_reference(name):
    line = HLO_LINES[name]
    mine, theirs = port.analyze_hlo_collectives(line), ref.analyze_hlo_collectives(line)
    assert (mine.bytes_by_kind, mine.count_by_kind) == \
        (theirs.bytes_by_kind, theirs.count_by_kind)
    assert mine.total_bytes == theirs.total_bytes


def test_parser_on_a_whole_module_and_the_dtype_table():
    text = "\n".join(HLO_LINES.values())
    mine, theirs = port.analyze_hlo_collectives(text), ref.analyze_hlo_collectives(text)
    assert vars(mine) == vars(theirs)
    assert port.DTYPE_BYTES == ref.DTYPE_BYTES


@pytest.mark.parametrize("kind", ["all-gather", "all-reduce", "reduce-scatter",
                                  "all-to-all", "collective-permute"])
@pytest.mark.parametrize("g", [2, 4, 16])
def test_ring_model_as_the_reference_parses_it(kind, g):
    """The byte model the trace applies, against the reference's parse of
    the same op (a f32[4,64] result over a group of g)."""
    groups = "{{" + ",".join(map(str, range(g))) + "}}"
    line = f"%c = f32[4,64]{{1,0}} {kind}(%x), replica_groups={groups}"
    want = ref.analyze_hlo_collectives(line).bytes_by_kind[kind]
    assert port.ring_bytes(kind, 4 * 64 * 4.0, g) == want


def _row_parallel(device_type: str = "cpu"):
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    mesh = make_mesh((2, 4), ("data", "model"), device=device_type)
    x = distribute_tensor(torch.empty(32, 128, device="meta"), mesh, [Shard(0), Shard(1)])
    w = distribute_tensor(torch.empty(128, 64, device="meta"), mesh, [Replicate(), Shard(0)])
    return x, w


def test_sharded_trace_records_local_ops_and_the_reduce_scatter():
    with fake_world(8):
        x, w = _row_parallel()
        with recording() as cost:
            out = torch.relu(x @ w)
        assert tuple(out.to_local().shape) == (4, 64)
        # the ops the mode saw, as (func, args, kwargs, out) for the op model
        seen = []

        class Keep(hlo_cost._LedgerMode):
            def __torch_dispatch__(self, func, types, args=(), kwargs=None):
                res = super().__torch_dispatch__(func, types, args, kwargs)
                if res is not NotImplemented:
                    seen.append((func, args, kwargs or {}, res))
                return res

        with Keep(hlo_cost.HloCost()):
            torch.relu(x @ w)
        stats = port.collective_stats_from_ops(seen)
        recorded = [r for r in cost.ledger.records if r.op != "custom-call"]
    ops = [(r.op, r.op_class) for r in recorded]
    assert ops == [("dot", "matmul"), ("reduce-scatter", "collective"),
                   ("reshape", "data_movement"), ("relu", "elementwise")]
    dot, rs = recorded[0], recorded[1]
    assert dot.flops == 2 * 16 * 32 * 64 == 2 * 32 * 128 * 64 / 8
    assert dot.hbm_bytes == (16 * 32 + 32 * 64 + 16 * 64) * 4
    want = ref.analyze_hlo_collectives(
        "%rs = f32[4,64]{1,0} reduce-scatter(%d), replica_groups={{0,1,2,3}}")
    assert rs.collective_bytes == want.bytes_by_kind["reduce-scatter"] == 3072.0
    assert rs.hbm_bytes == (16 * 64 + 4 * 64) * 4
    assert cost.collective_bytes == 3072.0
    assert cost.bytes_by_kind == {"reduce-scatter": 3072.0}
    assert cost.count_by_kind == {"reduce-scatter": 1}
    assert vars(stats) == {"bytes_by_kind": cost.bytes_by_kind,
                           "count_by_kind": cost.count_by_kind}
    # sum(ledger) == aggregates, bit for bit
    assert cost.flops == cost.ledger.flops and cost.hbm_bytes == cost.ledger.hbm_bytes
    classes = cost.by_class()
    for key, total in (("flops", cost.flops), ("hbm_bytes", cost.hbm_bytes),
                       ("collective_bytes", cost.collective_bytes)):
        acc = 0.0
        for c in classes.values():
            acc += c[key]
        assert acc == total
    assert classes["collective"]["collective_bytes"] == 3072.0


def test_one_device_trace_has_exactly_zero_collective_bytes():
    x = torch.empty(32, 128, device="meta")
    w = torch.empty(128, 64, device="meta")
    cost = trace_cost(lambda: torch.relu(x @ w))
    assert cost.collective_bytes == 0.0 and cost.bytes_by_kind == {}
    assert "collective" not in cost.by_class()
    assert cost.flops == 2 * 32 * 128 * 64


def test_meta_memory_counts_the_local_shards():
    """Γ of the sharded forward is of the 2x4 shards: x (16, 32) and w
    (32, 64) resident, the (4, 64) result out, the largest temporary the
    (16, 64) partial product."""
    with fake_world(8):
        x, w = _row_parallel()
        mem = meta_memory(lambda a, b: [torch.relu(a @ b)], (x, w), [x, w], train=False)
    assert mem == {"arg": float((16 * 32 + 32 * 64) * 4), "temp": float(16 * 64 * 4),
                   "out": float(4 * 64 * 4)}
    full = meta_memory(lambda a, b: [torch.relu(a @ b)],
                       (torch.empty(32, 128, device="meta"),
                        torch.empty(128, 64, device="meta")),
                       [], train=False)
    assert full["out"] == 32 * 64 * 4 == 8 * mem["out"]


def test_fake_world_refuses_a_second_group_and_cleans_up():
    import torch.distributed as dist

    with fake_world(4):
        assert dist.get_world_size() == 4
        with pytest.raises(RuntimeError, match="already initialised"):
            with fake_world(2):
                pass
    assert not dist.is_initialized()
