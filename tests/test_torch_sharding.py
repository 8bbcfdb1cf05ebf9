"""Layout accounting of the port against the reference's: the sharding
rules (``distributed/sharding.py``, specs as plain tuples), the
per-class collective bytes and memory split (``distributed/
collectives.py``), the pipeline bubble, the mesh-spec validator
(``launch/mesh.py``) and the registry's cell filters.  All of it is
framework-free, so it is held exactly (``==``): the reference's
``PartitionSpec`` entries as a tuple, dicts compared as dicts, the
leaves of ``describe_sharding`` in order."""

import dataclasses

import jax
import pytest
from jax.sharding import PartitionSpec

from repro.configs import base as ref_base
from repro.configs import registry as ref_registry
from repro.distributed import collectives as ref_coll
from repro.distributed import pipeline_parallel as ref_pp
from repro.distributed import sharding as ref_sh
from repro.launch import mesh as ref_mesh
from repro_torch.configs import base, registry
from repro_torch.distributed import collectives as coll
from repro_torch.distributed import pipeline_parallel as pp
from repro_torch.distributed import sharding as sh
from repro_torch.launch import mesh

MESHES = [(1, 1), (2, 1), (1, 2), (16, 16), (2, 16, 16), (4,), (2, 4, 2)]
SHAPES = list(base.SHAPES.values()) + [
    base.ShapeSpec("small_train", 32, 2, "train"),
    base.ShapeSpec("small_decode", 32, 3, "decode"),
    base.ShapeSpec("single_decode", 64, 1, "decode")]


def _ref_shape(s):
    return ref_base.ShapeSpec(s.name, s.seq_len, s.global_batch, s.kind)


def _tuples(tree):
    """The reference's PartitionSpec tree with tuples for specs."""
    return jax.tree.map(tuple, tree, is_leaf=lambda x: isinstance(x, PartitionSpec))


def _configs(arch, reduced):
    return (registry.get_config(arch, reduced=reduced),
            ref_registry.get_config(arch, reduced=reduced))


@pytest.mark.parametrize("reduced", [False, True], ids=["full", "reduced"])
@pytest.mark.parametrize("arch", registry.ARCH_IDS)
def test_describe_sharding_and_param_specs(arch, reduced):
    """Every leaf's applied and wanted spec, shard factors and fallback
    flag, in the reference's leaf order and path strings, and the
    parameter / optimizer-state spec trees, with and without FSDP."""
    cfg, ref_cfg = _configs(arch, reduced)
    for dims in MESHES:
        m, rm = coll.abstract_mesh(dims), ref_coll.abstract_mesh(dims)
        for fsdp in (None, False, True):
            mine = [dataclasses.astuple(lf) for lf in sh.describe_sharding(cfg, m, fsdp=fsdp)]
            ref = [dataclasses.astuple(lf)
                   for lf in ref_sh.describe_sharding(ref_cfg, rm, fsdp=fsdp)]
            assert mine == ref, (dims, fsdp)
        for fsdp in (False, True):
            assert sh.param_pspecs(cfg, m, fsdp=fsdp) == \
                _tuples(ref_sh.param_pspecs(ref_cfg, rm, fsdp=fsdp))
        for kind in ("adamw", "sgdm"):
            assert sh.state_pspecs(cfg, m, kind=kind) == \
                _tuples(ref_sh.state_pspecs(ref_cfg, rm, kind=kind))
        assert sh.fsdp_wanted(cfg, m) == ref_sh.fsdp_wanted(ref_cfg, rm)


@pytest.mark.parametrize("reduced", [False, True], ids=["full", "reduced"])
@pytest.mark.parametrize("arch", registry.ARCH_IDS)
def test_batch_cache_specs_and_layout_collectives(arch, reduced):
    """Batch and cache spec trees and ``layout_collectives(...).to_dict()``
    (per-class bytes, memory split, replicated leaves, bubble) for every
    shape × mesh, plus pipeline stages, microbatches and forced FSDP."""
    cfg, ref_cfg = _configs(arch, reduced)
    for dims in MESHES:
        m, rm = coll.abstract_mesh(dims), ref_coll.abstract_mesh(dims)
        for s in SHAPES:
            rs = _ref_shape(s)
            assert sh.batch_pspecs(cfg, s, m) == _tuples(ref_sh.batch_pspecs(ref_cfg, rs, rm))
            assert sh.cache_pspecs(cfg, s, m) == _tuples(ref_sh.cache_pspecs(ref_cfg, rs, rm))
            assert coll.layout_collectives(cfg, s, m).to_dict() == \
                ref_coll.layout_collectives(ref_cfg, rs, rm).to_dict()
        s = SHAPES[0]
        for kw in ({"pipe": 4, "n_micro": 8}, {"fsdp": True}, {"fsdp": False},
                   {"bytes_per_el": 4, "pipe": 2}):
            mine = coll.layout_collectives(cfg, s, m, **kw)
            ref = ref_coll.layout_collectives(ref_cfg, _ref_shape(s), rm, **kw)
            assert mine.to_dict() == ref.to_dict() and mine.total_bytes == ref.total_bytes


def test_abstract_mesh_and_dp_axes():
    for dims in MESHES:
        m, rm = coll.abstract_mesh(dims), ref_coll.abstract_mesh(dims)
        assert (m.axis_names, m.devices.shape, m.devices.size) == \
            (rm.axis_names, rm.devices.shape, rm.devices.size)
        assert mesh.dp_axes(m) == ref_mesh.dp_axes(rm)
    assert coll.abstract_mesh((2, 3), ("x", "y")).axis_names == ("x", "y")
    for mod in (coll, ref_coll):
        with pytest.raises(ValueError, match="length mismatch"):
            mod.abstract_mesh((2, 2), ("data",))
    assert coll.COLLECTIVE_CLASSES == ref_coll.COLLECTIVE_CLASSES


@pytest.mark.parametrize("stages, micro", [(1, 1), (2, 8), (4, 4), (8, 1), (3, 7)])
def test_bubble_fraction(stages, micro):
    assert pp.bubble_fraction(stages, micro) == ref_pp.bubble_fraction(stages, micro)


@pytest.mark.parametrize("shape, axes, available", [
    ((), (), None),
    ((2, 2), ("data",), None),
    ((0, 2), ("data", "model"), None),
    ((2, -1), ("data", "model"), None),
    ((2.0, 2), ("data", "model"), None),
    ((2, 2), ("data", "data"), None),
    ((2, 2), ("data", ""), None),
])
def test_validate_mesh_spec_errors(shape, axes, available):
    """Each malformed request raises ``MeshSpecError`` (a ``ValueError``)
    with the reference's message and fields."""
    with pytest.raises(ref_mesh.MeshSpecError) as ref:
        ref_mesh.validate_mesh_spec(shape, axes, available)
    with pytest.raises(mesh.MeshSpecError) as mine:
        mesh.validate_mesh_spec(shape, axes, available)
    assert isinstance(mine.value, ValueError)
    assert str(mine.value) == str(ref.value)
    for f in ("shape", "axes", "needed", "available", "deficit"):
        assert getattr(mine.value, f) == getattr(ref.value, f), f


@pytest.mark.parametrize("shape, available", [((1, 2), 1), ((16, 16), 8), ((2, 16, 16), 1)])
def test_validate_mesh_spec_names_the_deficit(shape, available):
    """Too few devices: the deficit in the fields and in the message (the
    remedy the message suggests is the port's own: the reference's names
    a JAX flag)."""
    axes = ("pod", "data", "model")[-len(shape):]
    with pytest.raises(ref_mesh.MeshSpecError) as ref:
        ref_mesh.validate_mesh_spec(shape, axes, available)
    with pytest.raises(mesh.MeshSpecError) as mine:
        mesh.validate_mesh_spec(shape, axes, available)
    for f in ("shape", "axes", "needed", "available", "deficit"):
        assert getattr(mine.value, f) == getattr(ref.value, f), f
    assert f"({mine.value.deficit} short)" in str(mine.value)
    assert str(mine.value).split(" — ")[0] == str(ref.value).split(" — ")[0]
    assert "fake_world" in str(mine.value) and "XLA_FLAGS" not in str(mine.value)
    n = mesh.validate_mesh_spec(shape, axes, available=mine.value.needed)
    assert n == ref_mesh.validate_mesh_spec(shape, axes) == mine.value.needed


def test_registry_cells_and_shapes():
    """``SHAPES``, ``TRAIN_SHAPES``, ``DECODE_SHAPES``, ``get_shape``,
    ``all_cells`` and ``cell_supported`` with every mesh (the reasons word
    for word), and ``mesh_split``."""
    assert {k: dataclasses.astuple(v) for k, v in base.SHAPES.items()} == \
        {k: dataclasses.astuple(v) for k, v in ref_base.SHAPES.items()}
    assert base.TRAIN_SHAPES == ref_base.TRAIN_SHAPES
    assert base.DECODE_SHAPES == ref_base.DECODE_SHAPES
    assert all(dataclasses.astuple(registry.get_shape(n)) ==
               dataclasses.astuple(ref_registry.get_shape(n)) for n in base.SHAPES)
    assert registry.all_cells() == ref_registry.all_cells()
    assert len(registry.all_cells()) == 40
    for arch in registry.ARCH_IDS:
        for reduced in (False, True):
            cfg, ref_cfg = _configs(arch, reduced)
            for s in SHAPES:
                for dims in [None, ()] + MESHES + [(3, 5), (7,)]:
                    assert registry.cell_supported(cfg, s, dims) == \
                        ref_registry.cell_supported(ref_cfg, _ref_shape(s), dims)
    for dims in MESHES:
        assert base.mesh_split(dims) == ref_base.mesh_split(dims)


# ---------------------------------------------------------------------------
# Execution: DeviceMesh and DTensor placements (queue 1 item 7c)
# ---------------------------------------------------------------------------

_REF_INDICES = """
import json
import jax
from jax.sharding import NamedSharding
from repro.configs import base, registry
from repro.distributed import sharding as sh
from repro.launch.mesh import make_mesh
from repro.models import transformer as T

def slices(spec, shape, mesh):
    idx = NamedSharding(mesh, spec).devices_indices_map(tuple(shape))
    out = []
    for d in mesh.devices.flat:
        out.append([[s.start or 0, d_ if s.stop is None else s.stop]
                    for s, d_ in zip(idx[d], shape)])
    return out

def walk(specs, shapes, mesh, path=()):
    if isinstance(shapes, dict):
        return {k: walk(specs[k], shapes[k], mesh, path + (k,)) for k in shapes}
    return slices(specs, shapes, mesh)

res = {}
for dims in ((2, 4), (2, 2, 2)):
    axes = ("pod", "data", "model")[-len(dims):]
    mesh = make_mesh(dims, axes)
    for arch in registry.ARCH_IDS:
        cfg = registry.get_config(arch)
        tree = T._shape_tree(cfg)
        st = sh.state_pspecs(cfg, mesh)
        dec = base.SHAPES["decode_32k"]
        cache = T.cache_shapes(cfg, dec.global_batch, dec.seq_len)
        res[f"{arch}|{dims}"] = {
            "params": walk(st["params"], tree, mesh),
            "m": walk(st["opt"]["m"], tree, mesh),
            "cache": walk(sh.cache_pspecs(cfg, dec, mesh), cache, mesh),
            "tokens": slices(sh.batch_pspecs(cfg, base.SHAPES["train_4k"], mesh)["tokens"],
                             (256, 4096), mesh),
        }
print(json.dumps(res))
"""


def _port_slices(named, shape, dims):
    """Each rank's ``[[start, stop], ...]`` of a ``NamedSharding`` on a
    ``dims`` mesh (rank r at coordinate ``unravel(r)``, the reference's
    device r)."""
    import numpy as np
    from torch.distributed.tensor._utils import _compute_local_shape_and_global_offset

    out = []
    for r in range(int(np.prod(dims))):
        coord = [int(c) for c in np.unravel_index(r, dims)]
        local, offset = _compute_local_shape_and_global_offset(
            tuple(shape), tuple(dims), coord, list(named.placements))
        out.append([[int(o), int(o) + int(n)] for o, n in zip(offset, local)])
    return out


def _walk(named, shapes, dims):
    if isinstance(shapes, dict):
        return {k: _walk(named[k], shapes[k], dims) for k in shapes}
    return _port_slices(named, shapes, dims)


def test_to_named_places_every_leaf_as_the_reference(tmp_path):
    """``to_named`` of the state (parameters and ZeRO slots), the decode
    cache and the training batch of all 10 architectures at full size on
    (2, 4) and (2, 2, 2): every rank holds the same slice of every leaf
    as the reference's ``NamedSharding`` gives the same device (the
    reference in a subprocess with 8 forced host devices)."""
    import json
    import os
    import subprocess
    import sys

    from repro_torch.models import transformer as T

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count=8",
               PYTHONPATH=os.path.join(root, "src"), JAX_PLATFORMS="cpu")
    proc = subprocess.run([sys.executable, "-c", _REF_INDICES], capture_output=True,
                          text=True, env=env, timeout=300, cwd=root)
    assert proc.returncode == 0, proc.stderr[-3000:]
    ref = json.loads(proc.stdout.strip().splitlines()[-1])
    n = 0
    for dims in ((2, 4), (2, 2, 2)):
        axes = ("pod", "data", "model")[-len(dims):]
        with mesh.fake_world(8):
            m = mesh.make_mesh(dims, axes, device="cpu")
            assert tuple(m.mesh_dim_names) == axes and tuple(m.mesh.shape) == dims
            for arch in registry.ARCH_IDS:
                cfg = registry.get_config(arch)
                want = ref[f"{arch}|{dims}"]
                tree = T._shape_tree(cfg)
                st = sh.to_named(m, sh.state_pspecs(cfg, m))
                dec = base.SHAPES["decode_32k"]
                cache = T.cache_shapes(cfg, dec.global_batch, dec.seq_len)
                got = {
                    "params": _walk(st["params"], tree, dims),
                    "m": _walk(st["opt"]["m"], tree, dims),
                    "cache": _walk(sh.to_named(m, sh.cache_pspecs(cfg, dec, m)), cache, dims),
                    "tokens": _port_slices(sh.to_named(m, sh.batch_pspecs(
                        cfg, base.SHAPES["train_4k"], m))["tokens"], (256, 4096), dims),
                }
                assert got == want, (arch, dims)
                n += 1
    assert n == 2 * len(registry.ARCH_IDS)


def test_make_mesh_needs_a_group_and_enough_ranks():
    import torch.distributed as dist

    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="initialised process group"):
        mesh.make_mesh((1, 1), ("data", "model"))
    with mesh.fake_world(4):
        with pytest.raises(mesh.MeshSpecError) as e:
            mesh.make_mesh((2, 4), ("data", "model"), device="cpu")
        assert (e.value.needed, e.value.available, e.value.deficit) == (8, 4, 4)
        pm = mesh.make_mesh((2, 2), ("data", "model"), device="cpu")
        assert mesh.dp_axes(pm) == ("data",) and pm.device_type == "cpu"
    with mesh.fake_world(512):
        for multi, dims in ((False, (16, 16)), (True, (2, 16, 16))):
            pm = mesh.make_production_mesh(multi_pod=multi, device="cpu")
            assert tuple(pm.mesh.shape) == dims
            assert mesh.dp_axes(pm) == ref_mesh.dp_axes(
                ref_coll.abstract_mesh(dims)) == (("pod", "data") if multi else ("data",))
    assert not dist.is_initialized()


def test_placements_of_spec_entries():
    from torch.distributed.tensor import Replicate, Shard

    with mesh.fake_world(8):
        m = mesh.make_mesh((2, 2, 2), ("pod", "data", "model"), device="cpu")
        assert sh.placements(m, (("pod", "data"), None, "model")) == \
            (Shard(0), Shard(0), Shard(2))
        assert sh.placements(m, ()) == (Replicate(),) * 3
        assert sh.placements(m, (None, "data")) == (Replicate(), Shard(1), Replicate())
        with pytest.raises(ValueError, match="axis order"):
            sh.placements(m, (("data", "pod"),))
        with pytest.raises(ValueError, match="shards two dims"):
            sh.placements(m, ("data", "data"))


_HINT_CASES = [((8, 16, 32), ("dp", "model", None)), ((3, 16, 32), ("dp", "model", None)),
               ((8, 6, 32), ("dp", "model", None)), ((8, 16, 32), ("dp", None, None)),
               ((4, 8, 24, 16), ("dp", "model", None, None)),
               ((4, 6, 24, 16), ("dp", "model", None, None)),
               ((2, 4, 16), (None, "model", "data")), ((8, 16), ("pod", "model"))]

_REF_HINTS = """
import json, sys
import jax, jax.numpy as jnp
from repro.launch.mesh import make_mesh
from repro.models import layers as L
cases = json.loads(sys.argv[1])
jax.lax.with_sharding_constraint = lambda x, s: s.spec     # read the spec it asks
out = {}
for dims in ((2, 4), (2, 2, 2)):
    L.set_hint_mesh(make_mesh(dims, ("pod", "data", "model")[-len(dims):]))
    out[str(dims)] = [[list(e) if isinstance(e, tuple) else e
                       for e in L._maybe_constrain(jnp.zeros(shape), *spec)]
                      for shape, spec in cases]
print(json.dumps(out))
"""


def test_maybe_constrain_asks_the_reference_s_layout(monkeypatch):
    """``layers._maybe_constrain`` on a DTensor gives the placements of the
    spec the reference's ``_maybe_constrain`` hands
    ``with_sharding_constraint`` (its "dp" marker, its per-dim
    divisibility fallback), on (2, 4) and (2, 2, 2); on a plain tensor and
    with no hint mesh it is the identity."""
    import json
    import os
    import subprocess
    import sys

    import torch
    from torch.distributed.tensor import Replicate, distribute_tensor

    from repro_torch.models import layers as L

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count=8",
               PYTHONPATH=os.path.join(root, "src"), JAX_PLATFORMS="cpu")
    proc = subprocess.run([sys.executable, "-c", _REF_HINTS, json.dumps(_HINT_CASES)],
                          capture_output=True, text=True, env=env, timeout=300, cwd=root)
    assert proc.returncode == 0, proc.stderr[-3000:]
    ref = json.loads(proc.stdout.strip().splitlines()[-1])
    plain = torch.zeros(4, 4)
    assert L._maybe_constrain(plain, "dp", None) is plain
    for dims in ((2, 4), (2, 2, 2)):
        with mesh.fake_world(8):
            m = mesh.make_mesh(dims, ("pod", "data", "model")[-len(dims):], device="cpu")
            with L.hint_mesh(m):
                assert L._maybe_constrain(plain, "dp", None) is plain
                for (shape, spec), want in zip(_HINT_CASES, ref[str(dims)]):
                    x = distribute_tensor(torch.empty(shape, device="meta"), m,
                                          [Replicate()] * m.ndim)
                    want = tuple(tuple(e) if isinstance(e, list) else e for e in want)
                    want = want + (None,) * (len(shape) - len(want))
                    got = L._maybe_constrain(x, *spec).placements
                    assert got == sh.placements(m, want), (dims, shape, spec)
            assert L._HINT_MESH is None


@pytest.mark.parametrize("arch", ["internlm2-1.8b", "qwen3-moe-30b-a3b"])
def test_distributed_shards_own_only_their_storage(arch):
    """Every local shard of a placed train state owns exactly its own
    bytes: a slice of dim 0 alone (the embedding's vocab rows, the
    experts) is a copy, not a view that keeps the whole leaf alive on
    every rank.  Rank 0 of a fake (2, 4) group, real CPU tensors."""
    import torch
    from torch.distributed.tensor import Shard

    from repro_torch.models import transformer as T
    from repro_torch.optim.optimizer import OptimizerConfig, init_opt_state

    cfg = registry.get_config(arch, reduced=True)
    with mesh.fake_world(8):
        m = mesh.make_mesh((2, 4), ("data", "model"), device="cpu")
        model = T.init_params(cfg, 0, device="cpu", dtype=torch.float32)
        state = {"params": model, "opt": init_opt_state(
            dict(model.named_parameters()), OptimizerConfig(kind="adamw"))}
        state = sh.distribute_tree(state, sh.train_state_shardings(cfg, m))
        leaves = dict(state["params"].named_parameters())
        leaves.update({f"m.{n}": t for n, t in state["opt"]["m"].items()})
        leaves.update({f"v.{n}": t for n, t in state["opt"]["v"].items()})
        dim0_only = 0
        for name, t in leaves.items():
            local = t.to_local()
            assert local.untyped_storage().nbytes() == \
                local.numel() * local.element_size(), name
            shards = {p.dim for p in t.placements if isinstance(p, Shard)}
            dim0_only += shards == {0}
        assert dim0_only > 0            # the case a view would get wrong
