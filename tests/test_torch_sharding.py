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
