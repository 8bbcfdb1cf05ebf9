"""Sharding (port of ``repro/distributed``): the sharding rules as plain
tuples and their DTensor placements on a ``DeviceMesh``
(:mod:`.sharding`: ``to_named``, ``distribute_tree``), per-class
collective bytes and the per-device memory split of a layout
(:mod:`.collectives`, on abstract meshes: no device needed) and the
GPipe schedule with its bubble (:mod:`.pipeline_parallel`)."""
