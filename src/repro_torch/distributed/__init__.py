"""Layout accounting (port of ``repro/distributed``): the sharding rules
as plain tuples (:mod:`.sharding`), per-class collective bytes and the
per-device memory split of a layout (:mod:`.collectives`) and the
pipeline's bubble (:mod:`.pipeline_parallel`).  Nothing here needs a
device: meshes are abstract stand-ins.  Executing a sharded step
(DeviceMesh placements, the pipeline schedule) waits for ROADMAP queue 1
item 7c."""
