"""MoE capacity-dispatch tiling model (port of ``repro/kernels/moe_dispatch/``)."""
