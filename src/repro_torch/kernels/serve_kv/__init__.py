"""Paged serve KV pool tiling (port of ``repro/kernels/serve_kv/``)."""
