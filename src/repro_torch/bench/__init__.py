"""The paper's benchmark runners on the port (port of the paper half of
``benchmarks/``): Fig. 3, Fig. 4, §6.1, §6.2, §6.2.1 and Table 2, each a
module run as ``python -m repro_torch.bench.<name>``, all of them by
``python -m repro_torch.bench.run``.

They print the reference runners' ``name,value,derived`` CSV lines over
the port's own profiling cache (``build/repro_torch/bench/``), profile the
points it lacks on the card, and default to the full-width geometry of
``common.FULL``.  The beyond-paper benches of ``benchmarks/`` are here
too, each a module of the same name: ``engine_bench``, ``serve_bench``,
``kernel_bench``, ``roofline_table`` and ``check_thresholds``.
"""
