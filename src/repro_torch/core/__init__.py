"""The paper's CNN toolflow (port of ``repro/core/``): pruning, whole-step
profiling, the datapoint cache, the analytical features and the
random-forest predictor.  ``features``, ``tree``, ``forest`` and
``fileio`` are framework-free copies, held exactly against the reference;
``profiler`` measures on the card."""
