"""Step kinds.  ``traffic/<mix>.json`` names one as ``entry``, and the
harness loads ``entries/<entry>.py`` and builds its ``Entry(cell, seed,
device, program=None)``:

* ``items_per_step``: what one step completes (images, tokens);
* ``setup()``: builds the program's step, draws the inputs from the seed,
  and runs the step on them until every shape the window uses has run
  once; the checked first steps of a training step are among these;
* ``call(i)``: the window's ``i``-th call of the program, returning its
  output; ``keep(i, out)`` keeps what the check needs, without touching
  the device;
* ``release()``: frees the program's state once the window has closed;
* ``failed()``: the window's outputs that are not finite;
* ``readings()``: runs the reference and returns the numbers that decide
  ``correct`` (named as in ``limits/<workload>.json``);
* ``costs()``: the step's flops and passes that the per-layer readers
  price (``counts.StepCosts``).

``program`` replaces the program's step (the control, and the faults of
the tests); by default each entry takes the step from the program.
"""
