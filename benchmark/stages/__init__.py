"""The cells' stages.  A traffic mix's `stage` names the file
`stages/<stage>.py`, which the harness loads by its path
(harness/manifest.py) and which defines:

  Driver                  a subclass of harness.drivers.Driver: set-up
                          (the program built, its checked steps or sampled
                          answers, the warm-up), `window(seconds, tracing,
                          steps)` and `free()`;
  numbers(driver, control)  the numbers compared against the cell's limits,
                          the program's (with control, the reference at the
                          configuration's control precision) against the
                          reference's at the stated precision;
  counts(cell)            optional: the work counts the metric readers get
                          as rec["counts"];
  scene(workdir, cell)    optional: inputs written to disk before the
                          driver is built, handed to it as `scene`.

A module that defines no `numbers` (nerf.py: what the three NeRF stages
share) is not a stage."""
