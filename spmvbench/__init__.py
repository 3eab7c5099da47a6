"""The benchmark of the PyTorch/CUDA port (``repro_torch``) on one H100.

One run measures one cell of ``BENCHMARK.json`` (a configuration under a
traffic mix)::

    python3 -m spmvbench.run --workload hpcg256.cg50 --seed 7 --seconds 30 --trace 0

Everything a cell is made of is found by name, so a cell is added with
files and no edit:

* ``configs/<name>.json``: a deployment (a matrix of a public benchmark),
  built on the card by ``generators/<generator>.py``;
* ``traffic/<name>.json``: the parameters of a traffic mix, run by
  ``drivers/<driver>.py``;
* ``limits/<cell>.json``: the limit of each number that ``correct``
  compares in that cell, set from the cell's own readings;
* ``metrics/<name>.py``: the reader of one per-layer metric, which takes
  it from the traced window (:class:`spmvbench.trace.View`).

The drivers reach the port only through ``program.py`` (the control,
the bfloat16 reference, takes its place there).  The yardstick stays
here: the inputs, the float64 reference (``reference.py``), the byte counts behind every roofline share
(``roofline.py``) and the comparisons that decide ``correct``.  Nothing in
this package imports ``jax`` or the JAX package ``repro``.
"""
