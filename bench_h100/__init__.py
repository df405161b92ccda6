"""The benchmark of the PyTorch/CUDA port (``repro_torch``) on one NVIDIA H100.

``run.py`` is the entry point.  Everything that belongs to one model
configuration, traffic mix or per-layer metric is a file of its own,
found by the name that ``BENCHMARK.json`` gives it:

* ``configs/<config>.json``: a dataset deployment (rows, features, the
  GBDT settings, the generator's parameters);
* ``traffic/<traffic>.json``: a job mix, run by the kind of cell it names
  (``fit`` or ``score``, in ``workloads.py``);
* ``limits/<workload>.json``: the limit of each number that decides
  ``correct`` in that cell;
* ``metrics/<metric>.py``: a reader with ``read(run)`` that returns the
  metric, or None where it finds nothing to read.

The yardstick lives here and nowhere in the program: the data generator
(``synth.py``), the scoring forest (``forest.py``), the plain reference
and its control (``reference.py``), the comparison (``compare.py``), the
reduction of the device trace (``devtrace.py``), the work counts and the
card's published peaks (``counts.py``, ``h100_sxm.json``).
"""
