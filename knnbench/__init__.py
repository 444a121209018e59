"""knnbench: the benchmark of the PyTorch/CUDA port ``cuda_knearests_tpu_torch``.

Run from the root of a checkout::

    python3 -m knnbench --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Everything the harness does for a cell is found by name from
``BENCHMARK.json``: the configuration's file of sizes (``configs/``), the
traffic mix's data file (``traffic/``, read by the one generator in
``generate.py``) and one reader a metric (``metrics/<name>.py``).  The
plain reference (``reference.py``), the comparison that decides
``correct`` (``compare.py``), the table of peaks and the byte bound
(``roofline.py``) and the profiler reduction (``trace.py``) are the
benchmark's own: none of them imports the port or JAX.  The port is
reached only through ``KnnConfig``, ``KnnProblem.prepare`` / ``solve``,
``grid.permutation``, ``runtime.dispatch.stats`` and ``obs.spans``
(``run.py``).
"""
