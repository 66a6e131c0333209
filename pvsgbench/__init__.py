"""The benchmark of ``openpvsg_torch`` on NVIDIA H100s: a harness driven by
data (``configs/``, ``workloads/``, ``metrics/``, ``drivers/``), the plain
reference its comparisons hold the program to (``reference/``), the
generators of its inputs (``gen.py``), the work counted from shapes
(``counts.py``) and the reading of profiler traces (``trace.py``). Nothing
here imports JAX or ``openpvsg_tpu``; ``reference/`` imports nothing of
``openpvsg_torch``."""
