"""joinbench: the benchmark of dj_tpu_torch, the PyTorch/CUDA distributed join.

``python3 joinbench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` once on the cards of
this machine and prints one JSON line. Everything that belongs to one
configuration, traffic mix or per-layer metric is a file of its own,
found by its name: ``configs/<config>.json``, ``traffic/<mix>.json``,
``metrics/<metric>.py``. The generators, the plain reference, the byte
arithmetic of the kernel rooflines and the comparison that decides
``correct`` live here, apart from the program; ``system.py`` is the one
module that imports the program.
"""
