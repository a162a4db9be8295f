"""The benchmark of the PyTorch and CUDA port (``repro_torch``).

``python3 portbench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell once and prints one JSON line. Everything a
cell, a configuration, a traffic mix or a per-layer metric needs sits in a
file of its own that the harness finds by its name in ``BENCHMARK.json``:
``workloads/<cell>.json``, ``configs/<config>.json``,
``traffic/<traffic>.json``, ``metrics/<metric>.py``; the drivers of the
port's entry points are ``drivers/<entry>.py``.
"""
