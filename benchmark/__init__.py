"""The benchmark of ``prpe_tpu_torch``: ``python3 benchmark/run.py --workload <cell>``.

``BENCHMARK.json`` at the repository root names the cells; each cell's
traffic, configuration, driver and per-layer readers are files under this
directory, found by name (see ``harness.py``).
"""
