"""The benchmark of etol_tpu_torch on an H100: ``python3 perfbench/run.py``
runs one cell of BENCHMARK.json (see ``harness.py``)."""
