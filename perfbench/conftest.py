"""The benchmark's own tests (``python -m pytest perfbench/tests``). Tests
that need a CUDA card carry the ``chip`` marker and skip inside the test
where there is none."""
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "chip: needs a CUDA card; skips inside the test without one")
