"""The benchmark's own tests: CPU tests at tiny sizes, and the tests
marked ``chip``, which run only where a CUDA card is present."""

import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "chip: needs a CUDA card; skipped, with the reason, "
        "where none is present")
