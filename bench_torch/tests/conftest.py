"""The benchmark's own tests, run by hand on the CPU from the repository
root (python -m pytest bench_torch/tests -q); they are not part of the
repository's test suite."""

import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
for path in (BENCH, BENCH.parent):
    if str(path) not in sys.path:
        sys.path.insert(0, str(path))
