"""The benchmark's tests: ``pytest hvd_bench/tests`` from the root of the
repository. Tests marked ``cuda`` decide inside the test whether a card is
there, and skip without one."""

import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
sys.path[:0] = [str(HERE.parent), str(HERE.parents[1])]
