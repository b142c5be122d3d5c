"""Run the check's control on the card (see hvdb/control.py).

    python3 hvd_bench/control.py --workload <name> --seeds <n> [<n> ...]
"""

import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
sys.path[:0] = [str(HERE), str(HERE.parent)]

from hvdb import control  # noqa: E402

if __name__ == "__main__":
    sys.exit(control.main(sys.argv[1:]))
