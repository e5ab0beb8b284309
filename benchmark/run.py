"""Run one cell of the benchmark once, on the card:

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout (see benchmark/harness.py).  Exits 2 without
the cards the cell asks for, and 3 when JAX or the JAX package was loaded;
a run that fails raises, and no result is printed.
"""

import time

T_START = time.perf_counter()

import sys  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import hmcmt2d_tpu_torch  # noqa: E402,F401  (the program under test; fails outside a checkout)
from benchmark.harness import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(t_start=T_START))
