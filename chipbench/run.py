"""Run one cell of the benchmark on the card:

    python chipbench/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout. The program under test is ``repro_torch``
(``src/``); its kernels build into ``build/`` there. The last line of the
standard output is the result (``chipbench/harness.py`` says what it
holds). Exits non-zero, printing no result, without enough CUDA devices.
"""
import time

T_START = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

from chipbench import harness  # noqa: E402

if __name__ == "__main__":
    os.environ.update(harness.cache_env())
    raise SystemExit(harness.main(sys.argv[1:], T_START))
