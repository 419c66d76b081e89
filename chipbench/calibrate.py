"""Readings a cell's limits are set from, on the card; the benchmark's own
runs never run this.

    python chipbench/calibrate.py program --workload <name> \
        --seeds 1,2,... --seconds 6
    python chipbench/calibrate.py control --workload <name> \
        --seeds 1,2,3 --seconds 48

Each seed is one whole run of the cell through the harness (weights and
prompts made anew, set-up, a window of ``--seconds``, the comparison), in
one process, and prints one JSON line: the comparison's numbers and how
many batches they were read over. ``program``: the program as the
benchmark runs it (the lower readings). ``control``: the
reference with float8 products in the program's place
(``check.control_serve``), read by the same numbers (the upper readings);
its window has to be long enough to serve the sample.
"""
from __future__ import annotations

import argparse
import gc
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

from chipbench import check, harness  # noqa: E402
from chipbench.loops import prefill  # noqa: E402


def main(argv=None) -> int:
    import torch
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("what", choices=("program", "control"))
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, default=6.0)
    ap.add_argument("--seeds", required=True)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("calibrate: needs a CUDA device", file=sys.stderr)
        return 2
    if args.what == "control":
        prefill.PrefillCell.serve = check.control_serve
    for seed in (int(x) for x in args.seeds.split(",")):
        r = harness.execute(args.workload, seed, args.seconds, False,
                            time.perf_counter())
        print(json.dumps({"workload": args.workload, "what": args.what,
                          "seed": seed,
                          "numbers": {k: v["value"]
                                      for k, v in r["checks"].items()},
                          "compared": r["notes"]["compared"],
                          "comparison_s": r["notes"]["comparison_s"],
                          "setup_s": r["metrics"]["setup_s"]["value"]}),
              flush=True)
        del r
        gc.collect()
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    import os
    os.environ.update(harness.cache_env())
    raise SystemExit(main())
