"""The readings that the correctness limits are set from: many seeds of one
cell in one process (the kernels built once), the program's runs and the
control's, one JSON line each with every number the comparison computes.

    python3 benchmark/harness/readings.py --workload <cell> --seconds <s> \
        --seeds 11,12,13 [--control-seeds 21,22,23] [--out FILE]

On a card only; the measured runs are benchmark/run.py's."""

import argparse
import gc
import json
import math
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
HERE = str(Path(__file__).resolve().parent)
sys.path[:] = [p for p in sys.path if p != HERE]
sys.path.insert(0, str(ROOT))


def clean(x):
    """JSON-safe: non-finite floats as strings."""
    if isinstance(x, float) and not math.isfinite(x):
        return repr(x)
    if isinstance(x, dict):
        return {k: clean(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [clean(v) for v in x]
    return x


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--out", default=None)
    args = ap.parse_args()

    import torch

    from benchmark.harness import manifest as MF
    from benchmark.harness.runner import run
    if not torch.cuda.is_available():
        print("readings: no CUDA device", file=sys.stderr)
        return 2
    cell = MF.resolve(args.workload)
    plan = [(int(s), None) for s in args.seeds.split(",") if s] + \
        [(int(s), "tf32") for s in args.control_seeds.split(",") if s]
    out = open(args.out, "a") if args.out else None
    rc = 0
    for seed, control in plan:
        t0 = time.perf_counter()
        try:
            res = run(cell, seed, args.seconds, False, "cuda", t0,
                      control=control)
            line = dict(workload=cell.name, seed=seed, control=control,
                        correct=res["correct"], attempted=res["attempted"],
                        failed=res["failed"], numbers=res["numbers"],
                        metrics={k: v["value"]
                                 for k, v in res["metrics"].items()},
                        wall_s=time.perf_counter() - t0)
        except Exception as e:     # one seed's failure is a reading too
            rc = 1
            line = dict(workload=cell.name, seed=seed, control=control,
                        error=f"{type(e).__name__}: {e}")
        text = json.dumps(clean(line))
        print(text, flush=True)
        if out:
            out.write(text + "\n")
            out.flush()
        gc.collect()
        torch.cuda.empty_cache()
    if out:
        out.close()
    return rc


if __name__ == "__main__":
    sys.exit(main())
