"""The benchmark of the PyTorch/CUDA port (`sos_slam_tpu_torch`): one run of
one cell of BENCHMARK.json, one JSON result line last on standard output.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

`--trace 0` reports the cell's end-to-end metrics, `--trace 1` its
per-layer metrics and the device trace. Every run compares what the
window produced with the plain reference (benchmark/reference/) and
prints each compared number beside its limit, last on standard error and
last in the result line. The run refuses to start without as many CUDA
devices as the cell asks for, and refuses to print a result if JAX or
the JAX package was loaded.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
HERE = str(Path(__file__).resolve().parent)
sys.path[:] = [p for p in sys.path if os.path.abspath(p or ".") != HERE]
sys.path.insert(0, str(ROOT))

FORBIDDEN = ("jax", "jaxlib", "flax", "sos_slam_tpu")


def forbidden_modules():
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted({name.split(".")[0] for name in list(sys.modules)
                   if name.split(".")[0] in FORBIDDEN})


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from benchmark.harness import manifest as MF
    from benchmark.harness.runner import RunFailed, log, run
    cell = MF.resolve(args.workload)

    import torch
    if not torch.cuda.is_available() \
            or torch.cuda.device_count() < cell.chips:
        log(f"[run] {cell.name} needs {cell.chips} CUDA device(s); "
            f"available: {torch.cuda.is_available()}, count "
            f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 2
    try:
        result = run(cell, args.seed, args.seconds, bool(args.trace), "cuda",
                     T_START)
    except RunFailed as e:
        log(f"[run] failed: {e}")
        return 3
    found = forbidden_modules()
    if found:
        log(f"[run] refused: JAX or the JAX package was loaded: {found}")
        return 4
    return emit(result)


def json_safe(x):
    """Non-finite floats as null: the line stays strict JSON."""
    if isinstance(x, float) and not math.isfinite(x):
        return None
    if isinstance(x, dict):
        return {k: json_safe(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [json_safe(v) for v in x]
    return x


def emit(result: dict) -> int:
    """The comparison's lines last on standard error, the result line last
    on standard output (its `checks` key last)."""
    checks = result["checks"]
    for name, c in checks.items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r} "
              f"{'ok' if c['value'] <= c['limit'] else 'FAILED'}",
              file=sys.stderr)
    print(f"correct {result['correct']}", file=sys.stderr, flush=True)
    line = {k: result[k] for k in ("correct", "attempted", "failed",
                                   "metrics", "device")}
    for key in ("breakdown", "numbers"):
        if key in result:
            line[key] = result[key]
    line["checks"] = checks
    print(json.dumps(json_safe(line)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
