"""The correctness control on the card, at each cell's own size and load:
the program's float32 matmuls in TF32 (the precision just below the
float32 with TF32 off that the port states), and the plain remap in TF32
in the intake's place. On three seeds, `correct` must come out false.

    python -m pytest benchmark/tests/test_bench_control.py -m cuda -s \
        -p no:cacheprovider -o addopts=""

Each run's numbers are printed as one JSON line: the control's readings,
the upper ends the limits in the configurations were set below.
"""

import json
import time

import pytest

from benchmark.harness import manifest as MF

CELLS = [w["name"] for w in MF.load_manifest()["workloads"]]
SEEDS = (1618033988, 2 ** 31 + 77, 1732050807)


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_the_control_is_not_correct_on_the_card(cell):
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the control runs at the cell's "
                    "own size")
    from benchmark.harness.runner import run
    c = MF.resolve(cell)
    for seed in SEEDS:
        res = run(c, seed, float(MF.load_manifest()["run_seconds"]),
                  False, "cuda", time.perf_counter(), control="tf32")
        print(json.dumps(dict(cell=cell, seed=seed, control="tf32",
                              correct=res["correct"], failed=res["failed"],
                              numbers=res["numbers"])), flush=True)
        assert not res["correct"], (seed, res["checks"])
