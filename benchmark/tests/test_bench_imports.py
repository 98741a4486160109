"""What a benchmark run loads: never JAX or the JAX package, compared by
whole top-level names; the reference loads nothing of the program (CPU,
each in a fresh interpreter)."""

import subprocess
import sys

from benchmark.harness import manifest as MF

FORBIDDEN = ("jax", "jaxlib", "flax", "sos_slam_tpu")


def loaded_after(code: str) -> set:
    prog = (f"import sys; sys.path.insert(0, {str(MF.ROOT)!r}); {code}; "
            "print(sorted({m.split('.')[0] for m in list(sys.modules)}))")
    out = subprocess.run([sys.executable, "-c", prog], capture_output=True,
                         text=True, timeout=300, cwd=MF.ROOT)
    assert out.returncode == 0, out.stderr
    return set(eval(out.stdout.strip().splitlines()[-1]))


def test_harness_and_reference_load_no_jax():
    metrics = ", ".join(repr(m["name"])
                        for m in MF.load_manifest()["per_layer"])
    top = loaded_after(
        "import runpy; runpy.run_path('benchmark/run.py', run_name='bench');"
        "from benchmark.harness import manifest as MF, runner, readings, "
        "devtrace, utilization, timing;"
        "from benchmark.reference import check, camera, evaluate;"
        "from benchmark.costs import kernels, window;"
        "from benchmark.scene import ring;"
        "import sos_slam_tpu_torch.io.node, sos_slam_tpu_torch.ops.ba_p;"
        f"[MF.reader(n) for n in ({metrics},)]")
    assert "sos_slam_tpu_torch" in top and "torch" in top
    assert not top & set(FORBIDDEN), top & set(FORBIDDEN)


def test_reference_loads_nothing_of_the_program():
    top = loaded_after("from benchmark.reference import check, camera, "
                       "evaluate")
    assert not top & {"sos_slam_tpu_torch", "torch", *FORBIDDEN}


def test_run_refuses_without_a_card():
    out = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload",
         "euroc_mono.cruise", "--seed", "1", "--seconds", "1", "--trace",
         "0"], capture_output=True, text=True, timeout=300, cwd=MF.ROOT)
    assert out.returncode != 0 and out.stdout.strip() == ""
