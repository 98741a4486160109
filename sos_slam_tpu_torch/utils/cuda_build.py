"""Build and load the port's CUDA kernels (csrc/*.cu) at first use.

Each source is compiled by `nvcc` for sm_90a into its own shared library
with a plain C interface, loaded through ctypes: no PyTorch headers, so a
build takes seconds. Libraries land in `sos_slam_tpu_torch/_build/` under a
name that carries a hash of the source and the flags, so an edited source
is rebuilt and a stale library is never loaded. `build_all()` compiles
every missing library with one nvcc process per source, all at once.
`graph_cond` (conditional graph nodes, ops/control.py) also calls the
driver API and links libcuda: against the toolkit's stub at build time,
the driver's own library at load time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Iterable

_PKG = Path(__file__).resolve().parents[1]
SRC_DIR = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
SOURCES = ("pyramid", "template", "ba_fused", "act_pass", "graph_cond")
# the libraries a source links besides the CUDA runtime
LINK = {"graph_cond": ("-lcuda",)}
# -fmad=false: no contraction of a*b+c into one rounding, so a kernel
# rounds like its plain PyTorch twin (separate elementwise ops) and the
# residual-state thresholds decide alike
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-fmad=false", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")

_LIBS: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _link_flags(name: str, nvcc: str | None = None) -> tuple:
    """`LINK[name]` behind the toolkit's stub directories (libcuda.so is
    a stub there; the driver's libcuda.so.1 is loaded at run time)."""
    libs = LINK.get(name, ())
    if not libs or nvcc is None:
        return libs
    root = Path(nvcc).resolve().parents[1]
    dirs = [d for d in (root / "lib64" / "stubs",
                        root / "targets" / "x86_64-linux" / "lib" / "stubs")
            if d.is_dir()]
    return tuple(f"-L{d}" for d in dirs) + libs


def lib_path(name: str) -> Path:
    src = (SRC_DIR / f"{name}.cu").read_bytes()
    flags = " ".join(NVCC_FLAGS + LINK.get(name, ()))
    digest = hashlib.sha1(src + flags.encode()).hexdigest()[:12]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def build_all(names: Iterable[str] = SOURCES) -> Dict[str, dict]:
    """Compile every missing library in parallel. Returns, per source,
    {"seconds", "ptxas"} (ptxas = nvcc's register/spill report)."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    t0 = time.perf_counter()
    for name in names:
        out = lib_path(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        nvcc = _nvcc()
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(SRC_DIR / f"{name}.cu"),
               *_link_flags(name, nvcc)]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out)
    report = {n: {"seconds": 0.0, "ptxas": "cached"} for n in names}
    failed = []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        report[name] = {"seconds": time.perf_counter() - t0, "ptxas": log}
        if proc.returncode != 0:
            failed.append(f"{name}.cu:\n{log}")
            continue
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    return report


def load(name: str) -> ctypes.CDLL:
    """The loaded library of csrc/<name>.cu, built first if missing."""
    lib = _LIBS.get(name)
    if lib is None:
        path = lib_path(name)
        if not path.exists():
            build_all([name])
        lib = ctypes.CDLL(str(path))
        _LIBS[name] = lib
    return lib


def function(name: str, symbol: str, argtypes) -> ctypes._CFuncPtr:
    """A C entry point of library `name` with its argument types set."""
    fn = getattr(load(name), symbol)
    if fn.argtypes is None:
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return fn


def ptr(t) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def stream_ptr(device) -> ctypes.c_void_p:
    import torch
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def empty_views(shapes, dtype, device):
    """One uninitialised allocation cut into contiguous views, one per
    shape, each starting on a multiple of 4 elements (16 bytes of float32):
    the outputs of one kind of a kernel that writes several, each fit for
    16-byte stores."""
    import torch
    sizes = [torch.Size(s).numel() for s in shapes]
    starts = [0]
    for n in sizes:
        starts.append(starts[-1] + -(-n // 4) * 4)
    flat = torch.empty(starts[-1], dtype=dtype, device=device)
    return [flat[at:at + n].view(shape)
            for at, n, shape in zip(starts, sizes, shapes)]


def check(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with error {err}")
