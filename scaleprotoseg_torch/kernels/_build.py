"""Build the CUDA sources under ``scaleprotoseg_torch/csrc`` and load them.

Each ``csrc/<name>.cu`` compiles with ``nvcc`` for ``sm_90a`` into its own
shared library with a plain C interface, loaded with ``ctypes``.  The
libraries land in ``build/kernels/`` at the root of the checkout, named
by a hash of the source, of every shared header ``csrc/*.cuh`` and of the
flags, so an edited source or header rebuilds and an unchanged one is
reused.  ``build()`` starts one ``nvcc`` per missing
library, all at once, and waits for them.

No ``--use_fast_math``: it swaps ``logf``/``expf`` and the division for
approximations that the prototype head's eps = 1e-4 cannot absorb.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Iterable

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
SOURCES = ("aspp", "aspp_bwd", "int8_mm", "proto", "upsample")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
              "-I", str(CSRC))

_libs: Dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") \
        or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME to the CUDA "
                           "toolkit that builds the port's kernels")
    return found


def library_path(name: str) -> Path:
    digest = hashlib.sha256()
    for src in [CSRC / f"{name}.cu", *sorted(CSRC.glob("*.cuh"))]:
        digest.update(src.name.encode() + b"\0" + src.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:12]}.so"


def build(names: Iterable[str] = SOURCES) -> Dict[str, dict]:
    """Compile every missing library in parallel.  Returns, per name, the
    wall seconds of its ``nvcc`` (0 when reused) and the compiler's
    register/shared-memory report.  Raises with the compiler output if a
    build fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out, time.perf_counter())
    report = {name: {"seconds": 0.0, "log": ""} for name in names}
    failed = []
    for name, (proc, tmp, out, t0) in procs.items():
        log, _ = proc.communicate()
        report[name] = {"seconds": time.perf_counter() - t0, "log": log}
        if proc.returncode != 0:
            failed.append(f"--- nvcc {name}.cu (exit {proc.returncode})\n{log}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return report


def library(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built on first use."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            build([name])
            lib = _libs[name] = ctypes.CDLL(str(library_path(name)))
        return lib


def check(lib: ctypes.CDLL, status: int, what: str) -> None:
    """Raise on a nonzero ``cudaError_t`` returned by a launcher; every
    library exports ``error_string`` for the message."""
    if status != 0:
        fn = lib.error_string
        fn.argtypes = [ctypes.c_int]
        fn.restype = ctypes.c_char_p
        raise RuntimeError(f"{what}: CUDA error {status} "
                           f"({fn(status).decode()})")
