"""Build and load the port's hand-written CUDA kernels, and count launches.

Each kernel source under `gps_gaussian_tpu_torch/csrc/` exposes plain C
functions (the headers they share are `csrc/*.cuh`). It is compiled with
nvcc for Hopper (`sm_90a`) into its own shared library at first use and
loaded with ctypes; nothing includes PyTorch's headers, so a build takes
seconds. Libraries land in `build/torch_kernels/` under the repository root
(listed in `.gitignore`), in a directory named by a hash of the source, the
shared headers and the flags, so an edited source is rebuilt and an
unchanged one is reused.

Every kernel wrapper adds one to `LAUNCHES[name]` each time it launches its
kernel, and nowhere else, so a run can show which kernels its main path went
through.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Optional, Sequence, Tuple

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
ARCH = "-gencode=arch=compute_90a,code=sm_90a"
# --fmad=false keeps every multiply and add separately rounded, as the plain
# PyTorch versions compute them; no --use_fast_math, so expf stays expf
NVCC_FLAGS = (ARCH, "-std=c++17", "-O3", "--fmad=false", "-shared",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")

LAUNCHES: Dict[str, int] = {}
_LIBS: Dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def count_launch(name: str) -> None:
    LAUNCHES[name] = LAUNCHES.get(name, 0) + 1


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    candidates = [shutil.which("nvcc")]
    if CUDA_HOME:
        candidates.append(os.path.join(CUDA_HOME, "bin", "nvcc"))
    for c in candidates:
        if c and os.path.exists(c):
            return c
    raise RuntimeError("nvcc not found: the CUDA kernels are built from "
                       "source and need the CUDA toolkit")


def library_path(name: str, defines: Sequence[str] = (),
                 src: Optional[Path] = None) -> Path:
    """Where `name`.cu builds, keyed by a hash of its source and flags.

    `defines` are -D macros (a kernel's tuning constants, e.g.
    "COMPOSITE_BWD_PPL=4") and `src` another source file exporting the same
    C functions; both are for measuring variants beside the shipped kernel.
    """
    src = src or CSRC / f"{name}.cu"
    flags = [*NVCC_FLAGS, *(f"-D{d}" for d in defines)]
    headers = b"".join(h.read_bytes() for h in sorted(CSRC.glob("*.cuh")))
    digest = hashlib.sha256(src.read_bytes() + headers
                            + " ".join(flags).encode()).hexdigest()
    return BUILD_ROOT / f"{name}-{digest[:16]}" / f"lib{name}.so"


def build(name: str, defines: Sequence[str] = (),
          src: Optional[Path] = None) -> Tuple[Path, str]:
    """Compile csrc/`name`.cu (or `src`) unless its library exists; returns
    the path and the compiler's output (ptxas register and shared-memory
    report, empty when the library was already built)."""
    out = library_path(name, defines, src)
    if out.exists():
        return out, ""
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, f"-I{CSRC}", *(f"-D{d}" for d in defines),
           "-o", str(tmp), str(src or CSRC / f"{name}.cu")]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}.cu:\n{proc.stdout}\n"
                           f"{proc.stderr}")
    os.replace(tmp, out)
    return out, proc.stdout + proc.stderr


def load(name: str) -> ctypes.CDLL:
    """The loaded library of csrc/`name`.cu, built at first use."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            path, _ = build(name)
            lib = ctypes.CDLL(str(path))
            _LIBS[name] = lib
        return lib
