"""ctypes bindings for the host-side C++ image kernels of the data pipeline.

Counterpart of gps_gaussian_tpu/native.py `remap_bilinear` :79 and
`erode3x3` :104 over its own copy of the source,
`gps_gaussian_tpu_torch/csrc/host/image_ops.cpp`. This is data preparation
on the host, not a device kernel. The library is compiled with g++ at first
use into `build/native_host/` under the repository root (listed in
`.gitignore`), with the JAX package's flags, so both give the same bits.
Every entry point has a numpy fallback (geometry/stereo.py), taken when no
toolchain is present; `available()` reports which path is active.
"""

from __future__ import annotations

import ctypes
import hashlib
import logging
import os
import subprocess
import threading
from pathlib import Path
from typing import Optional

import numpy as np

from gps_gaussian_tpu_torch.geometry import stereo

log = logging.getLogger("gps_tpu_torch.native")

_SRC = Path(__file__).resolve().parent / "csrc" / "host" / "image_ops.cpp"
_BUILD = Path(__file__).resolve().parents[1] / "build" / "native_host"
_FLAGS = ("-O3", "-march=native", "-std=c++17", "-shared", "-fPIC",
          "-pthread")
_LOCK = threading.Lock()
_LIB: Optional[ctypes.CDLL] = None
_TRIED = False


def _compile() -> ctypes.CDLL:
    digest = hashlib.sha256(_SRC.read_bytes()
                            + " ".join(_FLAGS).encode()).hexdigest()[:16]
    so = _BUILD / f"libimage_ops-{digest}.so"
    if not so.exists():
        _BUILD.mkdir(parents=True, exist_ok=True)
        tmp = so.with_suffix(f".{os.getpid()}.tmp")
        cmd = ["g++", *_FLAGS, "-o", str(tmp), str(_SRC)]
        log.info("building the native library: %s", " ".join(cmd))
        subprocess.run(cmd, check=True, capture_output=True)
        os.replace(tmp, so)
    lib = ctypes.CDLL(str(so))
    f32p = ctypes.POINTER(ctypes.c_float)
    ci = ctypes.c_int
    lib.remap_bilinear_f32.argtypes = [f32p, ci, ci, ci, f32p, f32p, ci, ci,
                                       f32p]
    lib.erode3x3_f32.argtypes = [f32p, ci, ci, f32p]
    return lib


def _get_lib() -> Optional[ctypes.CDLL]:
    global _LIB, _TRIED
    with _LOCK:
        if _LIB is None and not _TRIED:
            _TRIED = True
            try:
                _LIB = _compile()
            except Exception as e:  # no toolchain -> numpy fallbacks
                log.warning("native build failed (%s); using numpy "
                            "fallbacks", e)
        return _LIB


def available() -> bool:
    return _get_lib() is not None


def _fp(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def remap_bilinear(img: np.ndarray, map_x: np.ndarray,
                   map_y: np.ndarray) -> np.ndarray:
    """Bilinear remap with zero border; img (H, W[, C]) any float/int."""
    lib = _get_lib()
    if lib is None:
        return stereo.remap_bilinear(img, map_x, map_y)

    squeeze = img.ndim == 2
    src = np.ascontiguousarray(img[..., None] if squeeze else img,
                               dtype=np.float32)
    h, w, c = src.shape
    oh, ow = map_x.shape
    dst = np.empty((oh, ow, c), np.float32)
    mx = np.ascontiguousarray(map_x, np.float32)
    my = np.ascontiguousarray(map_y, np.float32)
    lib.remap_bilinear_f32(_fp(src), h, w, c, _fp(mx), _fp(my), oh, ow,
                           _fp(dst))
    if np.issubdtype(img.dtype, np.integer):
        info = np.iinfo(img.dtype)
        dst = np.clip(np.rint(dst), info.min, info.max)
    out = dst.astype(img.dtype)
    return out[..., 0] if squeeze else out


def erode3x3(mask: np.ndarray) -> np.ndarray:
    """3x3 erosion (local min), border treated as +inf."""
    lib = _get_lib()
    if lib is None:
        return stereo.erode3x3(mask)
    src = np.ascontiguousarray(mask, np.float32)
    h, w = src.shape
    dst = np.empty((h, w), np.float32)
    lib.erode3x3_f32(_fp(src), h, w, _fp(dst))
    return dst
