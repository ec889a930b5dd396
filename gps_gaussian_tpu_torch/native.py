"""ctypes bindings for the host-side C++ kernels of the data pipeline.

Counterpart of gps_gaussian_tpu/native.py (`remap_bilinear` :79,
`erode3x3` :104, `rasterize_mesh` :116 with its numpy fallback
`_rasterize_mesh_numpy` :167) over its own copies of the sources,
`gps_gaussian_tpu_torch/csrc/host/image_ops.cpp` and `mesh_raster.cpp`.
This is data preparation on the host, not a device kernel. Both sources are
compiled with g++ at first use into one library under `build/native_host/`
at the repository root (listed in `.gitignore`), named by a hash of both
sources and the flags, with the JAX package's flags, so both packages give
the same bits. Every entry point has a numpy fallback, taken when no
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

_SRC_DIR = Path(__file__).resolve().parent / "csrc" / "host"
_SRCS = (_SRC_DIR / "image_ops.cpp", _SRC_DIR / "mesh_raster.cpp")
_BUILD = Path(__file__).resolve().parents[1] / "build" / "native_host"
_FLAGS = ("-O3", "-march=native", "-std=c++17", "-shared", "-fPIC",
          "-pthread")
_LOCK = threading.Lock()
_LIB: Optional[ctypes.CDLL] = None
_TRIED = False


def _compile() -> ctypes.CDLL:
    digest = hashlib.sha256(b"".join(src.read_bytes() for src in _SRCS)
                            + " ".join(_FLAGS).encode()).hexdigest()[:16]
    so = _BUILD / f"libgps_native-{digest}.so"
    if not so.exists():
        _BUILD.mkdir(parents=True, exist_ok=True)
        tmp = so.with_suffix(f".{os.getpid()}.tmp")
        cmd = ["g++", *_FLAGS, "-o", str(tmp), *map(str, _SRCS)]
        log.info("building the native library: %s", " ".join(cmd))
        subprocess.run(cmd, check=True, capture_output=True)
        os.replace(tmp, so)
    lib = ctypes.CDLL(str(so))
    f32p = ctypes.POINTER(ctypes.c_float)
    i32p = ctypes.POINTER(ctypes.c_int32)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    ci = ctypes.c_int
    cf = ctypes.c_float
    lib.remap_bilinear_f32.argtypes = [f32p, ci, ci, ci, f32p, f32p, ci, ci,
                                       f32p]
    lib.erode3x3_f32.argtypes = [f32p, ci, ci, f32p]
    lib.rasterize_mesh.argtypes = [f32p, ci, i32p, ci, f32p, f32p, f32p, ci,
                                   ci, f32p, f32p, f32p, ci, cf, ci, ci,
                                   f32p, f32p, u8p, f32p]
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


# Directional lights, rows [direction xyz, colour rgb] (JAX native.py:134).
DEFAULT_LIGHTS = np.array([[0.5, 0.7, 0.5, 0.8, 0.76, 0.72],
                           [-0.6, 0.4, 0.2, 0.35, 0.38, 0.45],
                           [0.1, 0.3, -0.9, 0.4, 0.36, 0.32]])


def rasterize_mesh(verts: np.ndarray, faces: np.ndarray,
                   vert_color: np.ndarray, K: np.ndarray, E: np.ndarray,
                   height: int, width: int,
                   uv: Optional[np.ndarray] = None,
                   tex: Optional[np.ndarray] = None,
                   lights: Optional[np.ndarray] = None,
                   ambient: float = 0.25):
    """Render a mesh: returns (rgb (H,W,3) f32, inv_depth (H,W) f32,
    mask (H,W) u8, normal (H,W,3) f32). Depth is INVERSE z, the pipeline's
    convention. Triangles are split over the host's threads; the result
    does not depend on the thread timing."""
    lib = _get_lib()
    if lib is None:
        return _rasterize_mesh_numpy(verts, faces, vert_color, K, E,
                                     height, width, uv, tex, lights,
                                     ambient)

    verts = np.ascontiguousarray(verts, np.float32)
    faces = np.ascontiguousarray(faces, np.int32)
    vert_color = np.ascontiguousarray(vert_color, np.float32)
    K = np.ascontiguousarray(K, np.float32)
    E = np.ascontiguousarray(E, np.float32)
    lights = np.ascontiguousarray(
        DEFAULT_LIGHTS if lights is None else lights, np.float32)

    rgb = np.empty((height, width, 3), np.float32)
    invz = np.empty((height, width), np.float32)
    msk = np.empty((height, width), np.uint8)
    nrm = np.empty((height, width, 3), np.float32)

    null = ctypes.cast(None, ctypes.POINTER(ctypes.c_float))
    uv_p = null if uv is None else _fp(np.ascontiguousarray(uv, np.float32))
    th = tw = 0
    tex_p = null
    if tex is not None:
        tex = np.ascontiguousarray(tex, np.float32)
        tex_p, th, tw = _fp(tex), tex.shape[0], tex.shape[1]

    lib.rasterize_mesh(
        _fp(verts), len(verts),
        faces.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), len(faces),
        _fp(vert_color), uv_p, tex_p, th, tw, _fp(K), _fp(E), _fp(lights),
        len(lights), ctypes.c_float(ambient), height, width, _fp(rgb),
        _fp(invz), msk.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        _fp(nrm))
    return rgb, invz, msk, nrm


def _rasterize_mesh_numpy(verts, faces, vert_color, K, E, height, width,
                          uv, tex, lights, ambient):
    """Slow host fallback (a numpy loop over triangles, flat shading; the
    texture is not sampled)."""
    verts = np.asarray(verts, np.float64)
    K = np.asarray(K, np.float64)
    E = np.asarray(E, np.float64)
    cam = verts @ E[:3, :3].T + E[:3, 3]
    z = np.maximum(cam[:, 2], 1e-6)
    spx = (K[0, 0] * cam[:, 0] + K[0, 2] * cam[:, 2]) / z
    spy = (K[1, 1] * cam[:, 1] + K[1, 2] * cam[:, 2]) / z
    if lights is None:
        lights = DEFAULT_LIGHTS

    rgb = np.zeros((height, width, 3), np.float32)
    invz_buf = np.zeros((height, width), np.float32)
    nrm_buf = np.zeros((height, width, 3), np.float32)
    for f in np.asarray(faces):
        ia, ib, ic = int(f[0]), int(f[1]), int(f[2])
        if min(cam[ia, 2], cam[ib, 2], cam[ic, 2]) <= 1e-6:
            continue
        ax, ay, bx, by, cx, cy = (spx[ia], spy[ia], spx[ib], spy[ib],
                                  spx[ic], spy[ic])
        area = (bx - ax) * (cy - ay) - (by - ay) * (cx - ax)
        if abs(area) < 1e-12:
            continue
        n = np.cross(verts[ib] - verts[ia], verts[ic] - verts[ia])
        n = n / (np.linalg.norm(n) + 1e-12)
        x0, x1 = max(0, int(min(ax, bx, cx))), min(width - 1,
                                                   int(max(ax, bx, cx)) + 1)
        y0, y1 = max(0, int(min(ay, by, cy))), min(height - 1,
                                                   int(max(ay, by, cy)) + 1)
        if x0 > x1 or y0 > y1:
            continue
        xs, ys = np.meshgrid(np.arange(x0, x1 + 1) + 0.5,
                             np.arange(y0, y1 + 1) + 0.5)
        w0 = ((bx - xs) * (cy - ys) - (by - ys) * (cx - xs)) / area
        w1 = ((cx - xs) * (ay - ys) - (cy - ys) * (ax - xs)) / area
        w2 = 1.0 - w0 - w1
        inside = (w0 >= 0) & (w1 >= 0) & (w2 >= 0)
        iz = (w0 / cam[ia, 2] + w1 / cam[ib, 2] + w2 / cam[ic, 2])
        sl = (slice(y0, y1 + 1), slice(x0, x1 + 1))
        win = inside & (iz > invz_buf[sl])
        invz_buf[sl] = np.where(win, iz, invz_buf[sl])
        q = np.stack([w0 / cam[ia, 2], w1 / cam[ib, 2],
                      w2 / cam[ic, 2]]) / np.maximum(iz, 1e-12)
        albedo = (q[0][..., None] * vert_color[ia]
                  + q[1][..., None] * vert_color[ib]
                  + q[2][..., None] * vert_color[ic])
        shade = np.full(3, ambient)
        for L in lights:
            ld = L[:3] / np.linalg.norm(L[:3])
            shade = shade + max(0.0, float(n @ ld)) * L[3:]
        col = np.clip(albedo * shade, 0, 1)
        rgb[sl] = np.where(win[..., None], col, rgb[sl])
        nrm_buf[sl] = np.where(win[..., None], n, nrm_buf[sl])
    mask = (invz_buf > 0).astype(np.uint8) * 255
    return rgb, invz_buf, mask, nrm_buf
