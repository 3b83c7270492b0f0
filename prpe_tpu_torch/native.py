"""ctypes binding of the host preprocessing library (``prpe_tpu/native.py``).

The C++ source is the repository's ``native/host_ops.cpp``, shared with the
JAX package and compiled as it is: ``g++`` builds it at first use into
``build/prpe_tpu_torch/libprpe_host-<hash>.so`` at the root of the checkout,
the hash covering the source and the flags (as ``ops/kernels/_build.py``
does for the CUDA sources). A build or load that fails raises: the readers
never fall back to numpy on their own. The numpy versions (``*_plain``) are
the plain versions the tests hold the library against; they differ from it
by one grey level at exact .5 ties (their sample coordinates are float64,
the library's float32).

The library holds no global state and uses no threads, so forked decode
workers (``data/loader.py``) call it as the parent does.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import subprocess
import threading
from typing import Tuple

import numpy as np

_ROOT = pathlib.Path(__file__).resolve().parent.parent
SOURCE = _ROOT / "native" / "host_ops.cpp"
BUILD_DIR = _ROOT / "build" / "prpe_tpu_torch"
FLAGS = ["-O3", "-shared", "-fPIC"]

_lock = threading.Lock()
_lib = None

_f32p = ctypes.POINTER(ctypes.c_float)
_u8p = ctypes.POINTER(ctypes.c_uint8)
_i64 = ctypes.c_int64
_i64p = ctypes.POINTER(ctypes.c_int64)

_SIGNATURES = {
    "resize_bilinear_u8": [_u8p, _i64, _i64, _i64, _u8p, _i64, _i64],
    "letterbox_normalize_f32": [_u8p, _i64, _i64, _i64, _f32p, _i64, _f32p, _f32p,
                                ctypes.c_int, _f32p, _f32p, _i64p, _i64p],
    "resize_normalize_f32": [_u8p, _i64, _i64, _i64, _f32p, _i64, _i64, _f32p, _f32p,
                             ctypes.c_int],
    "warp_affine_u8": [_u8p, _i64, _i64, _i64, _u8p, _i64, _i64, _f32p],
    "hsv_lut_u8": [_u8p, _i64, ctypes.c_float, ctypes.c_float, ctypes.c_float],
}


def library_path() -> pathlib.Path:
    h = hashlib.sha256(SOURCE.read_bytes())
    h.update(" ".join(FLAGS).encode())
    return BUILD_DIR / f"libprpe_host-{h.hexdigest()[:16]}.so"


def _build(out: pathlib.Path) -> None:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.run(["g++", *FLAGS, "-o", str(tmp), str(SOURCE)],
                          capture_output=True, text=True, timeout=300)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"g++ failed for {SOURCE}:\n{proc.stderr}")
    os.replace(tmp, out)  # atomic: concurrent builds each write their own tmp


def get_lib() -> ctypes.CDLL:
    """The loaded library, built first if needed; raises if it cannot be."""
    global _lib
    if _lib is not None:  # no lock: a forked worker may inherit it held
        return _lib
    with _lock:
        if _lib is None:
            out = library_path()
            if not out.exists():
                try:
                    _build(out)
                except (OSError, subprocess.SubprocessError) as e:
                    raise RuntimeError(f"cannot build {SOURCE} with g++: {e}") from e
            lib = ctypes.CDLL(str(out))
            for name, argtypes in _SIGNATURES.items():
                getattr(lib, name).argtypes = argtypes
            _lib = lib
        return _lib


def _as_u8p(a: np.ndarray):
    return a.ctypes.data_as(_u8p)


def _as_f32p(a: np.ndarray):
    return a.ctypes.data_as(_f32p)


# ---------------------------------------------------------------------------
# plain numpy versions (the same half-pixel bilinear, float64 coordinates)
# ---------------------------------------------------------------------------

def np_bilinear(src: np.ndarray, dh: int, dw: int) -> np.ndarray:
    """Half-pixel bilinear resize of an HWC array, unrounded."""
    sh, sw = src.shape[:2]
    fy = np.clip((np.arange(dh) + 0.5) * (sh / dh) - 0.5, 0, sh - 1)
    fx = np.clip((np.arange(dw) + 0.5) * (sw / dw) - 0.5, 0, sw - 1)
    y0 = fy.astype(np.int64)
    y1 = np.minimum(y0 + 1, sh - 1)
    x0 = fx.astype(np.int64)
    x1 = np.minimum(x0 + 1, sw - 1)
    wy = (fy - y0)[:, None, None].astype(np.float32)
    wx = (fx - x0)[None, :, None].astype(np.float32)
    s = src.astype(np.float32)
    top = s[y0][:, x0] * (1 - wx) + s[y0][:, x1] * wx
    bot = s[y1][:, x0] * (1 - wx) + s[y1][:, x1] * wx
    return top * (1 - wy) + bot * wy


def resize_bilinear_u8_plain(src: np.ndarray, dh: int, dw: int) -> np.ndarray:
    return np.clip(np_bilinear(src, dh, dw) + 0.5, 0, 255).astype(np.uint8)


def hsv_lut_plain(img: np.ndarray, rh: float, rs: float, rv: float) -> np.ndarray:
    """cv2-exact uint8 HSV LUT jitter (the C kernel's math: H in [0, 180) =
    round(deg / 2), S = round(255 (V - min) / V), uint8 LUTs, sector-formula
    HSV -> RGB; fp32 throughout)."""
    x = img.astype(np.float32)
    r, g, b = x[..., 0], x[..., 1], x[..., 2]
    v = x.max(-1)
    mn = x.min(-1)
    diff = v - mn
    s = np.where(v > 0, 255.0 * diff / np.maximum(v, 1e-12), 0.0)
    safe = np.maximum(diff, 1e-12)
    is_r = (diff > 0) & (v == r)
    is_g = (diff > 0) & (v == g) & ~is_r
    is_b = (diff > 0) & ~is_r & ~is_g
    h = np.zeros_like(v)
    h = np.where(is_r, 60.0 * (g - b) / safe, h)
    h = np.where(is_g, 120.0 + 60.0 * (b - r) / safe, h)
    h = np.where(is_b, 240.0 + 60.0 * (r - g) / safe, h)
    h = np.where(h < 0, h + 360.0, h)
    hu = (h / 2.0 + 0.5).astype(np.uint8)
    hu = np.where(hu >= 180, 0, hu).astype(np.uint8)
    su = (s + 0.5).astype(np.uint8)
    vu = (v + 0.5).astype(np.uint8)

    idx = np.arange(256, dtype=np.float32)
    lut_h = np.fmod(idx * np.float32(rh), 180.0).astype(np.uint8)
    lut_s = np.clip(idx * np.float32(rs), 0, 255).astype(np.uint8)
    lut_v = np.clip(idx * np.float32(rv), 0, 255).astype(np.uint8)

    h2 = lut_h[hu].astype(np.float32) * 2.0
    s2 = lut_s[su].astype(np.float32) / 255.0
    v2 = lut_v[vu].astype(np.float32)
    hh = h2 / 60.0
    sector = hh.astype(np.int32) % 6
    f = hh - hh.astype(np.int32)
    p = v2 * (1.0 - s2)
    q = v2 * (1.0 - s2 * f)
    t = v2 * (1.0 - s2 * (1.0 - f))
    sectors = [sector == i for i in range(5)]
    ro = np.select(sectors, [v2, q, p, p, t], default=v2)
    go = np.select(sectors, [t, v2, v2, q, p], default=p)
    bo = np.select(sectors, [p, p, t, v2, v2], default=q)
    out = np.stack([ro, go, bo], -1)
    return np.clip(out + 0.5, 0, 255).astype(np.uint8)


def resize_normalize_plain(src, dh, dw, mean, std, bgr=False) -> np.ndarray:
    x = np_bilinear(src, dh, dw) / 255.0
    if bgr:
        x = x[..., ::-1]
    return ((x - np.asarray(mean, np.float32)) / np.asarray(std, np.float32)).astype(np.float32)


def letterbox_geometry(sh: int, sw: int, size: int) -> Tuple[float, int, int, int, int]:
    """(scale, resized h, resized w, top, left) of a letterbox to ``size``."""
    scale = size / max(sh, sw)
    nh, nw = int(round(sh * scale)), int(round(sw * scale))
    return scale, nh, nw, (size - nh) // 2, (size - nw) // 2


def letterbox_normalize_plain(src, size, mean, std, bgr=False):
    mean = np.asarray(mean, np.float32)
    std = np.asarray(std, np.float32)
    scale, nh, nw, t, l = letterbox_geometry(*src.shape[:2], size)
    out = np.broadcast_to(((0.0 - mean) / std).astype(np.float32), (size, size, src.shape[2])).copy()
    out[t: t + nh, l: l + nw] = resize_normalize_plain(src, nh, nw, mean, std, bgr)
    return out, scale, (t, l)


# ---------------------------------------------------------------------------
# the library's entry points
# ---------------------------------------------------------------------------

def resize_bilinear_u8(src: np.ndarray, dh: int, dw: int) -> np.ndarray:
    """uint8 HWC resize, half-pixel bilinear."""
    src = np.ascontiguousarray(src)
    dst = np.empty((dh, dw, src.shape[2]), np.uint8)
    get_lib().resize_bilinear_u8(_as_u8p(src), src.shape[0], src.shape[1], src.shape[2],
                                 _as_u8p(dst), dh, dw)
    return dst


def warp_affine_u8(src: np.ndarray, inv: np.ndarray, dh: int, dw: int) -> np.ndarray:
    """Inverse-mapped bilinear affine warp, black border; ``inv`` is the
    row-major 2x3 inverse matrix (output -> source coordinates)."""
    src = np.ascontiguousarray(src)
    inv = np.ascontiguousarray(inv, np.float32).reshape(6)
    dst = np.empty((dh, dw, src.shape[2]), np.uint8)
    get_lib().warp_affine_u8(_as_u8p(src), src.shape[0], src.shape[1], src.shape[2],
                             _as_u8p(dst), dh, dw, _as_f32p(inv))
    return dst


def hsv_lut(img: np.ndarray, rh: float, rs: float, rv: float) -> np.ndarray:
    """cv2-exact uint8 HSV LUT jitter on RGB HWC (the reference's
    augment_hsv semantics, training/yolopt/dataset.py:274-289)."""
    if img.shape[-1] != 3:
        raise ValueError(f"hsv_lut takes RGB images, got {img.shape}")
    out = np.ascontiguousarray(img).copy()
    get_lib().hsv_lut_u8(_as_u8p(out), out.shape[0] * out.shape[1], float(rh), float(rs),
                         float(rv))
    return out


def resize_normalize(src: np.ndarray, dh: int, dw: int, mean: np.ndarray, std: np.ndarray,
                     bgr: bool = False) -> np.ndarray:
    """uint8 HWC -> resized, /255, (x - mean) / std fp32; optional BGR swap."""
    src = np.ascontiguousarray(src)
    c = src.shape[2]
    mean = np.ascontiguousarray(mean, np.float32)
    std = np.ascontiguousarray(std, np.float32)
    dst = np.empty((dh, dw, c), np.float32)
    get_lib().resize_normalize_f32(_as_u8p(src), src.shape[0], src.shape[1], c, _as_f32p(dst),
                                   dh, dw, _as_f32p(mean), _as_f32p(std), int(bgr))
    return dst


def letterbox_normalize(src: np.ndarray, size: int, mean: np.ndarray, std: np.ndarray,
                        bgr: bool = False) -> Tuple[np.ndarray, float, Tuple[int, int]]:
    """uint8 HWC -> (size, size) letterboxed normalized fp32; the padding is
    normalized zero, (0 - mean) / std. Returns (image, scale, (top, left))."""
    src = np.ascontiguousarray(src)
    c = src.shape[2]
    mean = np.ascontiguousarray(mean, np.float32)
    std = np.ascontiguousarray(std, np.float32)
    pad = np.ascontiguousarray((0.0 - mean) / std, np.float32)
    dst = np.empty((size, size, c), np.float32)
    scale = ctypes.c_float()
    top, left = _i64(0), _i64(0)
    get_lib().letterbox_normalize_f32(
        _as_u8p(src), src.shape[0], src.shape[1], c, _as_f32p(dst), size, _as_f32p(mean),
        _as_f32p(std), int(bgr), _as_f32p(pad), ctypes.byref(scale), ctypes.byref(top),
        ctypes.byref(left))
    return dst, float(scale.value), (int(top.value), int(left.value))


def letterbox_u8(src: np.ndarray, size: int) -> Tuple[np.ndarray, float, Tuple[int, int]]:
    """uint8 HWC -> (size, size) letterboxed raw uint8 pixels, zero padding;
    the geometry of ``letterbox_normalize``. The normalisation happens on
    the device (``data/packed.py::apply_image_norm``), so batches cross to
    the card at 1 byte a pixel."""
    src = np.ascontiguousarray(src)
    scale, nh, nw, t, l = letterbox_geometry(*src.shape[:2], size)
    out = np.zeros((size, size, src.shape[2]), np.uint8)
    out[t: t + nh, l: l + nw] = resize_bilinear_u8(src, nh, nw)
    return out, scale, (t, l)
