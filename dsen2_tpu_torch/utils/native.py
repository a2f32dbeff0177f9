"""ctypes loader for the native host library (native/dsen2_host.cpp).

Builds the shared object on first use with g++ into build/native/ of the
checkout (ignored by git; the source is built by path and never written
to); every entry point has a numpy fallback so the framework works without
a toolchain. The library has a plain C ABI, bound with ctypes.

A copy of dsen2_tpu/utils/native.py apart from where the library is built
(tests/test_torch_patches.py holds both paths equal to the original's).
This is host code: it runs on the CPU beside the device pipeline."""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
import warnings
from typing import Optional

import numpy as np

__all__ = [
    "get_lib",
    "native_available",
    "symmetric_pad",
    "extract_patches_host",
    "pad_extract_host",
    "recompose_host",
]

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_tried = False

_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
_SRC = os.path.join(_REPO_ROOT, "native", "dsen2_host.cpp")
_SO = os.path.join(_REPO_ROOT, "build", "native", "libdsen2_host.so")

_i64 = ctypes.c_int64
_f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
_i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")


def _build() -> Optional[str]:
    if not os.path.exists(_SRC):
        return None
    if os.path.exists(_SO) and os.path.getmtime(_SO) >= os.path.getmtime(_SRC):
        return _SO
    # Concurrent builders (e.g. `parallel -j8 create_patches`) must not see a
    # half-written .so: link into a per-process temp file, then rename
    # atomically.
    tmp = f"{_SO}.build-{os.getpid()}"
    os.makedirs(os.path.dirname(_SO), exist_ok=True)
    cmd = [
        "g++", "-O3", "-std=c++17", "-fPIC", "-shared", "-pthread",
        "-march=native", _SRC, "-o", tmp,
    ]
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=120)
        os.replace(tmp, _SO)
        return _SO
    except (subprocess.SubprocessError, FileNotFoundError, OSError) as e:
        warnings.warn(f"native build failed ({e}); using numpy fallbacks")
        try:
            os.unlink(tmp)
        except OSError:
            pass
        return None


def get_lib() -> Optional[ctypes.CDLL]:
    global _lib, _tried
    with _lock:
        if _tried:
            return _lib
        _tried = True
        path = _build()
        if path is None:
            return None
        try:
            lib = ctypes.CDLL(path)
            lib.dsen2_host_abi_version.restype = ctypes.c_int32
            if lib.dsen2_host_abi_version() != 1:
                warnings.warn("native ABI mismatch; using numpy fallbacks")
                return None
        except OSError as e:
            warnings.warn(f"native library failed to load ({e}); using numpy fallbacks")
            return None
        lib.dsen2_symmetric_pad_f32.argtypes = [_f32p, _i64, _i64, _i64, _i64, _f32p]
        lib.dsen2_extract_patches_f32.argtypes = [
            _f32p, _i64, _i64, _i64, _i32p, _i64, _i64, _f32p,
        ]
        lib.dsen2_recompose_f32.argtypes = [
            _f32p, _i64, _i64, _i64, _i64, _i32p, _i64, _i64, _f32p,
        ]
        lib.dsen2_pad_extract_f32.argtypes = [
            _f32p, _i64, _i64, _i64, _i64, _i32p, _i64, _i64, _f32p,
        ]
        _lib = lib
        return _lib


def native_available() -> bool:
    return get_lib() is not None


def symmetric_pad(img: np.ndarray, border: int) -> np.ndarray:
    """np.pad(img, border, mode='symmetric') for HWC f32, threaded."""
    img = np.ascontiguousarray(img, np.float32)
    lib = get_lib()
    if lib is None:
        return np.pad(img, ((border, border), (border, border), (0, 0)), mode="symmetric")
    h, w, c = img.shape
    out = np.empty((h + 2 * border, w + 2 * border, c), np.float32)
    lib.dsen2_symmetric_pad_f32(img, h, w, c, border, out)
    return out


def pad_extract_host(img: np.ndarray, starts: np.ndarray, patch: int, border: int) -> np.ndarray:
    """Fused symmetric-pad + halo-patch extraction (starts in padded
    coordinates), threaded; numpy fallback pads then slices."""
    img = np.ascontiguousarray(img, np.float32)
    starts = np.ascontiguousarray(starts, np.int32)
    h, w, c = img.shape
    n = starts.shape[0]
    lib = get_lib()
    if lib is None:
        padded = np.pad(img, ((border, border), (border, border), (0, 0)), mode="symmetric")
        out = np.empty((n, patch, patch, c), np.float32)
        for k, (i, j) in enumerate(starts):
            out[k] = padded[i : i + patch, j : j + patch]
        return out
    out = np.empty((n, patch, patch, c), np.float32)
    lib.dsen2_pad_extract_f32(img, h, w, c, border, starts, n, patch, out)
    return out


def extract_patches_host(padded: np.ndarray, starts: np.ndarray, patch: int) -> np.ndarray:
    padded = np.ascontiguousarray(padded, np.float32)
    starts = np.ascontiguousarray(starts, np.int32)
    h, w, c = padded.shape
    n = starts.shape[0]
    lib = get_lib()
    if lib is None:
        out = np.empty((n, patch, patch, c), np.float32)
        for k, (i, j) in enumerate(starts):
            out[k] = padded[i : i + patch, j : j + patch]
        return out
    out = np.empty((n, patch, patch, c), np.float32)
    lib.dsen2_extract_patches_f32(padded, h, w, c, starts, n, patch, out)
    return out


def recompose_host(
    patches: np.ndarray, border: int, out_hw, positions: np.ndarray
) -> np.ndarray:
    """Border-crop mosaic with the reference's last-write-wins order,
    threaded over output rows."""
    patches = np.ascontiguousarray(patches, np.float32)
    positions = np.ascontiguousarray(positions, np.int32)
    n, p, _, c = patches.shape
    h, w = int(out_hw[0]), int(out_hw[1])
    lib = get_lib()
    if lib is None:
        s = p - 2 * border
        out = np.zeros((h, w, c), np.float32)
        for k in range(positions.shape[0]):
            y, x = positions[k]
            out[y : y + s, x : x + s] = patches[k, border : p - border, border : p - border]
        return out
    out = np.zeros((h, w, c), np.float32)
    lib.dsen2_recompose_f32(patches, positions.shape[0], p, c, border, positions, h, w, out)
    return out
