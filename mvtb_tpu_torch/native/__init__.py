"""Native (C++) host-side components, ctypes-bound with a Python fallback
(counterpart of mvtb_tpu/native; the port's own copies of its sources).

Two host functions, no device code: the trilinear/nearest resampler behind
:func:`mvtb_tpu_torch.data.preprocess.resample_to_spacing` and the one-pass
NIfTI-1 decoder (gzip inflate fused with the dtype conversion) behind
:func:`mvtb_tpu_torch.data.nifti.read_nifti`.

The shared library is built at first use with ``g++ -O3 -shared -fPIC ...
-lz`` into ``build/mvtb_tpu_torch/native/`` at the root of the checkout,
named by a hash of the sources, so an edited source is rebuilt. Without a
compiler (or when the build fails) :func:`resample3d` and
:func:`nifti_read` return None and the callers run their scipy / Python
paths; :func:`available` says which one ran.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Optional

import numpy as np

_DIR = Path(__file__).resolve().parent
SRCS = (_DIR / "resample.cpp", _DIR / "nifti.cpp")
BUILD_DIR = _DIR.parent.parent / "build" / "mvtb_tpu_torch" / "native"
CXX_FLAGS = ("-O3", "-shared", "-fPIC")
_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_tried = False


def lib_path() -> Path:
    """The library's path, named by a hash of the sources and the flags."""
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    for src in SRCS:
        h.update(src.name.encode() + b"\0" + src.read_bytes())
    return BUILD_DIR / f"libmvtbnative-{h.hexdigest()[:16]}.so"


def _build(path: Path) -> bool:
    cxx = shutil.which("g++")
    if cxx is None:
        return False
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = BUILD_DIR / f".{path.name}.{os.getpid()}"
    cmd = [cxx, *CXX_FLAGS, *map(str, SRCS), "-o", str(tmp), "-lz"]
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=120)
    except (OSError, subprocess.SubprocessError):
        tmp.unlink(missing_ok=True)
        return False
    os.replace(tmp, path)
    return True


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        path = lib_path()
        if not path.is_file() and not _build(path):
            return None
        try:
            lib = ctypes.CDLL(str(path))
        except OSError:
            return None
        lib.nifti_read_header.argtypes = [
            ctypes.c_char_p, ctypes.POINTER(ctypes.c_double)]
        lib.nifti_read_header.restype = ctypes.c_int
        lib.nifti_read_f32.argtypes = [
            ctypes.c_char_p, ctypes.POINTER(ctypes.c_float), ctypes.c_int64]
        lib.nifti_read_f32.restype = ctypes.c_int
        lib.resample3d_f32.argtypes = [
            ctypes.POINTER(ctypes.c_float),                 # in
            ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
            ctypes.POINTER(ctypes.c_double),                # 3x4 map
            ctypes.POINTER(ctypes.c_float),                 # out
            ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_int,                                   # order
        ]
        lib.resample3d_f32.restype = None
        _lib = lib
        return _lib


def available() -> bool:
    """True when the native library is (or can be) loaded."""
    return _load() is not None


def resample3d(volume: np.ndarray, matrix: np.ndarray, out_shape,
               order: int) -> Optional[np.ndarray]:
    """Native channel-first 3D resample; None when the library is absent.

    ``matrix`` is the 3x4 output-voxel -> input-voxel affine map;
    semantics match ``scipy.ndimage.map_coordinates(order, mode='nearest')``
    with float64 interpolation arithmetic.
    """
    lib = _load()
    if lib is None:
        return None
    vol = np.ascontiguousarray(volume, np.float32)
    m = np.ascontiguousarray(matrix, np.float64).reshape(12)
    out = np.empty((vol.shape[0],) + tuple(int(n) for n in out_shape),
                   np.float32)
    lib.resample3d_f32(
        vol.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        vol.shape[0], vol.shape[1], vol.shape[2], vol.shape[3],
        m.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        out.shape[1], out.shape[2], out.shape[3],
        int(order),
    )
    return out


def nifti_read(path: str):
    """Native NIfTI-1 read -> (float32 Fortran-order array, 4x4 affine),
    or None when the library is absent or the file needs the Python path
    (big-endian, exotic dtype, NIfTI-2).

    One fused pass: gzip inflate -> dtype convert -> scl scaling, straight
    into the result buffer. Semantics match
    :func:`mvtb_tpu_torch.data.nifti.read_nifti`'s Python path, except the
    result dtype is always float32.
    """
    lib = _load()
    if lib is None:
        return None
    hdr = np.zeros(24, np.float64)
    rc = lib.nifti_read_header(
        path.encode(), hdr.ctypes.data_as(ctypes.POINTER(ctypes.c_double)))
    if rc != 0:
        if rc in (-3, -4):  # not LE NIfTI-1 / unsupported dtype
            return None
        raise OSError(f"native NIfTI header parse failed for {path} ({rc})")
    ndim = int(hdr[0])
    shape = tuple(int(d) for d in hdr[1:1 + ndim])
    n = int(np.prod(shape))
    flat = np.empty(n, np.float32)
    rc = lib.nifti_read_f32(
        path.encode(), flat.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        ctypes.c_int64(n))
    if rc != 0:
        raise OSError(f"native NIfTI decode failed for {path} ({rc})")
    data = flat.reshape(shape, order="F")
    affine = np.eye(4)
    affine[:3, :] = hdr[12:24].reshape(3, 4)
    if not np.isfinite(affine).all() or np.allclose(affine[:3, :3], 0):
        affine = np.eye(4)
    return data, affine
