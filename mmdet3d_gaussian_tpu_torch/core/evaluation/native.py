"""ctypes loader for the native eval ops (``csrc/eval_ops.cpp``, host code).

Port of ``mmdet3d_gaussian_tpu/core/evaluation/native.py`` with its own copy
of the C++ source.  At first use ``g++`` compiles it into the checkout's
``build/`` directory (named by a hash of the source and flags, so a later
process reuses it).  Where there is no toolchain, :func:`available` is
false and the callers take the numpy versions (``geometry_np``,
``matcher.match_coco_np``): this is host code, not a device kernel.  With
``MMDET3D_TPU_REQUIRE_NATIVE=1`` in the environment the affinity
calculators and the matcher raise instead (:func:`refuse_fallback`), as in
the JAX package.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import Optional

import numpy as np

SOURCE = Path(__file__).resolve().parents[2] / 'csrc' / 'eval_ops.cpp'
BUILD_DIR = (Path(__file__).resolve().parents[3] / 'build'
             / 'mmdet3d_gaussian_tpu_torch' / 'eval_ops')
# the flags of the repository's csrc/Makefile less -march=native, so a
# library built on one x86-64 host loads on another (ISO C++17 mode keeps
# floating-point contraction off either way)
CXX_FLAGS = ['-O3', '-fPIC', '-shared', '-std=c++17']
# set to 1: the evaluators raise where they would fall back to numpy
REQUIRE_ENV = 'MMDET3D_TPU_REQUIRE_NATIVE'

_lib: Optional[ctypes.CDLL] = None
_error: Optional[BaseException] = None


def library_path() -> Path:
    h = hashlib.sha256(SOURCE.read_bytes())
    h.update(repr(CXX_FLAGS).encode())
    return BUILD_DIR / f'libeval_ops_{h.hexdigest()[:16]}.so'


def _build(so: Path) -> None:
    cxx = shutil.which('g++')
    if cxx is None:
        raise OSError('no C++ compiler (g++) to build the eval ops')
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix='.so', dir=BUILD_DIR)
    os.close(fd)
    try:
        subprocess.run([cxx, *CXX_FLAGS, '-o', tmp, str(SOURCE)],
                       check=True, capture_output=True, timeout=600)
        os.replace(tmp, so)     # atomic: concurrent builders are safe
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


def _load() -> ctypes.CDLL:
    """The library, built first if missing; raises ``OSError`` or
    ``subprocess.CalledProcessError`` when it cannot be built or loaded."""
    global _lib, _error
    if _lib is not None:
        return _lib
    if _error is not None:
        raise _error
    try:
        so = library_path()
        if not so.exists():
            _build(so)
        lib = ctypes.CDLL(str(so))
    except (OSError, subprocess.SubprocessError) as e:
        _error = e
        raise
    f32p = np.ctypeslib.ndpointer(np.float32, flags='C_CONTIGUOUS')
    i32p = np.ctypeslib.ndpointer(np.int32, flags='C_CONTIGUOUS')
    u8p = np.ctypeslib.ndpointer(np.uint8, flags='C_CONTIGUOUS')
    i8p = np.ctypeslib.ndpointer(np.int8, flags='C_CONTIGUOUS')
    for name in ('iou_bev', 'iou_3d', 'match_coco', 'riou5', 'kitti_stats'):
        getattr(lib, name).restype = None
    lib.iou_bev.argtypes = [f32p, ctypes.c_int64, f32p, ctypes.c_int64, f32p]
    lib.iou_3d.argtypes = [f32p, ctypes.c_int64, f32p, ctypes.c_int64,
                           ctypes.c_float, f32p]
    lib.match_coco.argtypes = [f32p, ctypes.c_int64, ctypes.c_int64, f32p,
                               ctypes.c_int64, u8p, u8p, i32p]
    lib.riou5.argtypes = [f32p, ctypes.c_int64, f32p, ctypes.c_int64,
                          ctypes.c_int32, f32p]
    lib.kitti_tp_scores.restype = ctypes.c_int64
    lib.kitti_tp_scores.argtypes = [f32p, f32p, i8p, ctypes.c_int64, i8p,
                                    ctypes.c_int64, ctypes.c_float, f32p]
    lib.kitti_stats.argtypes = [f32p, f32p, i8p, ctypes.c_int64, i8p,
                                ctypes.c_int64, f32p, ctypes.c_int64,
                                ctypes.c_float, f32p, ctypes.c_int64, i32p]
    _lib = lib
    return lib


def available() -> bool:
    """Whether the library is built and loaded (building it if needed)."""
    try:
        _load()
    except (OSError, subprocess.SubprocessError):
        return False
    return True


def refuse_fallback(what: str) -> None:
    """Raise ``RuntimeError`` where ``MMDET3D_TPU_REQUIRE_NATIVE=1`` asks
    for the native library and the caller is about to take its numpy
    version of ``what`` instead."""
    if os.environ.get(REQUIRE_ENV) == '1':
        raise RuntimeError(
            f'{REQUIRE_ENV}=1 but the eval ops library ({SOURCE.name}) failed '
            f'to build or load; refusing the numpy {what}, orders of '
            f'magnitude slower at val-set scale')


def iou_bev(det: np.ndarray, gt: np.ndarray) -> np.ndarray:
    lib = _load()
    det = np.ascontiguousarray(det, np.float32)
    gt = np.ascontiguousarray(gt, np.float32)
    out = np.empty((len(det), len(gt)), np.float32)
    lib.iou_bev(det, len(det), gt, len(gt), out)
    return out


def iou_3d(det: np.ndarray, gt: np.ndarray,
           z_offset: float = 0.5) -> np.ndarray:
    lib = _load()
    det = np.ascontiguousarray(det, np.float32)
    gt = np.ascontiguousarray(gt, np.float32)
    out = np.empty((len(det), len(gt)), np.float32)
    lib.iou_3d(det, len(det), gt, len(gt), z_offset, out)
    return out


def match_coco_native(cost: np.ndarray, thrs: np.ndarray,
                      is_ignore: np.ndarray,
                      is_crowd: np.ndarray) -> np.ndarray:
    lib = _load()
    cost = np.ascontiguousarray(cost, np.float32)
    thrs = np.ascontiguousarray(thrs, np.float32)
    ig = np.ascontiguousarray(is_ignore, np.uint8)
    cr = np.ascontiguousarray(is_crowd, np.uint8)
    out = np.empty((len(thrs), cost.shape[0]), np.int32)
    lib.match_coco(cost, cost.shape[0], cost.shape[1], thrs, len(thrs),
                   ig, cr, out)
    return out
