"""Build, load and launch the port's hand-written CUDA kernels.

At first use every ``csrc/*.cu`` of this package is compiled by its own
``nvcc`` process (all started together) for ``sm_90a``, and the objects
are linked into one shared library under the checkout's ``build/``
directory, named by a hash of the sources and flags, so a later process
reuses it.  The library has a plain C interface (``extern "C"`` launchers
taking device pointers, sizes, the device index and a stream; no PyTorch
headers), so a build takes seconds, and is bound with ``ctypes``.

Every launch goes through :func:`launch`, which raises when the launcher
reports an error (``cudaGetLastError`` after the launch) and otherwise adds
one to the kernel's count in :data:`LAUNCHES`.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import tempfile
import time
from pathlib import Path
from typing import Dict, Optional, Sequence, Tuple, Union

import torch

CSRC = Path(__file__).resolve().parent.parent / 'csrc'
BUILD_DIR = (Path(__file__).resolve().parents[2] / 'build'
             / 'mmdet3d_gaussian_tpu_torch')
ARCH = ['-gencode', 'arch=compute_90a,code=sm_90a']
NVCC_FLAGS = ARCH + ['-std=c++17', '-O3', '-Xcompiler', '-fPIC',
                     '-Xptxas', '-v']
# rotated IoU and the GD loss mirror the plain version's rounding, so no
# fused multiply-add: the shoelace terms of the IoU and the KL terms of the
# loss (sums near 1.5, then sqrt near 0) cancel, and a contracted product
# shifts the result well past the tolerances.
SOURCE_FLAGS = {'rotated_iou.cu': ['--fmad=false'],
                'gd_loss.cu': ['--fmad=false']}

_P, _I, _LL, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, \
    ctypes.c_float
_GD_CFG = [_I, _I, _F, _F, _F, _F, _F]   # loss type, fun, tau, alpha, offset
# kernel name -> (C launcher, argtypes after the leading device index; the
# stream is appended by launch())
KERNELS = {
    'segment_reduce': ('segment_reduce_launch',
                       [_P, _P, _P, _P, _I, _I, _I, _I]),
    'segment_reduce_mapback': ('segment_mapback_launch',
                               [_P, _P, _P, _P, _I, _I, _I, _I, _I]),
    'segment_max_winner': ('segment_max_winner_launch',
                           [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I]),
    'bev_splat': ('bev_splat_launch', [_P, _P, _P, _I, _I, _LL, _I]),
    'bev_splat_pairs': ('bev_splat_pairs_launch',
                        [_P, _P, _P, _P, _I, _I, _LL, _I]),
    'rotated_iou': ('rotated_iou_launch', [_P, _P, _I, _I]),
    'nms_sweep': ('nms_sweep_launch', [_P, _P, _P, _P, _I, _I, _F]),
    'bn_moments': ('bn_moments_launch',
                   [_P, _LL, _I] + [_LL] * 4 + [_I] + [_LL] * 4
                   + [_P, _P, _P, _I]),
    'bn_grad_moments': ('bn_grad_moments_launch',
                        [_P, _P, _P, _P, _LL, _I] + [_LL] * 7 + [_I]
                        + [_LL] * 4 + [_P, _P, _P, _I]),
    'gd_loss_fwd': ('gd_loss_fwd_launch',
                    [_P, _LL, _P, _P, _P, _LL, _I, _I] + _GD_CFG
                    + [_P, _I, _P, _P]),
    'gd_loss_bwd': ('gd_loss_bwd_launch',
                    [_P, _P, _LL, _P, _P, _P, _LL, _I, _I] + _GD_CFG
                    + [_P]),
    # does nothing: the device time of a launch, the floor of the kernels
    # whose bytes take less
    'empty': ('empty_launch', []),
}

# queries that launch nothing: name -> (C function, argtypes after the
# leading device index)
QUERIES = {
    'bev_splat_plan': ('bev_splat_plan', [_P, _P, _I, _LL, _I, _I, _P]),
}

LAUNCHES: Dict[str, int] = {name: 0 for name in KERNELS}

_lib: Optional[ctypes.CDLL] = None
BUILD_INFO: Dict[str, object] = {}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _nvcc() -> str:
    found = shutil.which('nvcc')
    if found:
        return found
    cuda_home = os.environ.get('CUDA_HOME', '/usr/local/cuda')
    return str(Path(cuda_home) / 'bin' / 'nvcc')


def _tag(sources: Sequence[Path]) -> str:
    h = hashlib.sha256()
    for p in sources:
        h.update(p.name.encode())
        h.update(p.read_bytes())
    h.update(repr((NVCC_FLAGS, sorted(SOURCE_FLAGS.items()))).encode())
    return h.hexdigest()[:16]


def _compile(so: Path) -> str:
    """Compile every source in parallel, link, move into place; returns
    the ptxas report."""
    sources = sorted(CSRC.glob('*.cu'))
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = Path(tempfile.mkdtemp(dir=BUILD_DIR))
    try:
        jobs = []
        for src in sources:
            obj = tmp / (src.stem + '.o')
            cmd = [nvcc, *NVCC_FLAGS, *SOURCE_FLAGS.get(src.name, []),
                   '-c', str(src), '-o', str(obj)]
            jobs.append((src, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                text=True)))
        report, failed = [], []
        for src, _obj, proc in jobs:
            out, err = proc.communicate()
            report.append(f'== {src.name}\n{out}{err}')
            if proc.returncode:
                failed.append(f'nvcc failed on {src.name}:\n{err}')
        if failed:
            raise RuntimeError('\n'.join(failed))
        lib_tmp = tmp / so.name
        link = subprocess.run(
            [nvcc, *ARCH, '-shared', '-o', str(lib_tmp)]
            + [str(obj) for _src, obj, _p in jobs],
            capture_output=True, text=True)
        if link.returncode:
            raise RuntimeError(f'nvcc link failed:\n{link.stderr}')
        text = '\n'.join(report)
        # several processes (the ranks of a job) may build at once: each
        # in its own directory, each file moved into place whole, the log
        # before the library that a later process takes as the sign of a
        # finished build
        log_tmp = tmp / so.with_suffix('.log').name
        log_tmp.write_text(text)
        os.replace(log_tmp, so.with_suffix('.log'))
        os.replace(lib_tmp, so)
        return text
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def ptxas_summary(report: str) -> Dict[str, str]:
    """Kernel (mangled name) -> 'N registers, S bytes spill stores, ...'."""
    out, current = {}, None
    for line in report.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            current = m.group(1)
            continue
        if current and ('registers' in line or 'spill' in line):
            text = line.split('ptxas info    :')[-1].strip()
            out[current] = (out[current] + '; ' + text) if current in out \
                else text
    return out


def library() -> ctypes.CDLL:
    """The kernel library, built at the first call of the process."""
    global _lib
    if _lib is not None:
        return _lib
    sources = sorted(CSRC.glob('*.cu')) + sorted(CSRC.glob('*.cuh'))
    so = BUILD_DIR / f'libkernels_{_tag(sources)}.so'
    t0 = time.perf_counter()
    if so.exists():
        report = so.with_suffix('.log').read_text()
        built = False
    else:
        report = _compile(so)
        built = True
    lib = ctypes.CDLL(str(so))
    for name, (symbol, argtypes) in KERNELS.items():
        fn = getattr(lib, symbol)
        fn.argtypes = [_I] + argtypes + [_P]
        fn.restype = _I
    for name, (symbol, argtypes) in QUERIES.items():
        fn = getattr(lib, symbol)
        fn.argtypes = [_I] + argtypes
        fn.restype = _I
    lib.kernels_error_string.argtypes = [_I]
    lib.kernels_error_string.restype = ctypes.c_char_p
    BUILD_INFO.update(path=str(so), built=built,
                      seconds=time.perf_counter() - t0, ptxas=report)
    _lib = lib
    return lib


def launch(name: str, device: torch.device, *args,
           stream: Optional[int] = None) -> None:
    """Launch kernel ``name`` on ``stream`` (default: ``device``'s current
    stream); raise on a refused launch, count it otherwise."""
    lib = library()
    symbol = KERNELS[name][0]
    if stream is None:
        stream = torch.cuda.current_stream(device).cuda_stream
    err = getattr(lib, symbol)(device.index if device.index is not None
                               else torch.cuda.current_device(),
                               *args, stream)
    if err:
        msg = lib.kernels_error_string(err).decode()
        raise RuntimeError(f'CUDA kernel {name} failed to launch: {msg} '
                           f'(error {err})')
    LAUNCHES[name] += 1


def query(name: str, device: torch.device, *args) -> None:
    """Call query ``name`` of :data:`QUERIES` for ``device``; raise on an
    error.  Launches nothing and counts nothing."""
    lib = library()
    err = getattr(lib, QUERIES[name][0])(
        device.index if device.index is not None
        else torch.cuda.current_device(), *args)
    if err:
        msg = lib.kernels_error_string(err).decode()
        raise RuntimeError(f'CUDA query {name} failed: {msg} (error {err})')


# element types of the activations the kernels read (f32, or the
# mixed-precision model's bf16)
FLOAT_TYPES = (torch.float32, torch.bfloat16)


def check_tensor(t: torch.Tensor, name: str,
                 dtype: Union[torch.dtype, Tuple[torch.dtype, ...]],
                 shape: Sequence[Optional[int]]) -> None:
    """Raise unless ``t`` has ``dtype`` (or one of a tuple of them),
    ``len(shape)`` dims matching the non-None entries of ``shape``, and is
    contiguous."""
    if not isinstance(t, torch.Tensor):
        raise TypeError(f'{name} must be a tensor, got {type(t).__name__}')
    if t.dtype not in (dtype if isinstance(dtype, tuple) else (dtype,)):
        raise TypeError(f'{name} must be {dtype}, got {t.dtype}')
    if t.dim() != len(shape) or any(
            s is not None and s != d for s, d in zip(shape, t.shape)):
        raise ValueError(f'{name} must have shape {tuple(shape)} '
                         f'(None = any), got {tuple(t.shape)}')
    if not t.is_contiguous():
        raise ValueError(f'{name} must be contiguous')


def same_device(*tensors: torch.Tensor) -> torch.device:
    """The common device of ``tensors``; raise if they differ or if it is
    neither the CPU nor CUDA."""
    dev = tensors[0].device
    for t in tensors[1:]:
        if t.device != dev:
            raise ValueError(f'tensors on different devices: {dev} and '
                             f'{t.device}')
    if dev.type not in ('cpu', 'cuda'):
        raise ValueError(f'unsupported device {dev}')
    return dev
