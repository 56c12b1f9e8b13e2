"""Build and load the hand-written CUDA kernels (``csrc/*.cu``).

Each source is compiled by ``nvcc`` for ``sm_90a`` into its own shared
library with a plain C interface, at first use, under ``build/kernels/``
beside the package (``.gitignore`` lists it).  The libraries are loaded
with ``ctypes``: every pointer and the stream cross as ``c_void_p``, and
each C entry returns ``cudaGetLastError()``, which :func:`check` turns into
an exception.  Nothing here runs at import time, so the CPU tests import
every module of the port without a compiler.

A library's file name carries a hash of its sources and flags, so an edited
kernel is rebuilt and a stale one is never loaded.  ``build_all`` starts one
``nvcc`` per source, all together.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

_CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

# the C dtype codes of csrc/common.cuh::vt::DType
DTYPE_CODES = {"float32": 0, "bfloat16": 1}

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_F = ctypes.c_float

# source stem -> {C function: argtypes}; every function returns int
SIGNATURES = {
    "groupnorm_silu": {
        "vt_gn_stats": [_P, _I, _I, _L, _I, _I, _I, _P, _P, _F, _P, _P, _P,
                        _P, _P, _P],
        "vt_gn_apply": [_P, _I, _I, _L, _I, _P, _P, _P, _I, _P],
    },
    "groupnorm_silu_vec": {
        "vt_gn_stats_vec": [_P, _I, _I, _L, _I, _I, _I, _I, _I, _I, _P, _P,
                            _F, _P, _P, _P, _P, _P, _P, _P],
        "vt_gn_apply_vec": [_P, _I, _I, _L, _I, _I, _I, _I, _I, _P, _P, _P,
                            _I, _P],
    },
    "groupnorm_silu_bwd": {
        "vt_gn_bwd_blocks_per_sm": [_I, _I, _I, _P],
        "vt_gn_bwd_reduce": [_P, _P, _I, _I, _L, _I, _I, _I, _I, _I, _I, _P,
                             _P, _P, _P, _P, _F, _I, _I, _P, _P, _P, _P, _P,
                             _P, _P, _P, _P, _P, _P, _P],
        "vt_gn_bwd_apply": [_P, _P, _I, _I, _L, _I, _I, _I, _I, _I, _P, _P,
                            _P, _P, _I, _P, _P],
    },
    "rms_norm": {
        "vt_rms_stats": [_P, _I, _L, _I, _F, _P, _P],
        "vt_rms_apply": [_P, _I, _L, _I, _P, _P, _P, _I, _P],
    },
    "gn_silu_conv3x3": {
        "vt_gn_silu_conv3x3": [_P, _I, _I, _I, _I, _I, _I, _P, _P, _P, _P,
                               _P, _I, _P, _P, _P, _P],
    },
    "gn_silu_conv3x3_tc": {
        "vt_gn_silu_conv3x3_tc": [_P, _I, _I, _I, _I, _I, _I, _P, _P, _P,
                                  _P, _P, _I, _P, _P, _P, _P],
        "vt_rms_silu_conv3x3_tc": [_P, _I, _I, _I, _I, _I, _I, _P, _P, _P,
                                   _P, _P, _I, _P, _P, _P, _P],
        "vt_gn_silu_conv3x3_tc_attrs": [_I, _I, _P],
        "vt_rms_silu_conv3x3_tc_attrs": [_I, _I, _P],
    },
    "gn_silu_conv3x3_tf32x3": {
        "vt_gn_silu_conv3x3_tf32x3": [_P, _I, _I, _I, _I, _I, _P, _P, _P, _P,
                                      _I, _P, _P, _P, _P, _P],
        "vt_gn_silu_conv3x3_tf32x3_attrs": [_I, _I, _P],
    },
    "flash_attention_fwd": {
        "vt_flash_attn_fwd": [_P, _P, _P, _I, _I, _I, _I, _I, _F, _P, _P,
                              _P],
    },
    "flash_attention_fwd_tc": {
        "vt_flash_attn_fwd_tc": [_P, _P, _P, _I, _I, _I, _I, _I, _F, _P, _P,
                                 _P],
        "vt_flash_attn_fwd_tc_attrs": [_I, _P],
    },
    "flash_attention_fwd_tf32x3": {
        "vt_flash_attn_fwd_tf32x3": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                                     _F, _P, _P, _P],
        "vt_flash_attn_fwd_tf32x3_attrs": [_I, _P],
    },
    "flash_attention_bwd": {
        "vt_flash_attn_bwd_dq": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                                 _F, _P, _P],
        "vt_flash_attn_bwd_dkv": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                                  _I, _F, _P, _P, _P],
    },
    "flash_attention_bwd_tc": {
        "vt_flash_attn_bwd_dq_tc": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                                    _I, _F, _P, _P],
        "vt_flash_attn_bwd_dkv_tc": [_P, _P, _P, _P, _P, _P, _I, _I, _I,
                                     _I, _I, _F, _P, _P, _P],
        "vt_flash_attn_bwd_dq_tc_attrs": [_P],
        "vt_flash_attn_bwd_dkv_tc_attrs": [_P],
    },
    "flash_attention_bwd_tf32x3": {
        "vt_flash_attn_bwd_dq_tf32x3": [_P, _P, _P, _P, _P, _P, _P, _P, _P,
                                        _P, _I, _I, _I, _I, _I, _F, _P, _P],
        "vt_flash_attn_bwd_dkv_tf32x3": [_P, _P, _P, _P, _P, _P, _P, _P, _P,
                                         _P, _P, _P, _I, _I, _I, _I, _I, _F,
                                         _P, _P, _P],
        "vt_flash_attn_bwd_dq_tf32x3_attrs": [_P],
        "vt_flash_attn_bwd_dkv_tf32x3_attrs": [_P],
    },
}

_LIBS: dict = {}
_LOCK = threading.Lock()
# per-source build record: seconds and the compiler's resource report
BUILD_LOG: dict = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = Path(cuda) / "bin" / "nvcc"
    if path.exists():
        return str(path)
    raise RuntimeError("nvcc not found: the CUDA kernels are built on a "
                       "machine with the CUDA toolkit (CUDA_HOME or PATH)")


def _lib_path(stem: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(_CSRC.glob("*.cuh")) + [_CSRC / f"{stem}.cu"]:
        h.update(src.read_bytes())
    return BUILD_DIR / f"lib{stem}-{h.hexdigest()[:16]}.so"


def _start(stem: str):
    """Start nvcc for one source; returns (process, tmp, final, t0) or None
    when the library is already built."""
    final = _lib_path(stem)
    if final.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = final.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-I", str(_CSRC), "-o", str(tmp),
           str(_CSRC / f"{stem}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp, final, time.perf_counter()


def _finish(stem: str, started) -> None:
    proc, tmp, final, t0 = started
    log, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {stem}.cu:\n{log}")
    os.replace(tmp, final)  # atomic: a concurrent loader never sees half
    BUILD_LOG[stem] = {"seconds": time.perf_counter() - t0, "log": log}


def build_all() -> dict:
    """Compile every kernel source that is not built yet, one nvcc process
    per source, all running together; returns BUILD_LOG.  Every process
    is waited for before a failure is raised."""
    with _LOCK:
        started = {s: _start(s) for s in SIGNATURES}
        errors = []
        for stem, st in started.items():
            if st is None:
                continue
            try:
                _finish(stem, st)
            except RuntimeError as e:
                errors.append(str(e))
        if errors:
            raise RuntimeError("\n".join(errors))
    return BUILD_LOG


def lib(stem: str):
    """The loaded ctypes library of ``csrc/<stem>.cu``, built if needed."""
    with _LOCK:
        if stem in _LIBS:
            return _LIBS[stem]
        st = _start(stem)
        if st is not None:
            _finish(stem, st)
        handle = ctypes.CDLL(str(_lib_path(stem)))
        for fn, argtypes in SIGNATURES[stem].items():
            f = getattr(handle, fn)
            f.argtypes = argtypes
            f.restype = ctypes.c_int
        _LIBS[stem] = handle
        return handle


def dtype_code(t) -> int:
    """The C dtype code of a tensor; raises for a dtype no kernel takes."""
    code = DTYPE_CODES.get(str(t.dtype).removeprefix("torch."))
    if code is None:
        raise TypeError(f"CUDA kernels take float32 or bfloat16, got {t.dtype}")
    return code


def check_tma_aligned(*tensors) -> None:
    """Raise unless every given tensor (None skipped) starts on a 16-byte
    boundary: a TMA tensor map refuses any other base address."""
    for t in tensors:
        if t is not None and t.data_ptr() % 16:
            raise ValueError(f"a tensor-core kernel's operand must be "
                             f"16-byte aligned, got address "
                             f"{t.data_ptr():#x} ({tuple(t.shape)})")


def on_tensor_device(fn):
    """Run the kernel launch ``fn`` with the device of its first tensor
    argument current: ``<<<...>>>`` and ``cudaFuncSetAttribute`` act on
    the calling thread's current device, not on the device of the stream
    handed to them, so a replica on ``cuda:1`` launching while ``cuda:0``
    is current would fail with an invalid handle or worse."""
    @functools.wraps(fn)
    def launch(*args, **kwargs):
        import torch

        t = next(a for a in args if isinstance(a, torch.Tensor))
        with torch.cuda.device(t.device):
            return fn(*args, **kwargs)

    return launch


def stream_of(t) -> int:
    """The raw handle of PyTorch's current stream on t's device."""
    import torch

    return torch.cuda.current_stream(t.device).cuda_stream


def check(code: int, what: str) -> None:
    """Raise when a C entry returned a CUDA error (a refused launch never
    runs, and a later synchronize would not report it)."""
    if code != 0:
        raise RuntimeError(f"{what}: cudaError_t {code} (see "
                           f"cuda_runtime_api.h for the name)")
