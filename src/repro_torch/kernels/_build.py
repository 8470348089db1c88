"""Build, load and launch the hand-written CUDA kernels.

The sources under ``csrc/`` have a plain C interface. At first use they are
compiled for Hopper (``sm_90a``) by ``nvcc``, one process per source, all
started together, and linked into one shared library that is loaded with
``ctypes``. The build goes to ``build/repro_torch/`` at the root of the
checkout, keyed by a hash of the sources, so an unchanged tree reuses it.
Nothing here runs at import time: the CPU tests import every module on a
machine without ``nvcc``.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
COMPILE_FLAGS = ["-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas=-v"]

_P, _I, _F, _SZ = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_size_t
_LL = ctypes.c_longlong
# entry point -> (restype, argtypes); every pointer and the stream are c_void_p
_SIGNATURES = {
    "int8_matmul_launch": (_I, [_P] * 6 + [_I] * 3 + [_P]),
    "int8_matmul_mma_launch": (_I, [_P] * 6 + [_I] * 4 + [_P]),
    "int8_matmul_stream_launch": (_I, [_P] * 8 + [_I] * 5 + [_P]),
    "grouped_matmul_i8_launch": (_I, [_P, _P, _I] + [_P] * 4 + [_I] * 5 + [_P]),
    "grouped_matmul_f32_launch": (_I, [_P] * 4 + [_I] * 5 + [_P]),
    "grouped_wgrad_launch": (_I, [_P] * 4 + [_I] * 5 + [_P]),
    "quant_attention_launch": (_I, [_P] * 4 + [_I] * 9 + [_F, _P]),
    "lm_attention_launch": (_I, [_P] * 3 + [_I] + [_P] * 7 + [_I] * 11 + [_F] * 2
                            + [_I, _I, _P]),
    "lm_attention_smem_bytes": (_SZ, [_I] * 6),
    "selective_scan_launch": (_I, [_P] * 8 + [_I] * 7 + [_P]),
    "selective_scan_save_launch": (_I, [_P] * 9 + [_I] * 7 + [_P]),
    "selective_scan_lane_launch": (_I, [_P] * 8 + [_I] * 4 + [_P]),
    "selective_scan_bwd_launch": (_I, [_P] * 15 + [_I] * 6 + [_P]),
    "selective_scan_bwd_recompute_launch": (_I, [_P] * 15 + [_I] * 6 + [_P]),
    "selective_scan_bwd_blocks_per_sm": (_I, [_I] * 2),
    "rmsnorm_launch": (_I, [_P] * 3 + [_I] * 2 + [_LL] + [_I] * 2 + [_F, _P]),
}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = Path(cuda_home) / "bin" / "nvcc"
    if not path.exists():
        raise RuntimeError(f"nvcc not found on PATH or at {path}")
    return str(path)


def _sources():
    return sorted(CSRC.glob("*.cu")), sorted(CSRC.glob("*.cuh"))


def library_path() -> Path:
    cus, headers = _sources()
    digest = hashlib.sha256()
    for f in cus + headers:
        digest.update(f.name.encode())
        digest.update(f.read_bytes())
    return BUILD_DIR / f"librepro_torch_{digest.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile every ``csrc/*.cu`` in parallel and link the shared library;
    returns its path. Compiler output (``-Xptxas=-v``: registers, shared
    memory, spills per kernel) is kept beside it as ``<source>.log``."""
    lib = library_path()
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    cus, _ = _sources()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        procs = []
        for cu in cus:
            obj = Path(tmp) / (cu.stem + ".o")
            log = open(BUILD_DIR / (cu.stem + ".log"), "w")
            procs.append((cu, obj, log, subprocess.Popen(
                [nvcc, *ARCH_FLAGS, *COMPILE_FLAGS, "-c", str(cu), "-o", str(obj)],
                stdout=log, stderr=subprocess.STDOUT)))
        failed = []
        for cu, _, log, proc in procs:
            if proc.wait() != 0:
                failed.append(cu.name)
            log.close()
        if failed:
            raise RuntimeError(
                f"nvcc failed on {failed}; see the .log files in {BUILD_DIR}")
        staged = Path(tmp) / lib.name
        subprocess.run([nvcc, *ARCH_FLAGS, "-shared", "-o", str(staged),
                        *[str(obj) for _, obj, _, _ in procs]], check=True)
        os.replace(staged, lib)  # atomic: a concurrent build never sees half
    return lib


@functools.cache
def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first use)."""
    lib = ctypes.CDLL(str(build()))
    for name, (restype, argtypes) in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.restype = restype
        fn.argtypes = argtypes
    return lib


def check(err: int, kernel: str) -> None:
    """Raise on a nonzero ``cudaError_t`` returned by a launch entry."""
    if err != 0:
        raise RuntimeError(f"{kernel}: CUDA error {err} at launch")


def require_cuda(kernel: str, first: torch.Tensor, *others) -> None:
    """Every tensor argument of a launch lies on ``first``'s CUDA device
    (``None`` and Python scalars pass): a host pointer handed to a kernel
    would fault on the card."""
    if not first.is_cuda:
        raise ValueError(f"{kernel} launches a CUDA kernel: pass CUDA tensors")
    for t in others:
        if isinstance(t, torch.Tensor) and t.device != first.device:
            raise ValueError(f"{kernel}: operands on {t.device} and {first.device}")


def stream(t: torch.Tensor) -> int:
    """The current CUDA stream of ``t``'s device, as a launch argument."""
    return torch.cuda.current_stream(t.device).cuda_stream


def scalar(s, like: torch.Tensor) -> torch.Tensor:
    """A scale as a 1-element f32 tensor on ``like``'s device (kernels read
    scales through a device pointer, so no host sync is needed)."""
    return torch.as_tensor(s, dtype=torch.float32, device=like.device).reshape(1)
