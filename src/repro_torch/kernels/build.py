"""Build and load the port's CUDA kernels from the sources in the checkout.

``nvcc`` compiles each ``csrc/*.cu`` to an object, all sources at once in
parallel processes, and links them into one shared library with a plain C
interface at first use; :mod:`ctypes` loads it.  The sources include no
PyTorch header, so the build takes seconds rather than the minutes a
``torch/extension.h`` translation unit takes; the wrappers pass pointers
from ``Tensor.data_ptr()`` and PyTorch's current stream.

Flags: ``-gencode=arch=compute_90a,code=sm_90a`` (Hopper) and
``-fmad=false`` (the bitwise contract of ``rev_heun.cu``; the MLP,
attention and SSD kernels spell their multiply-adds as ``__fmaf_rn`` /
``__fma_rn``; the cross entropy's has none worth fusing); no ``--use_fast_math``, so ``sqrt``/``log1p``/``exp`` stay
IEEE.
The library lands in ``kernels/_build/`` (listed in .gitignore) under a
name hashed from the sources and flags, so an edited source rebuilds and
concurrent processes never load a half-written file.

A build or load failure raises :class:`KernelBuildError`.  Nothing here
falls back to the plain PyTorch versions.
"""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
ARCH_FLAG = "-gencode=arch=compute_90a,code=sm_90a"
NVCC_FLAGS = (ARCH_FLAG, "-fmad=false", "-O3", "-std=c++17", "-Xcompiler", "-fPIC")

_P, _I, _I64, _D = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64, ctypes.c_double
#: C signature of every entry point (all return cudaGetLastError(), but the
#: queries: those in INT64_RESULTS return an int64 count, and
#: rt_brownian_increment_unit its index path).
SIGNATURES = {
    "rt_brownian_increment": (_I, _P, _I64, _D, _P, _I64, _I64, _P),
    "rt_brownian_increment_unit": (_I, _I64, _I64, _I64, ctypes.POINTER(ctypes.c_int64)),
    "rt_graph_programmatic_edges": (_P,),
    "rt_brownian_value": (_I, _P, _P, _D, _D, _I, _P, _I64, _I64, _P),
    "rt_brownian_value_blocks": (_I, _I64, _I64),
    "rt_space_time_increment": (_I, _P, _I64, _D, _D, _P, _P, _I64, _I64, _P),
    "rt_space_time_value": (_I, _P, _P, _D, _D, _D, _D, _D, _I, _P, _P, _I64, _I64, _P),
    "rt_rev_heun_phase1_gen": (_I, _P, _P, _P, _P, _P, _I64, _D, _D, _D, _P, _P,
                               _I64, _I64, _P),
    "rt_brownian_increment_window": (_I, _P, _I64, _D, _P, _I64, _I64, _I64, _P),
    "rt_rev_heun_phase1_gen_window": (_I, _P, _P, _P, _P, _P, _I64, _D, _D, _D, _P, _P,
                                      _I64, _I64, _I64, _P),
    "rt_space_time_increment_window": (_I, _P, _I64, _D, _D, _P, _P, _I64, _I64, _I64, _P),
    "rt_rev_heun_phase1": (_I, _P, _P, _P, _P, _P, _D, _D, _P, _I64, _P),
    "rt_rev_heun_phase2": (_I, _P, _P, _P, _P, _P, _P, _D, _D, _P, _I64, _P),
    "rt_rev_heun_bwd_phase1": (_I, _P, _P, _P, _P, _D, _P, _P, _I64, _P),
    "rt_rev_heun_bwd_phase2": (_I, _P, _P, _P, _D, _P, _P, _P, _P, _I64, _P),
    "rt_flash_attention": (_I, _I, _P, _P, _P, _P, _I64, _I64, _I64, _I64, _I64, _I, _D, _P,
                           _P),
    "rt_ssd_chunk": (_I, _I, _I, _P, _P, _P, _P, _P, _P, _I64, _I64, _I64, _P, _I64, _P),
    "rt_ssd_chunk_slices": (_I, _I, _I, _I64),
    "rt_fused_mlp": (_I, _P, _P, _P, _P, _P, _P, _I64, _I, _I, _I, _P),
    "rt_fused_mlp_bwd": (_I, _P, _P, _P, _P, _P, _I64, _I64, _P, _P, _P, _P, _P, _P, _I64, _I64,
                         _I, _I, _I, _P),
    "rt_fused_mlp_bwd_plan": (_I, _I64, _I, _I, _I, ctypes.POINTER(ctypes.c_int64)),
    "rt_fused_mlp_bwd_clusters": (_I, _I64, _I, _I, _I),
    "rt_fused_xent_fwd": (_I, _P, _P, _P, _P, _I64, _I64, _P),
    "rt_fused_xent_bwd": (_I, _P, _P, _P, _P, _P, _I64, _I64, _P),
}
INT64_RESULTS = ("rt_brownian_value_blocks", "rt_ssd_chunk_slices",
                 "rt_fused_mlp_bwd_clusters", "rt_graph_programmatic_edges")

_lock = threading.Lock()
_lib = None


class KernelBuildError(RuntimeError):
    """nvcc is missing, the compile failed, or the library does not load."""


class KernelLaunchError(RuntimeError):
    """A kernel launch was refused (cudaGetLastError() != 0)."""


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    for cand in ([os.path.join(CUDA_HOME, "bin", "nvcc")] if CUDA_HOME else []) + [
            shutil.which("nvcc") or ""]:
        if cand and os.path.exists(cand):
            return cand
    raise KernelBuildError(
        "nvcc not found (no CUDA_HOME/bin/nvcc and none on PATH): the port's "
        "CUDA kernels are built from src/repro_torch/kernels/csrc at first use")


def _sources():
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def library_path() -> Path:
    h = hashlib.sha256()
    for p in _sources():
        h.update(p.name.encode())
        h.update(p.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"repro_torch_kernels_{h.hexdigest()[:16]}.so"


def _run_all(cmds):
    """Run the commands in parallel processes; raise on the first failure."""
    procs = [(cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                    text=True)) for cmd in cmds]
    failed = []
    for cmd, proc in procs:
        out, err = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n{out}\n{err}")
    if failed:
        raise KernelBuildError("\n".join(failed))


def build() -> Path:
    """Compile the kernels unless the hashed library exists; return its path."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        sources = sorted(CSRC.glob("*.cu"))
        objs = [os.path.join(tmp, p.stem + ".o") for p in sources]
        _run_all([[nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-c", "-o", o, str(p)]
                  for p, o in zip(sources, objs)])
        lib = os.path.join(tmp, out.name)
        _run_all([[nvcc, ARCH_FLAG, "-shared", "-o", lib, *objs]])
        os.replace(lib, out)
    return out


def load():
    """The loaded library (built at first call), with ctypes signatures set."""
    global _lib
    if _lib is not None:
        return _lib
    with _lock:
        if _lib is None:
            path = build()
            try:
                lib = ctypes.CDLL(str(path))
            except OSError as e:
                raise KernelBuildError(f"cannot load {path}: {e}") from e
            for name, argtypes in SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = list(argtypes)
                fn.restype = _I64 if name in INT64_RESULTS else ctypes.c_int
            _lib = lib
    return _lib


def device_guard(device):
    """Make ``device`` (a CUDA device or its index) current for a launch; a
    no-op when it already is (the single-card case), which saves the guard's
    cost on every launch."""
    index = device if isinstance(device, int) else device.index
    if index is None or index == torch.cuda.current_device():
        return contextlib.nullcontext()
    return torch.cuda.device(index)


def check(name: str, err: int) -> None:
    """Raise if a launch returned a CUDA error code."""
    if err != 0:
        raise KernelLaunchError(f"{name}: kernel launch failed with cudaError {err}")
