"""Build the port's CUDA kernels with nvcc and load them through ctypes.

Each source under `smpl_nerf_tpu_torch/csrc/` becomes its own shared library
with a plain C interface (no PyTorch headers, so a build takes seconds):

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
         -Xcompiler -fPIC -o build/torch_kernels/lib<name>-<hash>.so csrc/<name>.cu

`--use_fast_math` is deliberately absent: the in-kernel encoding evaluates
sin at arguments up to 2^9 * |x|, where `__sinf` is badly wrong.

Libraries go to `build/torch_kernels/` at the repo root, named by a hash of
the source, the shared headers (`csrc/*.cuh`) and the flags, so an edited source is rebuilt and never mixed with a
stale library. The build happens at first use; `build_all()` starts one nvcc
per source, all at once, for callers that want the build up front. Each
build or first load is an `ops.load` span (`tracing`).
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Iterable, Optional

import torch

from smpl_nerf_tpu_torch import tracing

PACKAGE_DIR = Path(__file__).resolve().parents[1]
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR.parent / "build" / "torch_kernels"
SOURCES = ("sample_pdf", "fused_mlp_v2_fwd", "fused_mlp_fwd", "fused_mlp_v2_bwd",
           "expert_tiles", "relu_matmul", "vertex_attention", "relu_attention")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")

_LIBS: Dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    candidate = os.path.join(cuda_home, "bin", "nvcc")
    if os.path.exists(candidate):
        return candidate
    raise RuntimeError("nvcc not found (looked on PATH, $CUDA_HOME/bin and "
                       "/usr/local/cuda/bin); the CUDA kernels build only on a "
                       "machine with the CUDA toolkit")


def library_path(name: str) -> Path:
    # the shared headers count too: an edited .cuh rebuilds every kernel
    sources = [CSRC_DIR / f"{name}.cu", *sorted(CSRC_DIR.glob("*.cuh"))]
    digest = hashlib.sha256(b"".join(p.read_bytes() for p in sources)
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}-{digest[:12]}.so"


def _start(name: str) -> Optional[subprocess.Popen]:
    """Start nvcc for one source unless its library is already built."""
    target = library_path(name)
    if target.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = target.with_name(f"{target.name}.{os.getpid()}.tmp")
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC_DIR / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    proc.target, proc.tmp = target, tmp
    return proc


def _finish(name: str, proc: subprocess.Popen) -> str:
    log, _ = proc.communicate()
    if proc.returncode != 0:
        proc.tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed to build {name}.cu:\n{log}")
    os.replace(proc.tmp, proc.target)   # atomic: a concurrent reader sees all or nothing
    (BUILD_DIR / f"{name}.log").write_text(log)
    return log


def build_all(names: Iterable[str] = SOURCES) -> Dict[str, str]:
    """Build every named kernel in parallel; returns {name: nvcc output}.

    Already-built libraries are skipped (their output is the saved log).
    """
    with tracing.span("ops.load"):
        procs = {name: _start(name) for name in names}
        logs = {}
        for name, proc in procs.items():
            if proc is None:
                log_file = BUILD_DIR / f"{name}.log"
                logs[name] = log_file.read_text() if log_file.exists() else ""
            else:
                logs[name] = _finish(name, proc)
    return logs


def load(name: str) -> ctypes.CDLL:
    """The kernel library `name`, built on first use."""
    lib = _LIBS.get(name)
    if lib is None:
        with tracing.span("ops.load"):
            proc = _start(name)
            if proc is not None:
                _finish(name, proc)
            lib = ctypes.CDLL(str(library_path(name)))
        lib.kernel_error_string.argtypes = [ctypes.c_int]
        lib.kernel_error_string.restype = ctypes.c_char_p
        _LIBS[name] = lib
    return lib


def current_stream(device) -> int:
    """The raw handle of PyTorch's current stream on `device`, for a launch.

    `torch.cuda.current_stream(device).cuda_stream` builds a Stream object
    per call, which takes as much host time as the small kernels' device
    time; the binding that PyTorch's own generated code calls returns the
    handle directly."""
    return torch._C._cuda_getCurrentRawStream(device.index)


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise if a launch returned a CUDA error (cudaGetLastError after launch)."""
    if err != 0:
        raise RuntimeError(f"{what} kernel launch failed: CUDA error {err} "
                           f"({lib.kernel_error_string(err).decode()})")
