"""Inverse-CDF fine sampling as one CUDA kernel (csrc/sample_pdf.cu).

Replaces the TPU kernel smpl_nerf_tpu/ops/sample_pdf_pallas.py:sample_pdf_fused.
The plain PyTorch version is core/sampling.py:sample_pdf; both use the same
u = f * float32(1/(F-1)) (`sampling.fine_u`; the kernel's launcher divides
in float32 itself).

What bounds it on the H100: launch latency, not bytes or arithmetic (~1 KB
per ray at K=63, F=128). One warp per ray: the weights read once into
registers, a cdf that is non-decreasing by construction, and the inversion
as a merge (a binary search per lane, then a walk); see the source.

`sample_pdf_fused` takes the plain version for CPU tensors and launches the
kernel for CUDA tensors — it never falls back from CUDA to the plain version.
The wrapper makes its checks and nothing else per call: its host time is part
of every call's time, and on an H100 it is several times a 2048-ray call's
device time.
`launches` counts kernel launches.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from smpl_nerf_tpu_torch.core import sampling
from smpl_nerf_tpu_torch.ops import _build

MAX_BINS = 1024   # keeps a lane's run of weights in 32 registers (and shared memory small)
launches = 0


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load("sample_pdf")
    lib.sample_pdf_launch.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                                      ctypes.c_int, ctypes.c_int, ctypes.c_int,
                                      ctypes.c_void_p]
    lib.sample_pdf_launch.restype = ctypes.c_int
    return lib


def sample_pdf_cuda(bins: torch.Tensor, weights: torch.Tensor, n_fine: int) -> torch.Tensor:
    """Launch the kernel: bins [R, K], weights [R, K-1] (float32, CUDA) -> [R, n_fine]."""
    global launches
    device = bins.device
    if device.type != "cuda" or weights.device != device:
        raise ValueError(f"sample_pdf_cuda needs both inputs on one CUDA device, got "
                         f"{device} and {weights.device}")
    if bins.dtype != torch.float32 or weights.dtype != torch.float32:
        raise TypeError(f"sample_pdf_cuda takes float32, got {bins.dtype}, {weights.dtype}")
    if bins.dim() != 2 or weights.dim() != 2:
        raise ValueError("sample_pdf_cuda takes 2-D bins [R, K] and weights [R, K-1]")
    R, K = bins.shape
    if weights.shape != (R, K - 1) or not 2 <= K <= MAX_BINS:
        raise ValueError(f"bad shapes bins {tuple(bins.shape)} weights {tuple(weights.shape)} "
                         f"(need weights [R, K-1], 2 <= K <= {MAX_BINS})")
    if not (bins.is_contiguous() and weights.is_contiguous()):
        raise ValueError("sample_pdf_cuda takes contiguous inputs")
    if n_fine < 1:
        raise ValueError(f"n_fine must be >= 1, got {n_fine}")
    out = torch.empty((R, n_fine), dtype=torch.float32, device=device)
    if R == 0:
        return out
    lib = _lib()
    err = lib.sample_pdf_launch(bins.data_ptr(), weights.data_ptr(), out.data_ptr(), R, K,
                                int(n_fine), _build.current_stream(device))
    _build.check(lib, err, "sample_pdf")
    launches += 1
    return out


def sample_pdf_fused(bins: torch.Tensor, weights: torch.Tensor, n_fine: int) -> torch.Tensor:
    """bins [R, K], weights [R, K-1] -> fine samples [R, n_fine].

    CPU tensors take the plain version; CUDA tensors take the kernel.
    """
    if bins.device.type == "cpu" and weights.device.type == "cpu":
        return sampling.sample_pdf(bins, weights, n_fine)
    return sample_pdf_cuda(bins, weights, n_fine)
