"""y = relu(x @ w) in bf16 with float32 accumulation (kernel F, csrc/relu_matmul.cu).

Replaces the TPU kernel scripts/mlp_roofline.py:_pallas_layer, the per-layer
matmul of the roofline script's chain (cli/mlp_roofline.py). x [n, K] and
w [K, N] are bf16; the products accumulate in float32, relu is applied in
float32 and the result is rounded to bf16 once.

What bounds it on the H100: bytes at widths 256 and 512 (W / 2 operations per
byte moved), tensor-core operations at 1024. The kernel is the Hopper GEMM
shape (csrc/relu_matmul.cu, over csrc/hopper.cuh): a persistent block per SM,
one producer warp that keeps TMA copies of x and w in flight through a ring
of mbarrier-guarded stages, and two consumer warpgroups that run wgmma on
128 x 256 (or 128 x 128) output tiles and store through TMA, so that copies,
tensor-core products and the epilogue overlap. w goes in as it lies ([K, N],
N contiguous) through wgmma's transpose bit; nothing is transposed per call.

`relu_matmul` takes the plain version (`relu_matmul_reference`) for CPU
tensors and launches the kernel for CUDA tensors; it never falls back from
CUDA to the plain version. Forward-only, as the TPU kernel is. `launches`
counts kernel launches.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from smpl_nerf_tpu_torch.ops import _build

K_MULTIPLE, N_MULTIPLE = 32, 128     # TMA zero-fills a K tail of 32; BN is 256 or 128
MAX_ROWS = 2 ** 31 - 1               # rows are int32 TMA coordinates
launches = 0


def relu_matmul_reference(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: float32 products of the bf16 values (exact),
    summed in float32, relu, one rounding to bf16."""
    return torch.relu(x.float() @ w.float()).to(torch.bfloat16)


def kernel_supports(K: int, N: int) -> str:
    """'' if the kernel takes a [K, N] weight, else the reason it does not."""
    if K < K_MULTIPLE or K % K_MULTIPLE or N < N_MULTIPLE or N % N_MULTIPLE:
        return (f"the kernel takes K a multiple of {K_MULTIPLE} and N a multiple of "
                f"{N_MULTIPLE}, got K={K}, N={N}")
    return ""


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load("relu_matmul")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.relu_matmul_launch.argtypes = [p, p, p, i, i, i, p]
    lib.relu_matmul_launch.restype = ctypes.c_int
    return lib


def relu_matmul_cuda(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Launch kernel F: x [n, K], w [K, N] (bf16, contiguous, one CUDA device) -> [n, N] bf16."""
    global launches
    if x.device.type != "cuda" or w.device != x.device:
        raise ValueError(f"relu_matmul_cuda needs both operands on one CUDA device, got "
                         f"{x.device} and {w.device}")
    if x.dtype != torch.bfloat16 or w.dtype != torch.bfloat16:
        raise TypeError(f"relu_matmul_cuda takes bfloat16, got {x.dtype}, {w.dtype}")
    if x.dim() != 2 or w.dim() != 2 or x.shape[1] != w.shape[0]:
        raise ValueError(f"bad shapes x {tuple(x.shape)} w {tuple(w.shape)} (need [n, K] @ [K, N])")
    if not (x.is_contiguous() and w.is_contiguous()):
        raise ValueError("relu_matmul_cuda takes contiguous operands")
    n, K = x.shape
    N = w.shape[1]
    reason = kernel_supports(K, N)
    if reason:
        raise ValueError(reason)
    if n > MAX_ROWS:
        raise ValueError(f"at most {MAX_ROWS} rows per launch, got {n}")
    if torch.is_grad_enabled() and (x.requires_grad or w.requires_grad):
        raise RuntimeError("relu_matmul is forward-only (the TPU kernel has no gradient either)")
    y = torch.empty((n, N), dtype=torch.bfloat16, device=x.device)
    if n == 0:
        return y
    lib = _lib()
    stream = _build.current_stream(x.device)
    err = lib.relu_matmul_launch(x.data_ptr(), w.data_ptr(), y.data_ptr(), n, K, N, stream)
    _build.check(lib, err, "relu_matmul")
    launches += 1
    return y


def relu_matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """relu(x @ w) for bf16 x [n, K], w [K, N] -> bf16 [n, N].

    CPU tensors take the plain version; CUDA tensors take the kernel.
    """
    if x.device.type == "cpu" and w.device.type == "cpu":
        return relu_matmul_reference(x, w)
    return relu_matmul_cuda(x, w)
