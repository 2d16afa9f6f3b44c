"""Device selection for the port's entry points.

Entry points default to CUDA and refuse to fall back to the CPU silently: a
render that was asked for the card must run on the card. Only an explicit
``device="cpu"`` (the tests) runs the plain PyTorch versions on the host.
"""
from __future__ import annotations

from typing import Union

import torch

DEFAULT_DEVICE = "cuda"


def set_matmul_precision() -> None:
    """Full-precision float32 products and convolutions on the card.

    PyTorch lets cuDNN convolutions use TF32 by default, which keeps about
    three decimal digits; the reference computes in full float32. bf16
    products keep f32 reductions, as the JAX package's
    `preferred_element_type=float32` does.
    """
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False


def resolve_device(device: Union[str, torch.device, None] = DEFAULT_DEVICE) -> torch.device:
    """torch.device for an entry point; raises when CUDA is asked for but absent."""
    dev = torch.device(DEFAULT_DEVICE if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "smpl_nerf_tpu_torch runs on a CUDA GPU and none is available; "
            "pass device='cpu' explicitly to run the plain PyTorch versions "
            "on the host")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    set_matmul_precision()
    return dev
