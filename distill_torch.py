#!/usr/bin/env python3
"""Distill a trained run into voxel experts with the PyTorch/CUDA port: python distill_torch.py --run_dir=... [--device cpu]."""
from smpl_nerf_tpu_torch.cli.distill import main

if __name__ == "__main__":
    main()
