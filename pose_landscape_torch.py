#!/usr/bin/env python3
"""Sweep an image-wise run's arm angle through its frozen coarse net with the
PyTorch/CUDA port: python pose_landscape_torch.py --run_dir=... --dataset_dir=... [--device cpu]."""
from smpl_nerf_tpu_torch.cli.pose_landscape import main

if __name__ == "__main__":
    main()
