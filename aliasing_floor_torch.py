#!/usr/bin/env python3
"""A dataset's supersampled ground-truth PSNR ceiling with the PyTorch/CUDA port:
python aliasing_floor_torch.py --dataset_dir=data/<set>/val [--frames 3] [--supersample 2] [--device cpu]."""
from smpl_nerf_tpu_torch.cli.aliasing_floor import main

if __name__ == "__main__":
    main()
