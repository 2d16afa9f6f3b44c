#!/usr/bin/env python3
"""Score pix2pix and SMPL-NeRF renders against ground truth with the PyTorch/CUDA port:
python evaluate_pix2pix_torch.py --gt_dir G --nerf_dir N [--pix2pix_dir P] [--out comparison.gif] [--device cpu]."""
from smpl_nerf_tpu_torch.cli.evaluate_pix2pix import main

if __name__ == "__main__":
    main()
