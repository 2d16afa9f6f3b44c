#!/usr/bin/env python3
"""Train and score the depth -> RGB U-Net baseline with the PyTorch/CUDA port:
python pix2pix_baseline_torch.py --dataset_dir D [--epochs 60] [--out DIR] [--device cpu]."""
from smpl_nerf_tpu_torch.cli.pix2pix import main

if __name__ == "__main__":
    main()
