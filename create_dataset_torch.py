#!/usr/bin/env python3
"""Generate a synthetic dataset with the PyTorch/CUDA port:
python create_dataset_torch.py --dataset_type=smpl --save_dir=data ... [--device cpu]."""
from smpl_nerf_tpu_torch.cli.dataset import main

if __name__ == "__main__":
    main()
