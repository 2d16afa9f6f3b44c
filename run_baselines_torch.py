#!/usr/bin/env python3
"""Score the nearest-neighbour baseline with the PyTorch/CUDA port:
python run_baselines_torch.py --dataset_dir D [--out DIR] [--device cpu]."""
from smpl_nerf_tpu_torch.cli.baselines import main

if __name__ == "__main__":
    main()
