#!/usr/bin/env python3
"""Train with the PyTorch/CUDA port: python train_torch.py --config=... [--device cpu]."""
from smpl_nerf_tpu_torch.cli.train import main

if __name__ == "__main__":
    main()
