#!/usr/bin/env python3
"""MLP roofline of the PyTorch/CUDA port: python mlp_roofline_torch.py [--part chain|fusedmlp|all] [--device cpu]."""
from smpl_nerf_tpu_torch.cli.mlp_roofline import main

if __name__ == "__main__":
    main()
