#!/usr/bin/env python3
"""Time a trained run's whole-image novel view with the PyTorch/CUDA port:
python measure_render_256_torch.py runs/<run> [resolution] [--device cpu]."""
from smpl_nerf_tpu_torch.cli.measure_render import main

if __name__ == "__main__":
    main()
