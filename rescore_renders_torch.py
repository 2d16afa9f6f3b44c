#!/usr/bin/env python3
"""Re-score persisted PNG renders with the PyTorch/CUDA port:
python rescore_renders_torch.py --renders_dir=... [--ground_truth_dir=...] | --scan=runs [--device cpu]."""
from smpl_nerf_tpu_torch.cli.rescore_renders import main

if __name__ == "__main__":
    main()
