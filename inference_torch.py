#!/usr/bin/env python3
"""Render, score and save a split with the PyTorch/CUDA port:
python inference_torch.py --inf_run_dir=... --inf_ground_truth_dir=... [--inf_fast 1|2] [--device cpu]."""
from smpl_nerf_tpu_torch.cli.inference import inference

if __name__ == "__main__":
    inference()
