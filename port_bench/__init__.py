"""The benchmark of the PyTorch/CUDA port (smpl_nerf_tpu_torch); see harness.py."""
