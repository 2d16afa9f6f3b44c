"""smpl_nerf_tpu_torch — the PyTorch/CUDA port of smpl_nerf_tpu for one NVIDIA H100.

The JAX package `smpl_nerf_tpu` stays the reference; this package mirrors its
layout and names so each module's counterpart is easy to find. It imports
torch, numpy and the standard library only — never jax, flax or
smpl_nerf_tpu.

Covered so far: rendering and training of the nerf / smpl_nerf / append
families, distilled-expert serving, and the MLP roofline script.
  core/       ray math in torch: cameras, rays, positional encoding, coarse &
              inverse-CDF fine sampling, alpha-composite integration.
  ops/        hand-written Hopper kernels (csrc/*.cu) with their plain
              PyTorch versions: sample_pdf, the fused RenderRayNet forwards
              (v1, v2) and the v2 backward, the fused expert tiles, relu-matmul.
  models/     RenderRayNet / WarpFieldNet nn.Modules with reference layer names.
  pipelines.py  nerf / smpl_nerf / append render functions.
  parallel/   ep: stacked voxel experts, bucketed and sorted-tile routing.
  training/   model factory, solver, run-dir checkpoints.
  render/     batched ray rendering of a dataset; experts: distillation,
              occupancy, fine-tuning and the serving forms of an expert field.
  evaluation/ scores: mse, psnr, ssim.
  data/       dataset loader and PNG codec.
  cli/        render_path, train, distill, mlp_roofline.

Entry points run on CUDA unless the caller passes device="cpu"; on CPU every
kernel wrapper takes its plain PyTorch version.
"""

__version__ = "0.1.0"
