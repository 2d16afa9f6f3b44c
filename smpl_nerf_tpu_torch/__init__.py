"""smpl_nerf_tpu_torch — the PyTorch/CUDA port of smpl_nerf_tpu for one NVIDIA H100.

The JAX package `smpl_nerf_tpu` stays the reference; this package mirrors its
layout and names so each module's counterpart is easy to find. It imports
torch, numpy and the standard library only — never jax, flax or
smpl_nerf_tpu.

Slice covered so far: the novel-view render of a `smpl_nerf` run.
  core/       ray math in torch: cameras, rays, positional encoding, coarse &
              inverse-CDF fine sampling, alpha-composite integration.
  ops/        hand-written Hopper kernels (csrc/*.cu) with their plain
              PyTorch versions: sample_pdf (inverse-CDF fine sampling) and the
              fused RenderRayNet v2 forward.
  models/     RenderRayNet / WarpFieldNet nn.Modules with reference layer names.
  pipelines.py  nerf / smpl_nerf render functions.
  training/   model factory (seeded torch.Generator) and run-dir checkpoints.
  render/     batched ray rendering of a dataset.
  cli/        render_path: novel camera path from a run directory.

Entry points run on CUDA unless the caller passes device="cpu"; on CPU every
kernel wrapper takes its plain PyTorch version.
"""

__version__ = "0.1.0"
