"""smpl_nerf_tpu_torch — the PyTorch/CUDA port of smpl_nerf_tpu for one NVIDIA H100.

The JAX package `smpl_nerf_tpu` stays the reference; this package mirrors its
layout and names so each module's counterpart is easy to find. It imports
torch, numpy and the standard library only — never jax, flax or
smpl_nerf_tpu.

Covered: every path of the JAX package. Training, rendering,
inference and scoring of every --model_type (with the SIREN and dense-grid
nets, --check_nans, --profile_dir and per-epoch logging), dataset
generation, distilled-expert serving, the Table-1 baselines and the MLP
roofline script; and the parallel layer (--mesh_shape, --tensor_parallel,
--multihost: one process per device on torch.distributed).
  core/       ray math in torch: cameras, rays, positional encoding, coarse &
              inverse-CDF fine sampling, alpha-composite integration, GMM.
  ops/        hand-written Hopper kernels (csrc/*.cu) with their plain
              PyTorch versions: sample_pdf, the fused RenderRayNet forwards
              (v1, v2) and the v2 backward, the fused expert tiles, relu-matmul;
              ray-mesh hits, vertex attention, vertex-sphere warps, occupancy.
  models/     RenderRayNet / SirenRenderRayNet / GridNerf / WarpFieldNet,
              SMPL, the estimators, with reference layer names.
  pipelines.py  every family's coarse and fine passes and the net runner.
  parallel/   mesh, multihost, tp (the ('data', 'model') mesh, batch rows,
              width-split trunks), sample_axis, pp, ep (stacked voxel experts:
              bucketed, sorted-tile and all-to-all routing), dryrun.
  training/   model factory, solver, run-dir checkpoints, per-epoch logging,
              the image-wise and estimator trainers.
  render/     batched and culled rendering, the ray tracer; experts:
              distillation, occupancy, fine-tuning and the serving forms.
  evaluation/ scores: mse, psnr, ssim, rlpips, lpips.
  data/       dataset loader and generator, PNG and GIF codecs.
  baselines/  nearest neighbours, the silhouette pose fit, SMPLify priors.
  cli/        train, inference, render_path, dataset, distill, mlp_roofline,
              baselines, pix2pix, evaluate_pix2pix.

Entry points run on CUDA unless the caller passes device="cpu"; on CPU every
kernel wrapper takes its plain PyTorch version.
"""

__version__ = "0.1.0"
