"""Config system: the configargparse-compatible parser and the training flag surface.

A copy of smpl_nerf_tpu/config.py (the port imports nothing of the JAX
package). Flag names and defaults are the same, so a `config.txt` written by
the JAX package's `parser.write_config_file` reads back here unchanged,
including list values such as ``skips = [4]``:

  * ``--config`` flag marked ``is_config_file=True`` reads ``key = value`` lines,
  * repeated (``action="append"``) flags serialize as ``key = [v1, v2]``,
  * ``parser.write_config_file(args, [path])`` writes the resolved config back out.

`config_parser` is the training flag surface, `dataset_config_parser` the
dataset generator's (create_dataset_torch.py).
"""
from __future__ import annotations

import argparse
import os
from typing import List, Optional, Sequence


def _parse_config_line(line: str):
    line = line.strip()
    if not line or line.startswith("#") or line.startswith(";"):
        return None
    if "=" in line:
        key, _, value = line.partition("=")
    elif ":" in line:
        key, _, value = line.partition(":")
    else:
        key, value = line, "true"
    key = key.strip()
    value = value.strip()
    return key, value


def _split_list_value(value: str) -> List[str]:
    inner = value.strip()[1:-1].strip()
    if not inner:
        return []
    return [item.strip().strip("'\"") for item in inner.split(",")]


class ConfigArgumentParser(argparse.ArgumentParser):
    """argparse.ArgumentParser with configargparse-style config-file support."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self._config_file_args: List[str] = []
        self._append_args: set = set()

    def add_argument(self, *args, **kwargs):
        is_config_file = kwargs.pop("is_config_file", False)
        action = super().add_argument(*args, **kwargs)
        if is_config_file:
            self._config_file_args.append(action.dest)
            # a missing default config file is not an error
            action.required = False
        if isinstance(action, argparse._AppendAction):
            self._append_args.add(action.dest)
        return action

    # -- config file handling ------------------------------------------------
    def _config_to_argv(self, path: str) -> List[str]:
        argv: List[str] = []
        with open(path) as fh:
            for raw in fh:
                parsed = _parse_config_line(raw)
                if parsed is None:
                    continue
                key, value = parsed
                flag = "--" + key
                if value.startswith("[") and value.endswith("]"):
                    for item in _split_list_value(value):
                        argv.extend([flag, item])
                elif value.lower() in ("true",) and self._is_store_true(key):
                    argv.append(flag)
                else:
                    argv.extend([flag, value])
        return argv

    def _is_store_true(self, key: str) -> bool:
        for action in self._actions:
            if action.dest == key and isinstance(action, argparse._StoreTrueAction):
                return True
        return False

    def parse_args(self, args: Optional[Sequence[str]] = None, namespace=None):  # type: ignore[override]
        import sys

        argv = list(sys.argv[1:]) if args is None else list(args)
        # find a config file flag on the CLI or use the default
        config_path = None
        for dest in self._config_file_args:
            flag = "--" + dest
            explicit = None
            for i, tok in enumerate(argv):
                if tok == flag and i + 1 < len(argv):
                    explicit = argv[i + 1]
                elif tok.startswith(flag + "="):
                    explicit = tok.split("=", 1)[1]
            if explicit is not None:
                config_path = explicit
            else:
                for action in self._actions:
                    if action.dest == dest and action.default:
                        config_path = action.default
        file_argv: List[str] = []
        if config_path and os.path.exists(config_path):
            file_argv = self._config_to_argv(config_path)
        # CLI args take precedence: put file args first
        ns = super().parse_args(file_argv + argv, namespace=namespace)
        # append-actions: CLI/file values *extend* defaults in configargparse only
        # when the default is [] — replicate reference behaviour where defaults
        # like [41, 38] stay if nothing was passed (argparse appends to the
        # default list; drop the default prefix if user supplied values).
        for dest in self._append_args:
            for action in self._actions:
                if action.dest == dest and action.default:
                    value = getattr(ns, dest)
                    if value is not None and len(value) > len(action.default) and value[: len(action.default)] == action.default:
                        setattr(ns, dest, value[len(action.default):])
        return ns

    def write_config_file(self, args: argparse.Namespace, paths: List[str]):
        lines = []
        for action in self._actions:
            dest = action.dest
            if dest in ("help",) or dest in self._config_file_args:
                continue
            if not hasattr(args, dest):
                continue
            value = getattr(args, dest)
            if value is None:
                continue
            if isinstance(value, (list, tuple)):
                lines.append(f"{dest} = [{', '.join(str(v) for v in value)}]")
            else:
                lines.append(f"{dest} = {value}")
        text = "\n".join(lines) + "\n"
        for path in paths:
            os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
            with open(path, "w") as fh:
                fh.write(text)


# -- ArgumentParser alias matching configargparse's API ---------------------
ArgumentParser = ConfigArgumentParser


MODEL_TYPES = [
    "smpl_nerf", "nerf", "append_to_nerf", "smpl", "warp", "vertex_sphere",
    "smpl_estimator", "original_nerf", "image_wise_dynamic",
    "append_smpl_params", "append_vertex_locations_to_nerf", "dummy_dynamic",
]


def config_parser() -> ConfigArgumentParser:
    """Training flag surface: the same flags and defaults as smpl_nerf_tpu.config, and
    one flag more, --smpl_model_path (JAX's training parser lacks it)."""
    parser = ConfigArgumentParser()
    parser.add_argument("--config", is_config_file=True, default="configs/config.txt",
                        help="config file path")
    parser.add_argument("--experiment_name", type=str, default="default")
    parser.add_argument("--model_type", default="nerf", type=str,
                        help=f"one of {MODEL_TYPES}")
    parser.add_argument("--dataset_dir", type=str, default="data")
    parser.add_argument("--number_validation_images", type=int, default=1)

    # network architecture
    parser.add_argument("--netdepth", type=int, default=8)
    parser.add_argument("--netwidth", type=int, default=256)
    parser.add_argument("--skips", type=int, default=[], action="append")
    parser.add_argument("--netdepth_fine", type=int, default=8)
    parser.add_argument("--netwidth_fine", type=int, default=256)
    parser.add_argument("--skips_fine", type=int, default=[], action="append")
    parser.add_argument("--run_fine", type=int, default=1)
    parser.add_argument("--netdepth_warp", type=int, default=8)
    parser.add_argument("--netwidth_warp", type=int, default=256)

    # losses / variant-specific options
    parser.add_argument("--gmm_std", type=float, default=0.07)
    parser.add_argument("--use_gmm_loss", default=0, type=int)
    parser.add_argument("--vertex_sphere_radius", type=float, default=0.01)
    parser.add_argument("--warp_by_vertex_mean", type=int, default=0)
    # -1 auto (in-step when the precomputed per-ray warp
    # arrays would exceed ~2 GB), 0 precompute (reference semantics),
    # 1 force in-step (shared-jitter z path only)
    parser.add_argument("--vertex_sphere_in_step", type=int, default=-1)
    parser.add_argument("--coarse_samples_from_prior", type=int, default=0)
    parser.add_argument("--coarse_samples_from_intersect", type=int, default=0)
    parser.add_argument("--std_dev_coarse_sample_prior", type=float, default=0.03)
    parser.add_argument("--warp_radius", type=float, default=0.01)
    parser.add_argument("--warp_temperature", type=float, default=10000)
    parser.add_argument("--load_coarse_model", type=str, default=None)

    # optimization
    parser.add_argument("--batchsize", type=int, default=2048)
    parser.add_argument("--batchsize_val", type=int, default=512)
    parser.add_argument("--lrate", type=float, default=5e-4)
    parser.add_argument("--lrate_decay", type=int, default=0,
                        help=">0: exponential lr decay to 0.1x over this many "
                             "thousand steps (original-NeRF schedule; the "
                             "reference keeps lr constant — 0 reproduces that)")
    parser.add_argument("--lrate_pose", type=float, default=0.1)
    parser.add_argument("--lrate_pose_decay", type=int, default=0,
                        help=">0: exponential decay to 0.1x over this many "
                             "thousand steps for the pose/estimator param "
                             "group only (the reference keeps lrate_pose "
                             "constant, which leaves analysis-by-synthesis "
                             "orbiting the basin floor — see RESULTS.md)")
    parser.add_argument("--param_ema", type=float, default=0.0,
                        help=">0 (e.g. 0.999): keep an exponential moving "
                             "average of the weights and use it for "
                             "validation, rendering and checkpoints (the raw "
                             "weights keep training; resume loads the EMA). "
                             "0 reproduces the reference (no averaging)")
    parser.add_argument("--weight_decay", type=float, default=0)
    parser.add_argument("--log_iterations", type=int, default=10)
    parser.add_argument("--mesh_epochs", type=float, default=[], action="append")
    parser.add_argument("--early_validation", type=int, default=0)
    parser.add_argument("--num_epochs", type=int, default=100)

    # sampling
    parser.add_argument("--near", type=float, default=1)
    parser.add_argument("--far", type=float, default=4)
    parser.add_argument("--number_coarse_samples", type=int, default=64)
    parser.add_argument("--number_fine_samples", type=int, default=128)

    # encodings
    parser.add_argument("--human_pose_encoding", type=int, default=0)
    parser.add_argument("--human_joints", type=int, action="append", default=[41, 38])
    parser.add_argument("--use_identity_positional", type=int, default=0)
    parser.add_argument("--use_identity_directional", type=int, default=0)
    parser.add_argument("--use_identity_pose", type=int, default=0)
    parser.add_argument("--number_frequencies_pose", type=int, default=10)
    parser.add_argument("--number_frequencies_postitional", type=int, default=10)
    parser.add_argument("--number_frequencies_directional", type=int, default=4)

    # rendering / regularization
    parser.add_argument("--sigma_noise_std", type=float, default=1)
    parser.add_argument("--white_background", default=0, type=int)
    parser.add_argument("--default_device", type=str, default="tpu",
                        help="kept for config compatibility; the port's entry points take "
                             "a device argument instead")
    parser.add_argument("--siren", type=int, default=0,
                        help="1: both nets are SirenRenderRayNets (sin(30 x) trunk, "
                             "SIREN init); they run their own forward, never a fused kernel")
    parser.add_argument("--load_run", type=str, default=None)
    parser.add_argument("--use_directional_input", type=int, default=1)

    # extensions beyond the reference (same names as the JAX package)
    parser.add_argument("--compute_dtype", type=str, default="float32",
                        help="float32|bfloat16 compute precision for MLP matmuls")
    parser.add_argument("--tensor_parallel", type=int, default=0,
                        help="1: split the nets' trunk layers over the mesh's model axis "
                             "(with a model axis > 1, e.g. --mesh_shape=4,2)")
    parser.add_argument("--mesh_shape", type=str, default="",
                        help="'' (all processes on the data axis), 'd' or 'd,m': the "
                             "(data, model) mesh; it must hold every process")
    parser.add_argument("--use_pallas", type=int, default=1,
                        help="1: fine sampling through the sample_pdf CUDA kernel on the GPU")
    parser.add_argument("--use_fused_mlp", type=int, default=0,
                        help="1: run RenderRayNet as one fused CUDA kernel on "
                             "pre-encoded rows (takes a conditioning prefix); 2: "
                             "with in-kernel encoding, forward and backward "
                             "(prefix-free nets); -1 (auto): 2 on the GPU for "
                             "prefix-free bf16 nets the kernels take, else 0")
    parser.add_argument("--foreground_sample_ratio", type=float, default=0.0,
                        help=">0: fraction of each ray batch drawn from foreground "
                             "(non-background) pixels. Synthetic human scenes are "
                             "~95%% background; uniform sampling with "
                             "white_background=1 collapses into the transparent-scene "
                             "dead-relu fixed point. 0 = reference behaviour.")
    parser.add_argument("--scan_steps", type=int, default=0,
                        help="accepted for config compatibility: it only changes how "
                             "the JAX package dispatches; steps run one batch at a time")
    parser.add_argument("--grid_encoding", type=int, default=0,
                        help="replace the frequency-encoded MLPs (beyond-reference). 1: "
                             "multi-res dense grids (--grid_levels, --grid_features) + a "
                             "ReLU trunk of --grid_depth (models/grid_nerf.GridNerf); 2: "
                             "Instant-NGP's multiresolution hash encoding at its published "
                             "NeRF sizes (models/grid_nerf.NGP_SIZES) with --grid_features "
                             "a level + its density and colour MLPs of --grid_width with "
                             "spherical-harmonic directions (models/grid_nerf.HashGridNerf)")
    parser.add_argument("--grid_levels", type=str, default="8,16,32,64")
    parser.add_argument("--grid_features", type=int, default=4)
    parser.add_argument("--grid_width", type=int, default=64)
    parser.add_argument("--grid_depth", type=int, default=3)
    parser.add_argument("--grid_bound", type=float, default=1.6,
                        help="grid covers [-bound, bound]^3 around the origin")
    parser.add_argument("--check_nans", type=int, default=0,
                        help="1: a non-finite epoch loss raises, with the NaN / Inf "
                             "counts of every non-finite parameter")
    parser.add_argument("--profile_dir", type=str, default=None,
                        help="write a torch.profiler Chrome trace of the training "
                             "(train_trace.json) into this directory")
    parser.add_argument("--multihost", type=int, default=0,
                        help="1: one process per device under torchrun: initialise the "
                             "process group from its environment (NCCL on CUDA, gloo on "
                             "the CPU)")
    parser.add_argument("--render_gif", type=int, default=1,
                        help="re-render train+val into <run>/img_XXX.png and "
                             "<run>/inference.gif after training (nerf, smpl_nerf and the "
                             "append families)")
    parser.add_argument("--steps_per_epoch", type=int, default=0,
                        help="0 = full epoch (dataset_size/batchsize steps)")
    parser.add_argument("--val_rays", type=int, default=0,
                        help=">0: per-epoch validation uses this many rays (a "
                             "deterministic stride over the val set) instead of all "
                             "of them; final scores always use the full set")
    parser.add_argument("--images_per_batch", type=int, default=0,
                        help=">0 (the SMPL-driven families, in-step vertex_sphere): "
                             "draw each ray batch from this many images, so the in-step "
                             "SMPL work runs on at most that many poses")
    parser.add_argument("--smpl_model_path", type=str, default=None,
                        help="a licensed SMPL model pkl (basicModel_*_lbs_10_207_0_v1.0.0.pkl) "
                             "for the SMPL-driven families and vertex_sphere; None: the "
                             "procedural human. A path that names no file raises")
    parser.add_argument("--seed", type=int, default=0)
    return parser


def dataset_config_parser() -> ConfigArgumentParser:
    """Dataset-generation flag surface: the same flags and defaults as
    smpl_nerf_tpu.config.dataset_config_parser (reference create_dataset.py:17-64)."""
    parser = ConfigArgumentParser()
    parser.add_argument("--save_dir", default="data")
    parser.add_argument("--dataset_type", default="nerf", type=str,
                        help="[smpl_nerf, nerf, pix2pix, smpl]")
    parser.add_argument("--train_val_ratio", default=0.8, type=float)
    parser.add_argument("--resolution", default=128, type=int)
    parser.add_argument("--camera_radius", default=2.4, type=float)
    parser.add_argument("--camera_path", default="sphere",
                        help="[sphere, circle, circle_on_sphere]")
    parser.add_argument("--start_angle", default=-90, type=int)
    parser.add_argument("--end_angle", default=90, type=int)
    parser.add_argument("--number_steps", default=10, type=int)
    parser.add_argument("--joints", action="append", type=int, default=[41, 38])
    parser.add_argument("--human_start_angle", default=-90, type=int)
    parser.add_argument("--human_end_angle", default=90, type=int)
    parser.add_argument("--human_number_steps", default=10, type=int)
    parser.add_argument("--multi_human_pose", type=int, default=0)
    parser.add_argument("--train_index", default=[], action="append")
    parser.add_argument("--val_index", default=[], action="append")
    parser.add_argument("--smpl_sequence_file", default=None, type=str)
    parser.add_argument("--sequence_start", default=0, type=int)
    parser.add_argument("--sequence_skip", default=3, type=int)
    parser.add_argument("--texture", default=1, type=int)
    parser.add_argument("--sequence_end", default=-1, type=int)
    parser.add_argument("--frames_per_view", default=1, type=int)
    parser.add_argument("--center_phi", default=0, type=float)
    parser.add_argument("--center_theta", default=0, type=float)
    parser.add_argument("--circle_on_sphere_radius", default=10, type=float)
    parser.add_argument("--smpl_model_path", default=None, type=str,
                        help="optional licensed SMPL .pkl; falls back to the built-in "
                             "procedural human")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--supersample", type=int, default=1,
                        help=">1: anti-aliased ground truth: render RGB at NxN subpixels "
                             "per pixel and box-average down (nerf / smpl_nerf / pix2pix "
                             "types). 1 matches the reference's single-ray-per-pixel renders")
    return parser
