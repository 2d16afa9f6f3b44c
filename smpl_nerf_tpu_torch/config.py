"""Config system: the configargparse-compatible parser and the training flag surface.

A copy of smpl_nerf_tpu/config.py (the port imports nothing of the JAX
package). Flag names and defaults are the same, so a `config.txt` written by
the JAX package's `parser.write_config_file` reads back here unchanged,
including list values such as ``skips = [4]``:

  * ``--config`` flag marked ``is_config_file=True`` reads ``key = value`` lines,
  * repeated (``action="append"``) flags serialize as ``key = [v1, v2]``,
  * ``parser.write_config_file(args, [path])`` writes the resolved config back out.

The dataset-generation parser is not ported yet.
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
    """Training flag surface: the same flags and defaults as smpl_nerf_tpu.config."""
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
    parser.add_argument("--siren", type=int, default=0)
    parser.add_argument("--load_run", type=str, default=None)
    parser.add_argument("--use_directional_input", type=int, default=1)

    # extensions beyond the reference (same names as the JAX package)
    parser.add_argument("--compute_dtype", type=str, default="float32",
                        help="float32|bfloat16 compute precision for MLP matmuls")
    parser.add_argument("--tensor_parallel", type=int, default=0,
                        help="1: width-shard the NeRF MLPs over the mesh "
                             "'model' axis (use with e.g. --mesh_shape=4,2)")
    parser.add_argument("--mesh_shape", type=str, default="",
                        help="device mesh, e.g. '8' (data) or '4,2' (data,model); '' = all devices on data axis")
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
                        help="1: replace the frequency-encoded MLP with a "
                             "multi-res dense-grid encoder + tiny head "
                             "(instant-NGP-style, models/grid_nerf.py) — "
                             "much faster convergence; beyond-reference")
    parser.add_argument("--grid_levels", type=str, default="8,16,32,64")
    parser.add_argument("--grid_features", type=int, default=4)
    parser.add_argument("--grid_width", type=int, default=64)
    parser.add_argument("--grid_depth", type=int, default=3)
    parser.add_argument("--grid_bound", type=float, default=1.6,
                        help="grid covers [-bound, bound]^3 around the origin")
    parser.add_argument("--check_nans", type=int, default=0,
                        help="1: enable jax_debug_nans (jit re-runs op-by-op at "
                             "the first NaN and points at the producing op) and "
                             "per-epoch finite checks with a param NaN report — "
                             "the reference's print_number_nans analog")
    parser.add_argument("--profile_dir", type=str, default=None,
                        help="write a jax.profiler trace of a few training steps here")
    parser.add_argument("--multihost", type=int, default=0,
                        help="call jax.distributed.initialize() (TPU pod slices)")
    parser.add_argument("--render_gif", type=int, default=1,
                        help="re-render train+val into <run>/walking.gif after training "
                             "(reference inference_gif behaviour for append models)")
    parser.add_argument("--steps_per_epoch", type=int, default=0,
                        help="0 = full epoch (dataset_size/batchsize steps)")
    parser.add_argument("--val_rays", type=int, default=0,
                        help=">0: per-epoch validation uses this many rays (a "
                             "deterministic stride over the val set) instead of all "
                             "of them; final scores always use the full set")
    parser.add_argument("--images_per_batch", type=int, default=0,
                        help=">0 (dynamic/append_vertices families): draw each ray "
                             "batch from this many images so in-step SMPL LBS runs "
                             "on a fixed small pose set instead of every dataset "
                             "image (keeps step cost flat in dataset size)")
    parser.add_argument("--seed", type=int, default=0)
    return parser
