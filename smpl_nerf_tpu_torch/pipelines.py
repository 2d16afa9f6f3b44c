"""Rendering pipelines (counterpart of smpl_nerf_tpu/pipelines.py): nerf, smpl_nerf,
the two append families (append_to_nerf, append_smpl_params) and the three
SMPL-driven families (dummy_dynamic, image_wise_dynamic,
append_vertex_locations_to_nerf).

A pipeline is ``pipeline(batch, generator=None, train=False) -> outputs dict``
over nn.Modules that hold their own weights; its `passes` (`FamilyPasses`)
run the family's coarse and fine passes on any rays, which the culled
renderers of render/fast.py call on the rays they select. Batch layout (tensors on one
device): ray_translation [R,3], ray_direction [R,3] (+ human_pose [R,69] for
the pose-conditioned families, + image_indices [R] for the SMPL-driven ones).
The append families hand the (encoded) pose, two joints or all 69, to both
nets as a per-ray conditioning prefix.

The SMPL-driven families look each ray's image up in the estimator's pose
table (a buffer of `smpl_estimator`; the image-wise estimator's one pose for
every ray) and take those poses' SMPL LBS vertices
(`FamilyPasses.goal_verts_table`); with --images_per_batch K only the
batch's (at most K) unique images. A table that needs no gradient is skinned
whole once per table version and looked up after (`FamilyPasses.skinned_table`);
a table that needs one, and the image-wise pose, run LBS inside the step.
dummy_dynamic and image_wise_dynamic warp every coarse sample by vertex
attention (ops/vertex_attention.py) toward the canonical mesh, and have no
fine pass; append_vertex_locations_to_nerf embeds the goal mesh's vertex
cloud once per image (`VertexEmbedder`) and hands it to both nets as a
64-wide prefix.

Three families have a pipeline of their own (`FamilyPasses.smpl`, `.warp_only`,
`.vertex_sphere`), from samples the loader precomputed, with no fine pass:
  * smpl: one surface sample per ray, moved by its ground-truth warp, through
    the coarse net's PLAIN forward and a sigmoid, whatever --use_fused_mlp
    says (the JAX package calls the flax module there, not its runner);
  * warp: the warp field alone on the surface sample and two joints; the
    loss holds it against the ground-truth warp, and the rgb outputs are the
    batch's own (the nets get no gradient);
  * vertex_sphere: every coarse sample moved by its ground-truth vertex-sphere
    warp, precomputed by the loader or, in-step, recomputed from the batch's
    goal meshes (`ops/vertex_sphere.sample_warps_by_vertex_sphere_rays`; with
    --images_per_batch K only the batch's K unique meshes are read), through
    the coarse net's runner (so kernels B and C, or D, on the card).

The MLP runner owns the encoding step. A net that takes raw rows (GridNerf,
HashGridNerf) gets [prefix || xyz || unit dir] and encodes them itself. For a RenderRayNet:
  * use_fused_mlp=0: PositionalEncoder + the RenderRayNet module,
  * use_fused_mlp=1: encode, then the fused v1 forward (ops/fused_mlp.py): the
    CUDA kernel on the card, its plain version on the CPU; takes any prefix,
  * use_fused_mlp=2: raw 24 B/sample rows to the fused v2 kernels
    (ops/fused_mlp_v2.py), forward and, under autograd, backward; prefix-free
    nets only on the card,
  * use_fused_mlp=-1 (auto): each net gets one mode for passes under autograd
    and one for passes without it (`resolve_fused_modes_auto`). On CUDA a
    prefix-free net the v2 kernels take (bf16, W <= 256) runs mode 2 in both,
    as JAX's auto picks on its accelerator; a prefixed bf16 net that kernel D
    takes runs the plain net under autograd (JAX's choice, for training) and
    kernel D's forward without it (renders, validation); everything else, and
    every net on the CPU, runs mode 0.
A SIREN or grid net always runs its own forward: auto leaves it there, and an
explicit --use_fused_mlp=1|2 raises (JAX silently runs such a net plain).
Spans (`tracing`): `pass.coarse` and `pass.fine` hold a pass; inside them
`pass.sample` (coarse sampling, or the fine inverse-CDF sampling: kernel A),
`pass.warp` (the warp field or vertex attention), `pass.net` (the runner: B,
D or PyTorch's layers; a hash-grid net's `pass.encode` inside it) and
`pass.integrate` (`raw2outputs`). `pass.lbs`,
before the coarse pass, holds the SMPL-driven families' goal vertices of the
batch's poses (the skinned table's lookup, or in-step LBS), and for the two
attention families the per-vertex warps canonical - goal and the per-ray
gathers.
smpl_estimator trains a CNN with no render pipeline (training/estimator.py).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Tuple

import torch

from smpl_nerf_tpu_torch import tracing
from smpl_nerf_tpu_torch.config import MODEL_TYPES
from smpl_nerf_tpu_torch.core.encoding import PositionalEncoder
from smpl_nerf_tpu_torch.core.integrate import raw2outputs
from smpl_nerf_tpu_torch.core.sampling import coarse_sampling, fine_sampling
from smpl_nerf_tpu_torch.models import RenderRayNet
from smpl_nerf_tpu_torch.models import smpl as smpl_mod
from smpl_nerf_tpu_torch.models.render_ray_net import Dense
from smpl_nerf_tpu_torch.ops import fused_mlp as fused_mod
from smpl_nerf_tpu_torch.ops import fused_mlp_v2 as fused_v2
from smpl_nerf_tpu_torch.ops.vertex_attention import vertex_attention_warp
from smpl_nerf_tpu_torch.ops.vertex_sphere import sample_warps_by_vertex_sphere_rays

# the families that take the SMPL LBS vertices of the batch's images
DYNAMIC_FAMILIES = ("dummy_dynamic", "image_wise_dynamic", "append_vertex_locations_to_nerf")
# their pipeline has a coarse pass only, whatever --run_fine says
COARSE_ONLY_FAMILIES = ("dummy_dynamic", "image_wise_dynamic")
# the families with a pipeline of their own on the loader's samples, no fine pass
SAMPLE_FAMILIES = ("smpl", "warp", "vertex_sphere")
# the families that need the SMPL model (LBS in the step, or vertex_sphere's loader)
SMPL_MODEL_FAMILIES = DYNAMIC_FAMILIES + ("vertex_sphere",)
# the skinned pose tables (`FamilyPasses.skinned_table`): lookups that found
# the table's vertices, and builds (one smpl_forward call each); no device sync
goal_table_hits = 0
goal_table_builds = 0


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    """The rendering configuration the ported pipelines read."""
    model_type: str = "nerf"
    near: float = 1.0
    far: float = 4.0
    number_coarse_samples: int = 64
    number_fine_samples: int = 128
    run_fine: bool = True
    sigma_noise_std: float = 0.0
    white_background: bool = False
    human_pose_encoding: bool = False
    human_joints: tuple = (41, 38)
    use_pallas: bool = False
    use_fused_mlp: int = 0  # 0 off, 1 fused MLP, 2 fused MLP + in-kernel encoding
    warp_radius: float = 0.01
    warp_temperature: float = 10000.0
    vertex_sphere_radius: float = 0.01
    warp_by_vertex_mean: bool = False
    use_gmm_loss: bool = False
    gmm_std: float = 0.07
    images_per_batch: int = 0

    @classmethod
    def from_args(cls, args) -> "RenderConfig":
        return cls(
            model_type=args.model_type,
            near=float(args.near), far=float(args.far),
            number_coarse_samples=int(args.number_coarse_samples),
            number_fine_samples=int(args.number_fine_samples),
            run_fine=bool(int(args.run_fine)),
            sigma_noise_std=float(args.sigma_noise_std),
            white_background=bool(int(args.white_background)),
            human_pose_encoding=bool(int(args.human_pose_encoding)),
            human_joints=tuple(int(j) for j in args.human_joints),
            use_pallas=bool(int(getattr(args, "use_pallas", 0))),
            use_fused_mlp=int(getattr(args, "use_fused_mlp", 0) or 0),
            warp_radius=float(args.warp_radius),
            warp_temperature=float(args.warp_temperature),
            vertex_sphere_radius=float(getattr(args, "vertex_sphere_radius", 0.01)),
            warp_by_vertex_mean=bool(int(getattr(args, "warp_by_vertex_mean", 0) or 0)),
            use_gmm_loss=bool(int(args.use_gmm_loss)),
            gmm_std=float(args.gmm_std),
            images_per_batch=int(getattr(args, "images_per_batch", 0) or 0),
        )

    @property
    def has_fine(self) -> bool:
        """Whether the pipeline runs a fine pass."""
        return (self.run_fine and self.model_type not in COARSE_ONLY_FAMILIES
                and self.model_type not in SAMPLE_FAMILIES)


def build_encoders(args) -> Dict[str, PositionalEncoder]:
    """The three positional encoders: position, direction, human_pose."""
    return {
        "position": PositionalEncoder(int(args.number_frequencies_postitional),
                                      bool(int(args.use_identity_positional))),
        "direction": PositionalEncoder(int(args.number_frequencies_directional),
                                       bool(int(args.use_identity_directional))),
        "human_pose": PositionalEncoder(int(args.number_frequencies_pose),
                                        bool(int(args.use_identity_pose))),
    }


def get_pose_table(models) -> Optional[torch.Tensor]:
    """The dummy estimator's per-image goal-pose table (a buffer), or None
    (no estimator, or the image-wise one). The dynamic pipeline's lookup and
    the solver's table swap (training/solver.swap_pose_table) both read it here."""
    return getattr(models.get("smpl_estimator"), "goal_poses", None)


def unique_padded(x: torch.Tensor, size: int) -> torch.Tensor:
    """`jnp.unique(x, size=size, fill_value=-1)`: the `size` smallest distinct
    values of the 1-D x in ascending order, padded with -1. No host sync."""
    s, _ = torch.sort(x)
    first = torch.ones_like(s, dtype=torch.bool)
    first[1:] = s[1:] != s[:-1]
    pos = torch.cumsum(first, 0) - 1
    slot = torch.where(first & (pos < size), pos, torch.full_like(pos, size))
    out = torch.full((size + 1,), -1, dtype=x.dtype, device=x.device)
    out.scatter_(0, slot, s)          # repeats and overflow land in the dropped last slot
    return out[:size]


def _normalize(v: torch.Tensor) -> torch.Tensor:
    return v / torch.linalg.norm(v, dim=-1, keepdim=True)


def two_joint_pose(cfg: RenderConfig, batch) -> torch.Tensor:
    """The configured joints of human_pose, stacked in ascending joint order
    (the reference hardcodes [38, 41] whatever --human_joints says)."""
    gp = batch["human_pose"]
    return torch.stack([gp[:, j] for j in sorted(cfg.human_joints)], -1)


def warp_field_inputs(cfg: RenderConfig, encoders, samples: torch.Tensor,
                      pose2: torch.Tensor, R: int, S: int) -> torch.Tensor:
    """[R*S, pos_feat+pose_feat] rows for the warp-field MLP."""
    pose_feat = encoders["human_pose"].encode(pose2) if cfg.human_pose_encoding else pose2
    pose_exp = pose_feat[:, None, :].expand(R, S, pose_feat.shape[-1])
    sample_feat = encoders["position"].encode(samples) if cfg.human_pose_encoding else samples
    return torch.cat([sample_feat.reshape(R * S, -1), pose_exp.reshape(R * S, -1)], -1)


def resolve_fused_mode_auto(spec, pos_enc, dir_enc, device: torch.device) -> int:
    """--use_fused_mlp=-1 (auto), as JAX's resolver picks on its accelerator:
    the fused v2 kernel for the prefix-free nets it takes, else the plain net.
    On the CPU always the plain net. A prefixed net stays plain although
    kernels B and C take it: JAX measured v2 slower end to end on the
    prefixed flagship, so only an explicit --use_fused_mlp=2 sends it there."""
    if (device.type == "cuda" and not spec.additional_input_dim
            and fused_v2.supports(spec, pos_enc, dir_enc)
            and not fused_v2.kernel_supports(spec)):
        return 2
    return 0


def resolve_fused_modes_auto(spec, pos_enc, dir_enc,
                             device: torch.device) -> Tuple[int, int]:
    """--use_fused_mlp=-1 (auto) as (mode under autograd, mode without it).

    Under autograd, JAX's choice (`resolve_fused_mode_auto`). Without it, a
    prefixed net that kernel D takes runs D's forward on CUDA: JAX's reason
    to keep it plain was training, and a pass with no backward meets neither
    v2's slower prefixed step nor mode 1's float32 backward. On the CPU, and
    for every other net, the same mode both ways."""
    train = resolve_fused_mode_auto(spec, pos_enc, dir_enc, device)
    if (train == 0 and device.type == "cuda" and spec.additional_input_dim
            and not fused_mod.kernel_supports(spec)):
        return 0, 1
    return train, train


def _split_layers(net: torch.nn.Module) -> bool:
    """Whether --tensor_parallel swapped a layer of `net` for its column-parallel
    subclass of Dense (parallel/tp.py), which it does after the pipeline is built."""
    return any(isinstance(m, Dense) and type(m) is not Dense for m in net.modules())


def _make_net_runner(cfg: RenderConfig, models, encoders) -> Callable:
    """run(key, samples [R,S,3], dirs_unit [R,S|1,3], prefix [R,P] | None) -> raw [R,S,4].

    Each net's modes, under autograd and without it, are resolved and
    checked here, on the device its weights lie on, so a configuration the
    kernels cannot take fails when the pipeline is built rather than at the
    first batch. Where the two differ (auto's route to kernel D), each call
    reads the grad mode; a net that tensor parallelism split keeps the mode
    under autograd."""
    pos_enc = encoders["position"]
    dir_enc = encoders["direction"]
    modes, specs = {}, {}
    for key in ("model_coarse", "model_fine"):
        if key not in models:
            continue
        if type(models[key]) is not RenderRayNet:
            # the kernels compute RenderRayNet's ReLU trunk on encoded rows: a
            # SIREN or grid net runs its own forward. JAX runs such a net plain
            # whatever the flag says; an explicit fused mode is refused here.
            if int(cfg.use_fused_mlp) > 0:
                raise ValueError(
                    f"--use_fused_mlp={cfg.use_fused_mlp}: the fused kernels run "
                    f"RenderRayNet only, and {key} is a {type(models[key]).__name__}; "
                    "use --use_fused_mlp=0 or -1")
            modes[key] = (0, 0)
            continue
        spec = fused_mod.spec_from_model(models[key])
        device = next(models[key].parameters()).device
        mode = no_grad_mode = int(cfg.use_fused_mlp)
        if mode < 0:
            mode, no_grad_mode = resolve_fused_modes_auto(spec, pos_enc, dir_enc, device)
            if mode:
                print(f"use_fused_mlp=auto: fused v{mode} selected for {key} "
                      f"(W={spec.width})")
            elif no_grad_mode:
                print(f"use_fused_mlp=auto: fused v1 (kernel D) selected for {key} "
                      f"without autograd (W={spec.width})")
        if mode >= 2:
            if not fused_v2.supports(spec, pos_enc, dir_enc):
                raise ValueError("--use_fused_mlp=2 needs 3-coord sin/cos encoders without "
                                 "identity blocks (got identity or mismatched dims)")
            reason = fused_v2.kernel_supports(spec) if device.type == "cuda" else ""
            if reason:
                raise ValueError(f"--use_fused_mlp=2 on CUDA: {reason}")
        elif mode == 1:
            reason = fused_mod.kernel_supports(spec) if device.type == "cuda" else ""
            if reason:
                raise ValueError(f"--use_fused_mlp=1 on CUDA: {reason}")
        modes[key], specs[key] = (mode, no_grad_mode), spec

    def _rows(parts, R, S):
        # one copy: cat reads the broadcast parts (a prefix per ray) in place
        return torch.cat([p.expand(R, S, p.shape[-1]) for p in parts], -1).reshape(R * S, -1)

    def run(key, samples, dirs_unit, prefix=None):
        R, S = samples.shape[:2]
        net = models[key]
        mode, no_grad_mode = modes[key]
        # auto's no-grad route: kernel D's forward, on the pack `packed` caches
        to_d = (no_grad_mode != mode and not torch.is_grad_enabled()
                and not _split_layers(net))
        lead = [] if prefix is None else [prefix[:, None, :]]
        if getattr(net, "takes_raw", False):
            raw = net(_rows(lead + [samples, dirs_unit], R, S))
            return raw.reshape(R, S, raw.shape[-1])
        if mode >= 2:
            rows = _rows(lead + [samples, dirs_unit], R, S).contiguous()
            raw = fused_v2.fused_apply_raw(specs[key], net, rows)
            return raw.reshape(R, S, raw.shape[-1])
        inputs = _rows(lead + [pos_enc.encode(samples), dir_enc.encode(dirs_unit)], R, S)
        if to_d:
            raw = fused_mod.fused_forward_cuda(specs[key], net, inputs.contiguous())
        elif mode:
            raw = fused_mod.fused_apply(specs[key], net, inputs.contiguous())
        else:
            raw = net(inputs)
        return raw.reshape(R, S, raw.shape[-1])

    return run


class FamilyPasses:
    """How one family runs its coarse and fine passes, on any rays: the full
    pipeline runs them on every ray of a batch, the culled renderers
    (render/fast.py) on the rays they select. Each pass returns the
    family's per-sample tensors for the pipeline's outputs besides its
    integrated outputs.

    nerf: the nets see the samples and the unit ray direction. smpl_nerf: the
    warp field offsets every sample (conditioned on two joints), the nets see
    the warped samples and their unit directions from the origin, and the
    fine pass integrates with the unwarped per-ray direction, as the
    reference does (smpl_nerf_pipeline.py:95-98). The append families hand
    the (encoded) pose, two joints or all 69, to both nets as a prefix.
    dummy_dynamic / image_wise_dynamic: vertex attention warps every sample
    toward the canonical mesh, the net sees the warped samples and their
    unit directions from the origin (per sample), coarse pass only.
    append_vertex_locations_to_nerf: the embedded goal mesh is the prefix.

    extras (the SMPL-driven families and in-step vertex_sphere): 'smpl_model'
    and 'betas'.
    """

    def __init__(self, cfg: RenderConfig, models: Dict[str, torch.nn.Module],
                 encoders: Dict[str, PositionalEncoder], extras: Optional[dict] = None):
        self.cfg = cfg
        self.models = models
        self.encoders = encoders
        self.extras = extras or {}
        self.run = _make_net_runner(cfg, models, encoders)
        self._betas, self._canonical = {}, {}
        self._skinned = []      # (table, its _version, (verts, warps)), least recent first

    def betas(self, device) -> torch.Tensor:
        """The betas on `device`, copied there once (a copy per batch would
        block the host until the device drains)."""
        key = str(device)
        if key not in self._betas:
            self._betas[key] = torch.as_tensor(self.extras["betas"], dtype=torch.float32,
                                               device=device).reshape(-1)
        return self._betas[key]

    def canonical_vertices(self, device) -> torch.Tensor:
        """[V, 3] SMPL vertices at the zero pose (made once per device)."""
        key = str(device)
        if key not in self._canonical:
            self._canonical[key] = smpl_mod.smpl_forward(
                self.extras["smpl_model"], self.betas(device), torch.zeros(69, device=device))
        return self._canonical[key]

    def skinned_table(self, table: torch.Tensor):
        """(verts [N_img, V, 3], canonical - verts [N_img, V, 3]) of a pose table
        that needs no gradient: LBS of the whole table, once per table version,
        kept on the table's device.

        The key is the table tensor itself (which fixes its device) and its
        `_version`: a new table (`training.solver.swap_pose_table`, a checkpoint
        load that replaces the buffer) or an in-place write (`load_state_dict`)
        skins anew. An entry holds its table, so no other table can take its
        place. The two most recent tables are kept: the train table outlives
        each validation's swap. Built as normal tensors even under
        inference_mode, so that a later step under autograd may save them.
        """
        global goal_table_hits, goal_table_builds
        for i, (t, version, tables) in enumerate(self._skinned):
            if t is table and version == table._version:
                goal_table_hits += 1
                self._skinned.append(self._skinned.pop(i))
                return tables
        with torch.inference_mode(False), torch.no_grad():
            device = table.device
            verts = smpl_mod.smpl_forward(self.extras["smpl_model"], self.betas(device), table)
            tables = verts, self.canonical_vertices(device)[None] - verts
        goal_table_builds += 1
        kept = [e for e in self._skinned if e[0] is not table][-1:]
        self._skinned = kept + [(table, table._version, tables)]
        return tables

    def _goal_rows(self, image_indices: torch.Tensor):
        """(verts [K | N_img, V, 3], their warps canonical - verts, ray_pos [R]):
        `goal_verts_table`'s rows and the warps of the same rows."""
        est = self.models["smpl_estimator"]
        image_indices = image_indices.long()
        table = get_pose_table(self.models)
        K = self.cfg.images_per_batch
        rows = None                                         # the whole table
        if table is None:
            ray_pos = torch.zeros_like(image_indices)
        elif K and K < table.shape[0]:
            uniq = unique_padded(image_indices, K)
            rows = uniq.clamp(min=0)
            ray_pos = torch.argmax((image_indices[:, None] == uniq[None, :]).int(), 1)
        else:
            ray_pos = image_indices
        if table is not None and not table.requires_grad:
            verts, warps = self.skinned_table(table)
            if rows is not None:
                verts, warps = verts[rows], warps[rows]
            return verts, warps, ray_pos
        poses = est() if table is None else table if rows is None else est(rows)
        device = image_indices.device
        verts = smpl_mod.smpl_forward(self.extras["smpl_model"], self.betas(device), poses)
        return verts, self.canonical_vertices(device)[None] - verts, ray_pos

    def goal_verts_table(self, image_indices: torch.Tensor):
        """(verts_table [K | N_img, V, 3], ray_pos [R]): LBS vertices of the
        estimator's poses for the images the batch touches, and each ray's row.

        With --images_per_batch K below the table's length, the rows are the
        batch's unique images only (`unique_padded`: sorted, padded with -1,
        which looks up image 0), and ray_pos is the first slot holding the
        ray's image; a ray whose image is not among them maps to slot 0 (the
        solver's guards keep such batches out). The image-wise estimator has
        one pose, which every ray takes (where the JAX package's lookup is
        out of range past image 0). The rows of a table that needs no gradient
        come from `skinned_table`; else LBS runs on the rows' poses here.
        """
        verts, _, ray_pos = self._goal_rows(image_indices)
        return verts, ray_pos

    def pose(self, batch):
        """The per-ray conditioning of the family: two joints for smpl_nerf
        and append_to_nerf, all 69 for append_smpl_params, the vertex
        embedding [R, 64] for append_vertex_locations_to_nerf, each ray's
        (goal vertices, canonical - goal) [R, V, 3] pair for dummy_dynamic and
        image_wise_dynamic, else None."""
        mt = self.cfg.model_type
        if mt == "append_smpl_params":
            return batch["human_pose"]
        if mt in ("smpl_nerf", "append_to_nerf"):
            return two_joint_pose(self.cfg, batch)
        if mt in DYNAMIC_FAMILIES:
            with tracing.span("pass.lbs"):
                verts, warps, ray_pos = self._goal_rows(batch["image_indices"])
                if mt != "append_vertex_locations_to_nerf":
                    return verts[ray_pos], warps[ray_pos]
            # embedded once per image of the table, then gathered per ray
            return self.models["vertex_embedder"](verts.reshape(verts.shape[0], -1))[ray_pos]
        return None

    def prefix(self, pose: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
        """The append families' conditioning prefix of `pose` rows, else None."""
        mt = self.cfg.model_type
        if pose is None or mt == "smpl_nerf" or mt in COARSE_ONLY_FAMILIES:
            return None
        if mt == "append_vertex_locations_to_nerf":
            return pose
        return self.encoders["human_pose"].encode(pose) if self.cfg.human_pose_encoding else pose

    def warp(self, samples: torch.Tensor, pose2: torch.Tensor) -> torch.Tensor:
        """smpl_nerf warp-field offsets of [R, S, 3] samples."""
        R, S = samples.shape[:2]
        rows = warp_field_inputs(self.cfg, self.encoders, samples, pose2, R, S)
        return self.models["model_warp_field"](rows).reshape(R, S, 3)

    def _net_pass(self, key, origins, dirs, pose, samples, z_vals, noise, gen, fine):
        cfg = self.cfg
        if cfg.model_type in COARSE_ONLY_FAMILIES:
            goal_verts, warp_vecs = pose
            with tracing.span("pass.warp"):
                warp = vertex_attention_warp(samples, goal_verts, warp_vecs, cfg.warp_radius,
                                             cfg.warp_temperature)
                warped = samples + warp
                sample_dirs = warped - origins[:, None, :]
            with tracing.span("pass.net"):
                raw = self.run(key, warped, _normalize(sample_dirs))
            with tracing.span("pass.integrate"):
                out = raw2outputs(raw, z_vals, sample_dirs, noise, cfg.white_background, gen)
            return out, {"warp": warp, "ray_samples": samples, "warped_samples": warped}
        if cfg.model_type == "smpl_nerf":
            with tracing.span("pass.warp"):
                warp = self.warp(samples, pose)
                warped = samples + warp
                sample_dirs = warped - origins[:, None, :]
            with tracing.span("pass.net"):
                raw = self.run(key, warped, _normalize(sample_dirs))
            if fine:
                sample_dirs = dirs[:, None, :].expand(samples.shape)
            with tracing.span("pass.integrate"):
                out = raw2outputs(raw, z_vals, sample_dirs, noise, cfg.white_background, gen)
            return out, {"warp": warp, "ray_samples": samples, "warped_samples": warped}
        with tracing.span("pass.net"):
            raw = self.run(key, samples, _normalize(dirs)[:, None, :], prefix=self.prefix(pose))
        with tracing.span("pass.integrate"):
            out = raw2outputs(raw, z_vals, dirs[:, None, :].expand(samples.shape), noise,
                              cfg.white_background, gen)
        extras = {"ray_samples": samples}
        if cfg.model_type in ("nerf", "original_nerf"):
            extras["depth"] = out.depth
        return out, extras

    def coarse(self, origins, dirs, pose, noise: float = 0.0,
               gen: Optional[torch.Generator] = None):
        """(outputs, z_vals, per-sample tensors) of the coarse pass."""
        cfg = self.cfg
        with tracing.span("pass.coarse"):
            with tracing.span("pass.sample"):
                samples, z_vals = coarse_sampling(origins, dirs, cfg.near, cfg.far,
                                                  cfg.number_coarse_samples, gen)
            out, extras = self._net_pass("model_coarse", origins, dirs, pose, samples, z_vals,
                                         noise, gen, fine=False)
        return out, z_vals, extras

    def fine(self, origins, dirs, pose, z_vals, weights, noise: float = 0.0,
             gen: Optional[torch.Generator] = None):
        """(outputs, per-sample tensors) of the fine pass, sampled from the
        coarse pass's z_vals and weights."""
        cfg = self.cfg
        with tracing.span("pass.fine"):
            with tracing.span("pass.sample"):
                z_fine, samples = fine_sampling(origins, dirs, z_vals, weights,
                                                cfg.number_fine_samples, cfg.use_pallas)
            return self._net_pass("model_fine", origins, dirs, pose, samples, z_fine, noise,
                                  gen, fine=True)

    # ------------------------------------ the families on the loader's samples
    def smpl(self, batch, noise: float = 0.0, gen=None) -> dict:
        """The surface sample moved by its ground-truth warp through the coarse
        net's plain forward; rgb = sigmoid of its first three outputs."""
        warped = batch["ray_samples"] + batch["warp"]                      # [R, 3]
        direction = _normalize(warped - batch["ray_translation"])
        inputs = torch.cat([self.encoders["position"].encode(warped),
                            self.encoders["direction"].encode(direction)], -1)
        rgb = torch.sigmoid(self.models["model_coarse"](inputs)[..., :3])
        return {"rgb_coarse": rgb, "rgb_fine": rgb}

    def warp_only(self, batch, noise: float = 0.0, gen=None) -> dict:
        """The warp field on the surface sample and two joints; the loss holds
        `warp` against the batch's, the rgb outputs are the batch's own."""
        sample = batch["ray_samples"]                                       # [R, 3]
        pose2 = two_joint_pose(self.cfg, batch)
        if self.cfg.human_pose_encoding:
            inputs = torch.cat([self.encoders["position"].encode(sample),
                                self.encoders["human_pose"].encode(pose2)], -1)
        else:
            inputs = torch.cat([sample, pose2], -1)
        return {"warp": self.models["model_warp_field"](inputs),
                "rgb_coarse": batch["rgb"], "rgb_fine": batch["rgb"]}

    def vertex_sphere_warps(self, batch, samples: torch.Tensor) -> torch.Tensor:
        """In-step ground-truth warps [R, S, 3] of `samples` from the goal
        meshes of the batch's images (the whole table `goal_verts_itable`,
        read for the batch's K unique images under --images_per_batch K)."""
        table = batch["goal_verts_itable"]                                  # [N_img, V, 3]
        image_indices = batch["image_indices"].long()
        K = self.cfg.images_per_batch
        if K and K < table.shape[0]:
            uniq = unique_padded(image_indices, K)
            ray_pos = torch.argmax((image_indices[:, None] == uniq[None, :]).int(), 1)
            goal_verts = table[uniq.clamp(min=0)][ray_pos]
        else:
            goal_verts = table[image_indices]
        canonical = self.canonical_vertices(goal_verts.device)
        return sample_warps_by_vertex_sphere_rays(
            samples, goal_verts, canonical[None] - goal_verts, self.cfg.vertex_sphere_radius,
            self.cfg.warp_by_vertex_mean)

    def vertex_sphere(self, batch, noise: float = 0.0, gen=None) -> dict:
        """Every coarse sample moved by its ground-truth warp (precomputed, or
        recomputed in-step from the split's shared jitter `vs_z`) through the
        coarse net's runner; no fine pass."""
        origins = batch["ray_translation"]
        if "warp" in batch:
            samples, z_vals, warp = batch["ray_samples"], batch["z_vals"], batch["warp"]
        else:
            z_vals = batch["vs_z"]                                          # [R, S]
            samples = origins[:, None, :] + batch["ray_direction"][:, None, :] * z_vals[..., None]
            warp = self.vertex_sphere_warps(batch, samples)
        warped = samples + warp
        sample_dirs = warped - origins[:, None, :]
        raw = self.run("model_coarse", warped, _normalize(sample_dirs))
        out = raw2outputs(raw, z_vals, sample_dirs, noise, self.cfg.white_background, gen)
        return {"rgb_coarse": out.rgb, "rgb_fine": out.rgb, "warp": warp,
                "ray_samples": samples, "warped_samples": warped, "densities": out.density}


class Pipeline:
    """A built pipeline: call as fn(batch, generator=None, train=False) -> outputs.
    `passes` runs the family's coarse and fine passes on their own."""

    def __init__(self, passes: FamilyPasses):
        self.passes = passes
        self.cfg = passes.cfg
        self.models = passes.models
        self.encoders = passes.encoders

    def __call__(self, batch, generator: Optional[torch.Generator] = None,
                 train: bool = False):
        gen = generator if train else None
        noise = self.cfg.sigma_noise_std if train else 0.0
        own = {"smpl": self.passes.smpl, "warp": self.passes.warp_only,
               "vertex_sphere": self.passes.vertex_sphere}.get(self.cfg.model_type)
        if own is not None:
            return own(batch, noise, gen)
        origins, dirs = batch["ray_translation"], batch["ray_direction"]
        pose = self.passes.pose(batch)
        out, z_vals, extras = self.passes.coarse(origins, dirs, pose, noise, gen)
        result = {"rgb_coarse": out.rgb, "densities": out.density, **extras}
        if not self.cfg.has_fine:
            result["rgb_fine"] = out.rgb
            return result
        out_f, extras_f = self.passes.fine(origins, dirs, pose, z_vals, out.weights, noise, gen)
        result.update(rgb_fine=out_f.rgb, densities=out_f.density, **extras_f)
        return result


def build_pipeline(cfg: RenderConfig, models: Dict[str, torch.nn.Module],
                   encoders: Dict[str, PositionalEncoder],
                   extras: Optional[dict] = None) -> Pipeline:
    """The pipeline for cfg.model_type (any of config.MODEL_TYPES but
    smpl_estimator, which has none). extras:
    the per-dataset constants of the SMPL-driven families ('smpl_model',
    'betas'; training.factory.dataset_extras)."""
    if cfg.model_type == "smpl_estimator":
        raise ValueError("smpl_estimator has no render pipeline: it trains through "
                         "training/estimator.train_estimator")
    if cfg.model_type not in MODEL_TYPES:
        raise ValueError(f"unknown model_type {cfg.model_type!r}")
    return Pipeline(FamilyPasses(cfg, models, encoders, extras))
