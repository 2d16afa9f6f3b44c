"""Dummy SMPL estimators (counterpart of smpl_nerf_tpu/models/dummy_estimators.py).

* DummySmplEstimatorModel: the per-image goal-pose table, looked up by image
  index. The table is a buffer, not a parameter (the JAX package keeps it in
  the `constants` collection): it is saved with the run and never trained. A
  table of any length loads into it, as flax's restore replaces the leaf,
  because a run trained on one split is rendered on another split's table
  (`training.solver.swap_pose_table`).
* DummyImageWiseEstimator: two trainable scalar arm angles written into dims
  38 and 41 of a frozen canonical 69-dim pose; image-wise training optimises
  them by gradient through a frozen NeRF.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn as nn

# body_pose dims: 38 = SMPL joint 13 (L collar) z-axis, 41 = joint 14
# (R collar) z-axis
LEFT_ARM_JOINT = 38
RIGHT_ARM_JOINT = 41


class DummySmplEstimatorModel(nn.Module):
    def __init__(self, goal_poses, device=None):
        super().__init__()
        self.register_buffer("goal_poses", torch.as_tensor(
            np.asarray(goal_poses, np.float32).reshape(-1, 69), device=device))

    def forward(self, image_indices: torch.Tensor) -> torch.Tensor:
        return self.goal_poses[image_indices.long()]

    def _load_from_state_dict(self, state_dict, prefix, *args, **kwargs):
        table = state_dict.get(prefix + "goal_poses")
        if table is not None and table.shape != self.goal_poses.shape:
            self.goal_poses = torch.empty(table.shape, device=self.goal_poses.device)
        super()._load_from_state_dict(state_dict, prefix, *args, **kwargs)


class DummyImageWiseEstimator(nn.Module):
    """Trainable (arm_angle_l, arm_angle_r) inside a frozen canonical pose.

    forward ignores its input and returns the current [1, 69] body pose with
    arm_angle_l in dim 38 and arm_angle_r in dim 41.
    """

    def __init__(self, canonical_pose=None, initial_arm_angle_l: float = 0.0,
                 initial_arm_angle_r: float = 0.0, device=None):
        super().__init__()
        base = np.zeros(69, np.float32) if canonical_pose is None else canonical_pose
        self.register_buffer("canonical_pose", torch.as_tensor(
            np.asarray(base, np.float32).reshape(69), device=device), persistent=False)
        self.arm_angle_l = nn.Parameter(torch.tensor([float(initial_arm_angle_l)],
                                                     device=device))
        self.arm_angle_r = nn.Parameter(torch.tensor([float(initial_arm_angle_r)],
                                                     device=device))

    def forward(self, _x=None) -> torch.Tensor:
        base = self.canonical_pose
        pose = torch.cat([base[:LEFT_ARM_JOINT], self.arm_angle_l,
                          base[LEFT_ARM_JOINT + 1:RIGHT_ARM_JOINT], self.arm_angle_r,
                          base[RIGHT_ARM_JOINT + 1:]])
        return pose[None, :]

    @staticmethod
    def pose_error(state_dict, ground_truth_pose) -> float:
        """|arm_angle_l - gt[38]| + |arm_angle_r - gt[41]| of a state dict."""
        gt = np.asarray(ground_truth_pose).reshape(-1)
        pl = float(state_dict["arm_angle_l"].reshape(-1)[0])
        pr = float(state_dict["arm_angle_r"].reshape(-1)[0])
        return float(abs(pl - gt[LEFT_ARM_JOINT]) + abs(pr - gt[RIGHT_ARM_JOINT]))
