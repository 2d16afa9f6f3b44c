"""SMPLify pose priors (counterpart of smpl_nerf_tpu/baselines/pose_priors.py).

  * MaxMixturePrior: the negative log of a max over GMM components fitted to
    mocap poses. The mixture data (SMPLify's gmm_08.pkl) is MPI-licensed and
    not shipped: the class loads a user-supplied file,
  * angle_prior / l2_prior: from baselines/silhouette_pose_fit.py.
"""
from __future__ import annotations

import os
import pickle
from typing import Optional

import numpy as np
import torch

from smpl_nerf_tpu_torch.baselines.silhouette_pose_fit import angle_prior, l2_prior  # noqa: F401


class MaxMixturePrior:
    """Max-of-gaussians pose prior over the 69-dim body pose:

      nll(pose) = min_k [ 0.5 (pose - mu_k)^T P_k (pose - mu_k) - log w_k + c_k ]

    with P_k the precision matrices and c_k = 0.5 log det(covar_k). Loads
    SMPLify's gmm_XX.pkl layout {means [K, 69], covars [K, 69, 69], weights
    [K]}. The constants are float32 tensors on `device`.
    """

    def __init__(self, means: np.ndarray, covars: np.ndarray, weights: np.ndarray,
                 device="cpu"):
        self.means = torch.as_tensor(np.asarray(means, np.float32), device=device)
        self.precisions = torch.as_tensor(np.linalg.inv(covars).astype(np.float32),
                                          device=device)
        logdets = np.linalg.slogdet(covars)[1]
        self.consts = torch.as_tensor((0.5 * logdets - np.log(weights)).astype(np.float32),
                                      device=device)

    @classmethod
    def load(cls, path: str, device="cpu") -> Optional["MaxMixturePrior"]:
        """The prior from a user's gmm pkl, or None when there is no such file.
        The file is unpickled: load only one you trust."""
        if not path or not os.path.exists(path):
            return None
        with open(path, "rb") as fh:
            data = pickle.load(fh, encoding="latin1")
        return cls(np.asarray(data["means"]), np.asarray(data["covars"]),
                   np.asarray(data["weights"]).reshape(-1), device=device)

    def __call__(self, pose: torch.Tensor) -> torch.Tensor:
        """pose [69] (or [..., 69]) -> scalar (or [...]) neg-log-likelihood."""
        diff = pose[..., None, :] - self.means                 # [..., K, 69]
        quad = 0.5 * torch.einsum("...ki,kij,...kj->...k", diff, self.precisions, diff)
        return torch.min(quad + self.consts, -1).values
