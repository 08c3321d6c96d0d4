"""Max-of-Gaussians (GMM) pose prior.

Counterpart of tuch_tpu/losses/prior.py: the precisions and the NLL
weights are computed once on the host in float64 and kept as float32
tensors; the forward is an einsum and a min over components.
"""

from typing import NamedTuple

import numpy as np
import torch


class GMMPrior(NamedTuple):
    means: torch.Tensor        # (M, 69)
    precisions: torch.Tensor   # (M, 69, 69)
    nll_weights: torch.Tensor  # (1, M)

    def to(self, device) -> 'GMMPrior':
        return GMMPrior(*(t.to(device) for t in self))


def create_gmm_prior(gmm: dict, epsilon: float = 1e-16,
                     device='cpu') -> GMMPrior:
    """gmm: dict(means, covs, weights), as from assets.load_gmm_prior."""
    means = np.asarray(gmm['means'], np.float64)
    covs = np.asarray(gmm['covs'], np.float64)
    weights = np.asarray(gmm['weights'], np.float64)
    precisions = np.stack([np.linalg.inv(c) for c in covs])
    sqrdets = np.array([np.sqrt(np.linalg.det(c)) for c in covs])
    const = (2 * np.pi) ** (69 / 2.0)
    nll_weights = (weights / (const * (sqrdets / sqrdets.min())))[None]
    return GMMPrior(*(torch.as_tensor(x.astype(np.float32), device=device)
                      for x in (means, precisions, nll_weights)))


def gmm_prior_nll(prior: GMMPrior, body_pose: torch.Tensor) -> torch.Tensor:
    """Least negative log likelihood over components, (B, 69) -> (B,)."""
    diff = body_pose[:, None, :] - prior.means[None]         # (B, M, 69)
    pd = torch.einsum('mij,bmj->bmi', prior.precisions, diff)
    quad = (pd * diff).sum(-1)                                # (B, M)
    ll = 0.5 * quad - torch.log(prior.nll_weights)
    return ll.min(dim=1).values
