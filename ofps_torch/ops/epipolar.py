"""Point normalization helpers of ``ofps_tpu.ops.epipolar`` (the part the
homography estimator uses).

Image points are (..., N, 2) in [0, 1] screen space with (..., N) weights
(0/1 masks or soft weights); leading dims are batch.
"""

from __future__ import annotations

import math

import torch


def homogeneous(p: torch.Tensor) -> torch.Tensor:
    return torch.cat([p, torch.ones_like(p[..., :1])], dim=-1)


def hartley_normalization(p: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Similarity transform T with T*p at zero weighted centroid and mean
    distance sqrt(2).  ``p``: (..., N, 2); ``w``: (..., N).  Returns
    (..., 3, 3)."""
    wsum = torch.clamp(torch.sum(w, dim=-1), min=1e-12)
    c = torch.sum(p * w[..., None], dim=-2) / wsum[..., None]
    diff = p - c[..., None, :]
    d = torch.sqrt(torch.sum(diff * diff, dim=-1))
    mean_d = torch.sum(d * w, dim=-1) / wsum
    s = math.sqrt(2.0) / torch.clamp(mean_d, min=1e-12)
    z = torch.zeros_like(s)
    o = torch.ones_like(s)
    return torch.stack(
        [
            torch.stack([s, z, -s * c[..., 0]], -1),
            torch.stack([z, s, -s * c[..., 1]], -1),
            torch.stack([z, z, o], -1),
        ],
        dim=-2,
    )
