"""Checks of homography's fit on the kernels against its plain version
(``kernels/homography.ransac`` against ``estimators/homography.ransac_plain``),
shared by the emulated and the card tests.

The two versions sum the refit over the points in different orders, so
their refined homographies differ by float32 rounding.  On the
decomposition's pure-rotation branch (s1^2 - s3^2 < 1e-4) both families
are the polar projection of the calibrated homography, which that
rounding moves by well under 1e-6 rad.  Elsewhere the families are built
from the eigenvectors of Hn^T Hn, whose eigenvalues are s3^2 <= 1 <= s1^2
once Hn is scaled to s2 = 1: float32 rounding moves an eigenvector by
about eps over the distance to the nearest other eigenvalue, so the
families are held within 1e-6 rad plus 2 eps / min(s1^2 - 1, 1 - s3^2).
That distance is small where the translation is nearly along the plane's
normal; the plain decomposition alone, given two homographies one
rounding apart, then gives rotations up to ~0.4 eps over it apart.
"""

from __future__ import annotations

import numpy as np
import torch

from ofps_torch.core import quat

EPS32 = float(np.finfo(np.float32).eps)


def family_gap(got: torch.Tensor, ref: torch.Tensor) -> torch.Tensor:
    """Per stream the angle (rad) between ``got``'s two family rotations
    (B, 2, 4) and ``ref``'s, family by family: the larger of the two
    families' angles, in the pairing (as they stand or swapped) where it is
    smaller, since the two versions may order the families either way."""
    d = quat.angle_to(got[:, :, None, :].double().cpu(), ref[:, None, :, :].double().cpu())
    same = torch.maximum(d[:, 0, 0], d[:, 1, 1])
    swapped = torch.maximum(d[:, 0, 1], d[:, 1, 0])
    return torch.minimum(same, swapped)


def family_tolerance(h: torch.Tensor, camera) -> torch.Tensor:
    """Per stream of homographies ``h`` (B, 3, 3) the angle (rad) within
    which two float32 decompositions one rounding apart agree: 1e-6 on the
    pure-rotation branch, 1e-6 + 2 eps / min(s1^2 - 1, 1 - s3^2)
    elsewhere."""
    k = camera.intrinsics().double()
    s = torch.linalg.svdvals(torch.linalg.inv(k) @ h.double().cpu() @ k)
    s1sq, s3sq = (s[:, 0] / s[:, 1]) ** 2, (s[:, 2] / s[:, 1]) ** 2
    apart = torch.minimum(s1sq - 1, 1 - s3sq).clamp(min=1e-30)
    return torch.where(s1sq - s3sq < 1e-4, 1e-6, 1e-6 + 2 * EPS32 / apart)


def assert_fit_matches(got, ref, held: torch.Tensor, camera=None) -> None:
    """On the ``held`` streams: each of the kernels' family rotations within
    1e-6 rad of the plain one (``camera`` given: within
    :func:`family_tolerance`, for fields off the pure-rotation branch), and
    the translation norms |t| within the same; on every stream the
    kernels' rotation the first minimum of their own squared norms, as
    ``torch.argmin`` takes it."""
    held = held.cpu()
    tol = (torch.full(held.shape, 1e-6, dtype=torch.float64) if camera is None
           else family_tolerance(ref.h, camera))[held]
    gap = family_gap(got.quats, ref.quats)[held]
    assert bool((gap <= tol).all()), (gap, tol)
    tgap = (got.tnorm.double().sqrt() - ref.tnorm.double().sqrt()).abs().amax(-1).cpu()[held]
    assert bool((tgap <= tol).all()), (tgap, tol)
    first = torch.argmin(got.tnorm, dim=-1)
    rows = torch.arange(got.rot.shape[0], device=first.device)
    assert torch.equal(got.rot, got.quats[rows, first])
