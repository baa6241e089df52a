"""``tr_deg``: the widest angle, in degrees, between the direction of a
translation the program served and the reference's, over every checked
step, stream and estimator.

The served translations are ``run_batch``'s per-step history
(``served.outputs["result"].delta_tr``, per estimator (T, B, 3)); a result
without it cannot be judged, and the check raises.  The reference makes
the seed's draws for every step, the same calls in the same order as the
served step, and runs each checked step from the estimators' initial
state, as the built-in numbers do.

What is judged is a direction, as the nearer of +-t.  libmv, the only
estimator that translates, takes its direction from the step's primary
solve and only its signed length from the chain it carries: the sign is a
choice among an essential matrix's decompositions (as homography's two
families are for rotation), and the length is the chain's scale, which
under pure rotation shrinks by roughly a third a step until float32 holds
no length at all (a CPU replay at 640x352: 1 at step 1, ~1e-6 by step 32,
0 by step 64).  So:

* a served translation at least ``SERVED_MIN`` long has a direction, and
  reads its angle to the reference's, or 90 degrees where the reference's
  solve found no translation (shorter than ``MIN_NORM``);
* a shorter one is skipped: its length is the chain's, which the check
  does not replay (a replay of libmv over a 20 s window's ~500 steps took
  48 s on the H100, and its chained lengths fall under ``MIN_NORM``
  within ~30 steps, after which a replayed check judges nothing);
* one that is not finite reads inf.
"""

from __future__ import annotations

import numpy as np
import torch

from ofps_bench.check import _rows

MIN_NORM = 1e-6  # the reference's unit translation, or none
# float32 rounds each component of a vector this long to ~1e-45 at worst
# (its smallest subnormal), a part in 1e15 of its length.
SERVED_MIN = 1e-30


def line_angle_deg(served: np.ndarray, ref: np.ndarray) -> np.ndarray:
    """The angles (degrees) between the lines of (..., 3) ``served`` and
    ``ref``, for the served translations that are judged (above)."""
    s = np.asarray(served, np.float64)
    r = np.asarray(ref, np.float64)
    cross = np.linalg.norm(np.cross(s, r), axis=-1)
    dot = np.abs(np.sum(s * r, axis=-1))
    ang = np.degrees(np.arctan2(cross, dot))
    ang = np.where(np.linalg.norm(r, axis=-1) >= MIN_NORM, ang, 90.0)
    finite = np.isfinite(s).all(-1)
    ang = np.where(finite, ang, np.inf)
    with np.errstate(invalid="ignore"):
        judged = ~finite | (np.linalg.norm(s, axis=-1) >= SERVED_MIN)
    return ang[judged]


def number(cell, seed, served, ref, checked) -> float:
    tr = getattr(served.outputs["result"], "delta_tr", None)
    if tr is None:
        raise ValueError("tr_deg: the result records no per-step translations "
                         "(run_batch's BatchResult.delta_tr)")
    b, cap = cell.traffic["streams"], cell.config["capacity"]
    bank = served.outputs["bank"]
    checked = set(checked)
    gen = torch.Generator(device=ref.device).manual_seed(seed)
    widest = 0.0
    for t in range(max(checked) + 1):
        draws = ref.draws(gen, b, cap, dense=False)
        if t in checked:
            got = ref.codec_step(_rows(bank, t, cap, ref.device), draws)
            for e, r in enumerate(got.tr):
                ang = line_angle_deg(np.asarray(tr[e][t]), r.detach().cpu().numpy())
                widest = max([widest, *ang.tolist()])
    return widest
