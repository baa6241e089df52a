#!/usr/bin/env python3
"""Count the PyTorch operations one estimator call dispatches, on the CPU.

    python3 scripts/count_consumer_ops.py [--batch 4]

On the CUDA graph of the serving step's consumers nearly every dispatched
operation is one kernel launch, so this count (views excluded) is the
launch budget of an estimator, without a card.  For each built-in
estimator at the 1080p serving grid (84x150, dense draws), it
prints the total and the split by the innermost of its stages
(``ops/solve``, ``ops/epipolar``, ``ops/five_point``, ``ops/robust``, libmv
helpers and almeida's ``ransac_plain``; the rest is the stage code of
``robust_fit``, the estimator and its other ops).  libmv runs from the
empty carry.  Almeida's count is its CPU path, the plain version; on CUDA
``ransac_plain``'s operations are the hand kernels' three launches
(``kernels/almeida.ransac``), so its line also gives the CUDA count.
"""

from __future__ import annotations

import argparse
import collections
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent

# Operations that only make a view: no kernel.
VIEWS = {
    "view", "expand", "slice", "select", "unsqueeze", "squeeze", "transpose", "t",
    "permute", "alias", "_unsafe_view", "unbind", "split", "diagonal", "as_strided",
    "detach", "lift_fresh", "_reshape_alias",
}
STAGES = (
    "gauss_solve", "gauss_solve_pivoted", "eigh3x3", "svd3x3", "inv3x3",
    "smallest_eigvecs_inverse_iteration", "hartley_normalization", "masked_median",
    "_trig_eval", "_tangent_seeds", "_reduced_bpoly", "five_point_essential",
    "seven_point_fundamental", "eight_point_fundamental", "refine_pose_sampson",
    "rotation_only_fallback", "recover_pose_from_essential", "sampson_error",
    "rasterize_prev", "find_nearest", "robust_fit", "ransac_plain",
)
# Launches of kernels/almeida.ransac in place of ransac_plain on CUDA.
ALMEIDA_KERNEL_LAUNCHES = 3


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=4, help="streams")
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT))
    import torch
    from torch.utils._python_dispatch import TorchDispatchMode

    from ofps_torch.core.camera import StandardCamera
    from ofps_torch.core.motion import field_to_sparse
    from ofps_torch.estimators.base import available_estimators, create_estimator
    from ofps_torch.pipeline.graphs import tile

    class Count(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.by_stage = collections.Counter()

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if func.overloadpacket.__name__ not in VIEWS:
                frame, stage = sys._getframe(1), "stage code"
                while frame is not None:
                    if frame.f_code.co_name in STAGES:
                        stage = frame.f_code.co_name
                        break
                    frame = frame.f_back
                self.by_stage[stage] += 1
            return func(*args, **(kwargs or {}))

    cam = StandardCamera.create(1920 / 1080, 60.0)
    gen = torch.Generator().manual_seed(0)
    grid = torch.randn((args.batch, 84, 150, 2), generator=gen) * 1e-3
    flow = field_to_sparse(grid)
    for name in available_estimators():
        est = create_estimator(name)
        draws = est.draw(gen, (args.batch,), 84 * 150, "cpu")
        carry = tile(est.init(), args.batch, "cpu")
        est.estimate(carry, flow, cam, dense=True, fit_idx=draws)  # fill the caches
        with Count() as count:
            est.estimate(carry, flow, cam, dense=True, fit_idx=draws)
        total = sum(count.by_stage.values())
        line = f"{name} B={args.batch}: {total} operations"
        if name == "almeida":
            cuda = total - count.by_stage["ransac_plain"] + ALMEIDA_KERNEL_LAUNCHES
            line += (f" on the CPU's plain path, {cuda} on CUDA ({ALMEIDA_KERNEL_LAUNCHES} "
                     f"kernel launches for ransac_plain's {count.by_stage['ransac_plain']})")
        print(f"{line}: {dict(count.by_stage.most_common())}", flush=True)


if __name__ == "__main__":
    main()
