"""The hand kernels' share of their roofline (``csrc/flow_refine.cu``,
``csrc/flow_refine_small.cu``): the least time the H100 could take for a
step's launches (``ofps_bench/roofline.py``) over their device time a
traced step, in %.  Nothing where the trace shows no hand kernel."""

from ofps_bench import roofline, trace
from ofps_bench.reference.motion import grid_size_for


def read(rec):
    ms = trace.mean_per_step(rec.timeline, lambda ops: sum(trace.hand_kernel_us(ops).values()))
    if not ms:
        return None
    cfg = rec.cell.config
    gw, gh = grid_size_for(cfg["width"], cfg["height"])
    bound = roofline.step_bound_ms(rec.cell.traffic["streams"], cfg["height"], cfg["width"],
                                   (gh, gw))
    return 100.0 * bound / ms
