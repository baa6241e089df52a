"""Dense flow (``ops/flow_pyramid``, ``kernels/``): device ms a traced step
of the eager operations after the frame upload up to and with the last hand
kernel (pyramid, warm-start resize, 4 ``refine_sep_kernel``, 3
``refine_2d_kernel``, 1 ``guard_kernel``).  Nothing where the trace shows no
hand kernel."""

from ofps_bench import trace


def read(rec):
    tl = rec.timeline
    if tl is None or trace.steps(tl) <= 0 or not any(
            sum(trace.hand_kernel_us(ops).values()) for ops in trace.step_ops(tl)):
        return None
    return trace.mean_per_step(tl, lambda ops: sum(o.dur for o in trace.flow_ops(ops)))
