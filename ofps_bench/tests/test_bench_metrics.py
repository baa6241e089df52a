"""The metric readers give known answers on hand-made records."""

import types

import pytest

from ofps_bench import roofline, run, serve, spec, trace


def _x(name, cat, ts, dur, corr=None, tid=1):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur, "tid": tid,
            "args": {} if corr is None else {"correlation": corr}}


EVENTS = [
    _x("ofps_bench.step", "user_annotation", 0, 100),
    _x("ofps_bench.step", "user_annotation", 100, 100),
    _x("ofps_bench.upload", "user_annotation", 4, 2),
    _x("cudaLaunchKernel", "cuda_runtime", 5, 0.5, corr=3),
    _x("cudaGraphLaunch", "cuda_runtime", 10, 8, corr=1),
    _x("cudaGraphLaunch", "cuda_runtime", 110, 8, corr=2),
    _x("cudaLaunchKernel", "cuda_runtime", 60, 0.5, corr=4),
    _x("cudaLaunchKernel", "cuda_runtime", 61, 0.5, corr=5),
    _x("to_float", "kernel", 20, 5, corr=3, tid=7),
    _x("consumer", "kernel", 30, 40, corr=1, tid=7),
    _x("void refine_sep_kernel<2, false>(float)", "kernel", 72, 10, corr=4, tid=7),
    _x("grid_finish", "kernel", 85, 5, corr=5, tid=7),
    _x("consumer", "kernel", 130, 40, corr=2, tid=7),
]


def _record(perf=None, timeline=None, cell=None, step_s=(), traced=range(0)):
    served = serve.Served(step_s=list(step_s), window_s=0.0, frames=0, t_open=0.0,
                          window=range(10, 10 + len(step_s)), perf=perf or {}, counters={},
                          timeline=timeline, outputs={}, failed=0, traced=traced)
    return types.SimpleNamespace(served=served, timeline=timeline, cell=cell)


def test_timeline_classes_and_idle():
    tl = trace.parse_events(EVENTS)
    assert tl.marks == [0, 100, 200] and trace.steps(tl) == 2
    assert [o.kind for o in tl.ops] == ["harness", "graph", "eager", "eager", "graph"]
    assert trace.busy_us(tl) == 100.0
    # 50 us busy a traced step (steps 14-15).  The steps before the profiler
    # started (10-12; it starts in 13 and stops in 16) take 80 us at the
    # median, so the device idles 37.5% of a step; the traced steps' 1 ms and
    # the later steps are not read.
    step_s = [80e-6, 70e-6, 90e-6, 1e-3, 1e-3, 1e-3, 1e-3, 200e-6, 300e-6]
    rec = _record(timeline=tl, step_s=step_s, traced=range(14, 16))
    assert rec.served.after_trace_step_s() == [200e-6, 300e-6]
    assert spec.metric_reader("device_idle_pct")(rec) == pytest.approx(100 * (1 - 50 / 80))
    # The steps before the profiler (80, 70, 90 us): rank 0.95 * 2 = 1.9.
    assert spec.metric_reader("step_p95_ms.untraced")(rec) == pytest.approx(0.08 + 0.9 * 0.01)
    assert spec.metric_reader("consumers_device_ms")(_record(timeline=tl)) == pytest.approx(0.04)
    # The flow: step 1's eager ops up to its hand kernel (10 us), step 2 none.
    assert spec.metric_reader("flow_device_ms")(_record(timeline=tl)) == pytest.approx(0.005)
    gaps = trace.breakdown(tl)["idle_gaps"]
    # 90..130, the host in the graph's launch at its middle; then 170..200.
    assert gaps[:2] == [["cudaGraphLaunch", pytest.approx(40e-6)],
                        ["ofps_bench.step", pytest.approx(30e-6)]]
    assert trace.breakdown(tl)["device_ops"][0] == ["consumer", pytest.approx(80e-6)]


def test_roofline_share():
    tl = trace.parse_events(EVENTS)
    cfg = {"width": 1920, "height": 1080}
    cell = types.SimpleNamespace(config=cfg, traffic={"streams": 8})
    got = spec.metric_reader("flow_roofline")(_record(timeline=tl, cell=cell))
    bound = roofline.step_bound_ms(8, 1080, 1920, (84, 150))
    assert got == pytest.approx(100 * bound / 0.005)


def test_readers_find_nothing_without_a_trace():
    # No trace, and a trace without a marked step (no harness range in it).
    unmarked = trace.parse_events([e for e in EVENTS if e["name"] != "ofps_bench.step"])
    for name in ("device_idle_pct", "consumers_device_ms", "flow_device_ms",
                 "flow_roofline", "decode_wait_ms.b32", "upload_ms",
                 "step_enqueue_ms.codec", "step_enqueue_ms.frames"):
        assert spec.metric_reader(name)(_record()) is None
        assert spec.metric_reader(name)(_record(timeline=unmarked, step_s=[0.03])) is None
    assert spec.metric_reader("step_p95_ms.untraced")(_record()) is None


def test_perfstats_readers():
    perf = {"decode": [0.001, 0.003], "upload": [0.002], "step": [0.004, 0.006],
            "enqueue": [0.01]}
    rec = _record(perf=perf)
    assert spec.metric_reader("decode_wait_ms.b32")(rec) == pytest.approx(2.0)
    assert spec.metric_reader("upload_ms")(rec) == pytest.approx(2.0)
    assert spec.metric_reader("step_enqueue_ms.codec")(rec) == pytest.approx(5.0)
    assert spec.metric_reader("step_enqueue_ms.frames")(rec) == pytest.approx(10.0)


def test_p95_is_over_all_steps():
    # Rank 0.95 * 99 = 94.05: 5% of the way from the 95th sorted step to the 96th.
    steps = [0.100] * 5 + [0.030] * 95
    assert run.p95(steps) == pytest.approx(0.030 + 0.05 * 0.070)
    assert run.p95([0.030] * 94 + [0.100] * 6) == pytest.approx(0.100)
    served = types.SimpleNamespace(frames=800, window_s=4.0, step_s=[0.03] * 99 + [1.0],
                                   t_open=12.0, timeline=None)
    e2e = run.end_to_end(run.Record(None, served, 2.0))
    assert e2e == {"stream_fps": 200.0, "step_p95_ms": pytest.approx(30.0), "setup_s": 10.0}
