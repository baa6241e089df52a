"""The port's span recorder (``ofps_torch.pipeline.runtime.PerfStats``) and
what writes into it, on the CPU at tiny sizes.

* A ``step_from_frames`` and a ``step_from_flow`` step: the spans' names,
  step index and parents, ``start <= end``, and no span's children cover
  more than its own interval (self time >= 0).
* ``run_batch``: its four stages keep one entry a step and JAX's CSV header
  with "upload" added (``tests/test_torch_batch.py`` compares it with JAX's);
  a ``step`` span a step holds the upload's and the pipeline's spans, and
  ``decode.work`` is the slowest feed's parse.
* ``BatchResult.throughput_fps``: stream-frames over the four stages' totals.
* A graph replay's section spans (``PerfStats.replayed``): read once their
  end event completes, or missed where it has not by the next replay.
* The step bound (a smaller one given to the constructor), ``record_function``
  entered only under the profiler, ``last_perf`` returning a sharded
  pipeline's recorder (its rows write into it), and the benchmark's span
  readers on a hand-made recorder.
"""

import json
import types

import numpy as np
import pytest
import torch

from ofps_bench import serve, spec
from ofps_torch.apps import batch as tbatch
from ofps_torch.core.camera import StandardCamera
from ofps_torch.core.motion import SparseFlow
from ofps_torch.decoders.mvec import write_mvec_frame
from ofps_torch.detectors.base import create_detector
from ofps_torch.estimators.base import create_estimator
from ofps_torch.ops.flow_pyramid import FlowParams
from ofps_torch.parallel import make_stream_mesh, stream_sharding
from ofps_torch.parallel.stream import StreamPipeline
from ofps_torch.pipeline import runtime
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

H, W, B, CAP = 96, 160, 2, 256
# The spans of ``_pipe``'s consumers, children of ``consumers``: one a
# section, host times only off the card.
CONSUMER_SECTIONS = [("consumers.est.almeida", "consumers"),
                     ("consumers.det.block_motion", "consumers")]


def _pipe(**kw):
    return StreamPipeline(
        StandardCamera.create(W / H, 60.0), [create_estimator("almeida")],
        create_detector("block_motion"),
        flow_params=FlowParams(levels=3, coarse_search=3, fuse_min_pixels=3000),
        emit_dense_flow=False, device="cpu", **kw)


def _sparse(b, seed=0):
    rng = np.random.default_rng(seed)
    pos = torch.tensor(rng.uniform(0.05, 0.95, (b, CAP, 2)), dtype=torch.float32)
    motion = torch.tensor(rng.normal(0.0, 0.01, (b, CAP, 2)), dtype=torch.float32)
    return SparseFlow(pos, motion, torch.ones((b, CAP)))


def _check_tree(spans):
    """Every span closed, start <= end, and each span's children inside it
    covering no more than its own interval."""
    for sp in spans:
        assert sp.end is not None and sp.start <= sp.end, sp.name
        kids = [k for k in spans if k.parent is sp]
        for k in kids:
            assert sp.start <= k.start and k.end <= sp.end, (sp.name, k.name)
        assert (sp.end - sp.start) - sum(k.end - k.start for k in kids) >= -1e-9, sp.name


def _tree(spans):
    return [(sp.name, sp.parent.name if sp.parent else None) for sp in spans]


def test_step_spans_of_both_paths():
    pipe = _pipe()
    perf = pipe.perf
    gen = torch.Generator().manual_seed(0)
    state = pipe.init_state(B, H, W)
    for _ in range(2):
        state, _ = pipe.step_from_frames(state, torch.rand(B, H, W) * 255, gen)
    assert list(perf.spans) == [0, 1]
    for step, spans in perf.spans.items():
        assert _tree(spans) == [("step", None), ("flow", "step"), ("draws", "step"),
                                ("consumers", "step"), *CONSUMER_SECTIONS]
        assert all(sp.step == step and sp.row is None for sp in spans)
        assert all(sp.device_ms is None for sp in spans)  # no card: host times only
        _check_tree(spans)
    state = pipe.init_state(B, 1, 1)
    pipe.step_from_flow(state, _sparse(B), gen)
    assert _tree(perf.spans[2]) == [("step", None), ("draws", "step"), ("consumers", "step"),
                                     *CONSUMER_SECTIONS]
    _check_tree(perf.spans[2])
    assert perf.span_names() == ["step", "flow", "draws", "consumers",
                                 "consumers.est.almeida", "consumers.det.block_motion"]
    assert perf.stages == {}


def _write_streams(tmp_path, n_frames):
    paths = []
    rng = np.random.default_rng(3)
    for s in range(B):
        path = tmp_path / f"s{s}.mvec"
        with open(path, "wb") as f:
            for _ in range(n_frames):
                write_mvec_frame(f, rng.uniform(0.05, 0.95, (64, 2)),
                                 rng.normal(0.0, 0.01, (64, 2)))
        paths.append(str(path))
    return paths


def test_run_batch_stages_and_spans(tmp_path):
    res = tbatch.run_batch(_write_streams(tmp_path, 4), capacity=CAP, max_frames=3,
                           device="cpu")
    perf = res.perf
    assert res.frames == 3
    assert {k: len(v) for k, v in perf.stages.items()} == {
        "decode": 3, "upload": 3, "step": 3, "fetch": 3}
    perf.write_csv(str(tmp_path / "p.csv"))
    header = (tmp_path / "p.csv").read_text().splitlines()[0].split(",")
    assert header == ["frame", "decode", "fetch", "step", "upload"]  # JAX's and "upload"
    assert list(perf.spans) == [0, 1, 2]
    for step, spans in perf.spans.items():
        assert sorted(_tree(spans)) == sorted([
            ("step", None), ("decode.work", None), ("upload.wait", "step"),
            ("upload.pack", "step"), ("pipeline.step", "step"), ("draws", "pipeline.step"),
            ("consumers", "pipeline.step"), *CONSUMER_SECTIONS])
        assert all(sp.step == step for sp in spans)
        _check_tree([sp for sp in spans if sp.name != "decode.work"])
        work = next(sp for sp in spans if sp.name == "decode.work")
        assert 0.0 < work.end - work.start and work.end <= spans[0].end
    assert runtime.last_perf() is perf
    stages = perf.summary()
    total_s = sum(s["total_ms"] for s in stages.values()) / 1e3
    assert res.throughput_fps() == pytest.approx(3 * B / total_s)


def test_throughput_fps_is_over_the_four_stages():
    perf = runtime.PerfStats()
    for stage, s in (("decode", 0.001), ("upload", 0.002), ("step", 0.003), ("fetch", 0.004)):
        perf.add(stage, s)
        perf.add(stage, s)
    res = tbatch.BatchResult(frames=2, streams=8, poses_rot=[], poses_pos=[], detections=None,
                             perf=perf)
    assert res.throughput_fps() == pytest.approx(2 * 8 / 0.020)
    empty = tbatch.BatchResult(frames=0, streams=8, poses_rot=[], poses_pos=[],
                               detections=None, perf=runtime.PerfStats())
    assert empty.throughput_fps() == 0.0


def test_records_keep_the_newest_steps():
    perf = runtime.PerfStats(max_steps=4)
    for _ in range(10):
        with perf.span("step"):
            with perf.span("child"):
                pass
        perf.record("decode.work", 0.0, 1.0)
    assert list(perf.spans) == [6, 7, 8, 9]
    assert all(len(spans) == 3 for spans in perf.spans.values())
    with perf.span("step", step=100):
        pass
    assert list(perf.spans) == [7, 8, 9, 100]
    assert perf.depth == 0


def test_close_ends_spans_left_open_inside():
    perf = runtime.PerfStats()
    with perf.span("step") as step:
        perf.open("left_open")
    inner = perf.spans[0][1]
    assert inner.end == step.end and perf.depth == 0
    assert perf.close(inner) == step.end  # closing again changes nothing


def test_record_function_only_under_the_profiler(monkeypatch, tmp_path):
    entered = []
    real = torch.autograd.profiler.record_function

    class Counting(real):
        def __enter__(self):
            entered.append(self.name)
            return super().__enter__()

    monkeypatch.setattr(torch.autograd.profiler, "record_function", Counting)
    pipe = _pipe()
    gen = torch.Generator().manual_seed(0)
    state = pipe.init_state(B, 1, 1)
    state, _ = pipe.step_from_flow(state, _sparse(B), gen)
    assert entered == []
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        pipe.step_from_flow(state, _sparse(B, 1), gen)
    assert entered == ["ofps_torch.step", "ofps_torch.draws", "ofps_torch.consumers",
                       "ofps_torch.consumers.est.almeida",
                       "ofps_torch.consumers.det.block_motion"]
    prof.export_chrome_trace(str(tmp_path / "t.json"))
    events = json.loads((tmp_path / "t.json").read_text())["traceEvents"]
    ranges = {e["name"] for e in events if e.get("cat") == "user_annotation"}
    assert {"ofps_torch.step", "ofps_torch.draws", "ofps_torch.consumers"} <= ranges
    pipe.step_from_flow(state, _sparse(B, 2), gen)
    assert len(entered) == 5


def test_last_perf_is_the_sharded_pipelines():
    plain = _pipe()
    assert runtime.last_perf() is plain.perf
    mesh = make_stream_mesh(2, space=1, devices=["cpu"] * 2)
    pipe = _pipe(shardings=stream_sharding(mesh))
    assert runtime.last_perf() is pipe.perf
    assert all(row.perf is pipe.perf for row in pipe._rows)
    state = pipe.init_state(B, 1, 1)
    pipe.step_from_flow(state, _sparse(B), torch.Generator().manual_seed(0))
    spans = pipe.perf.spans[0]
    assert [(sp.name, sp.row) for sp in spans if sp.name == "pipeline.step"] == [
        ("pipeline.step", 0), ("pipeline.step", 1)]
    assert sorted((sp.name, sp.row) for sp in spans if sp.name == "consumers") == [
        ("consumers", 0), ("consumers", 1)]
    assert all(sp.parent.name == "step" for sp in spans if sp.name == "pipeline.step")
    _check_tree(spans)


class _GraphEvent:
    """A timing event that a replayed graph records: complete or not, and
    its time from the section's start event."""

    def __init__(self, ms=0.0, done=True):
        self.ms, self.done = ms, done

    def query(self):
        return self.done

    def synchronize(self):
        self.done = True

    def elapsed_time(self, end):
        return end.ms


def test_replayed_sections_are_read_or_missed():
    """A replay's section spans are children of its span, read once their
    end event completes (at the next root, without waiting) or settled
    before the graph replays again, where an incomplete one is missed; the
    graph's events never go into the recorder's pool."""
    perf = runtime.PerfStats()
    sections = [("consumers.est.a", _GraphEvent(), _GraphEvent(2.0)),
                ("consumers.det.b", _GraphEvent(), _GraphEvent(0.5, done=False))]
    last = []
    for t in range(3):
        with perf.span("step"):
            perf.settle(last)
            launch = perf.open("consumers.launch")
            perf.close(launch)
            last = perf.replayed(launch, sections)
            assert [(sp.name, sp.parent) for sp in last] == [
                ("consumers.est.a", launch), ("consumers.det.b", launch)]
            assert all(sp.start == launch.start and sp.end == launch.end for sp in last)
    # Steps 0 and 1: a read at the next root, b missed at the next replay;
    # a reader waits for the last replay's events.
    assert perf.missed == 2
    assert perf.per_step("consumers.est.a", device=True) == {0: 2.0, 1: 2.0, 2: 2.0}
    assert perf.per_step("consumers.det.b", device=True) == {2: 0.5}
    assert perf._pool == {} and not perf._pending


def _fake_perf():
    """Steps 0-19, each a ``step`` with a flow, a pack and a consumers'
    launch whose host and device ms are the step's index (and twice it on
    the device); two captures at steps 0 and 12."""
    perf = runtime.PerfStats()
    for t in range(20):
        base = 10.0 * t
        with perf.span("step", t=base, step=t):
            for name in ("flow", "upload.pack", "consumers.launch"):
                sp = perf.open(name, t=base + 1.0)
                perf.close(sp, t=base + 1.0 + t / 1e3)
                sp.device_ms = 2.0 * t
            if t in (0, 12):
                sp = perf.open("consumers.capture", t=base + 2.0)
                perf.close(sp, t=base + 2.5)
                sp.nodes = 1000 + t
    return perf


def _record(window=range(10, 20), traced=range(15, 17)):
    served = serve.Served(step_s=[0.03] * len(window), window_s=0.0, frames=0, t_open=0.0,
                          window=window, perf={}, counters={}, timeline=None, outputs={},
                          failed=0, traced=traced)
    return types.SimpleNamespace(served=served, timeline=None, cell=None)


@pytest.mark.parametrize("name, want", [
    # The steps before the profiler: 10-13 (it starts in step 14).
    ("consumers_replay_ms", 2.0 * 11.5),
    ("consumers_launch_ms", 11.5),
    ("flow_stream_ms", 2.0 * 11.5),
    ("pack_ms", 11.5),
    ("consumers_graph_nodes", 1012.0),
    ("capture_s", 1.0),
])
def test_span_readers(monkeypatch, name, want):
    read = spec.metric_reader(name)
    monkeypatch.setattr(runtime, "_LAST", _fake_perf())
    assert read(_record()) == pytest.approx(want)
    if name not in ("consumers_graph_nodes", "capture_s"):  # the run's, not the window's
        assert read(_record(traced=range(0))) == pytest.approx(want * 14.5 / 11.5)
    monkeypatch.setattr(runtime, "_LAST", runtime.PerfStats())
    assert read(_record()) is None
    monkeypatch.setattr(runtime, "_LAST", None)
    assert read(_record()) is None
