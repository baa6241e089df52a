"""The port's batch runner and runtime (``ofps_torch.apps.batch``,
``ofps_torch.pipeline.runtime``) against ofps_tpu's on the CPU, over
``.mvec`` files written by the JAX package's writer.

* ``run_batch``: steps, detections and ``motion_ranges`` equal JAX's (the
  detector draws nothing, so it is compared exactly); almeida's GT error
  at most 0.05 deg per frame on every stream; ``drop_ended`` and lockstep
  truncation as in JAX, an ended stream's poses frozen exactly.
* ``PerfStats``: the same CSV for the same stages; ``run_batch``'s header is
  JAX's with the port's "upload" stage added.
* ``LivePipeline.set_property``: an unknown name raises, a static name
  returns False, a dynamic change takes effect on the next step.
"""

import csv
import math

import numpy as np
import pytest
import torch

from ofps_torch.apps import batch as tbatch
from ofps_torch.core.camera import StandardCamera as TCam
from ofps_torch.core.motion import SparseFlow as TSparse
from ofps_torch.detectors.base import create_detector as t_det
from ofps_torch.estimators.base import create_estimator as t_est
from ofps_torch.parallel.stream import StreamPipeline as TPipe
from ofps_torch.pipeline import runtime as trt
from ofps_tpu.apps import batch as jbatch
from ofps_tpu.apps import gt as jgt
from ofps_tpu.core import quat as jq
from ofps_tpu.decoders.mvec import write_mvec_frame
from ofps_tpu.pipeline import runtime as jrt
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

CAP = 4096
GATE_DEG = 0.05
# Per stream: the yaw of each frame after the first (an empty I-frame), in
# degrees; 0.05 deg moves the cells by less than block_motion's target.
SCHEDULES = [[0.4] * 5, [0.05, 0.05, 0.5, 0.5, 0.05], [0.3, 0.04, 0.3, 0.04, 0.3]]


def _write_streams(tmp_path, schedules, tag="s"):
    """A .mvec file and GT CSV per schedule, the flow of each frame the
    JAX package's synthetic rotation field (tests/synthetic.py)."""
    from synthetic import euler_deg, synthetic_field

    cam = jbatch.StandardCamera.create(16 / 9, 90.0)
    inputs, gts = [], []
    for si, yaws in enumerate(schedules):
        path, gt = tmp_path / f"{tag}{si}.mvec", tmp_path / f"{tag}{si}_gt.csv"
        acc = np.asarray(jq.identity(), np.float64)
        rows = [jgt.GroundTruthRow(frame=1, fov_x=90.0, fov_y=90.0, rot=acc.copy(),
                                   pos=np.zeros(3))]
        with open(path, "wb") as f:
            write_mvec_frame(f, np.zeros((0, 2)), np.zeros((0, 2)))
            for k, yaw in enumerate(yaws):
                q = euler_deg(0.0, 0.0, yaw)
                flow = synthetic_field(cam, q)
                keep = np.asarray(flow.mask) > 0.5
                write_mvec_frame(f, np.asarray(flow.pos)[keep], np.asarray(flow.motion)[keep])
                acc = np.asarray(jq.mul(q, acc), np.float64)
                rows.append(jgt.GroundTruthRow(frame=k + 2, fov_x=90.0, fov_y=90.0,
                                               rot=acc.copy(), pos=np.zeros(3)))
        jgt.write_ground_truth(str(gt), rows)
        inputs.append(str(path))
        gts.append(str(gt))
    return inputs, gts


def _both(inputs, **kw):
    ref = jbatch.run_batch(inputs, capacity=CAP, **kw)
    got = tbatch.run_batch(inputs, capacity=CAP, device="cpu", **kw)
    return got, ref


def test_run_batch_matches_jax(tmp_path):
    inputs, gts = _write_streams(tmp_path, SCHEDULES)
    got, ref = _both(inputs, ground_truths=gts, stats_csv_prefix=str(tmp_path / "st_"))
    assert got.frames == ref.frames == 6 and got.streams == 3
    np.testing.assert_array_equal(got.detections, ref.detections)
    assert got.detections.any() and not got.detections.all()
    for s in range(3):
        assert got.motion_ranges(s) == ref.motion_ranges(s)
    assert got.motion_ranges(1) == [(3, 4)]
    np.testing.assert_array_equal(got.active, ref.active)
    assert got.vectors[0].tolist() == [0, 0, 0] and (got.vectors[1:] > 1000).all()
    assert got.eager_runs == 6 and got.graph_replays == 0
    for s in range(3):
        err = math.degrees(got.gt_avg_err[(s, "almeida")][0])
        assert err <= GATE_DEG, (s, err, math.degrees(ref.gt_avg_err[(s, "almeida")][0]))
        with open(tmp_path / f"st_s{s}_almeida.csv") as f:
            assert len(list(csv.reader(f))) == 7  # header + 6 frames
    header = (tmp_path / "p.csv", tmp_path / "q.csv")
    got.perf.write_csv(str(header[0]))
    ref.perf.write_csv(str(header[1]))
    h_got = header[0].read_text().splitlines()[0].split(",")
    h_ref = header[1].read_text().splitlines()[0].split(",")
    assert h_got == ["frame"] + sorted(h_ref[1:] + ["upload"])
    assert got.throughput_fps() > 0


def test_run_batch_drop_ended_and_lockstep_as_jax(tmp_path):
    inputs, gts = _write_streams(tmp_path, [[0.4] * 2, [0.4] * 5, [0.3] * 5])
    kw = dict(ground_truths=gts)
    got, ref = _both(inputs, drop_ended=True, **kw)
    assert got.frames == ref.frames == 6
    np.testing.assert_array_equal(got.active, ref.active)
    assert got.active[:, 0].tolist() == [True] * 3 + [False] * 3
    for s in range(3):
        assert got.motion_ranges(s) == ref.motion_ranges(s)
    # The ended stream feeds empty flows: identity deltas, its pose frozen.
    rots = np.stack(got.rot_hist[0])[:, 0]
    assert (rots[3:] == rots[2]).all() and not (rots[2] == rots[1]).all()
    assert (np.stack(got.delta_rot[0])[3:, 0] == [1.0, 0.0, 0.0, 0.0]).all()
    assert got.vectors[3:, 0].tolist() == [0, 0, 0]
    got, ref = _both(inputs, **kw)  # strict lockstep: the shortest stream ends it
    assert got.frames == ref.frames == 3
    np.testing.assert_array_equal(got.detections, ref.detections)
    got, ref = _both(inputs, max_frames=2, fetch_lag=2, **kw)
    assert got.frames == ref.frames == 2 and len(got.delta_rot[0]) == 2


def test_perf_stats_csv_same_as_jax(tmp_path):
    tp, jp = trt.PerfStats(), jrt.PerfStats()
    for stage, xs in (("decode", [0.001, 0.002, 0.0015]), ("step", [0.03, 0.031]),
                      ("fetch", [0.0004])):
        for x in xs:
            tp.add(stage, x)
            jp.add(stage, x)
    tp.write_csv(str(tmp_path / "t.csv"))
    jp.write_csv(str(tmp_path / "j.csv"))
    assert (tmp_path / "t.csv").read_text() == (tmp_path / "j.csv").read_text()
    assert tp.summary() == jp.summary()
    with tp.time("upload"):
        pass
    assert tp.summary()["upload"]["frames"] == 1


def test_decoder_feed_and_timer():
    class Counting:
        def __init__(self, n):
            self.n = n

        def process_frame(self, want_frame=False, skip=0):
            self.n -= 1
            if self.n < 0:
                return None
            return trt.DecodedFrame(pos=np.zeros((1, 2)), motion=np.zeros((1, 2)))

    feed = trt.DecoderFeed(Counting(5))
    assert len(list(feed)) == 5
    feed.stop()
    assert not feed._thread.is_alive()
    timer = trt.RealtimeTimer(1000.0)
    for _ in range(3):
        timer.tick()
    trt.RealtimeTimer(None).tick()


def test_live_pipeline_set_property():
    pipe = TPipe(TCam.create(1.0, 90.0), [t_est("almeida", num_iters=16)],
                 t_det("block_motion"), device="cpu")
    live = trt.LivePipeline(pipe, batch=2, height=1, width=1, from_flow=True)
    rng = np.random.default_rng(0)
    pos = torch.from_numpy(rng.uniform(0, 1, (2, 500, 2)).astype(np.float32))
    mot = torch.full((2, 500, 2), 0.006)
    flow = TSparse(pos, mot, torch.ones(2, 500))
    _, out = live.step(flow, torch.Generator().manual_seed(0))
    assert out.detection.detected.all()
    with pytest.raises(KeyError):
        live.set_property("detector", "no_such_prop", 1.0)
    with pytest.raises(TypeError):
        live.set_property("almeida", "use_ransac", 3)
    assert live.set_property("detector", "min_size", 0.2) is False  # static
    assert live.set_property(0, "num_iters", 50) is False
    target = live.props["detector"]["target_motion"]
    assert live.set_property("detector", "target_motion", 0.05) is True
    assert live.props["detector"]["target_motion"] is target  # written in place
    assert float(target) == pytest.approx(0.05)
    _, out = live.step(flow, torch.Generator().manual_seed(0))
    assert not out.detection.detected.any()
    assert live.set_property("almeida", "inlier_angle_deg", 99.0) is True  # clamped
    assert float(live.props["estimators"][0]["inlier_angle_deg"]) == 10.0


def test_run_batch_defaults_to_cuda(tmp_path):
    """With no device named, run_batch takes the CUDA card (its consumers
    replay as CUDA graphs), and raises where there is none rather than
    running on the CPU."""
    inputs, _ = _write_streams(tmp_path, [[0.4]])
    if torch.cuda.is_available():
        torch.backends.cuda.matmul.allow_tf32 = False
        res = tbatch.run_batch(inputs, capacity=CAP)
        assert res.frames == 2 and res.eager_runs == 0 and res.graph_replays == 2
    else:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            tbatch.run_batch(inputs)
