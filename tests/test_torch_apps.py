"""The port's single-stream apps and the library calls under them against
ofps_tpu on the CPU.

* ``dense_flow_stream``: the flow of each frame within the flow tests'
  tolerance of JAX's (99.5% of pixels within 1e-4 px, none off by more
  than one candidate step), and bit-equal to the port's chained
  ``dense_flow_warm``.
* camera ``point_angle``, ``fov``, ``essential`` and ``look_at_rh``
  within 1e-6 of JAX's.
* ``EstimatorInstance.motion_step`` with ``move_magnitude`` on libmv (JAX's
  draws injected): rotation within 2e-3 deg, position within 2.5e-3, as
  ``test_torch_libmv.py`` holds the estimator; almeida and homography
  accept the hint and ignore it (bit-equal results).
* viz: the RGBA functions and ``keyframe_panorama`` exactly equal to
  JAX's; ``save_png`` read back exactly by ``matplotlib.pyplot.imread``.
* ``summarize_stats_dir`` and ``KeyframeKeeper`` eviction equal to JAX's.
* ``run_detection_config``: ranges and CSV equal to JAX's (the detector
  draws nothing, so exactly).
* ``run_tracking_config`` (almeida, 5 frames): GT error under JAX's own
  test bound, the stats CSV's header and rows as JAX writes them (values
  within 1e-5 rad); ``props_hook`` reaches the step of its frame.
"""

import csv
import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ofps_torch import interop
from ofps_torch.apps import detection as tdet
from ofps_torch.apps import stats as tstats
from ofps_torch.apps import tracking as ttrack
from ofps_torch.apps import viz as tviz
from ofps_torch.core import camera as tcam
from ofps_torch.core import quat as tq
from ofps_torch.core.motion import SparseFlow as TSparse
from ofps_torch.estimators.base import create_estimator as t_est
from ofps_torch.ops import flow_pyramid as tfp
from ofps_tpu.apps import detection as jdet
from ofps_tpu.apps import gt as jgt
from ofps_tpu.apps import stats as jstats
from ofps_tpu.apps import tracking as jtrack
from ofps_tpu.apps import viz as jviz
from ofps_tpu.core import camera as jcam
from ofps_tpu.core import quat as jq
from ofps_tpu.core.motion import SparseFlow as JSparse
from ofps_tpu.decoders.mvec import write_mvec_frame
from ofps_tpu.estimators import libmv as jlm
from ofps_tpu.ops import flow_pyramid as jfp
from torch_threads import one_torch_thread  # noqa: F401 (autouse)


def _t(x):
    return torch.from_numpy(np.array(x, dtype=np.float32))


# -- dense_flow_stream --------------------------------------------------------


def test_dense_flow_stream_matches_jax_and_the_chain():
    from test_torch_flow import _assert_flow_close, _scene

    b, h, w = 2, 64, 96
    _, base, _ = _scene(3, h, w + 8, b)
    frames = [np.ascontiguousarray(base[:, :, 4 - 2 * t: 4 - 2 * t + w]) for t in range(3)]
    jp = jfp.FlowParams(levels=3, coarse_search=3, fuse_min_pixels=3000)
    tp = interop.flow_params_from_jax(jp)
    jstep = jax.jit(lambda f, c: jfp.dense_flow_stream(f, jp, c))

    (uj, vj), jc = jfp.dense_flow_stream(jnp.asarray(frames[0]), jp)
    (ut, vt), tc = tfp.dense_flow_stream(_t(frames[0]), tp)
    assert ut.dtype == vt.dtype == torch.float32 and not ut.any() and not vt.any()
    assert tc.warm[0].shape == (b, h // 2, w // 2) and tc.warm[0].dtype == torch.float32
    assert torch.equal(tc.cache.pyr[0], _t(frames[0]))
    warm, cache = tc.warm, tc.cache
    for t in (1, 2):
        (uj, vj), jc = jstep(jnp.asarray(frames[t]), jc)
        (ut, vt), tc = tfp.dense_flow_stream(_t(frames[t]), tp, tc)
        _assert_flow_close(ut.numpy(), vt.numpy(), np.asarray(uj), np.asarray(vj))
        # The unchained form: dense_flow_warm on (previous, current).
        (uc, vc), warm, cache = tfp.dense_flow_warm(
            _t(frames[t - 1]), _t(frames[t]), tp, warm=warm, prev_cache=cache)
        assert torch.equal(ut, uc) and torch.equal(vt, vc)
        assert all(torch.equal(x, y) for x, y in zip(tc.warm, warm))
    interior = ut[:, 8:-8, 8:-8]
    assert abs(interior.median().item() - 2.0) < 0.1  # the 2 px pan


def test_flow_to_normalized_matches_jax():
    flow = np.random.default_rng(0).normal(0, 3, (2, 6, 10, 2)).astype(np.float32)
    np.testing.assert_array_equal(tfp.flow_to_normalized(_t(flow)).numpy(),
                                  np.asarray(jfp.flow_to_normalized(jnp.asarray(flow))))


# -- camera ------------------------------------------------------------------


def test_camera_functions_match_jax():
    rng = np.random.default_rng(1)
    tc_, jc_ = tcam.StandardCamera.create(16 / 9, 75.0), jcam.StandardCamera.create(16 / 9, 75.0)
    p = rng.uniform(0, 1, (3, 7, 2)).astype(np.float32)
    np.testing.assert_allclose(tc_.point_angle(_t(p)).numpy(),
                               np.asarray(jc_.point_angle(jnp.asarray(p))), rtol=0, atol=1e-6)
    for g, r in zip(tc_.fov(), jc_.fov()):
        assert abs(float(g) - float(r)) <= 1e-6 * abs(float(r))
    f = rng.standard_normal((4, 3, 3)).astype(np.float32)
    np.testing.assert_allclose(tc_.essential(_t(f)).numpy(),
                               np.asarray(jc_.essential(jnp.asarray(f))), rtol=0, atol=1e-6)
    eye, target = rng.standard_normal((2, 5, 3)).astype(np.float32)
    up = np.array([0.0, 0.0, 1.0], np.float32)
    got = tcam.look_at_rh(_t(eye), _t(target), _t(up)).numpy()
    ref = np.stack([np.asarray(jcam.look_at_rh(e, t, up)) for e, t in zip(eye, target)])
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6)
    np.testing.assert_allclose(tcam.look_at_rh(eye[0], target[0], up).numpy(), ref[0],
                               rtol=0, atol=1e-6)


# -- motion_step -------------------------------------------------------------


def test_motion_step_move_magnitude_on_libmv_as_jax():
    from test_torch_libmv import _chain_flows, _draws

    cam, flows = _chain_flows()
    tc_ = tcam.StandardCamera.create(1.0, 90.0)
    pos, mot, mask = flows[0]
    key = jax.random.PRNGKey(11)
    rot0 = np.asarray(jq.from_euler(0.1, -0.2, 0.3), np.float32)
    pos0 = np.array([0.5, -1.0, 2.0], np.float32)
    jest = jlm.make_libmv(algo_points=8)
    jr, jpos, jst = jax.jit(jest.motion_step)(
        jest.init(), JSparse(*map(jnp.asarray, (pos, mot, mask))), cam, key,
        jnp.asarray(rot0), jnp.asarray(pos0), move_magnitude=jnp.float32(2.5))
    test = t_est("libmv", algo_points=8)
    draws = _draws(key, mask, 8)
    tr_, tpos, tst = test.motion_step(
        test.init(), TSparse(_t(pos), _t(mot), _t(mask)), tc_, _t(rot0), _t(pos0),
        move_magnitude=2.5, fit_idx=draws)
    assert math.degrees(tq.angle_to(_t(jr), tr_).item()) <= 2e-3
    np.testing.assert_allclose(tpos.numpy(), np.asarray(jpos), rtol=0, atol=2.5e-3)
    assert abs(np.linalg.norm(tpos.numpy() - pos0) - 2.5) < 0.01
    np.testing.assert_allclose(torch.linalg.norm(tst.tr).item(), 2.5, rtol=1e-5)
    np.testing.assert_array_equal(tst.valid.numpy(), np.asarray(jst.valid))


@pytest.mark.parametrize("name", ["almeida", "homography"])
def test_motion_step_hint_accepted_and_unused(name):
    from synthetic import euler_deg, synthetic_field

    jc_ = jcam.StandardCamera.create(1.0, 90.0)
    flow = synthetic_field(jc_, euler_deg(0.0, 0.3, 0.2))
    tflow = TSparse(*(_t(x) for x in (flow.pos, flow.motion, flow.mask)))
    est = t_est(name)
    draws = est.draw(torch.Generator().manual_seed(0), (), tflow.capacity, "cpu", dense=False)
    rot0, pos0 = _t(jq.from_euler(0.0, 0.1, 0.0)), torch.tensor([1.0, 2.0, 3.0])
    cam = tcam.StandardCamera.create(1.0, 90.0)
    plain = est.motion_step(est.init(), tflow, cam, rot0, pos0, fit_idx=draws)
    hinted = est.motion_step(est.init(), tflow, cam, rot0, pos0, move_magnitude=2.5,
                             fit_idx=draws)
    assert torch.equal(plain[0], hinted[0]) and torch.equal(plain[1], hinted[1])
    assert math.degrees(tq.angle_to(plain[0], rot0).item()) > 0.2  # it moved
    assert torch.equal(plain[1], pos0)  # rotation only


# -- viz ---------------------------------------------------------------------


def test_viz_images_equal_jax(tmp_path):
    import matplotlib.pyplot as plt

    rng = np.random.default_rng(2)
    field = rng.normal(0, 0.3, (20, 30, 2)).astype(np.float32)
    field[3:6, 4:9] = 0.0
    for fn in ("flow_to_rgba", "flow_extract_display"):
        np.testing.assert_array_equal(getattr(tviz, fn)(field), getattr(jviz, fn)(field))
    frame = rng.integers(0, 256, (60, 90, 4), dtype=np.uint8)
    rgba = tviz.flow_to_rgba(field)
    np.testing.assert_array_equal(tviz.overlay(frame, rgba), jviz.overlay(frame, rgba))
    imgs = [rng.integers(0, 256, (48, 64, c), dtype=np.uint8) for c in (4, 3, 4)]
    kfs = [(i, np.asarray(jq.from_euler(0.0, 0.1 * i, 0.4 * i)), img)
           for i, img in enumerate(imgs)] + [(3, np.asarray(jq.identity()), None)]
    pano = tviz.keyframe_panorama(kfs, tcam.StandardCamera.create(4 / 3, 60.0))
    np.testing.assert_array_equal(
        pano, jviz.keyframe_panorama(kfs, jcam.StandardCamera.create(4 / 3, 60.0)))
    assert (pano[..., 3] > 0).mean() > 0.02
    for img in (imgs[0], imgs[1], pano):
        path = str(tmp_path / "x.png")
        tviz.save_png(path, img)
        np.testing.assert_array_equal(plt.imread(path), img.astype(np.float32) / 255.0)
    with pytest.raises(ValueError):
        tviz.save_png(path, field)


# -- stats, keyframes --------------------------------------------------------


def test_summarize_stats_dir_equals_jax(tmp_path):
    rng = np.random.default_rng(3)
    for name in ("almeida", "libmv"):
        qs = [np.asarray(jq.from_euler(*rng.normal(0, 0.01, 3))) for _ in range(6)]
        poses = [np.asarray(jq.identity())]
        for q in qs[1:]:
            poses.append(np.asarray(jq.mul(q, poses[-1])))
        truth = [jgt.GroundTruthRow(frame=i + 1, fov_x=90.0, fov_y=90.0, rot=p, pos=np.zeros(3))
                 for i, p in enumerate(poses)]
        noisy = [np.asarray(jq.mul(jq.from_euler(*rng.normal(0, 1e-3, 3)), q)) for q in qs]
        jgt.write_stats_csv(str(tmp_path / f"stats_{name}.csv"), jgt.calc_err(truth, noisy),
                            jgt.pose_stats(noisy, poses))
    with open(tmp_path / "perf.csv", "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["frame", "decode", "estimate"])
        for i in range(6):
            w.writerow([i, f"{rng.uniform(1, 2):.4f}", f"{rng.uniform(20, 30):.4f}"])
    got = tstats.summarize_stats_dir(str(tmp_path), str(tmp_path / "t.csv"))
    ref = jstats.summarize_stats_dir(str(tmp_path), str(tmp_path / "j.csv"))
    assert got == ref and len(got) == 2 and got[0]["frames"] == 6
    assert (tmp_path / "t.csv").read_text() == (tmp_path / "j.csv").read_text()


def test_keyframe_keeper_eviction_equals_jax(tmp_path):
    rng = np.random.default_rng(4)
    tk, jk = ttrack.KeyframeKeeper(max_frames=6), jtrack.KeyframeKeeper(max_frames=6)
    for i in range(40):
        q = np.asarray(jq.from_euler(*rng.normal(0, 0.3, 3)))
        payload = rng.integers(0, 256, (8, 8, 4), dtype=np.uint8) if i % 3 == 0 else None
        tk.add(i, q, payload)
        jk.add(i, q, payload)
        assert [f[0] for f in tk.frames] == [f[0] for f in jk.frames]
    small = ttrack.KeyframeKeeper(max_frames=2)
    for i in range(4):
        small.add(i, np.asarray(jq.identity()))
    assert [f[0] for f in small.frames] == [2, 3]
    path = tk.export(str(tmp_path / "kf" / "a_"))
    rows = list(csv.reader(open(path)))
    assert rows[0] == "frame rot_w rot_i rot_j rot_k image".split() and len(rows) == 7
    assert all(os.path.exists(r[-1]) for r in rows[1:] if r[-1])


# -- detection ---------------------------------------------------------------


def test_run_detection_config_equals_jax(tmp_path):
    from test_apps import _write_mvec

    pattern = [False] * 3 + [True] * 8 + [False] * 2 + [True] * 7 + [False] * 3
    path = str(tmp_path / "in.mvec")
    _write_mvec(path, pattern)

    def config(tag):
        return {
            "app": "detection",
            "decoder": {"input": path},
            "detector": {"name": "block_motion", "properties": {"target_motion": 0.01}},
            "settings": {"max_frame_gap": 2, "min_frames": 5},
            "output": {"ranges_csv": str(tmp_path / f"{tag}.csv"),
                       "perf_csv": str(tmp_path / f"{tag}_perf.csv"),
                       "overlay_dir": str(tmp_path / f"{tag}_ov")},
        }

    got = tdet.run_detection_config(config("t"), device="cpu")
    ref = jdet.run_detection_config(config("j"))
    assert got.frames == ref.frames == len(pattern)
    assert got.motion_ranges == ref.motion_ranges == [(3, 10), (13, 19)]
    assert got.filtered_ranges(2, 5) == ref.filtered_ranges(2, 5)
    assert (tmp_path / "t.csv").read_text() == (tmp_path / "j.csv").read_text() != ""
    assert sorted(os.listdir(tmp_path / "t_ov")) == sorted(os.listdir(tmp_path / "j_ov"))
    header = (tmp_path / "t_perf.csv").read_text().splitlines()[0]
    assert header == (tmp_path / "j_perf.csv").read_text().splitlines()[0]


# -- tracking ----------------------------------------------------------------


N_FRAMES = 5


@pytest.fixture(scope="module")
def tracking_clip(tmp_path_factory):
    """JAX's tracking test input (tests/test_apps.py): a 5-frame .mvec of a
    synthetic rotation, the first frame empty, with its GT CSV; and JAX's
    run of the config over it, once for the file."""
    from synthetic import euler_deg, synthetic_field
    from test_apps import _gt_rows

    tmp = tmp_path_factory.mktemp("tracking")
    q = euler_deg(0.0, 0.3, 0.2)
    flow = synthetic_field(jcam.StandardCamera.create(1.0, 90.0), q)
    keep = np.asarray(flow.mask) > 0.5
    mvec = str(tmp / "in.mvec")
    with open(mvec, "wb") as f:
        write_mvec_frame(f, np.zeros((0, 2)), np.zeros((0, 2)))
        for _ in range(N_FRAMES - 1):
            write_mvec_frame(f, np.asarray(flow.pos)[keep], np.asarray(flow.motion)[keep])
    gt_path = str(tmp / "gt.csv")
    jgt.write_ground_truth(gt_path, _gt_rows(np.asarray(q), N_FRAMES))

    def config(tag):
        return {
            "app": "tracking",
            "decoder": {"input": mvec},
            "camera_aspect": 1.0,
            "camera_fov_y": 90.0,
            "estimators": [
                {"name": "almeida", "properties": {"num_iters": 64}},
                {"name": "homography", "enabled": False},
            ],
            "ground_truth": gt_path,
            "output": {"stats_csv_prefix": str(tmp / f"{tag}_stats_"),
                       "perf_csv": str(tmp / f"{tag}_perf.csv")},
        }

    ref = jtrack.run_tracking_config(config("j"))
    return tmp, config, gt_path, ref


def _csv_rows(path):
    with open(path) as f:
        return list(csv.reader(f))


def test_run_tracking_config_as_jax(tracking_clip):
    tmp, config, gt_path, ref = tracking_clip
    res = ttrack.run_tracking_config(config("t"), device="cpu")
    assert res.frames == ref.frames == N_FRAMES
    assert [t.name for t in res.tracks] == [t.name for t in ref.tracks] == ["almeida"]
    assert res.eager_runs == N_FRAMES and res.graph_replays == 0 and res.graphs == 0
    truth = jgt.load_ground_truth(gt_path)
    avg = res.tracks[0].avg_err(truth)
    assert avg[0] < math.radians(0.36) * 0.1, math.degrees(avg[0])  # JAX's bound
    assert float(tq.angle_to(_t(res.tracks[0].poses_rot[-1]), _t(truth[-1].rot))) < math.radians(0.2)
    got_rows = _csv_rows(tmp / "t_stats_almeida.csv")
    ref_rows = _csv_rows(tmp / "j_stats_almeida.csv")
    assert got_rows[0] == ref_rows[0] and len(got_rows) == len(ref_rows) == N_FRAMES + 1
    for g, r in zip(got_rows[1:], ref_rows[1:]):
        assert g[0] == r[0]
        np.testing.assert_allclose(np.float64(g[1:]), np.float64(r[1:]), rtol=0, atol=1e-5)
    perf = _csv_rows(tmp / "t_perf.csv")
    assert perf[0] == _csv_rows(tmp / "j_perf.csv")[0] == ["frame", "decode", "estimate"]
    assert len(perf) == N_FRAMES + 1


def test_tracking_props_hook_reaches_its_frame(tracking_clip):
    """The hook sees each frame's index and the per-frame properties as 0-d
    device tensors; a value written at frame k changes frame k's step only
    from then on (the same draws otherwise)."""
    _, config, _, _ = tracking_clip
    mvec = config("h")["decoder"]["input"]
    seen = []

    def hook(frame, props):
        seen.append(frame)
        v = props["estimators"][0]["inlier_angle_deg"]
        assert isinstance(v, torch.Tensor) and v.dim() == 0
        if frame == 3:
            v.fill_(0.0)  # no point is an inlier at 0 deg: identity from here
        return props

    def run(**kw):
        return ttrack.run_tracking(mvec, [{"name": "almeida", "properties": {"num_iters": 64}}],
                                   1.0, 90.0, device="cpu", **kw)

    base, hooked = run(), run(props_hook=hook)
    assert seen == list(range(N_FRAMES))
    a, b = base.tracks[0].transforms, hooked.tracks[0].transforms
    assert all(np.array_equal(x, y) for x, y in zip(a[:3], b[:3]))
    assert not np.array_equal(a[3], b[3])
