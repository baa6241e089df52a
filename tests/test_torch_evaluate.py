"""The evaluation matrix (ofps_torch.apps.evaluate_matrix, apps.synthetic)
and encode_gray_video against the JAX package's scripts/evaluate_matrix.py
and tests/synthetic.py, on the CPU.

* ``encode_gray_video``: the two encoders write the same bytes.
* ``make_schedules`` and ``translation_cloud`` equal to JAX's;
  ``make_translation_paths``' positions equal, its quaternions within
  1e-7 (float32 products, two frameworks).
* ``render_clip``: clip 0 within float32 coordinate rounding of JAX's
  (tolerance below); ``synthetic_field`` pos and motion within 1e-6.
* The "av" source on the "ffmpeg" route decodes JAX's encoding of clip 0
  to JAX's vectors exactly; rebuilding the committed ``.mvec`` files of
  the "mvec" route gives the same bytes.
* Non-RANSAC almeida through the port's serving path (``StreamPipeline``,
  ``step_from_flow``) on the gt-mv and av fields of clip 0, 4 frames:
  each delta within 1e-4 deg of JAX's.
* The "block" source, 4 frames of clip 0, within tests/test_torch_cv.py's
  tolerance: the port's ``CvDecoder`` on the encoded clip against JAX's,
  and the "mvec" route's cv step on the rendered frames against JAX's
  decoder step, each step from JAX's warm start.  (Chained, each package
  from its own warm start, the rendered clip's third step flips a near-tie
  of the coarsest level's warm/zero guard: 2% of the cells then move by up
  to 0.39 px.  So the steps are held on the same inputs, as
  test_torch_cv.py holds ``CvFlowStep``.)
* The gt-mv refit's 3-dim null space, which both packages' essential
  matrices lie in (why single epipolar gt-mv cells differ).
* An all-masked stream gets the identity and libmv's carry is held there.

JAX's runs are module fixtures; the file runs in well under a minute.
"""

import math
import os
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ofps_torch.apps import evaluate_matrix as em
from ofps_torch.apps import synthetic as tsyn
from ofps_torch.core.motion import SparseFlow as TSparse
from ofps_torch.decoders import av as tav
from ofps_torch.decoders.cv import CvDecoder as TCvDecoder
from ofps_tpu.apps import gt as jgt
from ofps_tpu.core.camera import StandardCamera as JCam
from ofps_tpu.decoders import av as jav
from ofps_tpu.decoders.cv import CvDecoder as JCvDecoder
from ofps_tpu.estimators.base import create_estimator as j_est
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
import scripts.evaluate_matrix as jem  # noqa: E402
import synthetic as jsyn  # noqa: E402

N_FRAMES = 4
EPS32 = float(np.finfo(np.float32).eps)


def _assert_motion_close(got, ref):
    """tests/test_torch_cv.py's SAD tolerance (normalized units): at least
    99.5% of entries within 1e-5, none off by more than 1.5 / W."""
    d = np.abs(got - ref)
    assert np.isfinite(got).all()
    assert (d <= 1e-5).mean() >= 0.995, (d > 1e-5).mean()
    assert d.max() <= 1.5 / em.W, d.max()


@pytest.fixture(scope="module")
def jcam():
    return JCam.create(1.0, 90.0)


@pytest.fixture(scope="module")
def jax_clip0(jcam):
    """JAX's render of clip 0 (float32 frames) and its uint8 cut."""
    frames, _ = jem.render_clip(jcam, jem.make_schedules()[0], seed=100)
    frames = np.stack([np.asarray(f) for f in frames])
    return frames, np.clip(frames, 0, 255).astype(np.uint8)


@pytest.fixture(scope="module")
def jax_avi(jax_clip0, tmp_path_factory):
    """Clip 0 encoded by JAX's encoder, at the port's ffmpeg-route path."""
    workdir = tmp_path_factory.mktemp("eval")
    path = workdir / "clip0.avi"
    jav.encode_gray_video(str(path), jax_clip0[1], gop=jem.T + 2)
    return workdir, path


def _drain(decoder, n):
    decoder.process_frame()
    return [decoder.process_frame() for _ in range(n)]


def test_encode_gray_video_writes_jax_bytes(tmp_path):
    rng = np.random.default_rng(0)
    base = rng.uniform(0, 255, (80, 80))
    frames = np.stack([np.roll(base, (i, 2 * i), (0, 1))[8:72, 8:72] for i in range(4)])
    frames = frames.astype(np.uint8)
    a, b = tmp_path / "jax.avi", tmp_path / "port.avi"
    jav.encode_gray_video(str(a), frames, gop=6)
    tav.encode_gray_video(str(b), frames, gop=6)
    assert a.read_bytes() == b.read_bytes()
    dec = tav.AvDecoder(str(b))
    assert dec.get_aspect() == (64, 64)
    assert [dec.process_frame() is not None for _ in range(5)] == [True] * 4 + [False]
    with pytest.raises(ValueError, match="frames must be"):
        tav.encode_gray_video(str(b), frames[0])


def test_schedules_paths_and_cloud_match_jax(jcam):
    assert em.make_schedules() == jem.make_schedules()
    for (jq, jp), (tq, tp) in zip(jem.make_translation_paths(), em.make_translation_paths()):
        np.testing.assert_array_equal(np.stack(tp), np.stack(jp))
        np.testing.assert_allclose(np.stack(tq), np.stack([np.asarray(q) for q in jq]),
                                   rtol=0, atol=1e-7)
    np.testing.assert_array_equal(em.translation_cloud(em.camera()).numpy(),
                                  np.asarray(jem.translation_cloud(jcam)))


def test_render_clip_matches_jax(jax_clip0):
    """The two renders sample the same texture at coordinates that differ
    by float32 rounding of the camera's delta (a unit in the last place of
    a normalized coordinate, ~1.2e-7, i.e. 3.4e-5 px at 288 px).  So each
    pixel is held within two such units times W times the texture's
    steepest gradient (2.5e-3 grey levels at most on clip 0), and at least
    99.9% of pixels within 1e-3; the uint8 cuts differ by at most one level
    where a value sits at an integer."""
    frames, qs = em.render_clip(em.camera(), em.make_schedules()[0], seed=100)
    ref, ref_u8 = jax_clip0
    d = np.abs(np.stack(frames) - ref)
    gy, gx = np.gradient(ref[0])
    bound = 2 * EPS32 * em.W * float(np.hypot(gx, gy).max() * math.sqrt(2))
    assert d.max() <= bound, (d.max(), bound)
    assert (d <= 1e-3).mean() >= 0.999, (d > 1e-3).mean()
    u8 = em.clip_frames(em.camera(), em.make_schedules(), 0)
    assert np.abs(u8.astype(int) - ref_u8).max() <= 1
    truth = np.stack([np.asarray(q) for q in jem._truth_quats(jem.make_schedules()[0])])
    np.testing.assert_allclose(np.stack(qs), truth, rtol=0, atol=1e-7)


@pytest.mark.parametrize("angles", [(0.3, 0.5, 0.2), (1.0, 0.0, 0.5), (0.0, 0.0, 0.0)])
def test_synthetic_field_matches_jax(jcam, angles):
    ref = jsyn.synthetic_field(jcam, jsyn.euler_deg(*angles), capacity=em.GRID * em.GRID)
    got = tsyn.synthetic_field(em.camera(), tsyn.euler_deg(*angles), capacity=em.GRID * em.GRID,
                               device="cpu")
    np.testing.assert_array_equal(got.mask.numpy(), np.asarray(ref.mask))
    np.testing.assert_allclose(got.pos.numpy(), np.asarray(ref.pos), rtol=0, atol=1e-6)
    np.testing.assert_allclose(got.motion.numpy(), np.asarray(ref.motion), rtol=0, atol=1e-6)


def test_av_source_decodes_jax_vectors(jax_avi):
    workdir, path = jax_avi
    got = em.source_fields("av", 0, em.camera(), em.make_schedules(), "cpu", "ffmpeg", workdir)
    ref = _drain(jav.AvDecoder(str(path)), em.T)
    assert len(got) == em.T
    for g, r in zip(got, ref):
        assert r.has_mvs and len(r.pos) >= em.MIN_VECTORS
        np.testing.assert_array_equal(g[0], r.pos)
        np.testing.assert_array_equal(g[1], r.motion)


def test_committed_av_vectors_rebuild_exactly(tmp_path):
    """The "mvec" route's files are what the "ffmpeg" route writes."""
    em.write_av_data(tmp_path)
    for ci in range(8):
        assert (tmp_path / f"clip{ci}.mvec").read_bytes() == em.av_mvec_path(ci).read_bytes()


@pytest.fixture(scope="module")
def jax_almeida(jcam, jax_avi):
    """JAX's non-RANSAC almeida deltas (N_FRAMES, 4) on clip 0's gt-mv
    fields and on JAX's decode of its av vectors."""
    est = j_est("almeida", use_ransac=False)
    fn = jax.jit(est.estimate)
    from ofps_tpu.core.motion import SparseFlow

    deltas = em.make_schedules()[0][:N_FRAMES]
    fields = {
        "gt-mv": [jsyn.synthetic_field(jcam, jsyn.euler_deg(*d), capacity=em.GRID * em.GRID)
                  for d in deltas],
        "av": [SparseFlow.from_arrays(f.pos, f.motion, capacity=em.GRID * em.GRID)
               for f in _drain(jav.AvDecoder(str(jax_avi[1])), N_FRAMES)],
    }
    return {s: np.stack([np.asarray(fn((), fl, jcam, jax.random.PRNGKey(0))[0]) for fl in fls])
            for s, fls in fields.items()}


@pytest.mark.parametrize("source", ["gt-mv", "av"])
def test_almeida_on_the_serving_path_matches_jax(source, jax_almeida, jax_avi):
    cam, schedules = em.camera(), em.make_schedules()
    fields = em.source_fields(source, 0, cam, schedules, "cpu", "ffmpeg", jax_avi[0])
    flows = em.stack_fields([fields[:N_FRAMES]], "cpu")
    rots, ms = em.run_config(em.make_pipeline("almeida", cam, "cpu"), flows)
    assert rots.shape == (N_FRAMES, 1, 4) and ms > 0
    for got, ref in zip(rots[:, 0], jax_almeida[source]):
        deg = math.degrees(jgt._qangle(jgt.rotation_to(got.astype(np.float64),
                                                       np.asarray(ref, np.float64))))
        assert deg <= 1e-4, deg
    truth = [jem._truth_quats(schedules[0])[:N_FRAMES]]
    err = em.mean_errors_deg(rots, truth)[0]
    assert err <= (1e-3 if source == "gt-mv" else 0.012)  # JAX's gates for clip 0


@pytest.fixture(scope="module")
def jax_block(jax_avi, jax_clip0):
    """JAX's cv decoder (block matching, the matrix's settings) on the
    encoded clip 0, and its jitted step chained over the rendered uint8
    frames from a zero warm start: N_FRAMES decoded frames, and per step
    (warm start in, grid, valid)."""
    dec = JCvDecoder(str(jax_avi[1]), grid_max_dim=em.GRID, levels=em.CV_LEVELS)
    decoded = _drain(dec, N_FRAMES)
    frames = jnp.asarray(jax_clip0[1][: N_FRAMES + 1].astype(np.float32))
    flow = jnp.zeros(frames.shape[1:] + (2,), jnp.float32)
    rendered = []
    for t in range(1, N_FRAMES + 1):
        warm = np.array(flow)
        flow, grid, valid = dec._fn(frames[t - 1], frames[t], flow)
        rendered.append((warm, np.asarray(grid).reshape(-1, 2), np.asarray(valid).reshape(-1)))
    return decoded, rendered, dec._grid_pos


def test_block_source_matches_jax(jax_block, jax_avi, jax_clip0):
    decoded, rendered, grid_pos = jax_block
    dec = TCvDecoder(str(jax_avi[1]), grid_max_dim=em.GRID, levels=em.CV_LEVELS, device="cpu")
    for got, ref in zip(_drain(dec, N_FRAMES), decoded):
        np.testing.assert_array_equal(got.pos, ref.pos)
        _assert_motion_close(got.motion, ref.motion)
    # The "mvec" route: the cv step on the rendered frames themselves.
    frames = jax_clip0[1][: N_FRAMES + 1]
    gray = torch.from_numpy(frames.astype(np.float32))
    step = em.cv_step(em.H, em.W, use_rlof=False, device="cpu")
    for t, (warm, grid, valid) in enumerate(rendered, start=1):
        _, got, got_valid = step(gray[t - 1], gray[t], torch.from_numpy(warm))
        np.testing.assert_array_equal(got_valid.reshape(-1).numpy(), valid)
        _assert_motion_close(got.reshape(-1, 2).numpy()[valid], grid[valid])
    pos, motion = em.cv_fields(frames[:2], use_rlof=False, device="cpu")[0]
    np.testing.assert_array_equal(pos, grid_pos[rendered[0][2]])
    first = step(gray[0], gray[1], torch.zeros(em.H, em.W, 2))[1].reshape(-1, 2).numpy()
    np.testing.assert_array_equal(motion, first[rendered[0][2]])


@pytest.mark.parametrize("ci,frame", [(0, 0), (4, 2)])
def test_pure_rotation_refit_is_a_null_space_pick(ci, frame):
    """Why single epipolar gt-mv cells differ between the packages (and
    between JAX's own backends): a gt-mv field is a pure rotation, so the
    8-point design matrix of the all-inlier refit has a 3-dim null space
    (x2^T [t]x R x1 = 0 for every t), and each package's refit E is some
    member of it, picked by float32 rounding."""
    from ofps_torch.estimators import multiview as tmv
    from ofps_torch.estimators.base import camera_intrinsics
    from ofps_tpu.ops import epipolar as jep

    cam = em.camera()
    sf = tsyn.synthetic_field(cam, tsyn.euler_deg(*em.make_schedules()[ci][frame]),
                              device="cpu")
    _, kinv = camera_intrinsics(cam, "cpu")
    x1 = tmv.normalized_coords(kinv, sf.pos)
    x2 = tmv.normalized_coords(kinv, sf.pos + sf.motion)
    h1, h2 = (np.c_[x.numpy().astype(np.float64), np.ones(len(x))] for x in (x1, x2))
    design = np.einsum("ni,nj->nij", h2, h1).reshape(-1, 9)
    sv = np.linalg.svd(design, compute_uv=False)
    assert (sv[-3:] < 1e-6 * sv[0]).all() and sv[-4] > 0.1 * sv[0], sv / sv[0]
    port = tmv._eight_point_essential(x1, x2, sf.mask).numpy().reshape(9)
    ref = np.asarray(jep.project_to_essential(jep.eight_point_fundamental(
        *(jnp.asarray(x.numpy()) for x in (x1, x2, sf.mask))))).reshape(9)
    for e in (port, ref):
        assert np.linalg.norm(design @ e) / np.linalg.norm(e) < 1e-3 * sv[-4]


def test_all_masked_stream_gets_identity_and_holds_libmv_carry():
    """A frame with fewer than MIN_VECTORS vectors is an all-masked row:
    every configuration returns the identity for it, and libmv's carry of
    that stream comes out unchanged."""
    cam, schedules = em.camera(), em.make_schedules()
    fields = em.gt_fields(cam, schedules[0][:2])
    flows = em.stack_fields([fields, [fields[0], None]], "cpu")
    pipe = em.make_pipeline("libmv-8pt", cam, "cpu")
    gen = torch.Generator().manual_seed(em.SEED)
    state = pipe.init_state(2, em.H, em.W)
    state, _ = pipe.step_from_flow(state, TSparse(flows.pos[0], flows.motion[0], flows.mask[0]),
                                   gen)
    new, out = pipe.step_from_flow(state, TSparse(flows.pos[1], flows.motion[1], flows.mask[1]),
                                   gen)
    assert torch.equal(out.delta_rot[0][1], torch.tensor([1.0, 0.0, 0.0, 0.0]))
    assert not torch.equal(out.delta_rot[0][0], out.delta_rot[0][1])
    for held, before in zip(new.est[0], state.est[0]):
        assert torch.equal(held[1], before[1])
    assert float(state.est[0].has[1]) == 1.0


def test_entry_point_defaults_to_cuda(tmp_path):
    """The command line runs on the card unless --device cpu is given,
    and raises where there is none."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        em.main(["--out", str(tmp_path), "--clips", "0"])
    assert not os.listdir(tmp_path)
