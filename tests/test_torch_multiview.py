"""Parity of the port's multiview estimator (``ofps_torch.estimators.
multiview``) with ofps_tpu on the CPU, with JAX's RANSAC draws injected.

Fixture: the 84x150 serving lattice of a camera that rotates ~0.5 degree
and translates (points at depths 2-6, so the essential matrix is well
conditioned), with 2e-6 of noise and 20% of the vectors replaced by
N(0, 0.01) noise; dense (all valid) and masked (a third invalid).

The 5-point candidates of a hypothesis come out in other slots in the two
packages, and float32-chaotic at ~1e-4 (``tests/test_torch_five_point.py``),
so the winner is compared as its hypothesis and its matrix (within 1e-3, up
to sign), not as a slot index, and the inlier masks on all but 0.1% of the
points; the rotations within 2e-3 degrees.

On the CPU the estimator runs its RANSAC's plain version
(``kernels/multiview.ransac_plain``): the ``robust_fit`` call it replaces,
bit for bit, and the benchmark's frozen plain multiview's rotations.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ofps_torch import interop
from ofps_torch.core import quat as tq
from ofps_torch.core.camera import StandardCamera as TCam
from ofps_torch.core.motion import SparseFlow as TSparse
from ofps_torch.estimators import multiview as tmv
from ofps_torch.estimators.base import available_estimators as t_available
from ofps_torch.estimators.base import camera_intrinsics
from ofps_torch.estimators.base import create_estimator as t_est
from ofps_torch.kernels import multiview as kmv
from ofps_torch.ops import epipolar as te
from ofps_torch.ops import robust as trob
from ofps_torch.ops.five_point import five_point_essential as t_five
from ofps_tpu.core import quat as jq
from ofps_tpu.core.camera import StandardCamera as JCam
from ofps_tpu.core.motion import SparseFlow as JSparse
from ofps_tpu.core.motion import field_to_sparse
from ofps_tpu.estimators import multiview as jmv
from ofps_tpu.ops import epipolar as je
from ofps_tpu.ops import robust as jrob
from ofps_tpu.ops.five_point import five_point_essential as j_five
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

GW, GH = 150, 84
JCAM = JCam.create(GW / GH, 60.0)
TCAM = TCam.create(GW / GH, 60.0)
H_COUNT = jrob.ransac_budget(0.999, 0.5, 5, 512)  # 218
ROT_DEG = 2e-3
_K = np.asarray(JCAM.intrinsics())
# The estimator's cut: max_error over the focal length, in float32.
THR = float(np.float32(1e-4) / ((_K[0, 0] + _K[1, 1]) * np.float32(0.5)))


def _t(x):
    return torch.from_numpy(np.array(x, dtype=np.asarray(x).dtype))


def _motion_flow(seed, outliers=0.2, invalid=0.0):
    """(pos, motion, mask) on the lattice: rotation + translation, depths
    2-6, noise and outliers as in the module docstring."""
    rng = np.random.default_rng(seed)
    pos = np.asarray(field_to_sparse(jnp.zeros((GH, GW, 2), jnp.float32)).pos, np.float64)
    k = np.asarray(JCAM.intrinsics(), np.float64)
    rays = np.concatenate([pos, np.ones_like(pos[:, :1])], -1) @ np.linalg.inv(k).T
    x = rays * rng.uniform(2, 6, (len(pos), 1))
    q = jq.from_euler(*rng.uniform(-0.01, 0.01, 3).astype(np.float32))
    x2 = x @ np.asarray(jq.to_matrix3(q), np.float64).T + rng.normal(0, 0.05, 3)
    p2 = x2 @ k.T
    mot = p2[:, :2] / p2[:, 2:] - pos + rng.normal(0, 2e-6, pos.shape)
    bad = rng.uniform(size=len(pos)) < outliers
    mot[bad] = rng.normal(0, 0.01, (bad.sum(), 2))
    mask = (rng.uniform(size=len(pos)) >= invalid).astype(np.float32)
    return pos.astype(np.float32), mot.astype(np.float32), mask


def _fit_kwargs(ops, five, minimal_wrap, dense):
    return dict(
        minimal_fit=five, sample_size=5, error_fn=ops.sampson_error, num_hypotheses=H_COUNT,
        threshold=THR,
        eval_cap=2048, adaptive_threshold=True, prescore_cap=128, finalists=32, dense=dense,
        refit_fn=minimal_wrap,
    )


def _jax_reference(key, pos, mot, mask, dense):
    """In one jit (XLA shares the minimal fits): JAX's draws, its
    robust_fit with the estimator's settings, its winning candidate (the
    same fit without LO refits returns it), and the estimator's rotation."""
    x1 = jmv._normalized_coords(JCAM, pos)
    x2 = jmv._normalized_coords(JCAM, pos + mot)
    idx = jrob.sample_indices(key, mask, H_COUNT, 5, dense=dense)
    refit = lambda a, b, ww: je.project_to_essential(je.eight_point_fundamental(a, b, ww))  # noqa: E731
    full = jrob.robust_fit(key, x1, x2, mask, **_fit_kwargs(je, j_five, refit, dense))
    bare = jrob.robust_fit(key, x1, x2, mask, **_fit_kwargs(je, j_five, None, dense))
    cands = jax.vmap(j_five)(x1[idx], x2[idx], jnp.ones(idx.shape))
    rot = jmv.make_multiview().estimate((), JSparse(pos, mot, mask), JCAM, key, dense=dense)[0]
    return idx, full.inliers, bare.model, cands, rot


def _deg(a, b):
    return float(np.degrees(tq.angle_to(_t(a), _t(b)).max().item()))


@pytest.mark.parametrize("dense", [True, False], ids=["dense", "masked"])
def test_multiview_matches_jax_with_injected_draws(dense):
    """The winning candidate within 1e-3 of JAX's (dense: of the same
    hypothesis; masked: the two pick different hypotheses whose candidates
    agree that far), the inlier masks equal on all but at most 0.1% of the
    points (7 and 8 of 12,600 here: outliers at the edge of the cut, which a
    1e-4 change of the model moves), the rotation within 2e-3 degrees."""
    pos, mot, mask = _motion_flow(3, invalid=0.0 if dense else 1 / 3)
    key = jax.random.PRNGKey(5)
    idx, ref_inl, ref_win, (ref_es, ref_v), ref = map(
        lambda x: jax.tree_util.tree_map(np.asarray, x),
        jax.jit(_jax_reference, static_argnums=4)(key, pos, mot, mask, dense))

    kinv = camera_intrinsics(TCAM, "cpu")[1]
    tx1 = tmv.normalized_coords(kinv, _t(pos))
    tx2 = tmv.normalized_coords(kinv, _t(pos + mot))
    tidx = _t(idx).long()
    bare = trob.robust_fit(tx1, tx2, _t(mask), idx=tidx, **_fit_kwargs(te, t_five, None, dense))
    gap = np.minimum(np.abs(ref_es - ref_win).max((-2, -1)), np.abs(ref_es + ref_win).max((-2, -1)))
    gap = np.where(ref_v, gap, np.inf)
    assert gap.min() <= 1e-3  # JAX's winner among its candidates
    if dense:
        assert int(bare.best) // 28 == int(np.argmin(gap)) // 28
    win = bare.model.numpy()
    assert min(np.abs(win - ref_win).max(), np.abs(win + ref_win).max()) <= 1e-3
    full = trob.robust_fit(tx1, tx2, _t(mask), idx=tidx,
                           **_fit_kwargs(te, t_five, kmv._eight_point_essential, dense))
    assert (full.inliers.numpy() != ref_inl).mean() <= 1e-3
    n_valid = mask.sum()
    assert 0.75 * n_valid < full.inliers.sum() < 0.85 * n_valid

    # The estimator: the rotation of the same draws, and batched streams.
    est = t_est("multiview")
    flow = TSparse(_t(pos), _t(mot), _t(mask))
    r, t, st = est.estimate((), flow, TCAM, dense=dense, fit_idx=tidx)
    assert st == () and torch.equal(t, torch.zeros(3))
    assert _deg(r, ref) <= ROT_DEG, _deg(r, ref)
    flow2 = TSparse(*(torch.stack([x, x]) for x in flow))
    r2, _, _ = est.estimate((), flow2, TCAM, dense=dense, fit_idx=torch.stack([tidx, tidx]))
    assert _deg(r2, r.expand(2, 4)) <= ROT_DEG


def test_chip_smoke_fixture_jax_misses_by_its_zero_candidate():
    """``chip_smoke.py``'s "estimators" fixture (``rotation_grid``, built on
    the CPU), masked, stream 3, JAX key 13: JAX's RANSAC winner is the zero
    candidate of a 5-point sample (every valid point an inlier,
    ``tests/test_torch_five_point.py``), and its multiview misses its
    almeida by 0.095 degrees, past the smoke run's EST_AGREE_DEG.  The port,
    given the same draws, marks zero candidates invalid and stays within
    it (0.0055 degrees)."""
    import importlib.util
    from pathlib import Path

    from ofps_torch.core.motion import field_to_sparse as t_field_to_sparse
    from ofps_tpu.estimators import almeida as jal

    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parent.parent / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    grid, _, mask = smoke.rotation_grid(torch, 4, smoke.SEED + 3)
    flow = t_field_to_sparse(grid)
    pos_np, mot_np, w_np = (x[3].numpy() for x in (flow.pos, flow.motion, mask))
    jcam = JCam.create(smoke.W / smoke.H, 60.0)
    k = np.asarray(jcam.intrinsics())
    thr = float(np.float32(1e-4) / ((k[0, 0] + k[1, 1]) * np.float32(0.5)))

    def reference(key):
        pos, mot, w = map(jnp.asarray, (pos_np, mot_np, w_np))
        x1 = jmv._normalized_coords(jcam, pos)
        x2 = jmv._normalized_coords(jcam, pos + mot)
        idx = jrob.sample_indices(key, w, H_COUNT, 5)
        bare = jrob.robust_fit(key, x1, x2, w, **dict(_fit_kwargs(je, j_five, None, False),
                                                      threshold=thr))
        sparse = JSparse(pos, mot, w)
        return (idx, bare.model, bare.inliers,
                jmv.make_multiview().estimate((), sparse, jcam, key, dense=False)[0],
                jal.make_almeida().estimate((), sparse, jcam, key, dense=False)[0])

    idx, model, inliers, ref_mv, ref_al = map(np.asarray, jax.jit(reference)(jax.random.PRNGKey(13)))
    assert not model.any() and inliers.sum() == w_np.sum()
    assert _deg(ref_mv, ref_al) > smoke.EST_AGREE_DEG
    r, _, _ = t_est("multiview").estimate(
        (), TSparse(*map(_t, (pos_np, mot_np, w_np))), TCam.create(smoke.W / smoke.H, 60.0),
        dense=False, fit_idx=_t(idx).long())
    assert _deg(r, ref_al) <= smoke.EST_AGREE_DEG, _deg(r, ref_al)


def test_wraparound_guard_keeps_small_rotations():
    """JAX's fixture (``tests/test_estimators.py``): a 2 degree roll on a
    30x30 grid; the >90 degree fix leaves it alone.  Pure rotation is
    degenerate for the essential matrix, so the pose is held against the
    truth at JAX's gate (10% of the angle), not against JAX's pose."""
    from synthetic import euler_deg, get_grid, synthetic_field

    cam = JCam.create(1.0, 90.0)
    q = euler_deg(2.0, 0.0, 0.0)
    flow = synthetic_field(cam, q, grid=get_grid(30, 30, cam, skip_edges=True))
    key = jax.random.PRNGKey(1)
    idx = jrob.sample_indices(key, flow.mask, H_COUNT, 5)
    r, _, _ = t_est("multiview").estimate(
        (), TSparse(*map(_t, flow)), TCam.create(1.0, 90.0), fit_idx=_t(idx).long())
    assert np.degrees(tq.angle(r).item()) < 45.0
    assert _deg(r, q) < 0.2
    # The fix itself: a quaternion past 90 degrees comes back wrapped.
    axis = torch.tensor([0.0, 0.6, 0.8])
    q_big = tq.from_axis_angle(axis, torch.tensor(2.5))
    a, ang = tq.axis_angle(q_big)
    wrapped = tq.from_axis_angle(a, torch.remainder(ang + np.pi, 2 * np.pi))
    ref_w = jq.from_axis_angle(jnp.asarray(a.numpy()), jnp.mod(jnp.float32(ang) + jnp.pi, 2 * jnp.pi))
    np.testing.assert_allclose(wrapped.numpy(), np.asarray(ref_w), atol=1e-6)


def test_registry_degenerate_input_and_interop():
    assert t_available() == ["almeida", "homography", "libmv", "multiview"]
    est = t_est("multiview", max_error=0.002)
    assert est.dyn_defaults() == {"max_error": 0.002}
    assert est.draw(torch.Generator().manual_seed(0), (3,), GW * GH, "cpu").shape == (3, H_COUNT, 5)
    assert tmv.hypothesis_count(est.params) == 218
    jp = jmv.MultiviewParams(max_error=0.004, use_five_point=False, gn_iters=2)
    assert interop.multiview_params_from_jax(jp)._asdict() == jp._asdict()
    assert interop.multiview_params_from_jax(jmv.MultiviewParams()) == tmv.MultiviewParams()
    pos, mot, _ = _motion_flow(4)
    mask = np.zeros(len(pos), np.float32)
    mask[:7] = 1.0  # fewer valid points than the guard's 8
    r, _, _ = t_est("multiview").estimate(
        (), TSparse(_t(pos), _t(mot), _t(mask)), TCAM, torch.Generator().manual_seed(0))
    np.testing.assert_array_equal(r.numpy(), np.array([1.0, 0.0, 0.0, 0.0], np.float32))


def _cpu_fit_inputs(dense, seed=3):
    """The dense or masked fixture as the estimator feeds its RANSAC: the
    normalized coordinates, the weights, its threshold tensor and torch
    draws."""
    pos, mot, mask = _motion_flow(seed, invalid=0.0 if dense else 1 / 3)
    k, kinv = camera_intrinsics(TCAM, "cpu")
    x1 = tmv.normalized_coords(kinv, _t(pos))
    x2 = tmv.normalized_coords(kinv, _t(pos + mot))
    params = tmv.MultiviewParams()
    thr = params.max_error / ((k[0, 0] + k[1, 1]) * 0.5)
    idx = trob.draw(torch.Generator().manual_seed(seed + 10), (), len(pos), H_COUNT, 5, "cpu",
                    dense=dense)
    return (pos, mot, mask), (x1, x2, _t(mask)), thr, params, idx


@pytest.mark.parametrize("dense", [True, False], ids=["dense", "masked"])
def test_ransac_plain_is_the_robust_fit_it_replaces(dense):
    """``kernels/multiview.ransac_plain`` is the estimator's former
    ``robust_fit`` call and refit on its inliers, bit for bit (model,
    inliers, score, winner, refit E); ``ransac`` on CPU tensors takes it."""
    _, (x1, x2, w), thr, params, idx = _cpu_fit_inputs(dense)
    ref = trob.robust_fit(x1, x2, w, idx=idx, **dict(
        _fit_kwargs(te, t_five, kmv._eight_point_essential, dense), threshold=thr))
    ref_e = kmv._eight_point_essential(x1, x2, ref.inliers)
    for got_e, got in (kmv.ransac_plain(x1, x2, w, thr, params, H_COUNT, idx=idx, dense=dense),
                       kmv.ransac(x1, x2, w, thr, params, H_COUNT, idx=idx, dense=dense)):
        assert torch.equal(got_e, ref_e)
        for a, b in zip(got, ref, strict=True):
            assert torch.equal(a, b)
    assert 0.75 * float(w.sum()) < float(ref.score) < 0.85 * float(w.sum())


@pytest.mark.parametrize("dense", [True, False], ids=["dense", "masked"])
def test_estimator_on_the_cpu_is_the_frozen_reference(dense):
    """On the CPU the estimator (``plain`` or not) gives the rotations of
    the benchmark's frozen plain multiview (``ofps_bench/reference``), bit
    for bit, for two streams with the same draws."""
    from ofps_bench.reference import multiview as ref_mv  # noqa: F401 (registers it)
    from ofps_bench.reference.camera import StandardCamera as RCam
    from ofps_bench.reference.est_base import create_estimator as r_est
    from ofps_bench.reference.motion import SparseFlow as RSparse

    flows = [_cpu_fit_inputs(dense, seed)[0] for seed in (3, 4)]
    pos, mot, mask = (torch.stack([_t(f[i]) for f in flows]) for i in range(3))
    idx = trob.draw(torch.Generator().manual_seed(21), (2,), pos.shape[1], H_COUNT, 5, "cpu",
                    dense=dense)
    ref, _, _ = r_est("multiview").estimate((), RSparse(pos, mot, mask), RCam.create(GW / GH, 60.0),
                                           dense=dense, fit_idx=idx)
    for plain in (False, True):
        got, _, _ = t_est("multiview").estimate((), TSparse(pos, mot, mask), TCAM, dense=dense,
                                                fit_idx=idx, plain=plain)
        assert torch.equal(got, ref)


@pytest.mark.parametrize("change,kernels", [
    ({}, True), ({"use_five_point": False}, False), ({"use_ransac": False}, False),
    ({"adaptive_threshold": False}, False), ({"prescore_cap": 256}, False),
    ({"finalists": 64}, False)])
def test_kernels_cover_the_default_params_only(change, kernels):
    """The kernels or the plain version, decided from ``MultiviewParams``
    alone: five-point RANSAC with the adaptive cut, a prescore of at most
    128 points and at most 32 finalists."""
    assert kmv.uses_kernels(tmv.MultiviewParams(**change)) is kernels
