"""The slice end to end: the port's StreamPipeline against ofps_tpu's.

Configuration: almeida (dense RANSAC), alone or with homography, +
block_motion, serving mode
(``emit_dense_flow=False``), 96 x 160 frames, B=2, 3 pyramid levels with
the two finer levels on the axis-separable refine (so the port's finest
level emits grid sums, the JAX CPU path densifies full-resolution flow).
The JAX pipeline runs two frames, its state is handed over with
``interop.state_from_jax``, and one more frame goes through both with the
RANSAC draws JAX's key split produced injected into the port (the JAX
stream splits its key into one key per estimator and stream).  JAX's
pipeline of all four estimators runs once for the file (``jax_slice``);
each estimator set of the test is a leading part of the four and takes
its estimators' state, outputs and draws from that run.

Tolerances: grid entries within 1e-5 (normalized units) for at least 99.5%
and none off by more than 1.5/W (one flow-candidate flip at a ~1-pixel
cell); rotations within 1e-4; detection exactly equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.ndimage import gaussian_filter

from ofps_torch import interop
from ofps_torch.core import quat as tq
from ofps_torch.core.camera import StandardCamera as TCam
from ofps_torch.core.motion import field_to_sparse
from ofps_torch.detectors.base import create_detector as t_det
from ofps_torch.device import check_fp32_policy, resolve_device
from ofps_torch.estimators import almeida as talm
from ofps_torch.estimators import homography as the
from ofps_torch.estimators.base import create_estimator as t_est
from ofps_torch.kernels import almeida as kalm
from ofps_torch.kernels import homography as khg
from ofps_torch.ops import robust as trob
from ofps_torch.parallel.stream import StreamPipeline as TPipe
from ofps_tpu.core.camera import StandardCamera as JCam
from ofps_tpu.detectors.base import create_detector as j_det
from ofps_tpu.estimators.base import create_estimator as j_est
from ofps_tpu.ops.flow_pyramid import FlowParams as JFlowParams
from ofps_tpu.ops.robust import sample_indices as j_sample_indices
from ofps_tpu.parallel.stream import StreamPipeline as JPipe
from homography_checks import assert_fit_matches
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

H, W, B = 96, 160, 2
# Multiview and libmv on this scene's grid: JAX's own multiview gives
# rotations 0.053 and 0.073 degrees apart for the same call compiled inside
# the pipeline and alone (the 5-point solve is float32-chaotic, and the pan
# with a patch is nearly degenerate for the essential matrix).
EPI_DEG = 0.1
JPARAMS = JFlowParams(levels=3, coarse_search=3, fuse_min_pixels=3000)


def _frames(n, seed=0):
    """(n, B, H, W): texture panning 2 px/frame left, with a square patch
    moving 3 px/frame down-right over it (stream 1: the patch is larger)."""
    rng = np.random.default_rng(seed)
    bg = gaussian_filter(rng.standard_normal((B, H + 40, W + 40)), (0, 2, 2)) * 100
    obj = gaussian_filter(rng.standard_normal((B, 60, 60)), (0, 1.5, 1.5)) * 100
    out = np.empty((n, B, H, W), np.float32)
    for t in range(n):
        out[t] = bg[:, 20 : 20 + H, 20 + 2 * t : 20 + 2 * t + W]
        for b, size in enumerate((24, 40)):
            y, x = 20 + 3 * t, 30 + 3 * t
            out[t, b, y : y + size, x : x + size] = obj[b, :size, :size]
    return out


ESTIMATOR_SETS = [("almeida",), ("almeida", "homography"),
                  ("almeida", "homography", "multiview", "libmv")]


def _pipes(names=("almeida",)):
    jp = JPipe(JCam.create(W / H, 60.0), [j_est(n) for n in names], j_det("block_motion"),
               flow_params=JPARAMS, emit_dense_flow=False)
    tp = TPipe(TCam.create(W / H, 60.0), [t_est(n) for n in names], t_det("block_motion"),
               flow_params=interop.flow_params_from_jax(JPARAMS), emit_dense_flow=False,
               device="cpu")
    return jp, tp


def _jax_draws(key, names, n):
    """The draws JAX's _consume made: one key per estimator and stream
    (estimator-major); almeida samples from its key's first split (200 x
    3), homography's and multiview's robust_fit from the key itself (91 x 4,
    218 x 5), libmv's primary solve from its first split (512 x 7) and its
    chained field's uniforms from its second."""
    keys = jax.random.split(key, len(names) * B)
    draws = []
    for i, name in enumerate(names):
        ks = keys[i * B : (i + 1) * B]
        if name == "libmv":
            k12 = [jax.random.split(k) for k in ks]
            idx = [j_sample_indices(k1, jnp.ones(n), 512, 7, dense=True) for k1, _ in k12]
            u = [jax.random.uniform(k2, (512, 7)) for _, k2 in k12]
            draws.append((_stack(idx), _stack(u)))
            continue
        if name == "almeida":
            d = [j_sample_indices(jax.random.split(k)[0], jnp.ones(n), 200, 3, dense=True)
                 for k in ks]
        else:
            rows, k = {"homography": (91, 4), "multiview": (218, 5)}[name]
            d = [j_sample_indices(k_, jnp.ones(n), rows, k, dense=True) for k_ in ks]
        draws.append(_stack(d))
    return tuple(draws)


def _stack(xs):
    return torch.from_numpy(np.stack([np.asarray(x) for x in xs]))


@pytest.fixture(scope="module")
def jax_slice():
    """JAX's pipeline of all four estimators, once for the file: two
    frames, the state handed over, the third frame's outputs and state, and
    the draws its key split produced.  Every estimator set of the test is a
    leading part of the four; the estimators of a step are independent, so
    their outputs here are those of a JAX pipeline of that set given the
    same draws."""
    names = ESTIMATOR_SETS[-1]
    frames = _frames(3)
    jp, _ = _pipes(names)
    step = jax.jit(jp.step_from_frames)
    state = jp.init_state(B, H, W)
    for t in range(2):
        state, _ = step(state, jnp.asarray(frames[t]), jax.random.PRNGKey(t))
    key = jax.random.PRNGKey(2)
    ref_state, ref = step(state, jnp.asarray(frames[2]), key)
    n = ref.grid.shape[1] * ref.grid.shape[2]
    return frames, state, ref_state, ref, _jax_draws(key, names, n)


def _leading(x, k):
    """A JAX state or outputs cut to its first ``k`` estimators."""
    per = {f: getattr(x, f)[:k] for f in ("rot", "pos", "delta_rot", "delta_tr", "est")
           if f in x._fields}
    return x._replace(**per)


@pytest.mark.parametrize("names", ESTIMATOR_SETS, ids="+".join)
def test_slice_matches_jax_after_state_handover(names, jax_slice):
    assert names == ESTIMATOR_SETS[-1][: len(names)]
    frames, state, ref_state, ref, draws = jax_slice
    k = len(names)
    state, ref_state, ref, draws = _leading(state, k), _leading(ref_state, k), _leading(ref, k), draws[:k]
    _, tp = _pipes(names)
    t_state = interop.state_from_jax(state, "cpu")
    new_state, out = tp.step_from_frames(t_state, torch.from_numpy(frames[2]), draws=draws)

    grid, ref_grid = out.grid.numpy(), np.asarray(ref.grid)
    assert grid.shape == ref_grid.shape == (B, 90, 150, 2)
    d = np.abs(grid - ref_grid)
    assert (d <= 1e-5).mean() >= 0.995, (d > 1e-5).mean()
    assert d.max() <= 1.5 / W, d.max()
    np.testing.assert_allclose(out.rot[0].numpy(), np.asarray(ref.rot[0]), rtol=0, atol=1e-4)
    np.testing.assert_allclose(out.delta_rot[0].numpy(), np.asarray(ref.delta_rot[0]),
                               rtol=0, atol=1e-4)
    if "homography" in names:
        _hold_homography(tp, names.index("homography"), out, ref, t_state, draws)
    for name in ("multiview", "libmv"):
        if name in names:
            _hold_epipolar(tp, names.index(name), out, ref, t_state, new_state, ref_state, draws)
    det, ref_det = out.detection, ref.detection
    np.testing.assert_array_equal(det.detected.numpy(), np.asarray(ref_det.detected))
    np.testing.assert_array_equal(det.area.numpy(), np.asarray(ref_det.area))
    np.testing.assert_array_equal(det.mask.numpy(), np.asarray(ref_det.mask))
    assert det.detected.any()  # the moving patch is found

    got = interop.state_to_numpy(new_state)
    dw = np.maximum(*(np.abs(g - np.asarray(r)) for g, r in zip(got["warm_uv"], ref_state.warm_uv)))
    assert (dw <= 1e-4).mean() >= 0.995 and dw.max() <= 1.0 + 1e-3
    np.testing.assert_array_equal(got["pyr"][0], frames[2])
    np.testing.assert_array_equal(got["has_prev"], np.ones(B, np.float32))


def _hold_homography(tp, i, out, ref, t_state, draws):
    """Homography's rotations against JAX's within 1e-4, family by family.

    The panning scene's homography is a translation, far from the
    pure-rotation branch, and its two decomposition families have equal
    |t| in exact arithmetic: which one the minimum picks is decided by
    rounding, in either package.  So the port's pick must be its own
    minimum's, JAX's delta rotation must be within 1e-4 of one of the
    port's two family rotations (on the port's grid, same draws), and JAX's
    integrated rotation within 1e-4 of that family's integrated one."""
    est = tp.estimators[i]
    fit = the.ransac_plain(field_to_sparse(out.grid), tp.camera, est.params,
                           the.hypothesis_count(est.params), est.params.max_error, dense=True,
                           idx=draws[i])
    quats, tnorm = fit.quats, fit.tnorm  # (B, 2, 4), (B, 2)
    rows = torch.arange(B)
    assert torch.equal(out.delta_rot[i], quats[rows, torch.argmin(tnorm, dim=-1)])
    np.testing.assert_allclose(out.rot[i].numpy(), tq.mul(out.delta_rot[i], t_state.rot[i]).numpy(),
                               rtol=0, atol=1e-7)
    ref_d = np.asarray(ref.delta_rot[i])
    fam = torch.from_numpy(np.abs(quats.numpy() - ref_d[:, None]).max(-1).argmin(-1))
    np.testing.assert_allclose(quats[rows, fam].numpy(), ref_d, rtol=0, atol=1e-4)
    np.testing.assert_allclose(tq.mul(quats[rows, fam], t_state.rot[i]).numpy(),
                               np.asarray(ref.rot[i]), rtol=0, atol=1e-4)


def _hold_epipolar(tp, i, out, ref, t_state, new_state, ref_state, draws):
    """Multiview or libmv: the pipeline's outputs are its estimator's on
    the port's grid (same draws, same carry), and the estimator on JAX's
    grid gives JAX's delta rotation within EPI_DEG degrees and, for libmv,
    JAX's translation direction and carried index.  On this scene (a pan,
    and a patch) the epipolar geometry is nearly degenerate, so the
    estimators are held on the same grid, not across the two packages'
    grids."""
    est = tp.estimators[i]

    def run(grid):
        return est.estimate(t_state.est[i], field_to_sparse(grid), tp.camera, dense=True,
                            fit_idx=draws[i])

    r, t, st = run(out.grid)
    assert torch.equal(out.delta_rot[i], r) and torch.equal(out.delta_tr[i], t)
    assert all(torch.equal(a, b) for a, b in zip(new_state.est[i], st))
    r, t, st = run(torch.from_numpy(np.asarray(ref.grid)))
    deg = np.degrees(tq.angle_to(r, torch.from_numpy(np.asarray(ref.delta_rot[i]))).numpy())
    assert deg.max() <= EPI_DEG, deg
    if est.name == "libmv":
        # The pan has no translation: its direction is set by the patch and
        # the noise, and its scale chain is chaotic (JAX's own magnitudes
        # differ by 17% between the two compilations).  The direction is
        # held within cos 0.99; the carried index exactly where it is a
        # selection, within 1e-5 where it is arithmetic.
        ref_t = np.asarray(ref.delta_tr[i])
        cos = np.sum(t.numpy() * ref_t, -1) / np.linalg.norm(t.numpy(), axis=-1) / np.linalg.norm(ref_t, axis=-1)
        assert cos.min() > 0.99, cos
        got = interop.state_to_numpy(interop.state_from_jax(ref_state, "cpu"))["est"][i]
        np.testing.assert_array_equal(st.valid.numpy(), got["valid"])
        np.testing.assert_array_equal(st.has.numpy(), got["has"])
        for f in ("pos", "motion"):
            np.testing.assert_allclose(getattr(st, f).numpy(), got[f], rtol=0, atol=1e-5, err_msg=f)


def test_port_scan_frames_from_init_state():
    _, tp = _pipes()
    frames = torch.from_numpy(_frames(3, seed=1))
    state, outs = tp.scan_frames(tp.init_state(B, H, W), frames, torch.Generator().manual_seed(0))
    assert len(outs) == 3 and state.has_prev.eq(1).all()
    for o in outs:
        assert o.grid.shape == (B, 90, 150, 2) and torch.isfinite(o.grid).all()
        assert torch.isfinite(o.rot[0]).all() and torch.isfinite(o.pos[0]).all()
        assert o.detection.mask.shape == (B, 14, 14)
    # The first frame has no predecessor: zero flow, identity rotation.
    assert torch.equal(outs[0].grid, torch.zeros_like(outs[0].grid))
    np.testing.assert_allclose(outs[0].delta_rot[0].numpy()[:, 0], 1.0, atol=1e-6)
    # The pan is recovered in the interior (u = -2 px).
    u_px = outs[-1].grid[:, 10:-10, 10:-10, 0] * W
    assert abs(float(u_px.median()) + 2.0) < 0.1


def test_carries_tile_and_flatten_for_the_graph():
    """``init_state`` tiles libmv's carry to B streams, and the graph's
    input list flattens and rebuilds the poses, the draws (a tuple for
    libmv, None for an estimator without) and the carries in order."""
    from ofps_torch.estimators.libmv import GRID, PrevMotion
    from ofps_torch.pipeline import graphs

    _, tp = _pipes(("almeida", "libmv"))
    state = tp.init_state(B, H, W)
    carry = state.est[1]
    assert state.est[0] == () and isinstance(carry, PrevMotion)
    assert carry.pos.shape == (B, GRID, GRID, 2) and carry.has.shape == (B,)
    assert torch.equal(carry.rot, tq.identity().expand(B, 4))
    draws = tp.estimators[1].draw(torch.Generator().manual_seed(0), (B,), 13500, "cpu")
    tree = (state.rot, state.pos, (None, draws), state.est)
    leaves = graphs.leaves(tree)
    assert len(leaves) == 2 + 2 + 2 + len(PrevMotion._fields)
    back = graphs.rebuild(tree, iter(leaves))
    assert back[2][0] is None and isinstance(back[3][1], PrevMotion) and back[3][0] == ()
    assert all(a is b for a, b in zip(graphs.leaves(back), leaves))


def test_interop_params():
    from ofps_tpu.detectors.block_motion import BlockMotionParams
    from ofps_tpu.estimators.almeida import AlmeidaParams

    fp = interop.flow_params_from_jax(JPARAMS)
    assert (fp.levels, fp.coarse_search, fp.fuse_min_pixels) == (3, 3, 3000)
    assert fp.cost_dtype == torch.bfloat16
    ap = interop.almeida_params_from_jax(AlmeidaParams(num_iters=50))
    assert ap.num_iters == 50 and ap.ransac_samples == 1000
    bp = interop.block_motion_params_from_jax(BlockMotionParams(min_size=0.1))
    assert bp.min_size == 0.1
    # A carry that is neither stateless nor libmv's PrevMotion is refused.
    from collections import namedtuple
    from types import SimpleNamespace

    z = np.zeros((B, 4), np.float32)
    state = SimpleNamespace(prev_cache=SimpleNamespace(pyr=(np.zeros((B, H, W)),)),
                            warm_uv=(z, z), has_prev=np.zeros(B), rot=(z,), pos=(z[:, :3],),
                            est=(namedtuple("Other", "x")(z),))
    with pytest.raises(ValueError, match="unknown estimator carry"):
        interop.state_from_jax(state, "cpu")


def test_pipeline_defaults_to_cuda():
    """With no device named, the pipeline takes the CUDA card, and raises
    where there is none rather than running on the CPU."""
    if torch.cuda.is_available():
        torch.backends.cuda.matmul.allow_tf32 = False
        assert TPipe(TCam.create(W / H, 60.0)).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            TPipe(TCam.create(W / H, 60.0))


def test_device_policy():
    assert resolve_device("cpu") == torch.device("cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            resolve_device("cuda")
    old = torch.backends.cuda.matmul.allow_tf32
    try:
        torch.backends.cuda.matmul.allow_tf32 = True
        with pytest.raises(RuntimeError):
            check_fp32_policy()
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old


@pytest.mark.cuda
@pytest.mark.parametrize("names", ESTIMATOR_SETS, ids="+".join)
def test_graphed_consumers_match_eager_on_cuda(names):
    """On the card the consumers replay as a CUDA graph; the replay runs
    the same kernels as the eager call on the same inputs, so the outputs
    are equal, over two consecutive steps so that libmv's carry passes
    through the graph.  Props are static inputs of the graph (0-d device
    tensors): passing them is one new graph, and a changed value
    (homography's max_error) replays it."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    tp = TPipe(TCam.create(W / H, 60.0), [t_est(n) for n in names], t_det("block_motion"),
               flow_params=interop.flow_params_from_jax(JPARAMS), emit_dense_flow=False,
               device=dev)
    frames = torch.from_numpy(_frames(2)).to(dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    state, _ = tp.step_from_frames(tp.init_state(B, H, W), frames[0], gen)
    state, out = tp.step_from_frames(state, frames[1], gen)
    assert tp.eager_runs == 0 and tp.graph_replays == 2
    g_state = e_state = state
    for _ in range(2):
        draws = tuple(e.draw(gen, (B,), 90 * 150, dev) for e in tp.estimators)
        graphed = tp._run_consumers(g_state, out.grid, draws, None)
        eager = tp._consume(out.grid, e_state.rot, e_state.pos, draws, e_state.est)
        assert len(tp.graphs.calls) == 1
        for g, e in zip(graphed[:4], eager[:4]):
            assert all(torch.equal(a, b) for a, b in zip(g, e))
        for g, e in zip(graphed[4], eager[4]):  # the carries
            assert all(torch.equal(a, b) for a, b in zip(g, e))
        for a, b in zip(graphed[5], eager[5]):
            assert torch.equal(a, b)
        g_state = g_state._replace(rot=graphed[0], pos=graphed[1], est=graphed[4])
        e_state = e_state._replace(rot=eager[0], pos=eager[1], est=eager[4])
    if "libmv" in names:
        assert bool((g_state.est[names.index("libmv")].has == 1).all())
    if "homography" in names:
        props = tp.dyn_props()
        i = names.index("homography")
        for max_error in (0.004, 0.002):
            props["estimators"][i]["max_error"] = max_error
            graphed = tp._run_consumers(state, out.grid, draws, props)
            eager = tp._consume(out.grid, state.rot, state.pos, draws, state.est, props)
            assert len(tp.graphs.calls) == 2
            assert torch.equal(graphed[2][i], eager[2][i])


@pytest.mark.cuda
def test_almeida_kernel_in_consumers_graph_on_cuda():
    """On the card almeida's RANSAC is three hand-kernel launches in the
    consumers' graph: a capture launches them twice (its eager warm-up and
    the captured call) and a replay none from the host; the replay's
    rotations equal the same kernels' called eagerly bit for bit and the
    eager plain path's (``plain=True``) within 1e-6 rad, with the same
    winners and counts (homography's, on its own kernels, family by family
    against its plain version: ``homography_checks``); and the graph has
    at least 17,000 fewer nodes than the plain pipeline's."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    frames = torch.from_numpy(_frames(2)).to(dev)

    def stepped(plain):
        tp = TPipe(TCam.create(W / H, 60.0), [t_est("almeida"), t_est("homography")],
                   t_det("block_motion"), flow_params=interop.flow_params_from_jax(JPARAMS),
                   emit_dense_flow=False, device=dev, plain=plain)
        gen = torch.Generator(device=dev).manual_seed(0)
        state, _ = tp.step_from_frames(tp.init_state(B, H, W), frames[0], gen)
        state, out = tp.step_from_frames(state, frames[1], gen)
        return tp, state, out, gen

    kalm.ransac.launches = 0
    tp, state, out, gen = stepped(False)
    assert kalm.ransac.launches == 6 and tp.graph_replays == 2 and tp.eager_runs == 0
    (nodes,) = [g.nodes for g in tp.graphs.calls.values()]
    draws = tuple(e.draw(gen, (B,), 90 * 150, dev) for e in tp.estimators)
    graphed = tp._run_consumers(state, out.grid, draws, None)
    assert kalm.ransac.launches == 6
    sparse = field_to_sparse(out.grid)
    eidx, w_e = (x.expand((B,) + x.shape) for x in trob.dense_eval_subset(90 * 150, 1000, "cuda"))
    bound = talm._inlier_bound(0.05, sparse.pos)
    got = kalm.ransac(tp.camera, sparse, draws[0], eidx, w_e, bound)
    ref = kalm.ransac_plain(tp.camera, sparse, draws[0], eidx, w_e, bound)
    assert torch.equal(got[1].long(), ref[1]) and torch.equal(got[2].long(), ref[2])

    tp_plain = stepped(True)[0]
    assert kalm.ransac.launches == 9  # the one direct call above
    eager = tp_plain._consume(out.grid, state.rot, state.pos, draws, state.est)
    assert kalm.ransac.launches == 9
    # The same kernels called eagerly: the replay's rotations bit for bit.
    eager_k = tp._consume(out.grid, state.rot, state.pos, draws, state.est)
    assert kalm.ransac.launches == 12
    for g, e in zip(graphed[2], eager_k[2]):
        assert torch.equal(g, e)
    assert tq.angle_to(graphed[2][0].double(), eager[2][0].double()).max().item() <= 1e-6
    # Homography on its kernels against its plain version (the plain
    # path's rotation), on the same field and draws: the same winner and
    # count, each family and |t| within 1e-6 rad, the pick the kernels' own
    # first minimum (which family the minimum picks off the pure-rotation
    # branch is decided by rounding, ROADMAP Queue 3), and the kernels'
    # rotation within 1e-6 rad of the nearer plain family.
    params = tp.estimators[1].params
    args = (sparse, tp.camera, params, the.hypothesis_count(params), params.max_error, True,
            draws[1])
    got, ref_h = khg.ransac(*args), the.ransac_plain(*args)
    assert torch.equal(got.rot, graphed[2][1]) and torch.equal(ref_h.rot, eager[2][1])
    assert torch.equal(got.fit.best, ref_h.fit.best)
    assert torch.equal(got.fit.score, ref_h.fit.score)
    assert_fit_matches(got, ref_h, torch.ones(B, dtype=torch.bool))
    near = tq.angle_to(got.rot.double()[:, None], ref_h.quats.double()).min(dim=-1).values
    assert near.max().item() <= 1e-6
    assert torch.allclose(graphed[2][0], ref[0], rtol=0, atol=1e-6)
    (plain_nodes,) = [g.nodes for g in tp_plain.graphs.calls.values()]
    assert plain_nodes - nodes >= 17000
