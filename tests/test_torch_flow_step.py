"""The codec-MV step end to end: the port's ``StreamPipeline.
step_from_flow`` / ``scan_flow`` against ofps_tpu's on the CPU.

Configuration: almeida (stateless) + libmv (its ``PrevMotion`` carried) +
block_motion, B=3 streams of capacity 1,024, three steps.  Streams 0 and 1
see a camera moving through points at varying depth (translation and a
small rotation per step, about 800 valid vectors, the rest padding); stream
2 is all-masked.  JAX's ``scan_flow`` splits its key per step and then per
estimator and stream; the uniforms its masked samplers drew from those keys
are injected into the port.

Tolerances: almeida's delta and integrated rotations within 1e-4 deg;
libmv's rotations within 2e-3 deg and its translation direction within
1e-3, its carried ``PrevMotion`` as ``tests/test_torch_libmv.py`` holds it
(valid and has exactly, positions and motions within 1e-6, rotation and
anchor translation within 1e-4); detections (detected, area, mask)
exactly equal and the island fields within 1e-6; the empty stream's pose
exactly identity in both.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ofps_torch.core import quat as tq
from ofps_torch.core.camera import StandardCamera as TCam
from ofps_torch.core.motion import SparseFlow as TSparse
from ofps_torch.detectors.base import create_detector as t_det
from ofps_torch.estimators.base import create_estimator as t_est
from ofps_torch.parallel.stream import StreamPipeline as TPipe
from ofps_torch.parallel.stream import _leaves
from ofps_tpu.core.camera import StandardCamera as JCam
from ofps_tpu.core.motion import SparseFlow as JSparse
from ofps_tpu.detectors.base import create_detector as j_det
from ofps_tpu.estimators.base import create_estimator as j_est
from ofps_tpu.parallel.stream import StreamPipeline as JPipe
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

B, CAP, T = 3, 1024, 3
NAMES = ("almeida", "libmv")


def _flows():
    """(T, B, CAP) pos, motion, mask: streams 0 and 1 on camera paths
    through 30x30 points at depths 0.3-1, stream 2 empty."""
    from synthetic import calc_view, euler_deg, get_grid

    cam = JCam.create(1.0, 90.0)
    rng = np.random.default_rng(0)
    grid = np.asarray(get_grid(30, 30, cam))
    pts = jnp.asarray(grid * rng.uniform(0.3, 1.0, (len(grid), 1)).astype(np.float32))
    paths = [
        [((0, 0, 0), (0, 0, 0)), ((0.1, 0, 0), (0.2, 0, 0.1)), ((0.1, 0, 0.05), (0.3, 0.1, 0.1)),
         ((0.15, 0, 0.05), (0.3, 0.1, 0.3))],
        [((0, 0, 0), (0, 0, 0)), ((0, 0, 0.08), (0, 0.2, 0)), ((0.05, 0, 0.1), (0.1, 0.2, -0.2)),
         ((0.05, 0, 0.18), (0.1, 0.3, -0.2))],
    ]
    pos = np.zeros((T, B, CAP, 2), np.float32)
    mot = np.zeros((T, B, CAP, 2), np.float32)
    mask = np.zeros((T, B, CAP), np.float32)
    for s, path in enumerate(paths):
        views = [calc_view(euler_deg(*r), jnp.asarray(p, jnp.float32)) for p, r in path]
        for t in range(T):
            a, b = (np.asarray(cam.project(pts, v)) for v in views[t : t + 2])
            keep = (np.abs(a - 0.5).max(1) < 0.5) & (np.abs(b - 0.5).max(1) < 0.5)
            n = int(keep.sum())
            pos[t, s, :n], mot[t, s, :n], mask[t, s, :n] = a[keep], (b - a)[keep], 1.0
    return pos, mot, mask


def _jax_draws(key):
    """Per step, the uniforms JAX's masked samplers drew: one key per
    estimator and stream (estimator-major); almeida samples from its key's
    first split (200 x 3), libmv's primary solve from its first split and
    its chained field from its second (512 x 7 each)."""
    out = []
    for k in jax.random.split(key, T):
        keys = jax.random.split(k, len(NAMES) * B)
        alm = [jax.random.uniform(jax.random.split(x)[0], (200, 3)) for x in keys[:B]]
        lm = [jax.random.split(x) for x in keys[B:]]
        out.append((_stack(alm), (_stack([jax.random.uniform(k1, (512, 7)) for k1, _ in lm]),
                                  _stack([jax.random.uniform(k2, (512, 7)) for _, k2 in lm]))))
    return out


def _stack(xs):
    return torch.from_numpy(np.stack([np.asarray(x) for x in xs]))


def _deg(a, b):
    return np.degrees(tq.angle_to(a, torch.from_numpy(np.array(b))).numpy())


def test_scan_flow_matches_jax_with_an_empty_stream():
    pos, mot, mask = _flows()
    assert (mask[:, :2].sum(-1) > 700).all() and mask[:, 2].sum() == 0
    jp = JPipe(JCam.create(1.0, 90.0), [j_est(n) for n in NAMES], j_det("block_motion"))
    key = jax.random.PRNGKey(3)
    ref_state, ref = jax.jit(jp.scan_flow)(jp.init_state(B, 1, 1),
                                          JSparse(*map(jnp.asarray, (pos, mot, mask))), key)
    tp = TPipe(TCam.create(1.0, 90.0), [t_est(n) for n in NAMES], t_det("block_motion"),
               device="cpu")
    seq = TSparse(*map(torch.from_numpy, (pos, mot, mask)))
    draws = _jax_draws(key)
    state, outs = tp.scan_flow(tp.init_state(B, 1, 1), seq, draws=draws)
    assert len(outs) == T and tp.eager_runs == T

    for t, o in enumerate(outs):
        assert o.flow.shape == o.grid.shape == (B, 0, 0, 2)
        assert _deg(o.delta_rot[0], ref.delta_rot[0][t]).max() <= 1e-4
        assert _deg(o.rot[0], ref.rot[0][t]).max() <= 1e-4
        assert _deg(o.delta_rot[1], ref.delta_rot[1][t]).max() <= 2e-3
        t_got, t_ref = o.delta_tr[1].numpy()[:2], np.asarray(ref.delta_tr[1][t])[:2]
        d_got = t_got / np.linalg.norm(t_got, axis=-1, keepdims=True)
        d_ref = t_ref / np.linalg.norm(t_ref, axis=-1, keepdims=True)
        assert np.abs(d_got - d_ref).max() <= 1e-3
        det, rdet = o.detection, jax.tree_util.tree_map(lambda x: np.asarray(x[t]), ref.detection)
        np.testing.assert_array_equal(det.detected.numpy(), rdet.detected)
        np.testing.assert_array_equal(det.area.numpy(), rdet.area)
        np.testing.assert_array_equal(det.mask.numpy(), rdet.mask)
        np.testing.assert_allclose(det.field.numpy(), rdet.field, rtol=0, atol=1e-6)
        for r in (o.rot[0], o.rot[1], o.delta_rot[0], o.delta_rot[1]):  # the empty stream
            assert torch.equal(r[2], tq.identity())
        for e in range(2):
            np.testing.assert_array_equal(np.asarray(ref.rot[e][t])[2], [1.0, 0.0, 0.0, 0.0])
    assert outs[-1].detection.detected[:2].all()

    carry, ref_carry = state.est[1], ref_state.est[1]
    np.testing.assert_array_equal(carry.valid.numpy(), np.asarray(ref_carry.valid))
    np.testing.assert_array_equal(carry.has.numpy(), np.asarray(ref_carry.has))
    assert carry.has.tolist() == [1.0, 1.0, 0.0]
    for f, tol in (("pos", 1e-6), ("motion", 1e-6), ("rot", 1e-4), ("tr", 1e-4)):
        np.testing.assert_allclose(getattr(carry, f).numpy(), np.asarray(getattr(ref_carry, f)),
                                   rtol=0, atol=tol, err_msg=f)

    # scan_flow is step_from_flow in order.
    st = tp.init_state(B, 1, 1)
    for t in range(T):
        st, o = tp.step_from_flow(st, TSparse(seq.pos[t], seq.motion[t], seq.mask[t]),
                                  draws=draws[t])
        assert all(torch.equal(a, b) for a, b in zip(o.rot, outs[t].rot))


@pytest.mark.cuda
def test_graphed_flow_consumers_match_eager_on_cuda():
    """On the card ``step_from_flow``'s consumers (masked RANSAC, the sparse
    detector) replay as one CUDA graph, equal to the same calls made
    eagerly over two consecutive steps with libmv's carry; props passed as
    values replay one more graph whatever their values."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    pos, mot, mask = (torch.from_numpy(x).to(dev) for x in _flows())
    tp = TPipe(TCam.create(1.0, 90.0), [t_est(n) for n in NAMES], t_det("block_motion"),
               device=dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    state, _ = tp.scan_flow(tp.init_state(B, 1, 1), TSparse(pos, mot, mask), gen)
    assert tp.graph_replays == T and tp.eager_runs == 0 and len(tp._graphs) == 1
    flow = TSparse(pos[-1], mot[-1], mask[-1])
    g_state = e_state = state
    for _ in range(2):
        draws = tuple(e.draw(gen, (B,), CAP, dev, dense=False) for e in tp.estimators)
        graphed = tp._run_consumers(g_state, flow, draws, None)
        eager = tp._consume(e_state.est, e_state.rot, e_state.pos, flow, draws)
        assert all(torch.equal(a, b) for a, b in zip(_leaves(graphed), _leaves(eager)))
        g_state = g_state._replace(rot=graphed[0], pos=graphed[1], est=graphed[4])
        e_state = e_state._replace(rot=eager[0], pos=eager[1], est=eager[4])
    props = tp.dyn_props()
    for target in (0.003, 0.5):
        props["detector"]["target_motion"] = target
        _, out = tp.step_from_flow(state, flow, gen, props=props)
        assert bool(out.detection.detected[:2].all()) == (target < 0.1)
    assert len(tp._graphs) == 2 and tp.eager_runs == 0
