"""The port's codec-MV input layer against ofps_tpu on the CPU: the
``.mvec`` and ``.flo`` formats, stream opening (files and ``tcp://``), the
decoder routing, ``OFPS_TORCH_PLUGINS``, the properties table, the GT
statistics, and each estimator's masked draws.

Tolerances: files byte-identical; readers, routing, properties and the
masked draws' indices exactly equal; GT statistics within 1e-12 (the
same float64 numpy code).  An estimator fed uniforms equals (bit for bit)
the same estimator fed the indices JAX's masked sampler made from them.
"""

import socket
import sys
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ofps_torch.apps import gt as tgt
from ofps_torch.core import properties as tprops
from ofps_torch.core.camera import StandardCamera as TCam
from ofps_torch.core.motion import SparseFlow as TSparse
from ofps_torch.decoders import base as tbase
from ofps_torch.decoders import flo as tflo
from ofps_torch.decoders import mvec as tmvec
from ofps_torch.estimators.base import create_estimator as t_est
from ofps_torch.ops import robust as trob
from ofps_torch.pipeline.graphs import leaves
from ofps_tpu.apps import gt as jgt
from ofps_tpu.core import properties as jprops
from ofps_tpu.decoders import flo as jflo
from ofps_tpu.decoders import mvec as jmvec
from ofps_tpu.ops import robust as jrob
from torch_threads import one_torch_thread  # noqa: F401 (autouse)


def _frames(seed, n=5):
    """(pos, motion) per frame: counts 0..~300, one empty frame."""
    rng = np.random.default_rng(seed)
    out = []
    for t in range(n):
        k = 0 if t == 1 else int(rng.integers(1, 300))
        out.append((rng.uniform(0, 1, (k, 2)).astype(np.float32),
                    rng.normal(0, 0.01, (k, 2)).astype(np.float32)))
    return out


def _write(mod, path, frames):
    with open(path, "wb") as f:
        for pos, mot in frames:
            mod.write_mvec_frame(f, pos, mot)


def _read_all(dec, skip=0):
    out = []
    while (fr := dec.process_frame(skip=skip)) is not None:
        out.append((fr.pos, fr.motion))
    dec.close()
    return out


def test_mvec_files_byte_identical_and_readers_agree(tmp_path):
    frames = _frames(0)
    _write(jmvec, tmp_path / "j.mvec", frames)
    _write(tmvec, tmp_path / "t.mvec", frames)
    data = (tmp_path / "j.mvec").read_bytes()
    assert data == (tmp_path / "t.mvec").read_bytes()
    # A truncated last frame ends the stream in both readers.
    (tmp_path / "cut.mvec").write_bytes(data[:-9])
    for name, skip in (("j.mvec", 0), ("j.mvec", 1), ("cut.mvec", 0), ("cut.mvec", 2)):
        ref = _read_all(jmvec.MvecDecoder(str(tmp_path / name)), skip)
        got = _read_all(tmvec.MvecDecoder(str(tmp_path / name)), skip)
        assert len(got) == len(ref) > 0
        for (gp, gm), (rp, rm) in zip(got, ref):
            np.testing.assert_array_equal(gp, rp)
            np.testing.assert_array_equal(gm, rm)
    assert len(_read_all(tmvec.MvecDecoder(str(tmp_path / "cut.mvec")))) == len(frames) - 1


def test_flo_files_byte_identical(tmp_path):
    flow = np.random.default_rng(1).normal(0, 3, (7, 11, 2)).astype(np.float32)
    jflo.write_flo(str(tmp_path / "j.flo"), flow)
    tflo.write_flo(str(tmp_path / "t.flo"), flow)
    assert (tmp_path / "j.flo").read_bytes() == (tmp_path / "t.flo").read_bytes()
    np.testing.assert_array_equal(tflo.read_flo(str(tmp_path / "j.flo")), flow)
    np.testing.assert_array_equal(jflo.read_flo(str(tmp_path / "t.flo")), flow)
    (tmp_path / "bad.flo").write_bytes(b"\0" * 20)
    with pytest.raises(ValueError, match="magic"):
        tflo.read_flo(str(tmp_path / "bad.flo"))


def test_create_decoder_routes_mvec_to_the_replay_reader(tmp_path):
    path = str(tmp_path / "x.mvec")
    _write(tmvec, path, _frames(2, 2))
    dec = tbase.create_decoder(path)
    assert isinstance(dec, tmvec.MvecDecoder)
    dec.close()
    assert {"mvec", "av", "cv"} <= set(tbase.available_decoders())
    with pytest.raises(KeyError, match="unknown decoder"):
        tbase.create_decoder(path, plugin="nope")


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_tcp_listen_and_connect_loopback(tmp_path):
    """``tcp://@:port`` listens, accepts one connection and replays what
    the peer sends (here over the loopback); ``tcp://addr:port`` connects
    to a listener.  Every wait has a timeout."""
    frames = _frames(3, 3)
    _write(tmvec, tmp_path / "s.mvec", frames)
    data = (tmp_path / "s.mvec").read_bytes()

    port = _free_port()
    got = {}
    server = threading.Thread(target=lambda: got.update(
        dec=tbase.create_decoder(f"tcp://@:{port}", plugin="mvec")), daemon=True)
    server.start()
    deadline = time.monotonic() + 10.0
    while True:
        try:
            sock = socket.create_connection(("127.0.0.1", port), timeout=1.0)
            break
        except OSError:
            assert time.monotonic() < deadline, "listener never came up"
            time.sleep(0.05)
    with sock:
        sock.sendall(data)
    server.join(timeout=10.0)
    assert not server.is_alive()
    out = _read_all(got["dec"])
    assert [len(p) for p, _ in out] == [len(p) for p, _ in frames]
    np.testing.assert_array_equal(out[-1][1], frames[-1][1])

    with socket.socket() as listener:
        listener.bind(("127.0.0.1", 0))
        listener.listen(1)
        listener.settimeout(10.0)
        dec = tmvec.MvecDecoder(f"tcp://127.0.0.1:{listener.getsockname()[1]}")
        conn, _ = listener.accept()
        with conn:
            conn.sendall(data)
        out = _read_all(dec)
    assert len(out) == len(frames)
    with pytest.raises(ValueError, match="addr:port"):
        tmvec.MvecDecoder("tcp://127.0.0.1")


def test_torch_plugins_env_loads_a_module(tmp_path, monkeypatch):
    """A module named in OFPS_TORCH_PLUGINS registers into the port's
    registries; one named only in OFPS_TPU_PLUGINS is not imported."""
    from ofps_torch.estimators import base as ebase

    (tmp_path / "port_plugin_mod.py").write_text(
        "from ofps_torch.estimators.base import EstimatorInstance, register\n"
        "@register('plugin_est')\n"
        "def make(**kw):\n"
        "    return EstimatorInstance(name='plugin_est', params=kw, init=lambda: (),\n"
        "                             estimate=None)\n")
    (tmp_path / "jax_only_mod.py").write_text("raise RuntimeError('imported')\n")
    monkeypatch.syspath_prepend(str(tmp_path))
    monkeypatch.setenv("OFPS_TORCH_PLUGINS", "port_plugin_mod")
    monkeypatch.setenv("OFPS_TPU_PLUGINS", "jax_only_mod")
    try:
        assert t_est("plugin_est", a=1).params == {"a": 1}
        assert "plugin_est" in ebase.available_estimators()
        assert "jax_only_mod" not in sys.modules
    finally:
        ebase._REGISTRY.pop("plugin_est", None)
        sys.modules.pop("port_plugin_mod", None)


def test_properties_match():
    assert tprops.BOUNDS == jprops.BOUNDS
    from ofps_torch.detectors.block_motion import BlockMotionParams as TB
    from ofps_torch.estimators.almeida import AlmeidaParams as TA
    from ofps_tpu.detectors.block_motion import BlockMotionParams as JB
    from ofps_tpu.estimators.almeida import AlmeidaParams as JA

    for comp, tp, jp, over in (("almeida", TA(), JA(), {"num_iters": 9999.7, "inlier_angle_deg": 0.2}),
                               ("block_motion", TB(), JB(), {"target_motion": 0.5})):
        assert tprops.describe(comp, tp) == [
            tprops.PropertyDesc(**d.__dict__) for d in jprops.describe(comp, jp)]
        assert tprops.set_properties(comp, tp, over)._asdict() == \
            jprops.set_properties(comp, jp, over)._asdict()
    with pytest.raises(KeyError):
        tprops.set_properties("almeida", TA(), {"nope": 1})
    with pytest.raises(TypeError):
        tprops.set_properties("almeida", TA(), {"use_ransac": 1})


def test_gt_statistics_match(tmp_path):
    rng = np.random.default_rng(4)

    def unit(q):
        return q / np.linalg.norm(q, axis=-1, keepdims=True)

    rows = [jgt.GroundTruthRow(frame=k + 1, fov_x=90.0, fov_y=90.0,
                               rot=unit(np.array([1.0, *rng.normal(0, 0.01, 3)])),
                               pos=rng.normal(0, 1, 3)) for k in range(6)]
    path = str(tmp_path / "gt.csv")
    jgt.write_ground_truth(path, rows)
    tgt.write_ground_truth(str(tmp_path / "gt2.csv"), tgt.load_ground_truth(path))
    assert (tmp_path / "gt2.csv").read_text() == (tmp_path / "gt.csv").read_text()
    truth_j, truth_t = jgt.load_ground_truth(path), tgt.load_ground_truth(path)
    transforms = [unit(np.array([1.0, *rng.normal(0, 0.01, 3)])) for _ in range(6)]
    positions = [rng.normal(0, 1, 3) for _ in range(6)]
    np.testing.assert_allclose(tgt.calc_avg_err(truth_t, transforms),
                               jgt.calc_avg_err(truth_j, transforms), rtol=0, atol=1e-12)
    np.testing.assert_allclose(tgt.calc_pos_err(truth_t, positions)[0],
                               jgt.calc_pos_err(truth_j, positions)[0], rtol=0, atol=1e-12)
    tgt.write_stats_csv(str(tmp_path / "t.csv"), tgt.calc_err(truth_t, transforms),
                        tgt.pose_stats(transforms, transforms))
    jgt.write_stats_csv(str(tmp_path / "j.csv"), jgt.calc_err(truth_j, transforms),
                        jgt.pose_stats(transforms, transforms))
    assert (tmp_path / "t.csv").read_text() == (tmp_path / "j.csv").read_text()


# -- masked draws ------------------------------------------------------------

B, N = 2, 700
# (rows, k) of each estimator's masked draws at its defaults, and how JAX
# derives the key its sampler uses from the estimator's key: almeida and
# libmv sample from the first split, homography and multiview from the key.
DRAWS = {"almeida": (200, 3, True), "homography": (91, 4, False),
         "multiview": (218, 5, False), "libmv": (512, 7, True)}


def _masked_flow(seed):
    """B flows of N entries on a rotation-like field, a quarter invalid
    (stream 1 also has its last 300 entries invalid)."""
    rng = np.random.default_rng(seed)
    pos = rng.uniform(0.05, 0.95, (B, N, 2)).astype(np.float32)
    mot = (np.array([0.004, -0.002]) + rng.normal(0, 1e-4, (B, N, 2))).astype(np.float32)
    mask = (rng.uniform(size=(B, N)) > 0.25).astype(np.float32)
    mask[1, -300:] = 0.0
    return pos, mot, mask


@pytest.mark.parametrize("name", list(DRAWS))
def test_masked_draw_mapping_gives_jax_indices(name):
    """JAX's masked sampler's uniforms, mapped by the port
    (``ops.robust.indices_from_uniform``), are JAX's indices exactly; the
    estimator fed those uniforms equals the estimator fed the indices."""
    rows, k, split = DRAWS[name]
    pos, mot, mask = _masked_flow(5)
    keys = jax.random.split(jax.random.PRNGKey(9), B)
    u, idx = [], []
    for b in range(B):
        key = jax.random.split(keys[b])[0] if split else keys[b]
        u.append(np.asarray(jax.random.uniform(key, (rows, k))))
        idx.append(np.asarray(jrob.sample_indices(key, jnp.asarray(mask[b]), rows, k)))
    u, idx = torch.from_numpy(np.stack(u)), torch.from_numpy(np.stack(idx)).long()
    mapped = trob.indices_from_uniform(u, torch.from_numpy(mask))
    assert torch.equal(mapped, idx)
    assert bool((torch.from_numpy(mask).gather(-1, mapped.flatten(1)) == 1).all())

    est = t_est(name)
    drawn = est.draw(torch.Generator().manual_seed(0), (B,), N, "cpu", dense=False)
    first = drawn[0] if name == "libmv" else drawn
    assert first.shape == (B, rows, k) and first.dtype == torch.float32
    flow = TSparse(torch.from_numpy(pos), torch.from_numpy(mot), torch.from_numpy(mask))
    cam = TCam.create(1.0, 90.0)
    state = est.init()
    if name == "libmv":
        from ofps_torch.estimators.libmv import PrevMotion

        state = PrevMotion(*(x.expand((B,) + x.shape).clone() for x in PrevMotion.empty()))
        chain = torch.rand((B, rows, k), generator=torch.Generator().manual_seed(1))
        by_u, by_idx = (u, chain), (idx, chain)
    else:
        by_u, by_idx = u, idx
    a = est.estimate(state, flow, cam, dense=False, fit_idx=by_u)
    b = est.estimate(state, flow, cam, dense=False, fit_idx=by_idx)
    for x, y in zip(leaves(a), leaves(b)):
        assert torch.equal(x, y)
    assert bool(torch.isfinite(a[0]).all())


@pytest.mark.parametrize("name", list(DRAWS))
def test_all_masked_flow_gives_identity_in_both_packages(name):
    """An all-masked flow (an ended stream under ``drop_ended``): JAX's
    masked sampler clamps its valid count to 1 and its gather clamps the
    past-the-end index; each JAX estimator returns the identity rotation
    and a zero translation with a finite carry, and so does the port's."""
    from ofps_tpu.core.camera import StandardCamera as JCam
    from ofps_tpu.core.motion import SparseFlow as JSparse
    from ofps_tpu.estimators.base import create_estimator as j_est

    n = 64
    pos = np.random.default_rng(6).uniform(0, 1, (n, 2)).astype(np.float32)
    zeros = np.zeros((n, 2), np.float32)
    jest = j_est(name)
    r, t, st = jax.jit(lambda s, f, k: jest.estimate(s, f, JCam.create(1.0, 90.0), k))(
        jest.init(), JSparse(jnp.asarray(pos), jnp.asarray(zeros), jnp.zeros(n)),
        jax.random.PRNGKey(1))
    np.testing.assert_array_equal(np.asarray(r), [1.0, 0.0, 0.0, 0.0])
    np.testing.assert_array_equal(np.asarray(t), [0.0, 0.0, 0.0])
    assert all(np.isfinite(np.asarray(x)).all() for x in jax.tree_util.tree_leaves(st))

    test = t_est(name)
    state = test.init()
    if name == "libmv":
        state = type(state)(*(x[None] for x in state))
    flow = TSparse(torch.from_numpy(pos)[None], torch.zeros(1, n, 2), torch.zeros(1, n))
    draws = test.draw(torch.Generator().manual_seed(0), (1,), n, "cpu", dense=False)
    r, t, st2 = test.estimate(state, flow, TCam.create(1.0, 90.0), dense=False, fit_idx=draws)
    assert torch.equal(r[0], torch.tensor([1.0, 0.0, 0.0, 0.0]))
    assert torch.equal(t[0], torch.zeros(3))
    assert all(torch.equal(a, b) for a, b in zip(leaves(st2), leaves(state)))  # held
