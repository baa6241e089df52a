"""The cv decoder (ofps_torch.decoders.cv) against ofps_tpu's, on the CPU.

One noise-pattern clip (128 x 96, 5 frames, moving (2, -1) px/frame) is
written with ofps_tpu's test-clip encoder and decoded by both packages'
``create_decoder(..., plugin="cv", levels=3)`` for both flow algorithms.
The contrast mask and cell partition are the same arithmetic, so ``pos``
and ``has_mvs`` are equal.  ``motion`` tolerance (normalized units): LK
within 2e-5 (float32 rounding, carried over frames through the warm start;
~3e-6 observed); SAD block matching as the stream tests hold it, at least
99.5% of cells within 1e-5 and none off by more than 1.5 / W (one
candidate flip at a float32 near-tie moves a ~1-pixel cell by one step).
"""

import ast
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.ndimage import gaussian_filter

from ofps_torch.decoders import av as tav
from ofps_torch.decoders.base import available_decoders
from ofps_torch.decoders.base import create_decoder as t_create
from ofps_torch.decoders.cv import CvDecoder, CvFlowStep
from ofps_tpu.decoders.av import encode_test_video
from ofps_tpu.decoders.base import create_decoder as j_create
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

ROOT = Path(__file__).resolve().parent.parent
H, W = 96, 128
LK_TOL = 2e-5


def _cv_kwargs_from_jax(dec) -> dict:
    """The port's ``CvDecoder`` keyword arguments that configure it as the
    JAX package's decoder ``dec`` is configured (the two take the same
    keyword names; the device is left to the caller)."""
    return {
        "grid_max_dim": dec._grid_max_dim,
        "use_contrast_mask": dec._use_mask,
        "levels": dec._levels,
        "mask_threshold": dec._mask_threshold,
        "mask_dilate": dec._mask_dilate,
        "use_rlof": dec._use_rlof,
    }


def _assert_motion_close(got, ref, use_rlof):
    d = np.abs(got - ref)
    assert np.isfinite(got).all()
    if use_rlof:
        assert d.max() <= LK_TOL, d.max()
    else:
        assert (d <= 1e-5).mean() >= 0.995, (d > 1e-5).mean()
        assert d.max() <= 1.5 / W, d.max()


@pytest.fixture(scope="module")
def clip(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("cv") / "clip.avi")
    encode_test_video(path, W, H, frames=5, gop=30, dx=2.0, dy=-1.0, pattern="noise")
    return path


@pytest.fixture(scope="module", params=[False, True], ids=["sad", "rlof"])
def decoded(request, clip):
    """(use_rlof, JAX frames, port frames, the JAX decoder) of the clip."""
    jd = j_create(clip, plugin="cv", levels=3, use_rlof=request.param)
    td = t_create(clip, plugin="cv", device="cpu", **_cv_kwargs_from_jax(jd))
    jf, tf = [], []
    for k in range(6):
        jf.append(jd.process_frame(want_frame=k == 0))
        tf.append(td.process_frame(want_frame=k == 0))
    return request.param, jf, tf, jd


def test_decoder_matches_jax(decoded):
    use_rlof, jf, tf, _ = decoded
    assert jf[-1] is None and tf[-1] is None  # end of stream after 5 frames
    assert not tf[0].has_mvs and len(tf[0].pos) == 0
    np.testing.assert_array_equal(tf[0].frame, jf[0].frame)
    assert tf[0].frame.shape == (H, W, 4)
    for a, b in zip(jf[1:-1], tf[1:-1]):
        assert b.has_mvs == a.has_mvs is True and b.frame is None
        np.testing.assert_array_equal(b.pos, a.pos)
        assert len(b.pos) > 0
        _assert_motion_close(b.motion, a.motion, use_rlof)
    med = np.median([np.median(f.motion, axis=0) * (W, H) for f in tf[1:-1]], axis=0)
    np.testing.assert_allclose(med, [2.0, -1.0], atol=0.1)


def test_flow_step_matches_jax(decoded):
    """``CvFlowStep`` against the JAX decoder's jitted step on seeded
    frames and a seeded warm start: flow (LK within 1e-4 px; SAD at least
    99.5% of pixels within 1e-4 px, none off by more than one candidate
    step), the grid as ``motion`` above, the valid cells equal."""
    use_rlof, _, _, jd = decoded
    rng = np.random.default_rng(0)
    img = (gaussian_filter(rng.standard_normal((H + 20, W + 20)), 2) * 300).astype(np.float32)
    img[:, : W // 3] *= 0.02  # a low-contrast band that the contrast mask drops
    prev, cur = img[10 : 10 + H, 10 : 10 + W], img[11 : 11 + H, 7 : 7 + W]
    warm = (gaussian_filter(rng.standard_normal((H, W, 2)), (6, 6, 0)) * 4 + (3, -1)).astype(
        np.float32
    )
    j_flow, j_grid, j_valid = map(np.asarray, jd._fn(*map(jnp.asarray, (prev, cur, warm))))
    step = CvFlowStep(H, W, levels=3, use_rlof=use_rlof, device="cpu")
    flow, grid, valid = step(*(torch.from_numpy(np.ascontiguousarray(x)) for x in (prev, cur, warm)))
    d = np.abs(flow.numpy() - j_flow).max(axis=-1)
    if use_rlof:
        assert d.max() <= 1e-4, d.max()
    else:
        assert (d <= 1e-4).mean() >= 0.995 and d.max() <= 1.0 + 1e-3, (d > 1e-4).mean()
    np.testing.assert_array_equal(valid.numpy(), j_valid)
    assert 0 < valid.sum() < valid.numel()  # the contrast mask drops some cells
    _assert_motion_close(grid.numpy(), j_grid, use_rlof)
    assert step.grid_wh == (W, H)  # grid_size_for caps at the frame size


def test_port_encoder_writes_the_same_clip(clip, tmp_path):
    """The port's own writer (its copy of the native source) and the JAX
    package's give clips that decode to the same frames."""
    path = str(tmp_path / "port.avi")
    tav.encode_test_video(path, W, H, frames=5, gop=30, dx=2.0, dy=-1.0, pattern="noise")
    a, b = tav.AvDecoder(clip), tav.AvDecoder(path)
    assert a.get_aspect() == b.get_aspect() == (W, H)
    for _ in range(5):
        fa, fb = a.process_frame(want_frame=True), b.process_frame(want_frame=True)
        np.testing.assert_array_equal(fa.frame, fb.frame)
    assert a.process_frame() is None and b.process_frame() is None
    a.close()
    b.close()
    assert available_decoders() == ["av", "cv", "mvec"]


def test_entry_points_default_to_cuda(clip):
    """``CvDecoder`` and ``CvFlowStep`` with no device take the CUDA card,
    and raise where there is none rather than running on the CPU."""
    if torch.cuda.is_available():
        torch.backends.cuda.matmul.allow_tf32 = False
        assert CvDecoder(clip).device.type == "cuda"
        assert CvFlowStep(H, W).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            CvDecoder(clip)
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            CvFlowStep(H, W)


def _imported_modules(path: Path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def test_port_imports_no_jax():
    """No module of ofps_torch, nor chip_smoke.py, imports jax or ofps_tpu,
    directly (read from the source) or through another module (checked in
    a fresh interpreter after importing every module of the port)."""
    files = sorted((ROOT / "ofps_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
    bad = [
        (f.name, m) for f in files for m in _imported_modules(f)
        if m.split(".")[0] in ("jax", "jaxlib", "ofps_tpu")
    ]
    assert not bad, bad
    mods = [
        ".".join(f.relative_to(ROOT).with_suffix("").parts).removesuffix(".__init__")
        for f in files[:-1]
    ]
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}: importlib.import_module(m)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'ofps_tpu')]\n"
        "assert not bad, bad\n"
    )
    subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True, timeout=120)
