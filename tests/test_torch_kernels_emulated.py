"""The CUDA kernels of ``ofps_torch/csrc`` on the CPU, in emulation.

The sources compile with ``g++`` against ``tests/cuda_cpu_emu.h`` (each CUDA
thread a fiber on one CPU thread, switched at ``__syncthreads``,
``__syncwarp`` and the warp shuffles), and the kernel wrappers are pointed at that library, so
each wrapper runs its kernel's own indexing, halos, passes, argmin order
and grid reduction on CPU tensors, against its plain version.  The tolerance
is the one ``chip_smoke.py`` holds the card to: under 0.1% of pixels off by
more than 1e-3 px, none by more than one candidate step, grid sums within
1e-5 normalized; the warp and the guard exact, and a refine with the
fused median (``median_in``) exactly the refine of the median-filtered
flow (a median is an exact selection).  Almeida's RANSAC kernels give the
plain version's winner and inlier count exactly and its rotation within
1e-6 rad: the kernels follow PyTorch's operations on the card (a multiply
by the reciprocal where it divides by a host scalar, the card's order of
a 3-point sum), the CPU plain version divides and sums in its own order,
and the refit's sums take another order.  Homography's kernels, given
their own candidates (which copy the card's arithmetic, not the CPU's),
give robust_fit's prescore medians and counts, adapted cut, finalists and
winner exactly, and end to end the plain version's winner, final inliers
and refused LO rounds, each decomposition family within 1e-6 rad; on the
card (``-m cuda``) the candidates are held bit for bit too.  The kernels multiply
the box sum by 1/win^2 (as PyTorch does on the card), where the CPU plain
version divides: near-ties may flip.  What the CUDA compiler makes of the
sources is tested on the card only (``-m cuda``).
"""

import contextlib
import ctypes
import re
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch
from scipy.ndimage import gaussian_filter

from ofps_torch.core.camera import StandardCamera
from ofps_torch.core.motion import SparseFlow
from ofps_torch.estimators import almeida as est_almeida
from ofps_torch.kernels import almeida as kalm
from ofps_torch.kernels import build
from ofps_torch.kernels import flow_refine as kfr
from ofps_torch.kernels import flow_refine_small as kfs
from ofps_torch.kernels import warp as kwarp
from ofps_torch.ops import robust
from ofps_torch.ops.geometry_uv import delta_planes, qmat
from homography_checks import assert_fit_matches, family_gap
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

EMU_HEADER = Path(__file__).resolve().parent / "cuda_cpu_emu.h"
STEP = 1.0 + 1e-3


@pytest.fixture(scope="module")
def emulated_library(tmp_path_factory):
    """The kernel sources built for the CPU emulation, as a ctypes library
    with the entry points of :mod:`ofps_torch.kernels.build`."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to build the emulation")
    out = tmp_path_factory.mktemp("cuda_emu")
    (out / "cuda_bf16.h").write_text("#pragma once\n")
    (out / "cuda_runtime.h").write_text('#pragma once\n#include "cuda_cpu_emu.h"\n')
    shutil.copy(EMU_HEADER, out / "cuda_cpu_emu.h")
    sources = []
    for name in build.SOURCES + build.HEADERS:
        text = (build.CSRC / name).read_text()
        text = text.replace(
            "extern __shared__ float4 smem4[];",
            "float4* smem4 = reinterpret_cast<float4*>(emu_dyn_smem);",
        )
        text = re.sub(r"(\w+(?:<[^<>;]*>)?)\s*<<<(.*?)>>>\s*\(", r"emu_launch(\1, \2, ",
                      text, flags=re.S)
        if name.endswith(".cu"):
            name = name[:-3] + ".cpp"
            text = '#include "cuda_cpu_emu.h"\n' + text
            sources.append(str(out / name))
        (out / name).write_text(text)
    lib_path = out / "libofps_emu.so"
    proc = subprocess.run(
        [gxx, "-std=c++20", "-O1", "-ffp-contract=off", "-shared", "-fPIC", "-pthread",
         "-I", str(out), "-o", str(lib_path), *sources],
        capture_output=True, text=True,
    )
    assert proc.returncode == 0, proc.stderr[-4000:]
    lib = ctypes.CDLL(str(lib_path))
    for name, argtypes in build._SIGNATURES.items():
        getattr(lib, name).argtypes = argtypes
        getattr(lib, name).restype = ctypes.c_int
    return lib


@pytest.fixture
def emulated(emulated_library, monkeypatch):
    """Route the kernel wrappers to the emulation for CPU tensors."""
    monkeypatch.setattr(build, "library", lambda: emulated_library)
    monkeypatch.setattr(build, "on_cuda", lambda name, t: True)
    monkeypatch.setattr(build, "require_cuda_f32", lambda *tensors: None)
    monkeypatch.setattr(build, "stream_ptr", lambda device: 0)
    monkeypatch.setattr(build, "on_device", lambda device: contextlib.nullcontext())


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x, dtype=np.float32))


def _scene(seed, h, w, batch, flat=False):
    """i1 = i2 moved by (2, 1) px plus noise, textured (optionally with a
    flat left half)."""
    rng = np.random.default_rng(seed)
    img = gaussian_filter(rng.standard_normal((batch, h + 20, w + 20)), (0, 2, 2)) * 100
    if flat:
        img[:, :, : (w + 20) // 2] = 7.0
    i2 = img[:, 10 : 10 + h, 10 : 10 + w]
    i1 = np.roll(i2, (1, 2), axis=(1, 2)) + rng.normal(0, 1, i2.shape)
    return _t(i1), _t(i2)


def _flow(seed, batch, h, w, mean_u):
    rng = np.random.default_rng(seed)
    u = gaussian_filter(rng.standard_normal((batch, h, w)), (0, 3, 3)) * 3 + mean_u
    v = gaussian_filter(rng.standard_normal((batch, h, w)), (0, 3, 3)) * 2 - 1
    return _t(u), _t(v)


def _assert_close(got, ref):
    d = torch.maximum((got[0] - ref[0]).abs(), (got[1] - ref[1]).abs())
    assert bool(torch.isfinite(d).all())
    assert (d > 1e-3).float().mean().item() < 1e-3
    assert d.max().item() <= STEP


@pytest.mark.parametrize(
    "h,w,batch,win,coarse",
    [(67, 121, 1, 5, True), (96, 160, 2, 5, True), (40, 72, 1, 3, True),
     (40, 72, 1, 7, True), (67, 121, 1, 5, False), (33, 65, 2, 5, False)],
)
def test_flow_refine_kernel_emulated(emulated, h, w, batch, win, coarse):
    """Axis-separable refine: partial 64x32 tiles, windows 3/5/7, from the
    coarser level's flow (upsampled in the kernel) or at full resolution."""
    a, b = _scene(1, h, w, batch)
    if coarse:
        u, v = _flow(2, batch, (h + 1) // 2, (w + 1) // 2, 2.0)
    else:
        u, v = _flow(3, batch, h, w, 0.5)
    before = kfr.flow_refine.launches
    got = kfr.flow_refine(a, b, u, v, win)
    assert kfr.flow_refine.launches == before + 1
    _assert_close(got, kfr.flow_refine_plain(a, b, u, v, win))


@pytest.mark.parametrize("gh,gw,border", [(84, 150, 4), (9, 16, 6)])
def test_flow_refine_grid_emulated(emulated, gh, gw, border):
    """Grid mode: per-tile cell rectangles summed by warps; cells narrower
    than a pixel pair (84x150 on 135x240) and wider than a tile edge."""
    h, w = 135, 240
    a, b = _scene(6, h, w, 1)
    u, v = _flow(7, 1, 68, 120, 2.0)
    plan = kfr.build_grid_plan(h, w, gh, gw, border_px=border)
    got = kfr.flow_refine(a, b, u, v, 5, grid_plan=plan)
    ref = kfr.flow_refine_plain(a, b, u, v, 5, grid_plan=plan)
    for g, r, n in zip(got, ref, (w, h)):
        assert ((g - r).abs() / (plan.counts * n)).max().item() <= 1e-5


@pytest.mark.parametrize(
    "h,w,batch,search,win,flat",
    [(33, 60, 2, 6, 5, False), (67, 120, 1, 6, 5, True), (9, 33, 1, 6, 5, False),
     (67, 121, 1, 1, 5, False), (40, 72, 1, 2, 5, True), (30, 50, 1, 4, 3, False),
     (30, 50, 1, 3, 7, False), (20, 36, 1, 0, 5, False)],
)
def test_flow_refine_small_kernel_emulated(emulated, h, w, batch, search, win, flat):
    """The 2-D sweep: s=6 on 8x8 tiles with 16 warps, s<=2 on 32x8 tiles,
    a flat half (ties the prior decides), from the coarser flow and from
    zero."""
    a, b = _scene(4, h, w, batch, flat)
    u, v = _flow(5, batch, (h + 1) // 2, (w + 1) // 2, 0.5)
    z = torch.zeros_like(a)
    for uu, vv in ((u, v), (z, z)):
        got = kfs.flow_refine_small(a, b, uu, vv, search, win)
        _assert_close(got, kfs.flow_refine_small_plain(a, b, uu, vv, search, win))


@pytest.mark.parametrize("search", [6, 2])
def test_flow_refine_small_ties_emulated(emulated, search):
    """Exact ties (binary blocks: every |diff| and box sum is exact) that
    the prior and the dy-outer order decide, the best candidate at the edge
    of the search: the kernel's (cost, index) argmin picks what the plain
    first-minimum scan picks, pixel for pixel."""
    h, w = 33, 60
    rng = np.random.default_rng(11)
    blocks = rng.integers(0, 2, (1, h // 2 + 2, w // 2 + search + 2)) * 8.0
    img = np.repeat(np.repeat(blocks, 2, axis=1), 2, axis=2)
    a, b = _t(img[:, :h, :w]), _t(img[:, :h, search : search + w])
    z = torch.zeros_like(a)
    got = kfs.flow_refine_small(a, b, z, z, search, 5)
    ref = kfs.flow_refine_small_plain(a, b, z, z, search, 5)
    assert (ref[0] == -search).float().mean().item() > 0.3
    for g, r in zip(got, ref):
        assert torch.equal(g.round(), r.round())
        assert (g - r).abs().max().item() <= 1e-6


def test_flat_kernels_emulated(emulated):
    """Warp and guard exact against their plain versions; the fused median
    gives the refine kernels exactly what filtering their input first
    gives them."""
    a, b = _scene(8, 33, 70, 2)
    u, v = _flow(9, 2, 33, 70, 1.0)
    assert torch.equal(kwarp.warp_bilinear(b, u, v), kwarp.warp_bilinear_plain(b, u, v))
    z = torch.zeros_like(a)
    uc, vc = _flow(10, 2, 17, 35, 1.0)
    filtered = kfs.median3x3_uv_plain(uc, vc)
    for got, ref in (
        (kfs.guard_select(a, b, u, v, z, z, 5), kfs.guard_select_plain(a, b, u, v, z, z, 5)),
        (kfr.flow_refine(a, b, uc, vc, 5, median_in=True), kfr.flow_refine(a, b, *filtered, 5)),
        (kfs.flow_refine_small(a, b, uc, vc, 1, 5, median_in=True),
         kfs.flow_refine_small(a, b, *filtered, 1, 5)),
    ):
        assert all(torch.equal(g, r) for g, r in zip(got, ref))


@pytest.mark.parametrize(
    "h,w,batch,win", [(67, 121, 1, 3), (67, 121, 1, 5), (33, 65, 2, 3), (33, 65, 2, 5)]
)
def test_flow_refine_median_in_emulated(emulated, h, w, batch, win):
    """Axis-separable refine with the 3x3 median in its staging, on partial
    64x32 tiles: within the tolerance of the plain median-then-refine, and
    bit-exact with the kernel on the filtered flow; counted as a fused
    launch."""
    a, b = _scene(12, h, w, batch)
    uc, vc = _flow(13, batch, (h + 1) // 2, (w + 1) // 2, 2.0)
    before = (kfr.flow_refine.launches, kfr.flow_refine.median_in_launches)
    got = kfr.flow_refine(a, b, uc, vc, win, median_in=True)
    assert (kfr.flow_refine.launches, kfr.flow_refine.median_in_launches) == (
        before[0] + 1, before[1] + 1)
    _assert_close(got, kfr.flow_refine_plain(a, b, uc, vc, win, median_in=True))
    filtered = kfs.median3x3_uv_plain(uc, vc)
    assert all(torch.equal(g, r) for g, r in zip(got, kfr.flow_refine(a, b, *filtered, win)))


@pytest.mark.parametrize(
    "h,w,batch,search,win",
    [(67, 120, 2, 1, 5), (9, 33, 1, 1, 3), (20, 36, 1, 2, 7), (30, 50, 1, 3, 5)],
)
def test_flow_refine_small_median_in_emulated(emulated, h, w, batch, search, win):
    """The 2-D sweep with the fused median: 32x8 tiles (s <= 2; 9x33 is one
    tile row whose region touches all four coarse edges) and 8x8 tiles (s =
    3), against the plain median-then-sweep and exactly the kernel on the
    filtered flow."""
    a, b = _scene(14, h, w, batch)
    uc, vc = _flow(15, batch, (h + 1) // 2, (w + 1) // 2, 0.5)
    before = kfs.flow_refine_small.median_in_launches
    got = kfs.flow_refine_small(a, b, uc, vc, search, win, median_in=True)
    assert kfs.flow_refine_small.median_in_launches == before + 1
    _assert_close(got, kfs.flow_refine_small_plain(a, b, uc, vc, search, win, median_in=True))
    filtered = kfs.median3x3_uv_plain(uc, vc)
    ref = kfs.flow_refine_small(a, b, *filtered, search, win)
    assert all(torch.equal(g, r) for g, r in zip(got, ref))


@pytest.mark.parametrize("win", [3, 5, 7])
def test_guard_select_tiles_emulated(emulated, win):
    """The guard's 16x8 tiles with a win/2 halo, on a partial tile edge
    (33x70), exact against the plain version: the right half moved by (2,
    1) px, so the warm flow (near that shift) wins there and the zero flow
    on the left; a zero block where both SADs are exactly 0 and the warm
    side must be kept."""
    h, w, batch = 33, 70, 2
    rng = np.random.default_rng(16)
    tex = gaussian_filter(rng.standard_normal((batch, h + 20, w + 20)), (0, 2, 2)) * 100
    tex[:, 14:30, 30:60] = 0.0
    b_np = tex[:, 10 : 10 + h, 10 : 10 + w]
    a_np = b_np.copy()
    a_np[:, :, w // 2 :] = tex[:, 9 : 9 + h, 8 + w // 2 : 8 + w]
    a, b = _t(a_np), _t(b_np)
    u_w, v_w = _flow(17, batch, h, w, -2.0)
    u_w, v_w = -2.0 + 0.1 * (u_w + 2.0), -1.0 + 0.1 * (v_w + 1.0)
    z = torch.zeros_like(a)
    got = kfs.guard_select(a, b, u_w, v_w, z, z, win)
    ref = kfs.guard_select_plain(a, b, u_w, v_w, z, z, win)
    assert all(torch.equal(g, r) for g, r in zip(got, ref))
    zero_side = got[0] == 0.0
    assert 0.2 < zero_side.float().mean().item() < 0.8
    # Inside the zero block, away from its edge by the window and the shift,
    # both SADs are 0: the tie keeps the warm flow.
    assert torch.equal(got[0][:, 9:15, 26:36], u_w[:, 9:15, 26:36])


def test_kernel_rejects_unbuilt_window(emulated):
    """A window the kernels are not compiled for raises, not falls back."""
    a, b = _scene(1, 20, 36, 1)
    with pytest.raises(ValueError):
        kfr.flow_refine(a, b, a, b, 9)
    with pytest.raises(ValueError):
        kfs.flow_refine_small(a, b, a, b, 1, 4)


# -- almeida's RANSAC --------------------------------------------------------

ALMEIDA_CAM = StandardCamera.create(16 / 9, 90.0)


def _almeida_flow(seed, batch, n, valid=1.0, noise=1e-4, outliers=0.08):
    """(B, n) points under a small rotation per stream, with noise and a
    share of outliers; ``valid`` < 1 masks a random share of the points."""
    rng = np.random.default_rng(seed)
    pos = rng.uniform(0.02, 0.98, (batch, n, 2)).astype(np.float32)
    q = rng.normal(0, 1, (batch, 4)) * np.array([0, 1, 1, 1]) * 0.003
    q[:, 0] = 1.0
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    r = tuple(c[:, None] for c in qmat(tuple(_t(q[:, i]) for i in range(4))))
    du, dv = delta_planes(ALMEIDA_CAM, _t(pos[..., 0]), _t(pos[..., 1]), r)
    mot = np.stack([du.numpy(), dv.numpy()], -1) + rng.normal(0, noise, (batch, n, 2))
    bad = rng.uniform(size=(batch, n)) < outliers
    mot[bad] = rng.uniform(-0.02, 0.02, (int(bad.sum()), 2))
    mask = (rng.uniform(size=(batch, n)) < valid).astype(np.float32)
    return SparseFlow(_t(pos), _t(mot), _t(mask))


def _almeida_inputs(flow, seed, dense, h=200, s=1000):
    """The hypotheses' indices and the eval subset, as solve_ypr_ransac
    makes them."""
    gen = torch.Generator().manual_seed(seed)
    b, n = flow.mask.shape
    draws = robust.draw(gen, (b,), n, h, 3, "cpu", dense=dense)
    fit_idx = robust.as_indices(draws, flow.mask)
    if dense:
        eidx, w_e = (x.expand((b,) + x.shape) for x in robust.dense_eval_subset(n, s, "cpu"))
    else:
        eidx, w_e = robust.eval_subset(flow.mask, s)
    return fit_idx, eidx, w_e


def _rot_gap(a, b):
    """Angle (rad) between unit quaternions (..., 4), in float64."""
    a, b = a.to(torch.float64), b.to(torch.float64)
    w = (a * b).sum(-1)
    x = a[..., 0:1] * b[..., 1:] - b[..., 0:1] * a[..., 1:] - torch.linalg.cross(a[..., 1:], b[..., 1:])
    return 2 * torch.atan2(torch.linalg.vector_norm(x, dim=-1), w.abs())


def _check_ransac(flow, fit_idx, eidx, w_e, bound):
    before = kalm.ransac.launches
    got = kalm.ransac(ALMEIDA_CAM, flow, fit_idx, eidx, w_e, bound)
    assert kalm.ransac.launches == before + 3
    ref = kalm.ransac_plain(ALMEIDA_CAM, flow, fit_idx, eidx, w_e, bound)
    assert torch.equal(got[1].long(), ref[1]) and torch.equal(got[2].long(), ref[2])
    assert _rot_gap(got[0], ref[0]).max().item() <= 1e-6
    return got, ref


@pytest.mark.parametrize("dense,s", [(True, 1000), (False, 1000), (True, 1500)],
                         ids=["dense", "masked", "dense-two-chunks"])
def test_almeida_ransac_emulated(emulated, dense, s):
    """B=2, N=2000, H=200, S=1000: dense draws over all-valid points, and
    masked draws (uniforms mapped to the valid points) with a fifth of the
    points invalid; S=1500 is staged in two chunks.  The winner and its
    count exact, the rotation within 1e-6 rad, against the plain version."""
    flow = _almeida_flow(20, 2, 2000, valid=1.0 if dense else 0.8)
    fit_idx, eidx, w_e = _almeida_inputs(flow, 21, dense, s=s)
    bound = est_almeida._inlier_bound(0.05, flow.pos)
    got, ref = _check_ransac(flow, fit_idx, eidx, w_e, bound)
    assert (ref[2] > s // 2).all()  # a real winner, not the identity
    rot = est_almeida.solve_ypr_ransac(None, ALMEIDA_CAM, flow, 200, 0.05, s, dense=dense,
                                       fit_idx=robust.draw(torch.Generator().manual_seed(21),
                                                           (2,), 2000, 200, 3, "cpu", dense))
    assert _rot_gap(rot, ref[0]).max().item() <= 1e-6


def test_almeida_ransac_few_inliers_emulated(emulated):
    """A stream with two valid points has fewer than 3 inliers: identity,
    beside a stream with a winner."""
    flow = _almeida_flow(22, 2, 2000, valid=0.9)
    mask = flow.mask.clone()
    mask[1] = 0.0
    mask[1, 17] = mask[1, 1500] = 1.0
    flow = flow._replace(mask=mask)
    fit_idx, eidx, w_e = _almeida_inputs(flow, 23, dense=False)
    got, ref = _check_ransac(flow, fit_idx, eidx, w_e, est_almeida._inlier_bound(0.05, flow.pos))
    assert int(ref[2][1]) <= 2 and int(ref[2][0]) > 500
    assert torch.equal(got[0][1], torch.tensor([1.0, 0.0, 0.0, 0.0]))


def test_almeida_ransac_first_maximum_emulated(emulated):
    """The winner's draws planted again at rows 37 and 190 (other blocks of
    the fit kernel): equal counts, and the first maximum wins."""
    flow = _almeida_flow(24, 2, 2000)
    fit_idx, eidx, w_e = _almeida_inputs(flow, 25, dense=True)
    bound = est_almeida._inlier_bound(0.05, flow.pos)
    won = kalm.ransac_plain(ALMEIDA_CAM, flow, fit_idx, eidx, w_e, bound)[1]
    planted = fit_idx.clone()
    for b in range(2):
        planted[b, 37] = planted[b, 190] = fit_idx[b, won[b]]
    got, ref = _check_ransac(flow, planted, eidx, w_e, bound)
    assert torch.equal(ref[1], torch.minimum(won, torch.tensor(37)))


def test_almeida_ransac_bound_tensor_emulated(emulated):
    """``inlier_angle_deg`` as a 0-d tensor (a prop of the consumers'
    graph): read on the device, one bound for every stream; per stream
    bounds take their own."""
    flow = _almeida_flow(26, 2, 2000)
    fit_idx, eidx, w_e = _almeida_inputs(flow, 27, dense=True)
    for deg in (torch.tensor(0.05), torch.tensor([0.05, 0.003])):
        bound = est_almeida._inlier_bound(deg, flow.pos)
        got, ref = _check_ransac(flow, fit_idx, eidx, w_e, bound)
    assert int(ref[2][1]) < int(_check_ransac(
        flow, fit_idx, eidx, w_e, est_almeida._inlier_bound(0.05, flow.pos))[1][2][1])


@pytest.mark.parametrize("plain", [False, True], ids=["kernels", "plain"])
def test_almeida_plain_pipeline_takes_the_plain_version_emulated(emulated, plain):
    """The consumers of a ``StreamPipeline(plain=True)`` run almeida's plain
    version (no launch), those of a kernel pipeline the kernels (three
    launches); their rotations agree within 1e-6 rad."""
    from ofps_torch.core.motion import field_to_sparse
    from ofps_torch.estimators.base import create_estimator
    from ofps_torch.parallel.stream import StreamPipeline

    pipe = StreamPipeline(ALMEIDA_CAM, [create_estimator("almeida")], device="cpu",
                          plain=plain)
    state = pipe.init_state(2, 60, 80)
    flow = _almeida_flow(28, 2, 30 * 40)
    grid = flow.motion.reshape(2, 30, 40, 2)
    sparse = field_to_sparse(grid)
    draws = (pipe.estimators[0].draw(torch.Generator().manual_seed(29), (2,), 1200, "cpu"),)
    before = kalm.ransac.launches
    rot = pipe._consume(grid, state.rot, state.pos, draws, state.est)[2][0]
    assert kalm.ransac.launches == before + (0 if plain else 3)
    eidx, w_e = (x.expand((2,) + x.shape) for x in robust.dense_eval_subset(1200, 1000, "cpu"))
    ref = kalm.ransac_plain(ALMEIDA_CAM, sparse, draws[0], eidx, w_e,
                            est_almeida._inlier_bound(0.05, sparse.pos))
    assert _rot_gap(rot, ref[0]).max().item() <= 1e-6
    assert (ref[2] >= 3).all()


# -- multiview's RANSAC ------------------------------------------------------


def _multiview_inputs(seed, batch=2, gh=24, gw=40, hyps=16):
    """Normalized coordinates of a translating, rotating camera over depths
    2-6 (20% outliers, a third of the points masked), the estimator's
    threshold tensor and masked draws of ``hyps`` hypotheses."""
    from ofps_torch.estimators import multiview as mv
    from ofps_torch.estimators.base import camera_intrinsics

    cam = StandardCamera.create(gw / gh, 60.0)
    k, kinv = camera_intrinsics(cam, "cpu")
    rng = np.random.default_rng(seed)
    ys, xs = np.meshgrid((np.arange(gh) + 0.5) / gh, (np.arange(gw) + 0.5) / gw, indexing="ij")
    pos = np.stack([xs.ravel(), ys.ravel()], -1)
    kk = k.numpy().astype(np.float64)
    flows = []
    for _ in range(batch):
        x = (np.c_[pos, np.ones(len(pos))] @ np.linalg.inv(kk).T) * rng.uniform(2, 6, (len(pos), 1))
        a = rng.uniform(-0.01, 0.01, 3)
        kx = np.array([[0, -a[2], a[1]], [a[2], 0, -a[0]], [-a[1], a[0], 0]])
        p2 = (x @ (np.eye(3) + kx).T + rng.normal(0, 0.05, 3)) @ kk.T
        mot = p2[:, :2] / p2[:, 2:] - pos + rng.normal(0, 2e-6, pos.shape)
        bad = rng.uniform(size=len(pos)) < 0.2
        mot[bad] = rng.normal(0, 0.01, (bad.sum(), 2))
        flows.append((pos, mot, (rng.uniform(size=len(pos)) >= 1 / 3).astype(np.float32)))
    pos, mot, mask = (_t(np.stack([f[i] for f in flows])) for i in range(3))
    params = mv.MultiviewParams()
    thr = params.max_error / ((k[0, 0] + k[1, 1]) * 0.5)
    idx = robust.draw(torch.Generator().manual_seed(seed), (batch,), len(pos[0]), hyps, 5, "cpu",
                      dense=False)
    return (pos, mot, kinv), mask, thr, params, idx


def test_multiview_ransac_emulated(emulated):
    """Multiview's kernels, B=2, 960 points, 16 hypotheses: the normalized
    coordinates are the estimator's exactly (a stride-0 batch too); given
    the fit kernel's own
    candidates, the prescore medians, the adapted cut, the counts, the
    finalists, the winner and its inliers are ``robust_fit``'s, exactly;
    each valid candidate is an essential matrix (unit norm, det E and 2 E
    Et E - tr(E Et) E ~ 0); a LO round's scoring is exact; the eight-point
    fit within 1e-5 of the plain fit on the same inliers.  The five-point
    and eight-point algebra copies the card's order of PyTorch's sums and
    cuBLAS's products, not the CPU's: it is held to the plain version bit
    for bit on the card (``-m cuda``)."""
    from ofps_torch.estimators import multiview as mv
    from ofps_torch.kernels import multiview as kmv
    from ofps_torch.ops.epipolar import sampson_error

    (pos, mot, kinv), w, thr, params, idx = _multiview_inputs(30)
    before = kmv.ransac.launches
    x1, x2 = kmv.normalized_coords(kinv, pos, mot)
    assert torch.equal(x1, mv.normalized_coords(kinv, pos))
    assert torch.equal(x2, mv.normalized_coords(kinv, pos + mot))
    # A batch broadcast with stride 0 (a dense lattice's positions) is read
    # as its copy, not past its one row.
    b1, b2 = kmv.normalized_coords(kinv, pos[:1].expand(2, -1, -1), mot[:1].expand(2, -1, -1))
    assert torch.equal(b1, x1[:1].expand(2, -1, -1)) and torch.equal(b2, x2[:1].expand(2, -1, -1))
    out = kmv._launch(x1, x2, w, thr, params, 16, idx, False, None)
    m, valid = out["models"], out["valid"].bool()
    assert int(valid.sum()) > 100
    mv_ = m[valid].double()
    eet = mv_ @ mv_.transpose(-1, -2)
    cubic = 2 * eet @ mv_ - eet.diagonal(dim1=-2, dim2=-1).sum(-1)[:, None, None] * mv_
    assert cubic.abs().max().item() < 1e-5 and torch.linalg.det(mv_).abs().max().item() < 1e-5
    assert (mv_.norm(dim=(-2, -1)) - 1).abs().max().item() < 1e-5

    x1e, x2e, we = x1, x2, w  # 960 points: under the eval cap, all are scored
    pidx = torch.arange(params.prescore_cap) * (w.shape[-1] // params.prescore_cap)
    errs = sampson_error(m, x1e[:, None, pidx], x2e[:, None, pidx])
    med = robust.masked_median(errs, we[:, None, pidx])
    assert bool(((med == out["med"]) | (med.isnan() & out["med"].isnan())).all())
    t = thr.to(torch.float32)
    nvalid = torch.clamp(torch.sum(we, dim=-1), min=6.0)
    sigma_k = 2.5 * 1.4826 * (1.0 + 5.0 / (nvalid - 5))
    med_best = torch.min(torch.where(valid, med, 1e30), dim=-1).values
    thr2 = torch.maximum(t * t, torch.square(sigma_k) * torch.clamp(med_best, min=0.0))
    assert torch.equal(thr2, out["thr2"])
    pre = torch.where(valid, ((errs <= thr2[:, None, None]) & (we[:, None, pidx] > 0.5)).sum(-1), -1)
    assert torch.equal(pre.int(), out["pre"])
    cand = torch.sort(pre.float(), dim=-1, descending=True, stable=True).indices[:, :32]
    assert torch.equal(cand, out["cand"])
    fin = robust._take(m, cand)
    ok = (sampson_error(fin, x1e[:, None], x2e[:, None]) <= thr2[:, None, None]) & (we[:, None] > 0.5)
    best = torch.argmax(torch.where(robust._take(valid, cand), ok.sum(-1), -1), dim=-1)
    assert torch.equal(robust._take(cand, best[:, None])[:, 0], out["best"])
    model = robust._take(fin, best[:, None])[:, 0]
    assert torch.equal(model, out["model"])
    err = sampson_error(model, x1, x2)
    inl = ((err <= thr2[:, None]) & (w > 0.5)).float()
    assert torch.equal(inl, out["inliers"]) and torch.equal(err * inl, out["err"])

    e = kmv.eight_point_essential(x1, x2, inl)
    ref = kmv._eight_point_essential(x1, x2, inl)
    assert torch.minimum((e - ref).abs().amax((-2, -1)), (e + ref).abs().amax((-2, -1))).max() < 1e-5
    lo = [torch.empty_like(w) for _ in range(3)]
    kmv._points(kmv.LO_SCORE, 2, w.shape[-1], w.device, a=x1, b=x2, w=w, m=e, m2=thr2, s1=inl,
                o1=lo[0], o2=lo[1], o3=lo[2])
    err2 = sampson_error(e, x1, x2)
    inl2 = ((err2 <= thr2[:, None]) & (w > 0.5)).float()
    assert torch.equal(lo[0], err2 * inl) and torch.equal(lo[1], inl2)
    assert torch.equal(lo[2], err2 * inl2)
    assert kmv.ransac.launches == before + 2 + 4 + 3 + 1


# -- homography's RANSAC -----------------------------------------------------

HOMOGRAPHY_CAM = StandardCamera.create(16 / 9, 90.0)


def _homography_flow(seed, batch, n, valid=1.0, noise=1e-4, outliers=0.1, lattice=None,
                     plane=False):
    """(B, n) correspondences of a camera rotating by ~0.3 deg a stream (H =
    K R K^-1), with noise, a share of outliers and, for ``valid`` < 1, a
    share of the points masked; ``lattice`` (gh, gw) puts the points on the
    dense path's grid (positions shared by the streams, as a stride-0
    batch).  ``plane``: the camera also translates by 0.03 over a plane
    (H = K (R + t n^T) K^-1), far from the decomposition's pure-rotation
    branch, so its two families differ."""
    from ofps_torch.core import quat

    rng = np.random.default_rng(seed)
    if lattice is None:
        pos = rng.uniform(0.02, 0.98, (batch, n, 2)).astype(np.float32)
    else:
        gh, gw = lattice
        ys, xs = np.meshgrid(np.arange(gh) / gh, np.arange(gw) / gw, indexing="ij")
        pos = np.broadcast_to(np.stack([xs.ravel(), ys.ravel()], -1).astype(np.float32),
                              (batch, gh * gw, 2))
        n = gh * gw
    k = HOMOGRAPHY_CAM.intrinsics().double().numpy()
    mot = np.empty((batch, n, 2), np.float32)
    for s in range(batch):
        q = np.r_[1.0, rng.normal(0, 0.003, 3)]
        r = quat.to_matrix3(torch.tensor(q / np.linalg.norm(q))).numpy()
        if plane:  # t mostly across n, so s1^2 - 1 and 1 - s3^2 are both ~|t|
            normal = np.r_[rng.normal(0, 0.3, 2), 1.0]
            normal /= np.linalg.norm(normal)
            t = rng.normal(0, 1, 3)
            t -= 0.8 * (t @ normal) * normal
            r = r + np.outer(0.03 * t / np.linalg.norm(t), normal)
        x2 = np.c_[pos[s], np.ones(n)] @ (k @ r @ np.linalg.inv(k)).T
        mot[s] = x2[:, :2] / x2[:, 2:] - pos[s] + rng.normal(0, noise, (n, 2))
        bad = rng.uniform(size=n) < outliers
        mot[s][bad] = rng.uniform(-0.02, 0.02, (int(bad.sum()), 2))
    mask = (rng.uniform(size=(batch, n)) < valid).astype(np.float32)
    pos_t = torch.from_numpy(pos[:1].copy()).expand(batch, -1, -1) if lattice else _t(pos)
    return SparseFlow(pos_t, _t(mot), _t(mask))


def _homography_draws(flow, seed, dense, hyps=None):
    from ofps_torch.estimators import homography as he

    est = he.make_homography()
    gen = torch.Generator().manual_seed(seed)
    b, n = flow.mask.shape
    return est.draw(gen, (b,), n, "cpu", dense=dense) if hyps is None else robust.draw(
        gen, (b,), n, hyps, 4, "cpu", dense)


def _homography_selection(models, valid, flow, params, thr, dense):
    """robust_fit's prescore and scoring on the candidates ``models`` (B, H,
    3, 3) with ``valid``: the adapted cut, the finalists and the winner."""
    from ofps_torch.ops.homography import homography_transfer_error as err_fn

    b, n = flow.mask.shape
    dev = flow.mask.device
    x1, x2, w = flow.pos, flow.pos + flow.motion, flow.mask
    if dense:
        eidx, we = (x.expand((b,) + x.shape) for x in robust.dense_eval_subset(
            n, params.eval_cap, str(dev)))
    else:
        eidx, we = robust.eval_subset(w, params.eval_cap)
    x1e, x2e = robust._take_points(x1, eidx), robust._take_points(x2, eidx)
    stride = eidx.shape[-1] // params.prescore_cap
    pidx = torch.arange(params.prescore_cap, device=dev) * stride
    errs = err_fn(models, x1e[:, None, pidx], x2e[:, None, pidx])
    wp = we[:, pidx]
    med = robust.masked_median(errs, wp[:, None])
    t = torch.as_tensor(thr, dtype=torch.float32, device=dev)
    sigma_k = 2.5 * 1.4826 * (1.0 + 5.0 / (torch.clamp(torch.sum(we, dim=-1), min=5.0) - 4))
    thr2 = torch.maximum(t * t, torch.square(sigma_k) * torch.clamp(
        torch.min(torch.where(valid, med, 1e30), dim=-1).values, min=0.0))
    pre = torch.where(valid, ((errs <= thr2[:, None, None]) & (wp[:, None] > 0.5)).sum(-1), -1)
    cand = torch.sort(pre.float(), dim=-1, descending=True, stable=True).indices[:, :32]
    fin = robust._take(models, cand)
    ok = (err_fn(fin, x1e[:, None], x2e[:, None]) <= thr2[:, None, None]) & (we[:, None] > 0.5)
    score = torch.where(robust._take(valid, cand), ok.sum(-1), -1)
    best = robust._take(cand, torch.argmax(score, dim=-1)[:, None])[:, 0]
    return thr2, cand, best, med, pre


def _check_homography(flow, idx, dense, thr=0.001, raised=None, plane=False):
    """The kernels against the plain version on ``flow`` with draws ``idx``:
    given the kernels' own candidates, the prescore medians and counts, the
    adapted cut, the finalists and the winner are robust_fit's exactly (the
    candidates copy the card's order of PyTorch's sums and products, not the
    CPU's: they are held to the plain ones within float32 rounding); end to
    end, the same winner and final inlier count, and the families, their
    translation norms and the pick as ``homography_checks`` holds them
    (within 1e-6 rad; ``plane``: within ``family_tolerance``).
    ``raised``: whether the adaptive cut must exceed thr^2 in every
    stream."""
    from ofps_torch.estimators import homography as he
    from ofps_torch.kernels import homography as kh
    from ofps_torch.ops.homography import dlt_homography

    params = he.HomographyParams()
    hyps = idx.shape[-2]
    before = kh.ransac.launches
    out = kh._launch(flow, HOMOGRAPHY_CAM, params, hyps, thr, dense, idx, None)
    assert kh.ransac.launches == before + kh.LAUNCHES
    models, valid = out["models"], out["valid"].bool()
    ii = robust.as_indices(idx, flow.mask)
    plain = dlt_homography(*(robust._take_points(x, ii) for x in (
        flow.pos, flow.pos + flow.motion)), robust._take_points(flow.mask[..., None], ii)[..., 0])
    finite = torch.isfinite(plain).flatten(-2).all(-1)
    assert torch.equal(valid, finite)  # the same samples fail
    # A minimal sample's null vector moves with the last bits of its sums
    # (far, for a sample near a degenerate one): most stay close.
    rel = ((models - plain).abs().amax((-2, -1)) / plain.abs().amax((-2, -1)))[finite]
    assert rel.median().item() < 1e-4
    thr2, cand, best, med, pre = _homography_selection(models, valid, flow, params, thr, dense)
    assert bool(((med == out["med"]) | (med.isnan() & out["med"].isnan())).all())
    assert torch.equal(pre.int(), out["pre"])
    assert torch.equal(thr2, out["thr2"]) and torch.equal(cand, out["cand"])
    assert torch.equal(best, out["best"])
    if raised is not None:
        assert bool((thr2 > np.float32(thr) ** 2).all()) == raised
    got = kh.fit_of(out, flow.mask.shape[:-1])  # what ransac returns from this launch
    ref = he.ransac_plain(flow, HOMOGRAPHY_CAM, params, hyps, thr, dense, idx)
    assert torch.equal(got.fit.best, ref.fit.best)
    assert torch.equal(got.fit.score, ref.fit.score)
    assert torch.equal(got.fit.inliers, ref.fit.inliers)
    # The same LO rounds refused: the LO model is then still the winner.
    b = torch.arange(flow.mask.shape[0])
    refused = (got.fit.model == models[b, got.fit.best]).flatten(1).all(-1)
    assert torch.equal(refused, (ref.fit.model == plain[b, ref.fit.best]).flatten(1).all(-1))
    # A stream with fewer than 4 valid points fits repeats of them (the
    # estimator gives identity there): its rotation is not held.
    held = flow.mask.sum(-1) >= 4
    assert_fit_matches(got, ref, held, HOMOGRAPHY_CAM if plane else None)
    return got, ref, refused


@pytest.mark.parametrize("batch", [2, 8])
@pytest.mark.parametrize("dense", [True, False], ids=["dense", "masked"])
def test_homography_ransac_emulated(emulated, dense, batch):
    """Homography's kernels, 91 hypotheses: the dense path on a 42x60
    lattice (its static eval subset of 2,048) and the masked path, 3,000
    points with a third masked; B=2 and B=8.  Every stream finds its
    rotation (the cut stays the threshold)."""
    flow = _homography_flow(40 + batch, batch, 3000, valid=1.0 if dense else 2 / 3,
                            lattice=(42, 60) if dense else None)
    idx = _homography_draws(flow, 41, dense)
    got, ref, _ = _check_homography(flow, idx, dense, raised=False)
    assert (ref.fit.score > 0.8 * flow.mask.sum(-1)).all()


@pytest.mark.parametrize("dense", [True, False], ids=["dense", "masked"])
def test_homography_ransac_plane_emulated(emulated, dense):
    """A camera translating over a plane as it rotates, B=4: the
    decomposition's two families are distinct rotations with nonzero
    translations, and each is held to the plain version's as above."""
    flow = _homography_flow(90, 4, 3000, valid=1.0 if dense else 2 / 3,
                            lattice=(42, 60) if dense else None, plane=True)
    got, ref, _ = _check_homography(flow, _homography_draws(flow, 91, dense), dense,
                                    raised=False, plane=True)
    assert (_rot_gap(ref.quats[:, 0], ref.quats[:, 1]) > 1e-3).all()
    assert (ref.tnorm > 1e-5).all()


def test_homography_ransac_degenerate_emulated(emulated):
    """A stream with three valid points (its fit takes what the plain
    version takes, and the estimator gives identity) and a collinear 4-point
    sample planted in the other stream (a non-finite candidate, invalid in
    both versions)."""
    from ofps_torch.estimators import homography as he
    from ofps_torch.kernels import homography as kh

    flow = _homography_flow(50, 2, 2500, valid=0.9)
    pos, mot, mask = (x.clone() for x in flow)
    mask[1] = 0.0
    mask[1, [7, 900, 2000]] = 1.0
    line = torch.tensor([0.1, 0.2, 0.3, 0.4])
    pos[0, :4] = torch.stack([line, line], -1)
    mot[0, :4] = 0.01
    mask[0, :4] = 1.0
    flow = SparseFlow(pos, mot, mask)
    idx = robust.as_indices(_homography_draws(flow, 51, dense=False), mask)
    idx[0, 5] = torch.arange(4)
    got, ref, _ = _check_homography(flow, idx, dense=False)
    out = kh._launch(flow, HOMOGRAPHY_CAM, he.HomographyParams(), 91, 0.001, False, idx, None)
    assert not bool(torch.isfinite(out["models"][0, 5]).all())
    est = he.make_homography()
    rot, _, _ = est.estimate((), flow, HOMOGRAPHY_CAM, dense=False, fit_idx=idx)
    assert torch.equal(rot[1], torch.tensor([1.0, 0.0, 0.0, 0.0]))


def test_homography_ransac_noisy_cut_emulated(emulated):
    """Noise of 2e-3 screen units raises the adaptive cut above the
    threshold's square in every stream, and the plain version refuses an
    LO round (the refit's inlier set shrinks or its error does not drop),
    as the kernels do; masked draws."""
    flow = _homography_flow(60, 2, 3000, valid=0.8, noise=2e-3)
    _, _, refused = _check_homography(flow, _homography_draws(flow, 61, dense=False), dense=False,
                                      raised=True)
    assert bool(refused.any())


@pytest.mark.parametrize("case", ["kernels", "lmeds", "no_prescore", "few_hypotheses", "plain"])
def test_homography_routing_emulated(emulated, case):
    """Where the kernels stand in for a card: the defaults launch them;
    LMedS, ``prescore_cap=0``, fewer hypotheses than finalists (no
    prescore) and ``plain=True`` (the estimator's, as a ``StreamPipeline(
    plain=True)`` passes it) run the plain version, with no launch."""
    from ofps_torch.estimators import homography as he
    from ofps_torch.kernels import homography as kh

    params = he.HomographyParams(**{"lmeds": {"use_ransac": False},
                                    "no_prescore": {"prescore_cap": 0}}.get(case, {}))
    est = he.make_homography(**params._asdict())
    assert kh.uses_kernels(params) == (case not in ("lmeds", "no_prescore"))
    flow = _homography_flow(70, 2, 2500)
    idx = _homography_draws(flow, 71, dense=False, hyps=24 if case == "few_hypotheses" else None)
    before = kh.ransac.launches
    rot, _, _ = est.estimate((), flow, HOMOGRAPHY_CAM, dense=False, fit_idx=idx,
                             plain=case == "plain")
    assert kh.ransac.launches == before + (kh.LAUNCHES if case == "kernels" else 0)
    ref = he.ransac_plain(flow, HOMOGRAPHY_CAM, params, idx.shape[-2], 0.001, False, idx)
    if case == "kernels":
        assert family_gap(rot[:, None].expand(-1, 2, -1), ref.quats).max().item() <= 1e-6
    else:
        assert torch.equal(rot, ref.rot)


def test_homography_kernel_parameters():
    """The parameters the kernels cover: RANSAC with the adaptive cut, a
    prescore of 1 to 128 points, 1 to 32 finalists, an eval subset of 1 to
    8,192 points; a CPU flow takes the plain version."""
    from ofps_torch.estimators import homography as he
    from ofps_torch.kernels import homography as kh

    p = he.HomographyParams
    assert kh.uses_kernels(p())
    for bad in ({"use_ransac": False}, {"adaptive_threshold": False}, {"prescore_cap": 0},
                {"prescore_cap": 129}, {"finalists": 0}, {"finalists": 33}, {"eval_cap": 0},
                {"eval_cap": 8193}):
        assert not kh.uses_kernels(p(**bad)), bad
    assert kh.uses_kernels(p(prescore_cap=128, finalists=32))
    assert not kh.on_kernels(p(), torch.zeros(1, 3000, 2), 91)


@pytest.mark.cuda
@pytest.mark.parametrize("batch", [8, 32])
def test_homography_kernels_on_the_card(batch):
    """Homography's kernels on the card at the cells' shapes, dense (the
    84x150 lattice) and masked (16,384 rows, a third masked), on a rotating
    camera and on one that also translates over a plane: the candidates
    are the plain version's bit for bit (NaNs where it has them), so the
    prescore medians and counts, the adapted cut, the finalists and the
    winner are robust_fit's exactly; end to end the same winner, final
    inliers and count, and the families, norms and pick as
    ``homography_checks`` holds them; one call adds LAUNCHES launches."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from ofps_torch.estimators import homography as he
    from ofps_torch.kernels import homography as kh
    from ofps_torch.ops.homography import dlt_homography

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    params = he.HomographyParams()
    thr = torch.tensor(params.max_error, device=dev)
    for dense, plane in ((True, False), (False, False), (True, True), (False, True)):
        flow = _homography_flow(80 + batch + 10 * plane, batch, 16384,
                                valid=1.0 if dense else 2 / 3,
                                lattice=(84, 150) if dense else None, plane=plane)
        flow = SparseFlow(*(x.to(dev) for x in flow))
        gen = torch.Generator(device=dev).manual_seed(81 + batch)
        idx = he.make_homography().draw(gen, (batch,), flow.mask.shape[-1], dev, dense=dense)
        hyps = idx.shape[-2]
        assert kh.on_kernels(params, flow.pos, hyps)
        out = kh._launch(flow, HOMOGRAPHY_CAM, params, hyps, thr, dense, idx, None)
        ii = robust.as_indices(idx, flow.mask)
        plain = dlt_homography(
            *(robust._take_points(x, ii) for x in (flow.pos, flow.pos + flow.motion)),
            robust._take_points(flow.mask[..., None], ii)[..., 0])
        assert bool(((out["models"] == plain) | (out["models"].isnan() & plain.isnan())).all())
        valid = torch.isfinite(plain).flatten(-2).all(-1)
        assert torch.equal(out["valid"].bool(), valid)
        thr2, cand, best, med, pre = _homography_selection(plain, valid, flow, params, thr, dense)
        assert bool(((med == out["med"]) | (med.isnan() & out["med"].isnan())).all())
        assert torch.equal(pre.int(), out["pre"]) and torch.equal(thr2, out["thr2"])
        assert torch.equal(cand, out["cand"]) and torch.equal(best, out["best"])
        before = kh.ransac.launches
        got = kh.ransac(flow, HOMOGRAPHY_CAM, params, hyps, thr, dense, idx)
        assert kh.ransac.launches == before + kh.LAUNCHES
        ref = he.ransac_plain(flow, HOMOGRAPHY_CAM, params, hyps, thr, dense, idx)
        assert torch.equal(got.fit.best, ref.fit.best)
        assert torch.equal(got.fit.score, ref.fit.score)
        assert torch.equal(got.fit.inliers, ref.fit.inliers)
        assert_fit_matches(got, ref, flow.mask.sum(-1) >= 4, HOMOGRAPHY_CAM if plane else None)
        if plane:  # away from the pure-rotation branch: two distinct families
            assert bool((_rot_gap(ref.quats[:, 0], ref.quats[:, 1]) > 1e-3).all())
