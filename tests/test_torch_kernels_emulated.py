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
flow (a median is an exact selection).  The kernels multiply
the box sum by 1/win^2 (as PyTorch does on the card), where the CPU plain
version divides: near-ties may flip.  What the CUDA compiler makes of the
sources is tested on the card only (``-m cuda``).
"""

import ctypes
import re
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch
from scipy.ndimage import gaussian_filter

from ofps_torch.kernels import build
from ofps_torch.kernels import flow_refine as kfr
from ofps_torch.kernels import flow_refine_small as kfs
from ofps_torch.kernels import warp as kwarp
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
