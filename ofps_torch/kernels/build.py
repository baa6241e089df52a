"""Build and load the hand-written CUDA kernels.

The sources in ``ofps_torch/csrc/`` are compiled at first use with ``nvcc``
for ``sm_90a``, one ``nvcc`` per source, all started together, and linked
into one shared library with a plain C interface, loaded with ctypes.  The build directory is keyed by a hash of the sources and flags, so
an edited kernel is rebuilt and an unchanged one is loaded as it is.

No ``--use_fast_math``: it flushes denormals, which breaks the float32
guard constants.  ``-fmad=false`` keeps every multiply and add separately
rounded, as the plain PyTorch versions compute them.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

import numpy as np
import torch

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_ROOT = _PKG / "_build"
SOURCES = ("flow_refine.cu", "flow_refine_small.cu", "warp.cu", "almeida_ransac.cu")
HEADERS = ("level_refine.cuh",)
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-fmad=false", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

# Window sizes the refine kernels are compiled for (csrc/flow_refine*.cu).
KERNEL_WINDOWS = (3, 5, 7)

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float

# C entry points: name -> argtypes.  Every one returns cudaGetLastError().
_SIGNATURES = {
    # i1, i2, uc, vc, yi, yw, xi, xw, scale, u_out, v_out, cell_y, cell_x,
    # gsum_u, gsum_v, gh, gw, B, h, w, hc, wc, win, round_bf16, median_in, stream
    "ofps_flow_refine": [_P] * 8 + [_F] + [_P] * 6 + [_I] * 10 + [_P],
    # i1, i2, uc, vc, yi, yw, xi, xw, scale, u_out, v_out,
    # B, h, w, hc, wc, search, win, round_bf16, median_in, stream
    "ofps_flow_refine_small": [_P] * 8 + [_F] + [_P] * 2 + [_I] * 9 + [_P],
    # a, b, u_w, v_w, u_0, v_0, u_out, v_out, B, h, w, win, stream
    "ofps_guard_select": [_P] * 8 + [_I] * 4 + [_P],
    # img, u, v, out, B, h, w, stream
    "ofps_warp_bilinear": [_P] * 4 + [_I] * 3 + [_P],
    # &Args (kernels/almeida.py _Args), stream
    "ofps_almeida_ransac": [_P, _P],
}


def _nvcc() -> str:
    found = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(found):
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return found


def source_digest() -> str:
    h = hashlib.sha256()
    for name in SOURCES + HEADERS:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def compile_shared(lib: Path, cmd) -> str:
    """Run the compiler command ``cmd`` with ``-o`` into a temporary
    directory beside ``lib``, then rename the result to ``lib`` (so
    processes building at once never load a half-written library).
    Returns the compiler's output; raises on a compiler error."""
    lib.parent.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=lib.parent) as tmp:
        tmp_lib = Path(tmp) / lib.name
        proc = subprocess.run([*cmd, "-o", str(tmp_lib)], capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(
                f"{cmd[0]} failed ({proc.returncode}):\n{proc.stdout}\n{proc.stderr}"
            )
        os.replace(tmp_lib, lib)
    return proc.stdout + proc.stderr


def build(verbose: bool = False) -> Path:
    """Compile the kernels (if this source hash has no library yet) and
    return the library's path.  Raises on any compiler error."""
    lib = BUILD_ROOT / source_digest() / "libofps_kernels.so"
    if lib.exists():
        return lib
    nvcc = _nvcc()
    lib.parent.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=lib.parent) as tmp:
        objs = [Path(tmp) / (Path(s).stem + ".o") for s in SOURCES]
        procs = [
            subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", str(CSRC / s), "-o", str(o)],
                             stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for s, o in zip(SOURCES, objs)
        ]
        logs = [p.communicate()[0] for p in procs]
        for s, p, out in zip(SOURCES, procs, logs):
            if p.returncode != 0:
                raise RuntimeError(f"{nvcc} failed on {s} ({p.returncode}):\n{out}")
        logs.append(compile_shared(lib, [nvcc, "-shared", *map(str, objs)]))
    if verbose:
        print("\n".join(logs))
    return lib


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first use."""
    lib = ctypes.CDLL(str(build()))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


def check(status: int, name: str) -> None:
    """Raise on a non-zero ``cudaError_t`` returned by an entry point."""
    if status != 0:
        raise RuntimeError(f"{name}: CUDA error {status} at launch")


# -- launch helpers shared by the wrappers ------------------------------------


def on_cuda(name: str, t: torch.Tensor) -> bool:
    """True for a CUDA tensor (launch the kernel), False for a CPU tensor
    (run the plain version); any other device raises."""
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {t.device}")
    return t.device.type == "cuda"


def require_cuda_f32(name: str, *tensors) -> None:
    """Raise unless every tensor is a contiguous float32 tensor on one CUDA
    device (the kernels read raw pointers)."""
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev or t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(
                f"{name}: expected contiguous float32 tensors on {dev}, got "
                f"{t.dtype} on {t.device} (contiguous={t.is_contiguous()})"
            )


def stream_ptr(device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def on_device(device):
    """Make ``device`` the current card for a launch: the entry points set
    the shared-memory attribute and launch on the current card, so it must
    be the one whose stream and pointers they are given."""
    return torch.cuda.device(device)


@functools.lru_cache(maxsize=None)
def _taps_np(n: int, on: int):
    """Two-tap form of the (on, n) resize matrix: ``idx`` (2, on) int32 and
    ``wts`` (2, on) float32, so out[i] = w0 * x[i0] + w1 * x[i1]."""
    from ofps_torch.ops.image import resize_matrix_np

    m = resize_matrix_np(n, on)
    idx = np.zeros((2, on), np.int32)
    wts = np.zeros((2, on), np.float32)
    for i in range(on):
        nz = np.nonzero(m[i])[0]
        if not 1 <= nz.size <= 2:
            raise ValueError(f"resize {n}->{on} is not a two-tap interpolation")
        idx[:, i] = nz[0], nz[-1]
        wts[0, i] = m[i, nz[0]]
        wts[1, i] = m[i, nz[-1]] if nz.size == 2 else 0.0
    # The kernels' median prologue bounds a tile's coarse region by its
    # first and last taps (csrc/level_refine.cuh coarse_flow).
    if (np.diff(idx, axis=1) < 0).any():
        raise ValueError(f"resize {n}->{on}: taps are not non-decreasing")
    return idx, wts


@functools.lru_cache(maxsize=64)
def upsample_taps(hc: int, wc: int, h: int, w: int, device: str):
    """Device tables for the in-kernel bilinear flow upsample (hc, wc) ->
    (h, w), the same weights as :func:`ofps_torch.ops.image.resize_bilinear`.
    Returns ``(yi, yw, xi, xw, scale)``; scale 2 when resizing (the flow
    doubles per level), 1 for the identity."""
    tables = (*_taps_np(hc, h), *_taps_np(wc, w))
    scale = 2.0 if (hc, wc) != (h, w) else 1.0
    return tuple(torch.from_numpy(a).to(device) for a in tables) + (scale,)
