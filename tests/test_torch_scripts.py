"""The port's ``mosh`` and ``export_preview`` apps against the JAX
package's ``scripts/mosh.py`` and ``scripts/export_preview.py`` (run as
subprocesses on the CPU), on two small encoded clips (160x120 and
192x144, 12 frames).

* ``python -m ofps_torch.apps.mosh``: the moshed clip's bytes equal JAX's.
* ``python -m ofps_torch.apps.export_preview --device cpu``: as many
  frames as JAX's, each frame's pixels equal to JAX's.  The files' bytes
  differ: JAX's ``save_png`` writes through matplotlib (its own metadata
  and compression), the port's through zlib.
* With ``--overlay``: frame 0 carries no flow and equals JAX's; frame 1,
  one cv step from the zero warm start, within the cv tests' share (at
  most 0.5% of pixels differ, ``tests/test_torch_cv.py``); later frames
  follow chains that flip float32 near-ties (ROADMAP, "cv chains"), so
  they are held by the share of pixels that differ: at most 1% (0.33%
  measured on the CPU).
* Without ``--device``, ``export_preview`` takes the CUDA card and raises
  where there is none.
"""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from PIL import Image

from ofps_torch.apps import export_preview as tprev
from ofps_torch.apps import mosh as tmosh
from ofps_tpu.decoders.av import encode_test_video
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

ROOT = Path(__file__).resolve().parent.parent
FIRST_STEP_SHARE = 0.005
CHAIN_SHARE = 0.01
PREVIEW = ["--width", "80", "--fps", "30"]


def _jax_script(name, *args):
    subprocess.run([sys.executable, str(ROOT / "scripts" / name), *map(str, args)], check=True,
                   env=dict(os.environ, JAX_PLATFORMS="cpu"), capture_output=True, timeout=600)


def _pngs(d):
    return [np.asarray(Image.open(p)) for p in sorted(Path(d).glob("frame_*.png"))]


@pytest.fixture(scope="module")
def clips(tmp_path_factory):
    d = tmp_path_factory.mktemp("scripts")
    encode_test_video(str(d / "a.avi"), 160, 120, frames=12, gop=30, dx=2.0, dy=1.0,
                      pattern="noise")
    encode_test_video(str(d / "b.avi"), 192, 144, frames=12, gop=30, dx=1.0, dy=0.0)
    return d


def test_mosh_writes_jax_bytes(clips):
    _jax_script("mosh.py", clips / "b.avi", clips / "a.avi", clips / "j_mosh.avi")
    assert tmosh.main([str(clips / "b.avi"), str(clips / "a.avi"),
                       str(clips / "t_mosh.avi")]) == 0
    assert (clips / "t_mosh.avi").read_bytes() == (clips / "j_mosh.avi").read_bytes()


@pytest.mark.parametrize("overlay", [False, True], ids=["plain", "overlay"])
def test_export_preview_matches_jax(overlay, clips):
    flag = ["--overlay"] if overlay else []
    jdir, tdir = clips / f"j_prev_{overlay}", clips / f"t_prev_{overlay}"
    _jax_script("export_preview.py", clips / "a.avi", jdir, *PREVIEW, *flag)
    assert tprev.main([str(clips / "a.avi"), str(tdir), *PREVIEW, *flag,
                       "--device", "cpu"]) == 0
    got, ref = _pngs(tdir), _pngs(jdir)
    assert len(got) == len(ref) == 12
    assert all(g.shape == r.shape == (60, 80, 4) for g, r in zip(got, ref))
    shares = [float((g != r).any(-1).mean()) for g, r in zip(got, ref)]
    if not overlay:
        assert shares == [0.0] * 12
        return
    assert shares[0] == 0.0
    assert shares[1] <= FIRST_STEP_SHARE, shares
    assert max(shares[2:]) <= CHAIN_SHARE, shares
    # The overlay is there: frames 1.. differ from the plain preview.
    plain = _pngs(clips / "t_prev_False")
    assert all((g != p).any() for g, p in zip(got[1:], plain[1:]))


def test_export_preview_raises_without_cuda(clips, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tprev.main([str(clips / "a.avi"), str(clips / "x")])
