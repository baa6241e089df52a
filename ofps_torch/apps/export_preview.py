"""Export a clip as downscaled preview frames (port of
``scripts/export_preview.py``, the reference's ``scripts/webp.sh``).

    python -m ofps_torch.apps.export_preview IN.avi OUT_DIR [--fps 15]
        [--width 720] [--overlay] [--device cuda|cpu]

Writes ``OUT_DIR/frame_%05d.png``: the clip subsampled to about ``--fps``
frames per second and downscaled (nearest) to ``--width``.  ``--overlay``
blends in the HSV optical-flow view of the "cv" decoder's flow (block
matching on ``--device``, densified to 90x60).  The clip is decoded on the
host with the port's FFmpeg decoder.  ``--device`` defaults to the CUDA
card and fails without one unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from ofps_torch.apps.viz import flow_to_rgba, overlay, save_png
from ofps_torch.decoders.av import AvDecoder
from ofps_torch.decoders.base import create_decoder
from ofps_torch.device import resolve_device


def _nearest(img: np.ndarray, oh: int, ow: int) -> np.ndarray:
    h, w = img.shape[:2]
    yi = (np.arange(oh) * h // oh).clip(0, h - 1)
    xi = (np.arange(ow) * w // ow).clip(0, w - 1)
    return img[yi][:, xi]


def export_preview(input_path: str, out_dir: str, fps: float = 15.0, width: int = 720,
                   with_overlay: bool = False, device="cuda") -> int:
    """Write the preview frames; returns how many."""
    from ofps_torch.core.motion import SparseFlow, densify

    dev = resolve_device(device)
    os.makedirs(out_dir, exist_ok=True)
    dec = AvDecoder(input_path)
    step = max(1, round((dec.get_framerate() or 30.0) / fps))
    cv = create_decoder(input_path, plugin="cv", device=dev) if with_overlay else None

    i = written = 0
    try:
        while True:
            fr = dec.process_frame(want_frame=True)
            if fr is None:
                break
            flow_rgba = None
            if cv is not None:
                cfr = cv.process_frame(want_frame=False)
                if cfr is not None and len(cfr.pos):
                    flow = SparseFlow.from_arrays(cfr.pos, cfr.motion, device=dev)
                    field = densify(flow, 90, 60)
                    flow_rgba = flow_to_rgba(field.cpu().numpy())
            if i % step == 0:
                h, w = fr.frame.shape[:2]
                oh = max(1, round(h * width / w))
                small = _nearest(fr.frame, oh, width)
                if flow_rgba is not None:
                    small = overlay(small, _nearest(flow_rgba, oh, width))
                save_png(os.path.join(out_dir, f"frame_{written:05d}.png"), small)
                written += 1
            i += 1
    finally:
        dec.close()
        if cv is not None:
            cv.close()
    return written


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m ofps_torch.apps.export_preview",
                                 description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("input")
    ap.add_argument("out_dir")
    ap.add_argument("--fps", type=float, default=15.0)
    ap.add_argument("--width", type=int, default=720)
    ap.add_argument("--overlay", action="store_true",
                    help="blend in the cv decoder's optical flow (HSV)")
    ap.add_argument("--device", default="cuda",
                    help="torch device of the cv decoder's flow (default cuda)")
    args = ap.parse_args(argv)
    n = export_preview(args.input, args.out_dir, args.fps, args.width, args.overlay, args.device)
    print(f"wrote {n} preview frames to {args.out_dir}/")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
