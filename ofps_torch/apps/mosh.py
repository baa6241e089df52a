"""Datamosh a clip: a single-I-frame re-encode with a foreign first frame
(port of ``scripts/mosh.py``, the reference's ``scripts/mosh.sh``).

    python -m ofps_torch.apps.mosh MOSH_FRAME_CLIP SOURCE_CLIP OUT.avi

The first decoded frame of MOSH_FRAME_CLIP, in grey and resized (nearest)
to SOURCE_CLIP's size, becomes the only I-frame; every frame after the
first of SOURCE_CLIP follows as a P-frame, so the codec's motion vectors
drag the foreign content around.  Host only: the port's FFmpeg decoder
and encoder (``ofps_torch.decoders.av``), no device.  Feed the result to
``python -m ofps_torch.apps.cli motion-extract`` or ``flow-extract``.
"""

from __future__ import annotations

import argparse

import numpy as np

from ofps_torch.decoders.av import AvDecoder, encode_gray_video


def gray_frames(path: str, limit: int = 100000) -> np.ndarray:
    """(N, H, W) uint8 grey frames of a clip (BT.601 luma of its RGBA)."""
    dec = AvDecoder(path)
    out = []
    try:
        while len(out) < limit:
            fr = dec.process_frame(want_frame=True)
            if fr is None:
                break
            rgba = fr.frame.astype(np.float32)
            out.append((0.299 * rgba[..., 0] + 0.587 * rgba[..., 1] + 0.114 * rgba[..., 2])
                       .clip(0, 255).astype(np.uint8))
    finally:
        dec.close()
    if not out:
        raise SystemExit(f"no decodable frames in {path!r}")
    return np.stack(out)


def mosh(mosh_src: str, video_src: str, out_path: str) -> int:
    """Write the moshed clip; returns its frame count."""
    first = gray_frames(mosh_src, limit=1)[0]
    vid = gray_frames(video_src)
    h, w = vid.shape[1:]
    if first.shape != (h, w):
        yi = (np.arange(h) * first.shape[0] // h).clip(0, first.shape[0] - 1)
        xi = (np.arange(w) * first.shape[1] // w).clip(0, first.shape[1] - 1)
        first = first[yi][:, xi]
    frames = np.concatenate([first[None], vid[1:]], axis=0)
    encode_gray_video(out_path, frames, gop=1 << 20)
    return len(frames)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m ofps_torch.apps.mosh", description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("mosh_frame_clip")
    ap.add_argument("source_clip")
    ap.add_argument("output")
    args = ap.parse_args(argv)
    n = mosh(args.mosh_frame_clip, args.source_clip, args.output)
    print(f"moshed {n} frames -> {args.output} (single I-frame)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
