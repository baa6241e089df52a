"""The evaluation matrix: flow sources x clips x estimator configurations,
run through the port's serving path (counterpart of the JAX package's
``scripts/evaluate_matrix.py``, whose constants and names it keeps).

* clips: 8 seeded rotation schedules (:func:`make_schedules`), each
  rendered (:func:`render_clip`) by sampling an oversized multi-octave
  texture through the accumulated rotation, so dense flow sees real
  imagery with an exact ground truth.
* sources: "gt-mv" (exact synthetic fields, the numerics floor), "av"
  (MPEG-4 codec motion vectors of the rendered clip), "block" (the cv
  decoder's SAD block matching) and "rlof" (its robust dense LK), the
  dense ones densified to a ``GRID`` x ``GRID`` grid.
* estimators: the 8 configurations of :data:`ESTIMATORS`.

``codec`` picks how the pixel sources get their input.  "ffmpeg" runs the
JAX matrix's route: each clip is encoded with
:func:`~ofps_torch.decoders.av.encode_gray_video`, the "av" source decodes
its motion vectors with ``AvDecoder`` and "block"/"rlof" run ``CvDecoder``
on its decoded frames.  "mvec" (:data:`AV_ROUTE`, for a machine without
FFmpeg, such as the H100 host) reads the "av" vectors from the committed
``ofps_torch/eval_data/clip<c>.mvec`` (written by :func:`write_av_data`
through the "ffmpeg" route) and runs ``CvFlowStep`` on the rendered frames
themselves, quantized to uint8 as the encoder receives them: the codec's
loss is then absent from the "block" and "rlof" columns.

The estimators run as the serving path runs them: one
:class:`~ofps_torch.parallel.stream.StreamPipeline` (no detector) per
configuration, the clips as its B streams, one ``step_from_flow`` per frame
over a (B, ``GRID``\\ :sup:`2`) :class:`SparseFlow` (masked RANSAC, in the
consumers' CUDA graph on the card), the RANSAC draws from
``torch.Generator(device).manual_seed(7)``.  A frame with fewer than 8
vectors is an all-masked row: every estimator returns the identity there
(the JAX loop skips the call and records the identity), and libmv's
degenerate-input guard holds its carry, as the skipped call does.

Writes ``err_<source>.csv`` (clips x configurations, mean rotation error in
deg/frame), ``perf_<source>.csv`` (ms/frame: the step's time over B, from
CUDA events on the card, a host clock on the CPU), ``ate.csv`` (libmv's
translation, :func:`run_translation_matrix`) and ``SUMMARY.md`` naming the
device and, on the card, its power limit::

    python -m ofps_torch.apps.evaluate_matrix [--out DIR] [--clips 0,5]
        [--device cuda|cpu] [--codec mvec|ffmpeg]
"""

from __future__ import annotations

import argparse
import csv
import math
import subprocess
import tempfile
import time
from pathlib import Path
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ofps_torch.apps import gt as gtmod
from ofps_torch.apps.synthetic import calc_view, euler_deg, get_grid, synthetic_field
from ofps_torch.core import quat
from ofps_torch.core.camera import StandardCamera
from ofps_torch.core.motion import SparseFlow, pack_entries
from ofps_torch.device import resolve_device
from ofps_torch.estimators.base import create_estimator
from ofps_torch.estimators.libmv import PrevMotion
from ofps_torch.parallel.stream import StreamPipeline

H = W = 288  # rendered clip resolution
T = 10  # frames per clip
GRID = 96  # densified grid max dim (the reference's <= 150, scaled to the render)
CV_LEVELS = 4  # the cv decoder's pyramid levels on the clips
MIN_VECTORS = 8  # fewer vectors in a frame: no estimate (identity)
SEED = 7  # RANSAC draws: torch.Generator(device).manual_seed(SEED)

ESTIMATORS = [
    ("almeida", "almeida", {"use_ransac": False}),
    ("almeida-ransac", "almeida", {}),
    ("homography-ransac", "homography", {}),
    ("homography-lmeds", "homography", {"use_ransac": False}),
    ("multiview-ransac", "multiview", {}),
    ("multiview-lmeds", "multiview", {"use_ransac": False}),
    ("libmv-7pt", "libmv", {"algo_points": 7}),
    ("libmv-8pt", "libmv", {"algo_points": 8}),
]
SOURCES = ("gt-mv", "av", "block", "rlof")
# FFmpeg is absent on the H100 host (PERF.md), so the default route reads
# the committed "av" vectors and runs the cv step on the rendered frames.
AV_ROUTE = "mvec"
EVAL_DATA = Path(__file__).resolve().parent.parent / "eval_data"

# A frame's vectors: (pos (n, 2), motion (n, 2)) float32, or None.
Field = Optional[Tuple[np.ndarray, np.ndarray]]


def camera() -> StandardCamera:
    return StandardCamera.create(1.0, 90.0)


def make_schedules(n_clips: int = 8, seed: int = 0):
    """Per-clip per-frame (roll, pitch, yaw) delta schedules in degrees:
    static spans, pans and combined-axis moves; the odd clips rest every
    fourth frame."""
    rng = np.random.default_rng(seed)
    clips = []
    for c in range(n_clips):
        mag = 0.2 + 0.8 * rng.random()
        axes = rng.random(3) < 0.7
        deltas = []
        for t in range(T):
            on = 1.0 if (t % 4 != 3 or c % 2 == 0) else 0.0
            d = mag * on * (axes * rng.uniform(0.5, 1.0, 3))
            deltas.append(tuple(d))
        clips.append(deltas)
    return clips


def render_clip(cam, deltas, seed: int, height: int = H, width: int = W, margin: int = 96):
    """(frames, quats): ``len(deltas) + 1`` float32 (height, width) frames,
    each ONE bilinear resample of an oversized texture (``margin`` px of
    content beyond the frame) through the accumulated rotation, and the
    per-frame delta quaternions (4,).

    One resample per frame keeps sequential warping's compounding blur
    out, and the margin keeps a clamped border band out of view."""
    from scipy.ndimage import gaussian_filter, map_coordinates

    rng = np.random.default_rng(seed)
    big = sum(
        gaussian_filter(rng.uniform(-1, 1, (height + 2 * margin, width + 2 * margin)), s)
        .astype(np.float32) * s
        for s in (1, 2, 4, 8, 16)
    )
    big = (big - big.min()) / (big.max() - big.min()) * 255.0
    ys, xs = np.meshgrid(
        (np.arange(height) + 0.5) / height, (np.arange(width) + 0.5) / width, indexing="ij"
    )
    pts = torch.from_numpy(np.stack([xs, ys], axis=-1).reshape(-1, 2).astype(np.float32))

    def sample(q_acc):
        delta = cam.delta(pts, quat.to_matrix4(q_acc)).numpy().reshape(height, width, 2)
        sy = (ys + delta[..., 1]) * height + margin - 0.5
        sx = (xs + delta[..., 0]) * width + margin - 0.5
        return map_coordinates(big, [sy, sx], order=1, mode="nearest").astype(np.float32)

    q_acc = quat.identity()
    frames, qs = [sample(q_acc)], []
    for d in deltas:
        q = euler_deg(*d)
        qs.append(q.numpy())
        q_acc = quat.mul(q_acc, q)
        frames.append(sample(q_acc))
    return frames, qs


def _truth_quats(deltas) -> List[np.ndarray]:
    return [euler_deg(*d).numpy() for d in deltas]


def clip_frames(cam, schedules, ci: int) -> np.ndarray:
    """Clip ``ci`` rendered and cut to uint8 (T+1, H, W), as the encoder
    receives it."""
    frames, _ = render_clip(cam, schedules[ci], seed=100 + ci)
    return np.clip(np.stack(frames), 0.0, 255.0).astype(np.uint8)


def _field(pos, motion) -> Field:
    pos = np.asarray(pos, np.float32).reshape(-1, 2)
    return (pos, np.asarray(motion, np.float32).reshape(-1, 2)) if len(pos) >= MIN_VECTORS else None


def decoder_fields(decoder) -> List[Field]:
    """T fields drained from a decoder: frame 0 (the I-frame, or the cv
    warm-up) is skipped; a frame without motion vectors is None."""
    decoder.process_frame()
    out = []
    for _ in range(T):
        f = decoder.process_frame()
        out.append(_field(f.pos, f.motion) if f is not None and f.has_mvs else None)
    return out


def gt_fields(cam, deltas) -> List[Field]:
    """The exact synthetic field of each frame's delta rotation."""
    out = []
    for d in deltas:
        sf = synthetic_field(cam, euler_deg(*d), capacity=GRID * GRID, device="cpu")
        n = int(sf.mask.sum().item())
        out.append(_field(sf.pos[:n].numpy(), sf.motion[:n].numpy()))
    return out


def cv_step(height: int, width: int, use_rlof: bool, device, plain: bool = False):
    """The cv decoder's step with the matrix's settings (``GRID``,
    ``CV_LEVELS``, the decoder's other defaults)."""
    from ofps_torch.decoders.cv import CvFlowStep

    return CvFlowStep(height, width, grid_max_dim=GRID, levels=CV_LEVELS, use_rlof=use_rlof,
                      device=device, plain=plain)


def cv_fields(frames: np.ndarray, use_rlof: bool, device) -> List[Field]:
    """The cv decoder's fields over rendered uint8 frames (T+1, H, W):
    ``CvFlowStep`` from a zero warm start, each step warm started from the
    last flow, the valid cells of its grid at the cell centres."""
    h, w = frames.shape[-2:]
    step = cv_step(h, w, use_rlof, device)
    gw, gh = step.grid_wh
    ys, xs = np.meshgrid(np.arange(gh), np.arange(gw), indexing="ij")
    cells = np.stack([(xs + 0.5) / gw, (ys + 0.5) / gh], axis=-1).reshape(-1, 2).astype(np.float32)
    gray = torch.from_numpy(frames.astype(np.float32)).to(step.device)
    flow = torch.zeros((h, w, 2), dtype=torch.float32, device=step.device)
    out = []
    for t in range(1, gray.shape[0]):
        flow, grid, valid = step(gray[t - 1], gray[t], flow)
        keep = valid.reshape(-1).cpu().numpy()
        out.append(_field(cells[keep], grid.reshape(-1, 2).cpu().numpy()[keep]))
    return out


def av_mvec_path(ci: int, directory: Path = EVAL_DATA) -> Path:
    return Path(directory) / f"clip{ci}.mvec"


def write_av_data(directory: Path = EVAL_DATA, clips: Sequence[int] = range(8)) -> None:
    """Write the "av" source's vectors of ``clips`` as ``.mvec`` files
    (the T inter frames; a frame without vectors has none), through the
    "ffmpeg" route: render, encode, decode.  Needs FFmpeg."""
    from ofps_torch.decoders.mvec import write_mvec_frame

    cam, schedules = camera(), make_schedules()
    Path(directory).mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(prefix="ofps_eval_") as tmp:
        for ci in clips:
            fields = source_fields("av", ci, cam, schedules, "cpu", "ffmpeg", Path(tmp))
            with open(av_mvec_path(ci, directory), "wb") as f:
                for fl in fields:
                    pos, mot = fl if fl is not None else (np.zeros((0, 2)),) * 2
                    write_mvec_frame(f, pos, mot)


def source_fields(name: str, ci: int, cam, schedules, device, codec: str = AV_ROUTE,
                  workdir: Optional[Path] = None) -> List[Field]:
    """The T per-frame fields of clip ``ci`` through source ``name``.
    ``workdir`` holds the encoded clip on the "ffmpeg" route (one
    I-frame, then inter frames: gop T + 2)."""
    if name == "gt-mv":
        return gt_fields(cam, schedules[ci])
    if name not in SOURCES:
        raise ValueError(f"unknown source {name!r}")
    if codec == "mvec":
        if name == "av":
            from ofps_torch.decoders.mvec import MvecDecoder

            dec = MvecDecoder(str(av_mvec_path(ci)))
            try:
                return [_field(f.pos, f.motion) for f in (dec.process_frame() for _ in range(T))]
            finally:
                dec.close()
        return cv_fields(clip_frames(cam, schedules, ci), name == "rlof", device)
    if codec != "ffmpeg":
        raise ValueError(f"unknown codec route {codec!r}")
    from ofps_torch.decoders.av import AvDecoder, encode_gray_video

    path = Path(workdir) / f"clip{ci}.avi"
    if not path.exists():
        encode_gray_video(str(path), clip_frames(cam, schedules, ci), gop=T + 2)
    if name == "av":
        dec = AvDecoder(str(path))
    else:
        from ofps_torch.decoders.cv import CvDecoder

        dec = CvDecoder(str(path), grid_max_dim=GRID, levels=CV_LEVELS,
                        use_rlof=name == "rlof", device=device)
    try:
        return decoder_fields(dec)
    finally:
        dec.close()


def stack_fields(per_clip: Sequence[Sequence[Field]], device) -> SparseFlow:
    """Per-clip field lists (B clips x T frames) as one (T, B, GRID^2)
    :class:`SparseFlow` on ``device`` (one upload); None rows all masked."""
    n_t = len(per_clip[0])
    rows = np.zeros((n_t, len(per_clip), GRID * GRID, 5), dtype=np.float32)
    for b, fields in enumerate(per_clip):
        for t, fl in enumerate(fields):
            if fl is not None:
                pack_entries(fl[0], fl[1], rows[t, b])
    x = torch.from_numpy(rows).to(device)
    return SparseFlow(x[..., 0:2], x[..., 2:4], x[..., 4])


def make_pipeline(label: str, cam, device) -> StreamPipeline:
    """One configuration of :data:`ESTIMATORS` as a serving pipeline."""
    _, name, props = next(e for e in ESTIMATORS if e[0] == label)
    return StreamPipeline(cam, [create_estimator(name, **props)], None, device=device)


def run_config(pipe: StreamPipeline, flows: SparseFlow, generator=None, draws=None):
    """The (T, B) flows through ``pipe`` from a fresh state: (delta
    rotations (T, B, 4) on the host, ms per step).  The ms are CUDA events
    around the T steps on the card, a host clock on the CPU.  ``draws``:
    optional per-frame ``step_from_flow`` draws in place of the
    generator's."""
    n_t, batch = flows.mask.shape[:2]
    state = pipe.init_state(batch, H, W)
    cuda = pipe.device.type == "cuda"
    if cuda:
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
    t0 = time.perf_counter()
    rots = []
    for t in range(n_t):
        flow = SparseFlow(flows.pos[t], flows.motion[t], flows.mask[t])
        state, out = pipe.step_from_flow(
            state, flow, generator, draws=None if draws is None else draws[t])
        rots.append(out.delta_rot[0])
    if cuda:
        ev[1].record()
        ev[1].synchronize()
        ms = ev[0].elapsed_time(ev[1])
    else:
        ms = (time.perf_counter() - t0) * 1e3
    return torch.stack(rots).cpu().numpy(), ms / n_t


def warm_up(pipe: StreamPipeline, batch: int) -> None:
    """One step on all-masked flows, so that the consumers' CUDA graph is
    captured before anything is timed (its own generator: the timed runs'
    draws are untouched)."""
    empty = torch.zeros((batch, GRID * GRID), device=pipe.device)
    flow = SparseFlow(torch.zeros(empty.shape + (2,), device=pipe.device),
                      torch.zeros(empty.shape + (2,), device=pipe.device), empty)
    gen = torch.Generator(device=pipe.device).manual_seed(0)
    pipe.step_from_flow(pipe.init_state(batch, H, W), flow, gen)


def mean_errors_deg(delta_rots: np.ndarray, truths: Sequence[Sequence[np.ndarray]]) -> List[float]:
    """Per clip, the mean angle (deg/frame) between the estimated delta
    rotations (T, B, 4) and the clip's true ones."""
    return [
        math.degrees(np.mean([
            gtmod._qangle(gtmod.rotation_to(delta_rots[t, b].astype(np.float64), q))
            for t, q in enumerate(truth)
        ]))
        for b, truth in enumerate(truths)
    ]


def run_matrix(clips: Sequence[int], device, codec: str = AV_ROUTE,
               workdir: Optional[Path] = None, log: Callable[[str], None] = print,
               fields: Optional[Dict[str, SparseFlow]] = None) -> Dict:
    """``{(source, clip, config): (mean deg/frame, ms/frame)}`` over the
    clips as one batch.  ``fields``: the stacked (T, B) flows per source,
    when the caller made them (else each source is built here)."""
    device = resolve_device(device)
    cam, schedules = camera(), make_schedules()
    truths = [_truth_quats(schedules[ci]) for ci in clips]
    if fields is None:
        fields = {s: stack_fields(
            [source_fields(s, ci, cam, schedules, device, codec, workdir) for ci in clips], device)
            for s in SOURCES}
    pipes = {label: make_pipeline(label, cam, device) for label, _, _ in ESTIMATORS}
    for pipe in pipes.values():
        warm_up(pipe, len(clips))
    results = {}
    for source in SOURCES:
        for label, pipe in pipes.items():
            gen = torch.Generator(device=device).manual_seed(SEED)
            rots, ms = run_config(pipe, fields[source], gen)
            for ci, err in zip(clips, mean_errors_deg(rots, truths)):
                results[(source, ci, label)] = (err, ms / len(clips))
                log(f"{source:6s} clip{ci} {label:18s} err={err:8.4f} deg  "
                    f"{ms / len(clips):7.3f} ms/frame")
    return results


# --- translation (scale-aligned ATE) ----------------------------------------
#
# libmv, the translation-emitting estimator, integrated over seeded 3-D
# camera paths through exact projections of a non-planar point cloud: the
# rendered clips warp a flat texture (no parallax), so pixel sources cannot
# measure translation here.

T_PATH = 6  # positions per translation path (T_PATH - 1 flow frames)


def make_translation_paths(n_paths: int = 4, seed: int = 11):
    """Seeded 3-D paths: per path (quats, positions) of T_PATH poses; the
    heading turns slowly, odd paths also rotate the camera."""
    rng = np.random.default_rng(seed)
    paths = []
    for c in range(n_paths):
        step = 0.06 + 0.06 * rng.random()
        d = rng.normal(size=3)
        positions = [np.zeros(3, np.float32)]
        quats = [quat.identity().numpy()]
        for _ in range(T_PATH - 1):
            d = d + 0.6 * rng.normal(size=3)
            d /= np.linalg.norm(d)
            positions.append((positions[-1] + step * d.astype(np.float32)).astype(np.float32))
            dq = euler_deg(*rng.uniform(-0.5, 0.5, 3)) if c % 2 == 1 else quat.identity()
            quats.append(quat.mul(torch.from_numpy(quats[-1]), dq).numpy())
        paths.append((quats, positions))
    return paths


def translation_cloud(cam, n: int = 40, seed: int = 0) -> torch.Tensor:
    """(n^2, 3) non-planar cloud: the unprojected grid at random depths."""
    rng = np.random.default_rng(seed)
    g = get_grid(n, n, cam).numpy()
    return torch.from_numpy(g * rng.uniform(0.3, 1.0, (len(g), 1)).astype(np.float32))


def path_fields(cam, cloud, quats, positions, capacity: int = 1600, device="cuda"):
    """Exact per-frame :class:`SparseFlow` of the cloud along the path
    (points inside the frame in both views)."""
    out = []
    for i in range(len(positions) - 1):
        a = cam.project(cloud, calc_view(quats[i], positions[i])).numpy()
        b = cam.project(cloud, calc_view(quats[i + 1], positions[i + 1])).numpy()
        keep = (np.abs(a - 0.5).max(1) < 0.5) & (np.abs(b - 0.5).max(1) < 0.5)
        out.append(SparseFlow.from_arrays(a[keep], (b - a)[keep], capacity=capacity,
                                          device=device))
    return out


def eval_translation_path(cam, cloud, quats, positions, algo_points: int, device="cuda"):
    """(ATE as % of the path length, mean direction error deg, mean
    rotation error deg) of libmv integrated along one path with
    ``motion_step``."""
    device = resolve_device(device)
    est = create_estimator("libmv", algo_points=algo_points)
    state = PrevMotion.empty(device)
    gen = torch.Generator(device=device).manual_seed(SEED)
    rot = torch.from_numpy(np.asarray(quats[0], np.float32)).to(device)
    pos = torch.zeros(3, device=device)
    rots, poss = [], []
    for flow in path_fields(cam, cloud, quats, positions, device=device):
        rot, pos, state = est.motion_step(state, flow, cam, rot, pos, generator=gen)
        rots.append(rot.cpu().numpy())
        poss.append(pos.cpu().numpy())
    truth = [
        gtmod.GroundTruthRow(frame=i, fov_x=90.0, fov_y=90.0,
                             rot=np.asarray(quats[i], np.float64),
                             pos=np.asarray(positions[i], np.float64))
        for i in range(1, len(positions))
    ]
    ate, stats = gtmod.calc_pos_err(truth, poss)
    path_len = sum(float(np.linalg.norm(np.subtract(b, a)))
                   for a, b in zip(positions, positions[1:]))
    rot_errs = [gtmod._qangle(gtmod.rotation_to(qe.astype(np.float64), np.asarray(qg)))
                for qe, qg in zip(rots, quats[1:])]
    return (100.0 * ate / path_len,
            math.degrees(np.mean([s.error_dir for s in stats])),
            math.degrees(np.mean(rot_errs)))


ATE_COLUMNS = ["clip", "ate_pct_7pt", "dir_deg_7pt", "rot_deg_7pt",
               "ate_pct_8pt", "dir_deg_8pt", "rot_deg_8pt"]


def run_translation_matrix(device, log: Callable[[str], None] = print) -> List[dict]:
    """One row per translation path: libmv 7- and 8-point ATE, direction
    and rotation errors (the keys of :data:`ATE_COLUMNS`)."""
    cam = camera()
    cloud = translation_cloud(cam)
    rows = []
    for ci, (quats, positions) in enumerate(make_translation_paths()):
        row = {"clip": ci}
        for pts in (7, 8):
            ate, dir_deg, rot_deg = eval_translation_path(cam, cloud, quats, positions, pts,
                                                          device)
            row.update({f"ate_pct_{pts}pt": ate, f"dir_deg_{pts}pt": dir_deg,
                        f"rot_deg_{pts}pt": rot_deg})
            log(f"trans path{ci} libmv-{pts}pt  ATE={ate:6.2f}% of path  "
                f"dir={dir_deg:6.2f} deg  rot={rot_deg:.4f} deg")
        rows.append(row)
    return rows


def device_line(device) -> str:
    """The device the numbers come from: the card's name and power limit
    (``nvidia-smi``), or the CPU."""
    device = torch.device(device)
    if device.type != "cuda":
        return "cpu (ms from a host clock)"
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader",
         f"--id={device.index or 0}"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    return f"{smi} (ms from CUDA events)"


def write_outputs(outdir: Path, results: Dict, clips: Sequence[int], ate_rows: List[dict],
                  device_desc: str, codec: str) -> None:
    """The CSVs and ``SUMMARY.md`` of one run."""
    outdir = Path(outdir)
    outdir.mkdir(parents=True, exist_ok=True)
    labels = [e[0] for e in ESTIMATORS]
    sources = sorted({k[0] for k in results}, key=SOURCES.index)
    for source in sources:
        for stem, col, fmt in (("err", 0, "{:.5f}"), ("perf", 1, "{:.3f}")):
            with open(outdir / f"{stem}_{source}.csv", "w", newline="") as f:
                w = csv.writer(f)
                w.writerow(["clip"] + labels)
                for ci in clips:
                    w.writerow([ci] + [fmt.format(results[(source, ci, lab)][col])
                                       for lab in labels])
    with open(outdir / "ate.csv", "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(ATE_COLUMNS)
        for row in ate_rows:
            w.writerow([row["clip"]] + [f"{row[c]:.4f}" for c in ATE_COLUMNS[1:]])
    route = ("each clip MPEG-4 encoded and decoded (FFmpeg)" if codec == "ffmpeg" else
             "av: the committed ofps_torch/eval_data/*.mvec vectors; block and rlof: "
             "the cv step on the rendered frames quantized to uint8, so the codec's "
             "loss is absent from those two columns")
    lines = [
        "# Evaluation matrix summary (ofps_torch)\n",
        f"{len(sources)} sources x {len(clips)} clips x {len(labels)} estimator configs = "
        f"{len(sources) * len(clips) * len(labels)} evaluations on {device_desc}.\n",
        f"Clips {list(clips)}, {H}x{W}, {T} frames, grid {GRID}; route: {route}.  Each "
        "configuration is one StreamPipeline with the clips as its B streams; ms/frame "
        "is one step_from_flow over B.\n",
        "| source | estimator | avg err (deg/frame) | ms/frame |",
        "|---|---|---|---|",
    ]
    for source in sources:
        for lab in labels:
            errs = [results[(source, ci, lab)][0] for ci in clips]
            mss = [results[(source, ci, lab)][1] for ci in clips]
            lines.append(f"| {source} | {lab} | {np.mean(errs):.4f} | {np.mean(mss):.3f} |")
    lines += [
        "\n## Translation (scale-aligned ATE)\n",
        "libmv integrated with motion_step over seeded 3-D camera paths (exact "
        "cloud projections); ATE is the scale-aligned RMS trajectory error as % of "
        "the path length, dir the mean per-frame translation-direction error.\n",
        "| path | libmv-7pt ATE | 7pt dir | libmv-8pt ATE | 8pt dir |",
        "|---|---|---|---|---|",
    ]
    for row in ate_rows:
        lines.append(f"| {row['clip']} | {row['ate_pct_7pt']:.2f}% | {row['dir_deg_7pt']:.2f} "
                     f"deg | {row['ate_pct_8pt']:.2f}% | {row['dir_deg_8pt']:.2f} deg |")
    (outdir / "SUMMARY.md").write_text("\n".join(lines) + "\n")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python -m ofps_torch.apps.evaluate_matrix",
                                description=__doc__.split("\n\n")[0])
    p.add_argument("--out", default="evaluate_matrix_out", help="output directory")
    p.add_argument("--clips", default="0,1,2,3,4,5,6,7", help="comma-separated clip indices")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    p.add_argument("--codec", default=AV_ROUTE, choices=("mvec", "ffmpeg"),
                   help="how the pixel sources get their input (module docstring)")
    args = p.parse_args(argv)
    torch.backends.cuda.matmul.allow_tf32 = False
    device = resolve_device(args.device)
    clips = [int(c) for c in args.clips.split(",")]
    with tempfile.TemporaryDirectory(prefix="ofps_eval_") as tmp:
        results = run_matrix(clips, device, codec=args.codec, workdir=Path(tmp))
    ate_rows = run_translation_matrix(device)
    write_outputs(Path(args.out), results, clips, ate_rows, device_line(device), args.codec)
    print(f"wrote {args.out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
