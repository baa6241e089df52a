"""Command-line tools (port of ``ofps_tpu.apps.cli``).

Subcommands:

* ``motion-extract`` — video -> ``.mvec`` dump.
* ``flow-extract``   — video -> numbered Middlebury ``.flo`` files: densify
  -> hole-fill -> 11x11 gaussian blur on the device, optional HSV debug
  PNGs.
* ``run-config``     — run a detection or tracking JSON config headlessly.
* ``info``           — list registered decoder/estimator/detector plugins.
* ``run-batch``      — N streams through one batched device step.
* ``bench-decode``   — host decode throughput over N parallel feeds.
* ``bench-e2e``      — host decode feeding the batched step; one JSON line.
* ``watch``          — live browser view of a running config.
* ``stats``          — summarize exported stats CSVs.
* ``bench``          — the port's benchmark (:mod:`ofps_torch.apps.bench`,
  the counterpart of the repository root's ``bench.py``); one JSON line.

Usage: ``python -m ofps_torch.apps.cli [--device cuda|cpu] <subcommand> ...``.
``--device`` (default ``cuda``) is where every subcommand runs; a machine
without CUDA fails unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile


def cmd_motion_extract(args) -> int:
    from ofps_torch.decoders.base import create_decoder
    from ofps_torch.decoders.mvec import write_mvec_frame

    decoder = create_decoder(args.input, args.plugin, device=args.device)
    n = 0
    with open(args.output, "wb") as f:
        while True:
            frame = decoder.process_frame()
            if frame is None or (args.frames and n >= args.frames):
                break
            write_mvec_frame(f, frame.pos, frame.motion)
            n += 1
    print(f"wrote {n} frames to {args.output}")
    return 0


def flow_field(pos, motion, width: int, height: int, capacity: int, device):
    """One frame's vectors -> the (height, width, 2) field flow-extract
    writes, in normalized units, on ``device``: scatter-mean densify,
    hole fill, 11x11 gaussian blur."""
    from ofps_torch.core.motion import Densifier, SparseFlow, gaussian_blur

    flow = SparseFlow.from_arrays(pos, motion, capacity, device=device)
    d = Densifier.zeros(width, height, device=device).add_flow(flow)
    return gaussian_blur(d.interpolate_empty_cells().finalize(), 11)


def cmd_flow_extract(args) -> int:
    import numpy as np

    from ofps_torch.decoders.base import create_decoder
    from ofps_torch.decoders.flo import write_flo

    decoder = create_decoder(args.input, args.plugin, device=args.device)
    os.makedirs(args.output, exist_ok=True)
    w, h = args.width, args.height

    n = 0
    while True:
        frame = decoder.process_frame()
        if frame is None or (args.frames and n >= args.frames):
            break
        field = flow_field(frame.pos, frame.motion, w, h, args.capacity, args.device)
        # Pixel units, as OpenCV's writeOpticalFlow receives them.
        field = field.cpu().numpy() * np.array([w, h], dtype=np.float32)
        write_flo(os.path.join(args.output, f"{n:06}.flo"), field)
        if args.draw_flow:
            from ofps_torch.apps.viz import flow_extract_display, save_png

            save_png(
                os.path.join(args.output, f"{n:06}.png"),
                flow_extract_display(field / np.array([w, h])),
            )
        n += 1
    print(f"wrote {n} .flo files to {args.output}")
    return 0


def cmd_run_config(args) -> int:
    with open(args.config) as f:
        config = json.load(f)
    app = config.get("app")
    if app == "detection":
        from ofps_torch.apps.detection import run_detection_config

        res = run_detection_config(config, device=args.device)
        s = config.get("settings", {})
        ranges = res.filtered_ranges(int(s.get("max_frame_gap", 10)), int(s.get("min_frames", 5)))
        print(f"processed {res.frames} frames; motion ranges: {ranges}")
    elif app == "tracking":
        from ofps_torch.apps.tracking import run_tracking_config

        res = run_tracking_config(config, device=args.device)
        print(f"processed {res.frames} frames with {[t.name for t in res.tracks]}")
        for stage, s in res.perf.summary().items():
            print(f"  {stage}: avg {s['avg_ms']:.2f} ms over {s['frames']}")
        print(f"  consumers: {res.graphs} CUDA graph(s), {res.graph_replays} replays, "
              f"{res.eager_runs} eager runs")
        _print_spans(res.perf)
    else:
        print(f"unknown app {app!r} (want 'detection' or 'tracking')", file=sys.stderr)
        return 1
    return 0


def cmd_info(args) -> int:
    from ofps_torch.decoders.base import available_decoders
    from ofps_torch.detectors.base import available_detectors
    from ofps_torch.estimators.base import available_estimators

    print("decoders:  ", ", ".join(available_decoders()))
    print("estimators:", ", ".join(available_estimators()))
    print("detectors: ", ", ".join(available_detectors()))
    return 0


def cmd_run_batch(args) -> int:
    from ofps_torch.apps.batch import run_batch

    res = run_batch(
        args.inputs,
        estimators=[{"name": n} for n in (args.estimators or "almeida").split(",")],
        detector=None if args.no_detector else "block_motion",
        camera_aspect=args.aspect,
        camera_fov_y=args.fov,
        max_frames=args.frames,
        ground_truths=args.ground_truth or None,
        stats_csv_prefix=args.stats_prefix,
        device=args.device,
    )
    print(
        f"{res.streams} streams x {res.frames} frames; "
        f"{res.throughput_fps():.1f} stream-frames/s over the loop's stages"
    )
    for stage, s in res.perf.summary().items():
        print(f"  {stage}: avg {s['avg_ms']:.2f} ms/batch-step")
    _print_spans(res.perf)
    if res.detections is not None:
        per_stream = res.detections.sum(axis=0)
        print(f"  detections per stream: {per_stream.tolist()}")
    if res.gt_avg_err:
        deg = 180.0 / 3.141592653589793
        for (si, name), avg in sorted(res.gt_avg_err.items()):
            print(
                f"  stream {si} {name}: avg err {avg[0]*deg:.4f} deg "
                f"(r {avg[1]*deg:.4f}, p {avg[2]*deg:.4f}, y {avg[3]*deg:.4f})"
            )
    return 0


def _print_spans(perf) -> None:
    """One line per span of ``perf``: its median host ms a step and, where
    it has one, its median device ms."""
    for name in perf.span_names():
        line = f"  span {name}: median {perf.median_ms(name):.3f} ms"
        device = perf.median_ms(name, device=True)
        print(line if device is None else f"{line}, device {device:.3f} ms")


def cmd_stats(args) -> int:
    from ofps_torch.apps.stats import summarize_stats_dir

    rows = summarize_stats_dir(args.stats_dir, args.out)
    for r in rows:
        print(f"{r['estimator']}: avg err {r['avg_error_deg']:.4f} deg over {r['frames']} frames")
    return 0


def cmd_bench_decode(args) -> int:
    """Host-decode throughput over N parallel DecoderFeed threads (each a
    1-frame-lookahead thread whose libav calls release the GIL)."""
    import time as _time

    from ofps_torch.decoders.base import create_decoder
    from ofps_torch.pipeline.runtime import DecoderFeed

    feeds = [DecoderFeed(create_decoder(args.input, args.plugin, device=args.device))
             for _ in range(args.streams)]
    iters = [iter(f) for f in feeds]
    t0 = _time.perf_counter()
    frames = 0
    live = list(range(len(iters)))
    try:
        while live:
            nxt = []
            for i in live:
                if next(iters[i], None) is not None:
                    frames += 1
                    nxt.append(i)
            live = nxt
    finally:
        for f in feeds:
            f.stop()
    dt = _time.perf_counter() - t0
    print(
        f"{frames} frames from {args.streams} feed(s) in {dt:.2f} s = "
        f"{frames / dt:.1f} frames/s aggregate"
    )
    return 0


def cmd_bench_e2e(args) -> int:
    """End-to-end serving: N parallel decoder feeds through the batched
    step (``run_batch``), reporting sustained stream-frames/s with decode
    and device overlapped.  Each feed is a 1-frame-lookahead thread, so the
    ``decode`` stage measures only the residual wait on the prefetch queue:
    host decode keeps up iff that wait is small next to the step time.
    ``--input`` takes a video or a ``.mvec`` file; without it an MPEG-4
    test clip is encoded (needs FFmpeg).  Prints one JSON line."""
    import time as _time

    from ofps_torch.apps.batch import run_batch

    path = args.input
    if path is None:
        from ofps_torch.decoders.av import encode_test_video

        path = os.path.join(
            tempfile.gettempdir(), f"ofps_e2e_{args.width}x{args.height}_{args.frames}.avi")
        if not os.path.exists(path):
            encode_test_video(path, args.width, args.height, frames=args.frames,
                              gop=30, dx=2.0, dy=1.0, pattern="noise")

    estimators = [{"name": n} for n in (args.estimators.split(",") if args.estimators else [])]
    t0 = _time.perf_counter()
    res = run_batch(
        [path] * args.streams,
        estimators=estimators,
        detector=args.detector or None,
        camera_aspect=args.width / args.height,
        camera_fov_y=90.0,
        max_frames=args.frames,
        drop_ended=False,
        fetch_lag=args.fetch_lag,
        device=args.device,
    )
    wall = _time.perf_counter() - t0
    dec_s = res.perf.stages.get("decode", [])
    step_s = res.perf.stages.get("step", [])
    fetch_s = res.perf.stages.get("fetch", [])
    # Steady state = wall time minus the first frame's decode + step (the
    # first step captures the consumers' CUDA graph).
    decode_ms = 1e3 * sum(dec_s[1:]) / max(len(dec_s) - 1, 1)
    step_ms = 1e3 * sum(step_s[1:]) / max(len(step_s) - 1, 1)
    fetch_ms = 1e3 * sum(fetch_s) / max(len(fetch_s), 1)
    steps = max(res.frames - 1, 1)
    warm = (dec_s[0] if dec_s else 0.0) + (step_s[0] if step_s else 0.0)
    fps = res.frames * res.streams / max(wall, 1e-9)
    fps_steady = steps * res.streams / max(wall - warm, 1e-9)
    print(json.dumps({
        "metric": "e2e_stream_fps",
        "streams": res.streams,
        "frames": res.frames,
        "decode_wait_ms_avg": round(decode_ms, 3),
        "step_ms_avg": round(step_ms, 3),
        "fetch_ms_avg": round(fetch_ms, 3),
        "value": round(fps_steady, 1),
        "wall_fps_incl_compile": round(fps, 1),
        "decode_keeps_up": bool(decode_ms < max(step_ms + fetch_ms, 1e-9)),
    }))
    return 0


def cmd_watch(args) -> int:
    """Live browser view of a running config."""
    from ofps_torch.apps.watch import run_watch

    with open(args.config) as f:
        config = json.load(f)
    return run_watch(config, port=args.port, max_frames=args.frames, hold=args.hold,
                     device=args.device)


def cmd_bench(args) -> int:
    """The port's benchmark on ``--device``, with the arguments after
    ``bench`` (``bench.py``'s flags)."""
    from ofps_torch.apps import bench

    return bench.main(args.rest, device=args.device)


def main(argv=None) -> int:
    import logging

    from ofps_torch.device import resolve_device

    level = os.environ.get("OFPS_LOG", "warning").upper()
    logging.basicConfig(level=getattr(logging, level, logging.WARNING))

    p = argparse.ArgumentParser(prog="ofps-torch", description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--device", default="cuda",
                   help="torch device every subcommand runs on (default cuda)")
    sub = p.add_subparsers(dest="cmd", required=True)

    me = sub.add_parser("motion-extract", help="video -> .mvec dump")
    me.add_argument("input")
    me.add_argument("output")
    me.add_argument("--plugin", default=None)
    me.add_argument("--frames", type=int, default=None)
    me.set_defaults(fn=cmd_motion_extract)

    fe = sub.add_parser("flow-extract", help="video -> .flo files")
    fe.add_argument("input")
    fe.add_argument("output")
    fe.add_argument("--width", type=int, default=150)
    fe.add_argument("--height", type=int, default=84)
    fe.add_argument("--plugin", default=None)
    fe.add_argument("--frames", type=int, default=None)
    fe.add_argument("--capacity", type=int, default=16384)
    fe.add_argument("--draw-flow", action="store_true")
    fe.set_defaults(fn=cmd_flow_extract)

    rc = sub.add_parser("run-config", help="run a JSON app config")
    rc.add_argument("config")
    rc.set_defaults(fn=cmd_run_config)

    info = sub.add_parser("info", help="list registered plugins")
    info.set_defaults(fn=cmd_info)

    rb = sub.add_parser("run-batch", help="process N streams in one batched device step")
    rb.add_argument("inputs", nargs="+")
    rb.add_argument("--estimators", default="almeida")
    rb.add_argument("--no-detector", action="store_true")
    rb.add_argument("--aspect", type=float, default=16.0 / 9.0)
    rb.add_argument("--fov", type=float, default=90.0)
    rb.add_argument("--frames", type=int, default=None)
    rb.add_argument(
        "--ground-truth",
        action="append",
        default=None,
        metavar="GT_CSV",
        help="per-stream GT CSV (repeat once per input, in order; use '' to skip a stream)",
    )
    rb.add_argument("--stats-prefix", default=None,
                    help="write per-stream per-estimator stats CSVs here")
    rb.set_defaults(fn=cmd_run_batch)

    bd = sub.add_parser("bench-decode", help="host decode throughput over N parallel feeds")
    bd.add_argument("input")
    bd.add_argument("--streams", type=int, default=4)
    bd.add_argument("--plugin", default=None)
    bd.set_defaults(fn=cmd_bench_decode)

    e2 = sub.add_parser("bench-e2e", help="host decode feeding the batched device step, sustained")
    e2.add_argument("--input", default=None,
                    help="video/.mvec (default: generated MPEG-4 test clip)")
    e2.add_argument("--streams", type=int, default=8)
    e2.add_argument("--frames", type=int, default=192)
    e2.add_argument("--width", type=int, default=1280)
    e2.add_argument("--height", type=int, default=720)
    e2.add_argument("--estimators", default="almeida,homography")
    e2.add_argument("--detector", default="block_motion")
    e2.add_argument("--fetch-lag", dest="fetch_lag", type=int, default=8)
    e2.set_defaults(fn=cmd_bench_e2e)

    wa = sub.add_parser("watch", help="live browser view (overlay stream + pose trace)")
    wa.add_argument("config", help="tracking/detection JSON config")
    wa.add_argument("--port", type=int, default=8799)
    wa.add_argument("--frames", type=int, default=None)
    wa.add_argument("--hold", action="store_true", help="keep serving after the stream ends")
    wa.set_defaults(fn=cmd_watch)

    st = sub.add_parser("stats", help="summarize exported stats CSVs")
    st.add_argument("stats_dir")
    st.add_argument("--out", default=None)
    st.set_defaults(fn=cmd_stats)

    be = sub.add_parser("bench", add_help=False,
                        help="the port's benchmark (bench.py's flags; one JSON line)")
    be.set_defaults(fn=cmd_bench)

    # ``bench`` hands every argument after it to the benchmark's own parser.
    args, rest = p.parse_known_args(argv)
    if args.cmd != "bench" and rest:
        p.error(f"unrecognized arguments: {' '.join(rest)}")
    args.rest = rest
    args.device = resolve_device(args.device)
    return args.fn(args)


if __name__ == "__main__":
    raise SystemExit(main())
