// Native host-side codec motion-vector decoder (C ABI over FFmpeg's libav*).
//
// The PyTorch port's own copy of the host decoder of ofps_tpu/native/.
// Equivalent of the reference's av-decoder plugin (av-decoder/src/lib.rs):
// demux any container or tcp:// MPEG-TS stream, decode with the
// `+export_mvs` flag, and surface the AV_FRAME_DATA_MOTION_VECTORS side data
// as normalized (pos, motion) float arrays ready to scatter into the
// device-side SparseFlow layout.  Decode stays on the host CPU (SURVEY.md
// §2.5): the device consumes the MV fields or the decoded frames.
//
// Also exposes a tiny MPEG-4 test-clip encoder so the test suite can
// round-trip codec motion vectors without shipping video assets, and an
// encoder of caller-provided grayscale frames (the evaluation clips).
//
// Build: ofps_torch/decoders/av.py runs g++ -shared on this file at first
// use, linking the system libavformat/avcodec/avutil/swscale.

extern "C" {
#include <libavcodec/avcodec.h>
#include <libavformat/avformat.h>
#include <libavutil/imgutils.h>
#include <libavutil/motion_vector.h>
#include <libavutil/opt.h>
#include <libswscale/swscale.h>
}

#include <cmath>
#include <cstdint>
#include <cstring>

namespace {

struct OfpsAvCtx {
  AVFormatContext *fmt = nullptr;
  AVCodecContext *codec = nullptr;
  AVPacket *pkt = nullptr;
  AVFrame *frame = nullptr;
  SwsContext *sws = nullptr;
  int stream_idx = -1;
};

}  // namespace

extern "C" {

// Opens a URL (file path, or any libavformat protocol incl. tcp://host:port
// and tcp://host:port?listen=1 — the reference's `@` listen mode maps to the
// ?listen=1 option).  Returns NULL on failure.
void *ofps_av_open(const char *url) {
  av_log_set_level(AV_LOG_ERROR);
  auto *ctx = new OfpsAvCtx();

  if (avformat_open_input(&ctx->fmt, url, nullptr, nullptr) < 0) {
    delete ctx;
    return nullptr;
  }
  if (avformat_find_stream_info(ctx->fmt, nullptr) < 0) goto fail;

  {
    const AVCodec *dec = nullptr;
    ctx->stream_idx =
        av_find_best_stream(ctx->fmt, AVMEDIA_TYPE_VIDEO, -1, -1, &dec, 0);
    if (ctx->stream_idx < 0 || !dec) goto fail;

    ctx->codec = avcodec_alloc_context3(dec);
    if (!ctx->codec) goto fail;
    if (avcodec_parameters_to_context(
            ctx->codec, ctx->fmt->streams[ctx->stream_idx]->codecpar) < 0)
      goto fail;

    // The whole point: ask the decoder to export motion vectors
    // (av-decoder/src/lib.rs:267-276 behavior).
    AVDictionary *opts = nullptr;
    av_dict_set(&opts, "flags2", "+export_mvs", 0);
    int rc = avcodec_open2(ctx->codec, dec, &opts);
    av_dict_free(&opts);
    if (rc < 0) goto fail;
  }

  ctx->pkt = av_packet_alloc();
  ctx->frame = av_frame_alloc();
  if (!ctx->pkt || !ctx->frame) goto fail;
  return ctx;

fail:
  if (ctx->codec) avcodec_free_context(&ctx->codec);
  if (ctx->fmt) avformat_close_input(&ctx->fmt);
  delete ctx;
  return nullptr;
}

void ofps_av_close(void *h) {
  auto *ctx = static_cast<OfpsAvCtx *>(h);
  if (!ctx) return;
  if (ctx->sws) sws_freeContext(ctx->sws);
  if (ctx->frame) av_frame_free(&ctx->frame);
  if (ctx->pkt) av_packet_free(&ctx->pkt);
  if (ctx->codec) avcodec_free_context(&ctx->codec);
  if (ctx->fmt) avformat_close_input(&ctx->fmt);
  delete ctx;
}

// Stream metadata: width/height and framerate (stream avg rate, falling back
// to the time base like av-decoder/src/lib.rs:252-257).
int ofps_av_meta(void *h, int *w, int *hgt, double *fps) {
  auto *ctx = static_cast<OfpsAvCtx *>(h);
  if (!ctx || ctx->stream_idx < 0) return -1;
  AVStream *st = ctx->fmt->streams[ctx->stream_idx];
  *w = ctx->codec->width;
  *hgt = ctx->codec->height;
  if (st->avg_frame_rate.num && st->avg_frame_rate.den)
    *fps = av_q2d(st->avg_frame_rate);
  else if (st->time_base.num)
    *fps = (double)st->time_base.den / st->time_base.num;
  else
    *fps = 0.0;
  return 0;
}

// Decodes the next video frame.
//   out_pos/out_mot: float[cap][2] — normalized positions and motions using
//     the reference convention (pos = src/(w,h); motion = -mv/scale/(w,h),
//     av-decoder/src/lib.rs:405-420).
//   out_n: number of motion vectors written.
//   rgba: optional w*h*4 buffer for the decoded frame (swscale conversion).
//   skip: number of video packets to feed-and-drop first (frame skipping).
// Returns 1 if the frame carried motion vectors, 0 if not (e.g. I-frame or
// decoder delay), -1 on EOF, -2 on read/decode error.
int ofps_av_next(void *h, float *out_pos, float *out_mot, int cap, int *out_n,
                 uint8_t *rgba, int skip) {
  auto *ctx = static_cast<OfpsAvCtx *>(h);
  *out_n = 0;
  if (!ctx) return -2;

  for (;;) {
    // Drain any frame already buffered in the decoder first.
    int rc = avcodec_receive_frame(ctx->codec, ctx->frame);
    if (rc == 0) {
      if (skip > 0) {
        skip--;
        av_frame_unref(ctx->frame);
        continue;
      }
      break;  // got a frame
    }
    if (rc != AVERROR(EAGAIN) && rc != AVERROR_EOF) return -2;

    // Feed the next packet of the wanted stream.
    int rr;
    while ((rr = av_read_frame(ctx->fmt, ctx->pkt)) >= 0 &&
           ctx->pkt->stream_index != ctx->stream_idx)
      av_packet_unref(ctx->pkt);
    if (rr < 0) {
      // Flush the decoder at EOF.
      avcodec_send_packet(ctx->codec, nullptr);
      rc = avcodec_receive_frame(ctx->codec, ctx->frame);
      if (rc == 0) break;
      return -1;
    }
    rc = avcodec_send_packet(ctx->codec, ctx->pkt);
    av_packet_unref(ctx->pkt);
    if (rc < 0 && rc != AVERROR(EAGAIN)) return -2;
  }

  int w = ctx->frame->width, hgt = ctx->frame->height;

  if (rgba) {
    ctx->sws = sws_getCachedContext(
        ctx->sws, w, hgt, (AVPixelFormat)ctx->frame->format, w, hgt,
        AV_PIX_FMT_RGBA, SWS_BILINEAR, nullptr, nullptr, nullptr);
    uint8_t *dst[4] = {rgba, nullptr, nullptr, nullptr};
    int dst_ls[4] = {4 * w, 0, 0, 0};
    sws_scale(ctx->sws, ctx->frame->data, ctx->frame->linesize, 0, hgt, dst,
              dst_ls);
  }

  int has = 0;
  AVFrameSideData *sd =
      av_frame_get_side_data(ctx->frame, AV_FRAME_DATA_MOTION_VECTORS);
  if (sd) {
    const auto *mvs = reinterpret_cast<const AVMotionVector *>(sd->data);
    int n = (int)(sd->size / sizeof(AVMotionVector));
    float inv_w = 1.0f / (float)w, inv_h = 1.0f / (float)hgt;
    int k = 0;
    for (int i = 0; i < n && k < cap; i++) {
      const AVMotionVector &mv = mvs[i];
      float scale = (float)mv.motion_scale;
      if (scale == 0.0f) continue;
      out_pos[2 * k] = (float)mv.src_x * inv_w;
      out_pos[2 * k + 1] = (float)mv.src_y * inv_h;
      out_mot[2 * k] = -((float)mv.motion_x / scale) * inv_w;
      out_mot[2 * k + 1] = -((float)mv.motion_y / scale) * inv_h;
      k++;
    }
    *out_n = k;
    has = 1;
  }
  av_frame_unref(ctx->frame);
  return has;
}

// ---------------------------------------------------------------------------
// Deterministic smooth value-noise texture (aperiodic — safe for
// block-matching tests, where a periodic sine pattern aliases).
static float value_noise(float x, float y) {
  float acc = 0.0f, amp = 1.0f;
  for (int oct = 0; oct < 3; oct++) {
    float scale = 1.0f / (24.0f / (float)(1 << oct));
    float fx = x * scale, fy = y * scale;
    int ix = (int)floorf(fx), iy = (int)floorf(fy);
    float tx = fx - ix, ty = fy - iy;
    auto hashv = [](int i, int j) {
      uint32_t n = (uint32_t)(i * 374761393 + j * 668265263);
      n = (n ^ (n >> 13)) * 1274126177u;
      return (float)((n ^ (n >> 16)) & 0xffff) / 65535.0f;
    };
    float v00 = hashv(ix, iy), v10 = hashv(ix + 1, iy);
    float v01 = hashv(ix, iy + 1), v11 = hashv(ix + 1, iy + 1);
    float sx = tx * tx * (3 - 2 * tx), sy = ty * ty * (3 - 2 * ty);
    float v = v00 + (v10 - v00) * sx + (v01 - v00) * sy +
              (v00 - v10 - v01 + v11) * sx * sy;
    acc += (v - 0.5f) * amp;
    amp *= 0.55f;
  }
  return acc;
}

// Test-clip encoder: a smooth texture translating (dx, dy) px/frame,
// MPEG-4 (always built into libavcodec), no B-frames so every inter frame
// carries forward motion vectors.  Lets tests round-trip codec MVs without
// video assets.  pattern: 0 = 2-D sines (periodic), 1 = value noise
// (aperiodic; use for optical-flow tests).
int ofps_av_encode_test_ex(const char *path, int w, int h, int nframes,
                           int gop, float dx, float dy, int pattern,
                           int move_start, int move_stop);
int ofps_av_encode_test_events(const char *path, int w, int h, int nframes,
                               int gop, float dx, float dy, int pattern,
                               const int *starts, const int *stops,
                               int n_events);

int ofps_av_encode_test(const char *path, int w, int h, int nframes, int gop,
                        float dx, float dy) {
  return ofps_av_encode_test_ex(path, w, h, nframes, gop, dx, dy, 0, 0,
                                1 << 30);
}

// move_start/move_stop bound the frames during which the texture translates
// (CCTV-style motion events: still -> moving -> still).
int ofps_av_encode_test_ex(const char *path, int w, int h, int nframes,
                           int gop, float dx, float dy, int pattern,
                           int move_start, int move_stop) {
  return ofps_av_encode_test_events(path, w, h, nframes, gop, dx, dy, pattern,
                                    &move_start, &move_stop, 1);
}

// Shared MPEG-4 encode scaffold: opens `path`, encodes `nframes` luma
// planes produced by `fill(user, t, dst, linesize)` (chroma fixed at
// gray), no B-frames so every inter frame carries forward MVs.
static int encode_clip(const char *path, int w, int h, int nframes, int gop,
                       int64_t bit_rate,
                       void (*fill)(void *, int, uint8_t *, int),
                       void *user) {
  AVFormatContext *fmt = nullptr;
  if (avformat_alloc_output_context2(&fmt, nullptr, nullptr, path) < 0 || !fmt)
    return -1;

  const AVCodec *enc = avcodec_find_encoder(AV_CODEC_ID_MPEG4);
  if (!enc) return -2;
  AVStream *st = avformat_new_stream(fmt, nullptr);
  AVCodecContext *cc = avcodec_alloc_context3(enc);
  if (!st || !cc) return -3;

  cc->width = w;
  cc->height = h;
  cc->pix_fmt = AV_PIX_FMT_YUV420P;
  cc->time_base = {1, 30};
  cc->gop_size = gop;
  cc->max_b_frames = 0;
  cc->bit_rate = bit_rate;
  if (fmt->oformat->flags & AVFMT_GLOBALHEADER)
    cc->flags |= AV_CODEC_FLAG_GLOBAL_HEADER;
  if (avcodec_open2(cc, enc, nullptr) < 0) return -4;
  avcodec_parameters_from_context(st->codecpar, cc);
  st->time_base = cc->time_base;

  if (!(fmt->oformat->flags & AVFMT_NOFILE) &&
      avio_open(&fmt->pb, path, AVIO_FLAG_WRITE) < 0)
    return -5;
  if (avformat_write_header(fmt, nullptr) < 0) return -6;

  AVFrame *fr = av_frame_alloc();
  fr->format = cc->pix_fmt;
  fr->width = w;
  fr->height = h;
  av_frame_get_buffer(fr, 0);
  AVPacket *pkt = av_packet_alloc();

  auto flush = [&](AVFrame *f) -> int {
    if (avcodec_send_frame(cc, f) < 0) return -7;
    for (;;) {
      int rc = avcodec_receive_packet(cc, pkt);
      if (rc == AVERROR(EAGAIN) || rc == AVERROR_EOF) return 0;
      if (rc < 0) return -8;
      av_packet_rescale_ts(pkt, cc->time_base, st->time_base);
      pkt->stream_index = st->index;
      if (av_interleaved_write_frame(fmt, pkt) < 0) return -9;
    }
  };

  for (int t = 0; t < nframes; t++) {
    av_frame_make_writable(fr);
    fill(user, t, fr->data[0], fr->linesize[0]);
    for (int y = 0; y < h / 2; y++) {
      memset(fr->data[1] + y * fr->linesize[1], 128, w / 2);
      memset(fr->data[2] + y * fr->linesize[2], 128, w / 2);
    }
    fr->pts = t;
    int rc = flush(fr);
    if (rc < 0) return rc;
  }
  if (flush(nullptr) < 0) return -10;

  av_write_trailer(fmt);
  av_packet_free(&pkt);
  av_frame_free(&fr);
  avcodec_free_context(&cc);
  if (!(fmt->oformat->flags & AVFMT_NOFILE)) avio_closep(&fmt->pb);
  avformat_free_context(fmt);
  return 0;
}

// Synthetic test-clip generator state: a smooth texture translating
// (dx, dy) px/frame inside the motion-event windows.
struct OfpsTestClipGen {
  float dx, dy, ox, oy;
  int pattern, w, h, n_events;
  const int *starts, *stops;
};

static void ofps_fill_test_clip(void *user, int t, uint8_t *dst, int ls) {
  auto *g = (OfpsTestClipGen *)user;
  bool moving = false;
  for (int e = 0; e < g->n_events; e++)
    if (t >= g->starts[e] && t < g->stops[e]) moving = true;
  if (moving) {
    g->ox += g->dx;
    g->oy += g->dy;
  }
  for (int y = 0; y < g->h; y++) {
    for (int x = 0; x < g->w; x++) {
      float val;
      if (g->pattern == 1) {
        val = 128.0f + 180.0f * value_noise(x - g->ox, y - g->oy);
      } else {
        float u = (x - g->ox) * 0.19f, v = (y - g->oy) * 0.23f;
        val = 128.0f + 55.0f * sinf(u) * cosf(v) +
              35.0f * sinf(0.061f * (x - g->ox) + 0.083f * (y - g->oy));
      }
      dst[y * ls + x] = (uint8_t)(val < 0 ? 0 : (val > 255 ? 255 : val));
    }
  }
}

// Multiple motion-event windows (the 30-min CCTV burglary scenario of the
// reference evaluation, docs/report.tex:919: long still spans punctuated by
// short motion events).
int ofps_av_encode_test_events(const char *path, int w, int h, int nframes,
                               int gop, float dx, float dy, int pattern,
                               const int *starts, const int *stops,
                               int n_events) {
  OfpsTestClipGen g{dx, dy, 0.0f, 0.0f, pattern, w, h, n_events, starts,
                    stops};
  return encode_clip(path, w, h, nframes, gop, (int64_t)w * h * 8,
                     ofps_fill_test_clip, &g);
}

// Caller-provided grayscale frames (row-major uint8, nframes*h*w bytes) ->
// MPEG-4 clip whose inter frames carry codec motion vectors: rendered or
// captured content (the evaluation clips) becomes a codec-MV source.
// bit_rate <= 0 selects the default w*h*8 (same as the test encoder).
struct OfpsGrayFrames {
  const uint8_t *p;
  int w, h;
};

static void ofps_fill_gray(void *user, int t, uint8_t *dst, int ls) {
  auto *g = (OfpsGrayFrames *)user;
  const uint8_t *src = g->p + (size_t)t * g->w * g->h;
  for (int y = 0; y < g->h; y++)
    memcpy(dst + (size_t)y * ls, src + (size_t)y * g->w, g->w);
}

int ofps_av_encode_gray(const char *path, int w, int h, int nframes, int gop,
                        int64_t bit_rate, const uint8_t *frames) {
  OfpsGrayFrames g{frames, w, h};
  if (bit_rate <= 0) bit_rate = (int64_t)w * h * 8;
  return encode_clip(path, w, h, nframes, gop, bit_rate, ofps_fill_gray, &g);
}

}  // extern "C"
