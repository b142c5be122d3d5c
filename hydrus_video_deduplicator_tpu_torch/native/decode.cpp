// libav*-based video decode + sample + rescale with reference semantics.
//
// The reference decodes every input through PyAV (a thin Cython binding over
// these exact libraries) in vpdqpy.py:59-101 (upstream src/
// hydrusvideodeduplicator/vpdqpy/vpdqpy.py). This module makes the same
// libavformat/libavcodec/libswscale calls directly, so the sampled frame set
// and output pixels match the reference bit-for-bit on the same FFmpeg
// version (and within the reference's own >=99-similarity tolerance across
// versions — reference tests/unit_tests/test_vpdqpy.py:116-128):
//
//   * first video stream in container order   (vpdqpy.py:68 streams.video[0])
//   * decoder thread_type "AUTO"              (vpdqpy.py:69)
//   * sample step = round(avg_frame_rate) with round-half-to-even on the
//     exact rational, None/<1 fps -> every frame (vpdqpy.py:71-77; Python
//     round() over a Fraction)
//   * keep frames where frame_index % step == 0 (vpdqpy.py:89)
//   * rescale to 512x512 rgb24 with SWS_POINT  (vpdqpy.py:90-95; PyAV
//     frame.reformat(..., interpolation=POINT) is sws_scale with SWS_POINT)
//   * an InvalidDataError from the decode generator kills it: the reference
//     catches the error, advances frame_index, and the *next* next() call on
//     the now-closed generator raises StopIteration, ending the stream
//     (vpdqpy.py:85-101 — a Python generator that raised is finished).
//     We reproduce that: first AVERROR_INVALIDDATA ends the stream.
//
// Also contains a small encoder used only to generate the committed test
// corpus (h264/mp4 via libx264, VP9/webm via libvpx, mpeg4/avi, mjpeg) —
// the reference's testdb uses real inter-frame-coded media; ours must too.

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <vector>

extern "C" {
#include <libavcodec/avcodec.h>
#include <libavformat/avformat.h>
#include <libavutil/imgutils.h>
#include <libavutil/opt.h>
#include <libswscale/swscale.h>
}

namespace {

constexpr int kDim = 512;  // DOWNSCALE_DIMENSIONS (vpdqpy.py:23)

struct MemIO {
    const uint8_t* data;
    int64_t size;
    int64_t pos;
};

int mem_read(void* opaque, uint8_t* buf, int buf_size) {
    MemIO* io = static_cast<MemIO*>(opaque);
    int64_t left = io->size - io->pos;
    if (left <= 0) return AVERROR_EOF;
    int n = static_cast<int>(left < buf_size ? left : buf_size);
    memcpy(buf, io->data + io->pos, n);
    io->pos += n;
    return n;
}

int64_t mem_seek(void* opaque, int64_t offset, int whence) {
    MemIO* io = static_cast<MemIO*>(opaque);
    if (whence == AVSEEK_SIZE) return io->size;
    whence &= ~AVSEEK_FORCE;
    int64_t target;
    switch (whence) {
        case SEEK_SET: target = offset; break;
        case SEEK_CUR: target = io->pos + offset; break;
        case SEEK_END: target = io->size + offset; break;
        default: return AVERROR(EINVAL);
    }
    if (target < 0) return AVERROR(EINVAL);
    io->pos = target;
    return target;
}

struct Decoder {
    std::vector<uint8_t> owned;  // copy of the input (caller buffer may die)
    MemIO io{};
    AVIOContext* avio = nullptr;
    AVFormatContext* fmt = nullptr;
    AVCodecContext* codec = nullptr;
    SwsContext* sws = nullptr;
    AVPacket* pkt = nullptr;
    AVFrame* frame = nullptr;
    int stream_index = -1;
    int64_t frame_index = 0;   // decoded-frame counter (vpdqpy.py:85)
    int64_t sampled = 0;       // frames returned to the caller
    int step = 1;
    bool eof_sent = false;     // flush packet delivered to the decoder
    bool finished = false;     // stream ended (EOF or dead generator)
    bool pkt_pending = false;  // pkt holds a packet send_packet EAGAIN'd on
    std::string err;
};

std::string av_errstr(int code) {
    char buf[AV_ERROR_MAX_STRING_SIZE] = {0};
    av_strerror(code, buf, sizeof(buf));
    return std::string(buf);
}

void dec_free(Decoder* d) {
    if (!d) return;
    if (d->sws) sws_freeContext(d->sws);
    if (d->frame) av_frame_free(&d->frame);
    if (d->pkt) av_packet_free(&d->pkt);
    if (d->codec) avcodec_free_context(&d->codec);
    if (d->fmt) avformat_close_input(&d->fmt);
    if (d->avio) {
        av_freep(&d->avio->buffer);
        avio_context_free(&d->avio);
    }
    delete d;
}

// Python round() on the exact rational num/den (den > 0): nearest, ties to
// even. (The reference rounds a Fraction — vpdqpy.py:77.) Uses floored
// division so negative rationals round like Python, and compares the
// remainder against den - rem so nothing can overflow.
int64_t round_half_even(int64_t num, int64_t den) {
    int64_t q = num / den;
    int64_t r = num % den;
    if (r < 0) {  // -> floored division: r in [0, den)
        q -= 1;
        r += den;
    }
    if (r > den - r) return q + 1;
    if (r < den - r) return q;
    return (q % 2 == 0) ? q : q + 1;  // tie -> even
}

int compute_step(const AVRational& r) {
    // None (0/0 or invalid) or < 1 fps -> hash every frame (vpdqpy.py:73-77)
    if (r.num <= 0 || r.den <= 0) return 1;
    if (r.num < r.den) return 1;
    int64_t s = round_half_even(r.num, r.den);
    return s < 1 ? 1 : static_cast<int>(s);
}

// Scale the decoded frame to 512x512 rgb24 with SWS_POINT, exactly as
// PyAV frame.reformat(512, 512, "rgb24", POINT) does (vpdqpy.py:90-95).
bool scale_frame(Decoder* d, const AVFrame* f, uint8_t* out) {
    d->sws = sws_getCachedContext(
        d->sws, f->width, f->height, static_cast<AVPixelFormat>(f->format),
        kDim, kDim, AV_PIX_FMT_RGB24, SWS_POINT, nullptr, nullptr, nullptr);
    if (!d->sws) {
        d->err = "could not create swscale context";
        return false;
    }
    uint8_t* dst[4] = {out, nullptr, nullptr, nullptr};
    int dst_ls[4] = {kDim * 3, 0, 0, 0};
    sws_scale(d->sws, f->data, f->linesize, 0, f->height, dst, dst_ls);
    return true;
}

}  // namespace

extern "C" {

int hvdd_abi_version() { return 1; }

// Exposed for unit tests of the sampling rule.
int64_t hvdd_round_rate(int64_t num, int64_t den) {
    return round_half_even(num, den);
}

// Open a video held in memory. Returns a handle, or NULL with a message in
// errbuf. The input buffer is copied (the handle outlives the caller's
// buffer, like the reference's in-memory BytesIO container, vpdqpy.py:61).
void* hvdd_open(const uint8_t* data, int64_t len, char* errbuf, int errlen) {
    auto fail = [&](const std::string& msg, Decoder* d) -> void* {
        if (errbuf && errlen > 0) snprintf(errbuf, errlen, "%s", msg.c_str());
        dec_free(d);
        return nullptr;
    };
    av_log_set_level(AV_LOG_QUIET);
    Decoder* d = new Decoder();
    d->owned.assign(data, data + len);
    d->io = MemIO{d->owned.data(), len, 0};

    constexpr int kBufSize = 1 << 16;
    uint8_t* iobuf = static_cast<uint8_t*>(av_malloc(kBufSize));
    if (!iobuf) return fail("could not allocate IO buffer", d);
    d->avio = avio_alloc_context(iobuf, kBufSize, 0, &d->io, mem_read, nullptr, mem_seek);
    if (!d->avio) {
        av_free(iobuf);
        return fail("could not allocate AVIO context", d);
    }
    d->fmt = avformat_alloc_context();
    if (!d->fmt) return fail("could not allocate format context", d);
    d->fmt->pb = d->avio;
    int ret = avformat_open_input(&d->fmt, nullptr, nullptr, nullptr);
    if (ret < 0) return fail("could not open input: " + av_errstr(ret), d);
    ret = avformat_find_stream_info(d->fmt, nullptr);
    if (ret < 0) return fail("could not read stream info: " + av_errstr(ret), d);

    // First video stream in container order (streams.video[0], vpdqpy.py:68)
    for (unsigned i = 0; i < d->fmt->nb_streams; ++i) {
        if (d->fmt->streams[i]->codecpar->codec_type == AVMEDIA_TYPE_VIDEO) {
            d->stream_index = static_cast<int>(i);
            break;
        }
    }
    if (d->stream_index < 0) return fail("Video stream not found.", d);

    AVStream* st = d->fmt->streams[d->stream_index];
    const AVCodec* dec = avcodec_find_decoder(st->codecpar->codec_id);
    if (!dec) return fail("no decoder for codec", d);
    d->codec = avcodec_alloc_context3(dec);
    if (!d->codec) return fail("could not allocate codec context", d);
    ret = avcodec_parameters_to_context(d->codec, st->codecpar);
    if (ret < 0) return fail("codec parameters: " + av_errstr(ret), d);
    // thread_type = "AUTO" (vpdqpy.py:69): frame+slice threads, auto count
    d->codec->thread_count = 0;
    d->codec->thread_type = FF_THREAD_FRAME | FF_THREAD_SLICE;
    ret = avcodec_open2(d->codec, dec, nullptr);
    if (ret < 0) return fail("could not open codec: " + av_errstr(ret), d);

    d->pkt = av_packet_alloc();
    d->frame = av_frame_alloc();
    if (!d->pkt || !d->frame) return fail("could not allocate packet/frame", d);
    d->step = compute_step(st->avg_frame_rate);
    return d;
}

// The stream's avg_frame_rate rational (0/0 when unknown).
void hvdd_avg_rate(void* h, int64_t* num, int64_t* den) {
    Decoder* d = static_cast<Decoder*>(h);
    AVRational r = d->fmt->streams[d->stream_index]->avg_frame_rate;
    *num = r.num;
    *den = r.den;
}

int hvdd_step(void* h) { return static_cast<Decoder*>(h)->step; }
int64_t hvdd_frames_seen(void* h) { return static_cast<Decoder*>(h)->frame_index; }
int64_t hvdd_frames_sampled(void* h) { return static_cast<Decoder*>(h)->sampled; }

const char* hvdd_errmsg(void* h) { return static_cast<Decoder*>(h)->err.c_str(); }

// Decode until the next *sampled* frame; write it, scaled to 512x512 rgb24,
// into out (512*512*3 bytes). Returns 1 on frame, 0 at end of stream,
// -1 on error (message via hvdd_errmsg).
int hvdd_next(void* h, uint8_t* out) {
    Decoder* d = static_cast<Decoder*>(h);
    if (d->finished) return 0;
    while (true) {
        int ret = avcodec_receive_frame(d->codec, d->frame);
        if (ret == 0) {
            bool take = (d->frame_index % d->step) == 0;
            d->frame_index++;
            if (!take) {
                av_frame_unref(d->frame);
                continue;
            }
            bool ok = scale_frame(d, d->frame, out);
            av_frame_unref(d->frame);
            if (!ok) return -1;
            d->sampled++;
            return 1;
        }
        if (ret == AVERROR_EOF) {
            d->finished = true;
            return 0;
        }
        if (ret != AVERROR(EAGAIN)) {
            if (ret == AVERROR_INVALIDDATA) {
                // dead-generator semantics (see file header)
                d->frame_index++;
                d->finished = true;
                return 0;
            }
            d->err = "decode error: " + av_errstr(ret);
            return -1;
        }
        // decoder wants input
        if (d->eof_sent) {  // defensive: EAGAIN after flush means EOF
            d->finished = true;
            return 0;
        }
        while (true) {
            if (!d->pkt_pending) {
                ret = av_read_frame(d->fmt, d->pkt);
                if (ret == AVERROR_EOF) {
                    avcodec_send_packet(d->codec, nullptr);  // flush
                    d->eof_sent = true;
                    break;
                }
                if (ret < 0) {
                    if (ret == AVERROR_INVALIDDATA) {
                        d->frame_index++;
                        d->finished = true;
                        return 0;
                    }
                    d->err = "demux error: " + av_errstr(ret);
                    return -1;
                }
                if (d->pkt->stream_index != d->stream_index) {
                    av_packet_unref(d->pkt);
                    continue;
                }
            }
            ret = avcodec_send_packet(d->codec, d->pkt);
            if (ret == AVERROR(EAGAIN)) {
                // decoder wants output drained first: keep the packet and
                // re-send it after the next receive_frame round
                d->pkt_pending = true;
                break;
            }
            d->pkt_pending = false;
            av_packet_unref(d->pkt);
            if (ret == 0) break;
            if (ret == AVERROR_INVALIDDATA) {
                d->frame_index++;
                d->finished = true;
                return 0;
            }
            d->err = "send packet: " + av_errstr(ret);
            return -1;
        }
    }
}

void hvdd_close(void* h) { dec_free(static_cast<Decoder*>(h)); }

// ---------------------------------------------------------------------------
// Encoder (test-corpus generation only; never on the hashing path)
// ---------------------------------------------------------------------------

// Encode n_frames interleaved rgb24 frames (w x h) to `path`. Container
// format is deduced from the filename, codec from codec_name ("libx264",
// "mpeg4", "libvpx-vp9", "mjpeg", ...). With pts_ms == NULL the stream is
// CFR at fps_num/fps_den; otherwise per-frame millisecond timestamps make a
// VFR stream (time_base 1/1000). Single-threaded for determinism.
// Returns 0 on success, <0 with a message in errbuf.
// gop_size > 0 / max_b >= 0 override the defaults (corpus generation
// needs long-GOP B-frame-heavy streams to exercise reordered decode).
int hvdd_encode(const char* path, const char* codec_name, int w, int h,
                int fps_num, int fps_den, const uint8_t* rgb, int n_frames,
                const int64_t* pts_ms, int gop_size, int max_b,
                char* errbuf, int errlen) {
    av_log_set_level(AV_LOG_QUIET);
    AVFormatContext* ofmt = nullptr;
    AVCodecContext* ctx = nullptr;
    SwsContext* sws = nullptr;
    AVFrame* frame = nullptr;
    AVPacket* pkt = nullptr;
    int ret = 0;
    auto fail = [&](const std::string& msg) -> int {
        if (errbuf && errlen > 0) snprintf(errbuf, errlen, "%s", msg.c_str());
        if (sws) sws_freeContext(sws);
        if (frame) av_frame_free(&frame);
        if (pkt) av_packet_free(&pkt);
        if (ctx) avcodec_free_context(&ctx);
        if (ofmt) {
            if (ofmt->pb) avio_closep(&ofmt->pb);
            avformat_free_context(ofmt);
        }
        return -1;
    };

    ret = avformat_alloc_output_context2(&ofmt, nullptr, nullptr, path);
    if (ret < 0 || !ofmt) return fail("output context: " + av_errstr(ret));
    const AVCodec* enc = avcodec_find_encoder_by_name(codec_name);
    if (!enc) return fail(std::string("no encoder: ") + codec_name);
    ctx = avcodec_alloc_context3(enc);
    if (!ctx) return fail("could not allocate encoder context");
    ctx->width = w;
    ctx->height = h;
    ctx->time_base = pts_ms ? AVRational{1, 1000} : AVRational{fps_den, fps_num};
    if (!pts_ms) ctx->framerate = AVRational{fps_num, fps_den};
    ctx->pix_fmt = enc->pix_fmts ? enc->pix_fmts[0] : AV_PIX_FMT_YUV420P;
    ctx->gop_size = gop_size > 0 ? gop_size : 12;
    if (max_b >= 0) ctx->max_b_frames = max_b;
    ctx->thread_count = 1;
    ctx->bit_rate = static_cast<int64_t>(w) * h * 4;  // plenty for tiny corpus clips
    if (strcmp(codec_name, "libx264") == 0) {
        av_opt_set(ctx->priv_data, "preset", "fast", 0);
        av_opt_set(ctx->priv_data, "crf", "18", 0);
        ctx->bit_rate = 0;
    } else if (strcmp(codec_name, "libvpx-vp9") == 0) {
        av_opt_set(ctx->priv_data, "crf", "20", 0);
        av_opt_set(ctx->priv_data, "b", "0", 0);
        av_opt_set(ctx->priv_data, "deadline", "good", 0);
        av_opt_set(ctx->priv_data, "cpu-used", "4", 0);
    } else if (strcmp(codec_name, "mjpeg") == 0) {
        ctx->flags |= AV_CODEC_FLAG_QSCALE;
        ctx->global_quality = FF_QP2LAMBDA * 3;
    }
    if (ofmt->oformat->flags & AVFMT_GLOBALHEADER)
        ctx->flags |= AV_CODEC_FLAG_GLOBAL_HEADER;
    ret = avcodec_open2(ctx, enc, nullptr);
    if (ret < 0) return fail("open encoder: " + av_errstr(ret));

    AVStream* st = avformat_new_stream(ofmt, nullptr);
    if (!st) return fail("new stream");
    st->time_base = ctx->time_base;
    ret = avcodec_parameters_from_context(st->codecpar, ctx);
    if (ret < 0) return fail("stream params: " + av_errstr(ret));

    if (!(ofmt->oformat->flags & AVFMT_NOFILE)) {
        ret = avio_open(&ofmt->pb, path, AVIO_FLAG_WRITE);
        if (ret < 0) return fail("open file: " + av_errstr(ret));
    }
    ret = avformat_write_header(ofmt, nullptr);
    if (ret < 0) return fail("write header: " + av_errstr(ret));

    frame = av_frame_alloc();
    if (!frame) return fail("could not allocate frame");
    frame->width = w;
    frame->height = h;
    frame->format = ctx->pix_fmt;
    ret = av_frame_get_buffer(frame, 0);
    if (ret < 0) return fail("frame buffer: " + av_errstr(ret));
    pkt = av_packet_alloc();
    if (!pkt) return fail("could not allocate packet");
    sws = sws_getContext(w, h, AV_PIX_FMT_RGB24, w, h, ctx->pix_fmt,
                         SWS_BICUBIC, nullptr, nullptr, nullptr);
    if (!sws) return fail("swscale context");

    auto drain = [&](bool flush) -> int {
        int r = avcodec_send_frame(ctx, flush ? nullptr : frame);
        if (r < 0) return r;
        while (true) {
            r = avcodec_receive_packet(ctx, pkt);
            if (r == AVERROR(EAGAIN) || r == AVERROR_EOF) return 0;
            if (r < 0) return r;
            // the mov/mp4 muxer drops trailing samples with unknown duration
            if (pkt->duration == 0) pkt->duration = 1;
            av_packet_rescale_ts(pkt, ctx->time_base, st->time_base);
            pkt->stream_index = st->index;
            r = av_interleaved_write_frame(ofmt, pkt);
            if (r < 0) return r;
        }
    };

    for (int i = 0; i < n_frames; ++i) {
        ret = av_frame_make_writable(frame);
        if (ret < 0) return fail("frame writable: " + av_errstr(ret));
        const uint8_t* src[4] = {rgb + static_cast<int64_t>(i) * w * h * 3,
                                 nullptr, nullptr, nullptr};
        int src_ls[4] = {w * 3, 0, 0, 0};
        sws_scale(sws, src, src_ls, 0, h, frame->data, frame->linesize);
        frame->pts = pts_ms ? pts_ms[i] : i;
        if (strcmp(codec_name, "mjpeg") == 0) frame->quality = ctx->global_quality;
        ret = drain(false);
        if (ret < 0) return fail("encode: " + av_errstr(ret));
    }
    ret = drain(true);
    if (ret < 0) return fail("flush: " + av_errstr(ret));
    ret = av_write_trailer(ofmt);
    if (ret < 0) return fail("trailer: " + av_errstr(ret));

    sws_freeContext(sws);
    av_frame_free(&frame);
    av_packet_free(&pkt);
    avcodec_free_context(&ctx);
    if (ofmt->pb) avio_closep(&ofmt->pb);
    avformat_free_context(ofmt);
    return 0;
}

}  // extern "C"
