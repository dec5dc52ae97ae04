// vscmedia — native media engine for vsc_tpu
// ===========================================
//
// Replaces the reference pipeline's external ffmpeg/ffprobe subprocess layer
// (reference frame_extractor.py:88-111, chunk_generator.py:241-267,
//  video_concatenator.py:198-254, helper/ffmpeg_utils.py:59-101) with one
// small native tool built directly on libavformat/libavcodec/libswscale.
//
// Subcommands:
//   probe    <video>                         -> one-line JSON metadata
//   extract  <video> <outdir> [opts]         -> decode frames to PNG files
//   decode   <video> [opts]                  -> raw RGB24 frames on stdout
//   encode   [opts]                          -> PNG sequence or raw stdin -> x265 .mkv
//   concat   --list f --output o [--audio a] -> stream-copy concat + audio mux
//   makevideo [opts]                         -> synthetic test video (+sine audio)
//
// Progress is reported as "frame=N" lines on stdout (flushed), matching the
// ffmpeg -progress convention the reference orchestrator parses
// (reference workflow_orchestrator.py:642-709).

#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <cstdint>
#include <cmath>
#include <string>
#include <vector>
#include <memory>
#include <chrono>

extern "C" {
#include <libavformat/avformat.h>
#include <libavcodec/avcodec.h>
#include <libavutil/avutil.h>
#include <libavutil/opt.h>
#include <libavutil/imgutils.h>
#include <libavutil/channel_layout.h>
#include <libavutil/parseutils.h>
#include <libswscale/swscale.h>
}

namespace {

[[noreturn]] void die(const std::string& msg, int err = 0) {
    if (err != 0) {
        char buf[256];
        av_strerror(err, buf, sizeof(buf));
        fprintf(stderr, "vscmedia: %s: %s\n", msg.c_str(), buf);
    } else {
        fprintf(stderr, "vscmedia: %s\n", msg.c_str());
    }
    exit(1);
}

double now_seconds() {
    using namespace std::chrono;
    return duration<double>(steady_clock::now().time_since_epoch()).count();
}

struct Progress {
    double last = 0.0;
    void tick(int64_t frame, bool force = false) {
        double t = now_seconds();
        if (force || t - last >= 0.25) {
            printf("frame=%lld\n", (long long)frame);
            fflush(stdout);
            last = t;
        }
    }
};

std::string json_escape(const char* s) {
    std::string out;
    for (const char* p = s; p && *p; ++p) {
        if (*p == '"' || *p == '\\') { out += '\\'; out += *p; }
        else if ((unsigned char)*p < 0x20) { char b[8]; snprintf(b, 8, "\\u%04x", *p); out += b; }
        else out += *p;
    }
    return out;
}

// ---------------------------------------------------------------- input video

struct InputVideo {
    AVFormatContext* fmt = nullptr;
    AVCodecContext* dec = nullptr;
    int vstream = -1;
    int astream = -1;

    void open(const char* path, AVDictionary** opts = nullptr, const AVInputFormat* ifmt = nullptr) {
        int ret = avformat_open_input(&fmt, path, ifmt, opts);
        if (ret < 0) die(std::string("cannot open input: ") + path, ret);
        ret = avformat_find_stream_info(fmt, nullptr);
        if (ret < 0) die("cannot read stream info", ret);
        vstream = av_find_best_stream(fmt, AVMEDIA_TYPE_VIDEO, -1, -1, nullptr, 0);
        astream = av_find_best_stream(fmt, AVMEDIA_TYPE_AUDIO, -1, -1, nullptr, 0);
        if (vstream < 0) die("no video stream found");
    }

    void open_decoder() {
        AVStream* st = fmt->streams[vstream];
        const AVCodec* codec = avcodec_find_decoder(st->codecpar->codec_id);
        if (!codec) die("no decoder for video codec");
        dec = avcodec_alloc_context3(codec);
        avcodec_parameters_to_context(dec, st->codecpar);
        dec->thread_count = 0;  // auto
        int ret = avcodec_open2(dec, codec, nullptr);
        if (ret < 0) die("cannot open decoder", ret);
    }

    ~InputVideo() {
        if (dec) avcodec_free_context(&dec);
        if (fmt) avformat_close_input(&fmt);
    }
};

// Decode video frames, invoking fn(AVFrame*); stops demuxing as soon as
// max_frames have been decoded (-1 = all). Returns frame count.
template <typename F>
int64_t for_each_frame(InputVideo& in, F&& fn, int64_t max_frames = -1) {
    AVPacket* pkt = av_packet_alloc();
    AVFrame* frame = av_frame_alloc();
    int64_t n = 0;
    auto done = [&]() { return max_frames >= 0 && n >= max_frames; };
    auto drain = [&]() {
        while (!done() && avcodec_receive_frame(in.dec, frame) == 0) {
            fn(frame);
            ++n;
            av_frame_unref(frame);
        }
    };
    while (!done() && av_read_frame(in.fmt, pkt) >= 0) {
        if (pkt->stream_index == in.vstream) {
            if (avcodec_send_packet(in.dec, pkt) == 0) drain();
        }
        av_packet_unref(pkt);
    }
    if (!done()) {
        avcodec_send_packet(in.dec, nullptr);
        drain();
    }
    av_packet_free(&pkt);
    av_frame_free(&frame);
    return n;
}

// ---------------------------------------------------------------- probe

int cmd_probe(int argc, char** argv) {
    if (argc < 1) die("usage: vscmedia probe <video>");
    InputVideo in;
    in.open(argv[0]);

    AVStream* v = in.fmt->streams[in.vstream];
    double duration = in.fmt->duration != AV_NOPTS_VALUE
        ? (double)in.fmt->duration / AV_TIME_BASE : 0.0;
    if (duration <= 0.0 && v->duration != AV_NOPTS_VALUE)
        duration = v->duration * av_q2d(v->time_base);

    AVRational rfr = v->r_frame_rate;
    AVRational afr = v->avg_frame_rate;
    // r_frame_rate on matroska demux is estimated from ms-rounded timestamps
    // and wobbles on short chunks; the container's DefaultDuration (afr) is
    // authoritative for CFR content. Snap rfr to afr when they agree within
    // the rounding error a 1 ms timebase can introduce.
    if (afr.num > 0 && afr.den > 0 && rfr.num > 0 && rfr.den > 0) {
        double r = av_q2d(rfr), a = av_q2d(afr);
        if (r != a && a > 0 && std::abs(r / a - 1.0) < 0.03) rfr = afr;
    }
    const char* vcodec = avcodec_get_name(v->codecpar->codec_id);
    int64_t nb = v->nb_frames;
    if (nb == 0 && duration > 0 && afr.num > 0)
        nb = (int64_t)(duration * av_q2d(afr));

    printf("{\"duration\": %.6f, \"r_frame_rate\": \"%d/%d\", \"avg_frame_rate\": \"%d/%d\", "
           "\"width\": %d, \"height\": %d, \"nb_frames\": %lld, \"has_audio\": %s, "
           "\"vcodec\": \"%s\", \"pix_fmt\": \"%s\"}\n",
           duration, rfr.num, rfr.den, afr.num, afr.den,
           v->codecpar->width, v->codecpar->height, (long long)nb,
           in.astream >= 0 ? "true" : "false",
           json_escape(vcodec).c_str(),
           json_escape(av_get_pix_fmt_name((AVPixelFormat)v->codecpar->format)).c_str());
    return 0;
}

// ------------------------------------------------------- RGB conversion state

struct RgbConverter {
    SwsContext* sws = nullptr;
    AVFrame* rgb = nullptr;
    int w = 0, h = 0;
    AVPixelFormat src_fmt = AV_PIX_FMT_NONE;

    AVFrame* convert(AVFrame* src) {
        if (!sws || src->width != w || src->height != h ||
            (AVPixelFormat)src->format != src_fmt) {
            if (sws) sws_freeContext(sws);
            if (rgb) av_frame_free(&rgb);
            w = src->width; h = src->height; src_fmt = (AVPixelFormat)src->format;
            sws = sws_getContext(w, h, src_fmt, w, h, AV_PIX_FMT_RGB24,
                                 SWS_BILINEAR, nullptr, nullptr, nullptr);
            if (!sws) die("cannot create swscale context");
            rgb = av_frame_alloc();
            rgb->format = AV_PIX_FMT_RGB24;
            rgb->width = w; rgb->height = h;
            av_frame_get_buffer(rgb, 32);
        }
        sws_scale(sws, src->data, src->linesize, 0, h, rgb->data, rgb->linesize);
        return rgb;
    }

    ~RgbConverter() {
        if (sws) sws_freeContext(sws);
        if (rgb) av_frame_free(&rgb);
    }
};

// ---------------------------------------------------------------- extract

// PNG encoder reused across frames (same geometry).
struct PngEncoder {
    AVCodecContext* enc = nullptr;
    AVPacket* pkt = nullptr;

    void ensure(int w, int h) {
        if (enc && enc->width == w && enc->height == h) return;
        if (enc) avcodec_free_context(&enc);
        const AVCodec* codec = avcodec_find_encoder(AV_CODEC_ID_PNG);
        if (!codec) die("PNG encoder unavailable");
        enc = avcodec_alloc_context3(codec);
        enc->width = w; enc->height = h;
        enc->pix_fmt = AV_PIX_FMT_RGB24;
        enc->time_base = {1, 25};
        enc->compression_level = 1;  // fast; intermediates are transient
        if (avcodec_open2(enc, codec, nullptr) < 0) die("cannot open PNG encoder");
        if (!pkt) pkt = av_packet_alloc();
    }

    // Encode one RGB24 frame and write it to path.
    void write(AVFrame* rgb, const std::string& path) {
        ensure(rgb->width, rgb->height);
        rgb->pts = 0;
        if (avcodec_send_frame(enc, rgb) < 0) die("png send_frame failed");
        if (avcodec_receive_packet(enc, pkt) < 0) die("png receive_packet failed");
        FILE* f = fopen(path.c_str(), "wb");
        if (!f) die("cannot write " + path);
        fwrite(pkt->data, 1, pkt->size, f);
        fclose(f);
        av_packet_unref(pkt);
        // drain any extra packets (PNG emits exactly one, but be safe)
        while (avcodec_receive_packet(enc, pkt) == 0) av_packet_unref(pkt);
    }

    ~PngEncoder() {
        if (enc) avcodec_free_context(&enc);
        if (pkt) av_packet_free(&pkt);
    }
};

// running index for the extract callback
int64_t png_counter = 0;

int cmd_extract(int argc, char** argv) {
    if (argc < 2) die("usage: vscmedia extract <video> <outdir> [--pattern frame_%06d.png] [--start-number 1]");
    const char* video = argv[0];
    std::string outdir = argv[1];
    std::string pattern = "frame_%06d.png";
    int64_t start_number = 1;
    for (int i = 2; i < argc; ++i) {
        if (!strcmp(argv[i], "--pattern") && i + 1 < argc) pattern = argv[++i];
        else if (!strcmp(argv[i], "--start-number") && i + 1 < argc) start_number = atoll(argv[++i]);
    }

    InputVideo in;
    in.open(video);
    in.open_decoder();
    RgbConverter conv;
    PngEncoder png;
    Progress prog;

    int64_t count = for_each_frame(in, [&](AVFrame* f) {
        AVFrame* rgb = conv.convert(f);
        char name[512];
        snprintf(name, sizeof(name), pattern.c_str(),
                 (long long)(start_number + png_counter));
        png.write(rgb, outdir + "/" + name);
        ++png_counter;
        prog.tick(png_counter);
    });
    prog.tick(count, true);
    fprintf(stderr, "extracted %lld frames\n", (long long)count);
    return 0;
}

// ---------------------------------------------------------------- decode

int cmd_decode(int argc, char** argv) {
    if (argc < 1) die("usage: vscmedia decode <video> [--start N --count M]");
    const char* video = argv[0];
    int64_t start = 0, count = -1;
    for (int i = 1; i < argc; ++i) {
        if (!strcmp(argv[i], "--start") && i + 1 < argc) start = atoll(argv[++i]);
        else if (!strcmp(argv[i], "--count") && i + 1 < argc) count = atoll(argv[++i]);
    }
    InputVideo in;
    in.open(video);
    in.open_decoder();
    RgbConverter conv;
    int64_t idx = 0, emitted = 0;
    int64_t max_frames = count >= 0 ? start + count : -1;
    for_each_frame(in, [&](AVFrame* f) {
        if (idx++ < start) return;
        if (count >= 0 && emitted >= count) return;
        AVFrame* rgb = conv.convert(f);
        for (int y = 0; y < rgb->height; ++y)
            fwrite(rgb->data[0] + y * rgb->linesize[0], 1, rgb->width * 3, stdout);
        ++emitted;
    }, max_frames);
    fflush(stdout);
    fprintf(stderr, "decoded %lld frames\n", (long long)emitted);
    return 0;
}

// ---------------------------------------------------------------- encoding core

struct VideoEncoder {
    AVFormatContext* ofmt = nullptr;
    AVCodecContext* enc = nullptr;
    AVStream* stream = nullptr;
    SwsContext* sws = nullptr;
    AVFrame* yuv = nullptr;
    AVPacket* pkt = nullptr;
    int64_t next_pts = 0;

    void open(const std::string& path, int w, int h, AVRational framerate,
              int crf, const std::string& preset, const std::string& codec_name,
              const std::string& pix_fmt_name) {
        const AVCodec* codec = avcodec_find_encoder_by_name(codec_name.c_str());
        if (!codec) die("encoder not available: " + codec_name);

        int ret = avformat_alloc_output_context2(&ofmt, nullptr, "matroska", path.c_str());
        if (ret < 0 || !ofmt) die("cannot allocate output context", ret);

        enc = avcodec_alloc_context3(codec);
        enc->width = w;
        enc->height = h;
        AVPixelFormat pf = av_get_pix_fmt(pix_fmt_name.c_str());
        if (pf == AV_PIX_FMT_NONE) die("unknown pix_fmt: " + pix_fmt_name);
        enc->pix_fmt = pf;
        enc->time_base = av_inv_q(framerate);
        enc->framerate = framerate;
        enc->thread_count = 0;
        if (ofmt->oformat->flags & AVFMT_GLOBALHEADER)
            enc->flags |= AV_CODEC_FLAG_GLOBAL_HEADER;
        if (codec_name == "libx265" || codec_name == "libx264") {
            av_opt_set(enc->priv_data, "preset", preset.c_str(), 0);
            av_opt_set_double(enc->priv_data, "crf", crf, 0);
            if (codec_name == "libx265")
                av_opt_set(enc->priv_data, "x265-params", "log-level=error", 0);
        } else {
            enc->bit_rate = (int64_t)w * h * 4;  // generic fallback
        }
        ret = avcodec_open2(enc, codec, nullptr);
        if (ret < 0) die("cannot open encoder " + codec_name, ret);

        stream = avformat_new_stream(ofmt, nullptr);
        stream->time_base = enc->time_base;
        // matroska stores timestamps at ms precision; DefaultDuration (from
        // avg_frame_rate) preserves the exact CFR rate for tiny chunks where
        // timestamp-derived estimates wobble (e.g. 5 frames -> "293/12").
        stream->avg_frame_rate = framerate;
        avcodec_parameters_from_context(stream->codecpar, enc);

        if (!(ofmt->oformat->flags & AVFMT_NOFILE)) {
            ret = avio_open(&ofmt->pb, path.c_str(), AVIO_FLAG_WRITE);
            if (ret < 0) die("cannot open output file " + path, ret);
        }
        ret = avformat_write_header(ofmt, nullptr);
        if (ret < 0) die("cannot write header", ret);

        yuv = av_frame_alloc();
        yuv->format = enc->pix_fmt;
        yuv->width = w;
        yuv->height = h;
        av_frame_get_buffer(yuv, 32);
        pkt = av_packet_alloc();
    }

    void mux_pending() {
        while (true) {
            int ret = avcodec_receive_packet(enc, pkt);
            if (ret == AVERROR(EAGAIN) || ret == AVERROR_EOF) break;
            if (ret < 0) die("encode error", ret);
            av_packet_rescale_ts(pkt, enc->time_base, stream->time_base);
            pkt->stream_index = stream->index;
            ret = av_interleaved_write_frame(ofmt, pkt);
            if (ret < 0) die("write_frame failed", ret);
        }
    }

    // src is any decodable frame; converted to the encoder pix_fmt.
    void push(AVFrame* src) {
        if (!sws) {
            sws = sws_getContext(src->width, src->height, (AVPixelFormat)src->format,
                                 enc->width, enc->height, enc->pix_fmt,
                                 SWS_BILINEAR, nullptr, nullptr, nullptr);
            if (!sws) die("cannot create encode swscale context");
        }
        av_frame_make_writable(yuv);
        sws_scale(sws, src->data, src->linesize, 0, src->height, yuv->data, yuv->linesize);
        yuv->pts = next_pts++;
        if (avcodec_send_frame(enc, yuv) < 0) die("send_frame failed");
        mux_pending();
    }

    void finish() {
        avcodec_send_frame(enc, nullptr);
        mux_pending();
        av_write_trailer(ofmt);
        if (!(ofmt->oformat->flags & AVFMT_NOFILE)) avio_closep(&ofmt->pb);
    }

    ~VideoEncoder() {
        if (sws) sws_freeContext(sws);
        if (yuv) av_frame_free(&yuv);
        if (pkt) av_packet_free(&pkt);
        if (enc) avcodec_free_context(&enc);
        if (ofmt) avformat_free_context(ofmt);
    }
};

AVRational parse_rational(const std::string& s) {
    AVRational r;
    if (av_parse_video_rate(&r, s.c_str()) < 0) die("bad framerate: " + s);
    return r;
}

int cmd_encode(int argc, char** argv) {
    std::string output, preset = "slow", codec = "libx265", pix_fmt = "yuv420p10le";
    std::string input_pattern, framerate = "25/1";
    int crf = 19;
    int64_t start_number = 0, frames = -1;
    int raw_w = 0, raw_h = 0;
    for (int i = 0; i < argc; ++i) {
        std::string a = argv[i];
        auto next = [&]() -> const char* {
            if (i + 1 >= argc) die("missing value for " + a);
            return argv[++i];
        };
        if (a == "--output") output = next();
        else if (a == "--input-pattern") input_pattern = next();
        else if (a == "--framerate") framerate = next();
        else if (a == "--crf") crf = atoi(next());
        else if (a == "--preset") preset = next();
        else if (a == "--codec") codec = next();
        else if (a == "--pix-fmt") pix_fmt = next();
        else if (a == "--start-number") start_number = atoll(next());
        else if (a == "--frames") frames = atoll(next());
        else if (a == "--raw") { raw_w = atoi(next()); raw_h = atoi(next()); }
        else die("unknown encode option: " + a);
    }
    if (output.empty()) die("encode: --output required");
    AVRational fr = parse_rational(framerate);

    VideoEncoder venc;
    Progress prog;
    int64_t n = 0;

    if (!input_pattern.empty()) {
        // PNG (or any image2) sequence input, like the reference chunk encoder
        // command (reference chunk_generator.py:241-254).
        const AVInputFormat* image2 = av_find_input_format("image2");
        AVDictionary* opts = nullptr;
        av_dict_set(&opts, "framerate", framerate.c_str(), 0);
        av_dict_set_int(&opts, "start_number", start_number, 0);
        InputVideo in;
        in.open(input_pattern.c_str(), &opts, image2);
        av_dict_free(&opts);
        in.open_decoder();
        bool opened = false;
        for_each_frame(in, [&](AVFrame* f) {
            if (frames >= 0 && n >= frames) return;
            if (!opened) {
                venc.open(output, f->width, f->height, fr, crf, preset, codec, pix_fmt);
                opened = true;
            }
            venc.push(f);
            ++n;
            prog.tick(n);
        }, frames);
        if (!opened) die("no input frames found for pattern: " + input_pattern);
    } else if (raw_w > 0 && raw_h > 0) {
        // Raw RGB24 frames on stdin: the zero-copy path from the TPU pipeline
        // (no PNG round-trip).
        venc.open(output, raw_w, raw_h, fr, crf, preset, codec, pix_fmt);
        AVFrame* rgb = av_frame_alloc();
        rgb->format = AV_PIX_FMT_RGB24;
        rgb->width = raw_w;
        rgb->height = raw_h;
        av_frame_get_buffer(rgb, 32);
        size_t row = (size_t)raw_w * 3;
        std::vector<uint8_t> buf(row * raw_h);
        while (frames < 0 || n < frames) {
            size_t got = fread(buf.data(), 1, buf.size(), stdin);
            if (got < buf.size()) break;
            av_frame_make_writable(rgb);
            for (int y = 0; y < raw_h; ++y)
                memcpy(rgb->data[0] + y * rgb->linesize[0], buf.data() + y * row, row);
            venc.push(rgb);
            ++n;
            prog.tick(n);
        }
        av_frame_free(&rgb);
    } else {
        die("encode: need --input-pattern or --raw W H");
    }

    venc.finish();
    prog.tick(n, true);
    fprintf(stderr, "encoded %lld frames\n", (long long)n);
    return 0;
}

// ---------------------------------------------------------------- concat

struct ConcatEntry {
    std::string path;
    double inpoint = 0.0;
};

// Parse the ffmpeg concat-demuxer file format the reference writes
// (reference video_concatenator.py:203-209): lines of
//   file '<path>'
//   inpoint <seconds>
std::vector<ConcatEntry> parse_concat_list(const std::string& list_path) {
    FILE* f = fopen(list_path.c_str(), "r");
    if (!f) die("cannot open concat list: " + list_path);
    std::vector<ConcatEntry> entries;
    char line[4096];
    while (fgets(line, sizeof(line), f)) {
        std::string s = line;
        while (!s.empty() && (s.back() == '\n' || s.back() == '\r')) s.pop_back();
        if (s.rfind("file ", 0) == 0) {
            std::string p = s.substr(5);
            if (!p.empty() && p.front() == '\'') p = p.substr(1, p.rfind('\'') - 1);
            // un-escape the concat-format quote escape '\''
            std::string clean;
            for (size_t i = 0; i < p.size(); ++i) {
                if (p.compare(i, 4, "'\\''") == 0) { clean += '\''; i += 3; }
                else clean += p[i];
            }
            entries.push_back({clean, 0.0});
        } else if (s.rfind("inpoint ", 0) == 0 && !entries.empty()) {
            entries.back().inpoint = atof(s.c_str() + 8);
        }
    }
    fclose(f);
    return entries;
}

int cmd_concat(int argc, char** argv) {
    std::string list_path, output, audio_path;
    for (int i = 0; i < argc; ++i) {
        std::string a = argv[i];
        auto next = [&]() -> const char* {
            if (i + 1 >= argc) die("missing value for " + a);
            return argv[++i];
        };
        if (a == "--list") list_path = next();
        else if (a == "--output") output = next();
        else if (a == "--audio") audio_path = next();
        else die("unknown concat option: " + a);
    }
    if (list_path.empty() || output.empty()) die("concat: --list and --output required");

    std::vector<ConcatEntry> entries = parse_concat_list(list_path);
    if (entries.empty()) die("concat list is empty");

    // Output context with video stream copied from the first chunk.
    InputVideo first;
    first.open(entries[0].path.c_str());
    AVStream* v0 = first.fmt->streams[first.vstream];

    AVFormatContext* ofmt = nullptr;
    int ret = avformat_alloc_output_context2(&ofmt, nullptr, "matroska", output.c_str());
    if (ret < 0) die("cannot allocate output", ret);

    AVStream* out_v = avformat_new_stream(ofmt, nullptr);
    avcodec_parameters_copy(out_v->codecpar, v0->codecpar);
    out_v->codecpar->codec_tag = 0;
    out_v->time_base = v0->time_base;
    out_v->avg_frame_rate = v0->avg_frame_rate;
    out_v->r_frame_rate = v0->r_frame_rate;

    // Optional audio stream copied from the audio source (the original input
    // video), matching `-map 1:a? -c:a copy`
    // (reference video_concatenator.py:221-228).
    AVFormatContext* afmt = nullptr;
    int a_in_idx = -1;
    AVStream* out_a = nullptr;
    if (!audio_path.empty()) {
        ret = avformat_open_input(&afmt, audio_path.c_str(), nullptr, nullptr);
        if (ret >= 0 && avformat_find_stream_info(afmt, nullptr) >= 0) {
            a_in_idx = av_find_best_stream(afmt, AVMEDIA_TYPE_AUDIO, -1, -1, nullptr, 0);
            if (a_in_idx >= 0) {
                out_a = avformat_new_stream(ofmt, nullptr);
                avcodec_parameters_copy(out_a->codecpar, afmt->streams[a_in_idx]->codecpar);
                out_a->codecpar->codec_tag = 0;
                out_a->time_base = afmt->streams[a_in_idx]->time_base;
            }
        }
        if (a_in_idx < 0)
            fprintf(stderr, "warning: no audio stream in %s, output will be silent\n",
                    audio_path.c_str());
    }

    if (!(ofmt->oformat->flags & AVFMT_NOFILE)) {
        ret = avio_open(&ofmt->pb, output.c_str(), AVIO_FLAG_WRITE);
        if (ret < 0) die("cannot open output " + output, ret);
    }
    ret = avformat_write_header(ofmt, nullptr);
    if (ret < 0) die("cannot write output header", ret);

    AVPacket* pkt = av_packet_alloc();

    // Pull audio packets up to a given output time (seconds).
    auto write_audio_until = [&](double t_limit) {
        if (!out_a) return;
        while (av_read_frame(afmt, pkt) >= 0) {
            if (pkt->stream_index != a_in_idx) { av_packet_unref(pkt); continue; }
            double t = pkt->pts == AV_NOPTS_VALUE ? 0.0
                : pkt->pts * av_q2d(afmt->streams[a_in_idx]->time_base);
            av_packet_rescale_ts(pkt, afmt->streams[a_in_idx]->time_base, out_a->time_base);
            pkt->stream_index = out_a->index;
            av_interleaved_write_frame(ofmt, pkt);
            if (t >= t_limit) return;  // packet consumed; resume next call
        }
    };

    // Copy video packets chunk by chunk, offsetting timestamps. For
    // overlapping chunks (inpoint > 0) the offset is reduced by the inpoint so
    // the duplicated first frame coincides with the previous chunk's last
    // frame instead of extending the timeline — the stream-copy analogue of
    // the reference's concat-demuxer inpoint skip
    // (reference video_concatenator.py:188-209, README.md:248).
    //
    // B-frame reordering detail: the matroska demuxer emits the first few
    // packets of each chunk with dts=NOPTS (decoder reorder delay), and the
    // interleaving muxer would mis-sort them. We buffer leading NOPTS packets
    // until the first inferred dts arrives, then back-fill synthetic dts at
    // one frame-duration spacing below it, keeping dts monotonic and <= pts.
    ofmt->avoid_negative_ts = AVFMT_AVOID_NEG_TS_DISABLED;
    double offset_s = 0.0;  // output-seconds where the current chunk starts
    Progress prog;
    int64_t packets = 0;
    int64_t last_out_dts = INT64_MIN;  // in out_v->time_base
    for (size_t ci = 0; ci < entries.size(); ++ci) {
        InputVideo in;
        in.open(entries[ci].path.c_str());
        AVStream* vs = in.fmt->streams[in.vstream];
        double chunk_start = offset_s - entries[ci].inpoint;
        int64_t off_pts = av_rescale_q((int64_t)llround(chunk_start * 1e6),
                                       {1, 1000000}, vs->time_base);
        double max_end = 0.0;
        std::vector<AVPacket*> pending;  // leading packets with dts == NOPTS

        auto emit = [&](AVPacket* p) {
            av_packet_rescale_ts(p, vs->time_base, out_v->time_base);
            // Never step dts backwards across chunk boundaries (equal is OK
            // for matroska, which stores only pts).
            if (p->dts != AV_NOPTS_VALUE && last_out_dts != INT64_MIN &&
                p->dts < last_out_dts)
                p->dts = last_out_dts;
            if (p->dts != AV_NOPTS_VALUE && p->pts != AV_NOPTS_VALUE &&
                p->pts < p->dts)
                p->pts = p->dts;
            if (p->dts != AV_NOPTS_VALUE) last_out_dts = p->dts;
            p->stream_index = out_v->index;
            av_interleaved_write_frame(ofmt, p);
            ++packets;
        };

        while (av_read_frame(in.fmt, pkt) >= 0) {
            if (pkt->stream_index != in.vstream) { av_packet_unref(pkt); continue; }
            double pts_s = pkt->pts == AV_NOPTS_VALUE ? 0.0 : pkt->pts * av_q2d(vs->time_base);
            double dur_s = pkt->duration > 0 ? pkt->duration * av_q2d(vs->time_base) : 0.0;
            if (pts_s + dur_s > max_end) max_end = pts_s + dur_s;

            if (pkt->pts != AV_NOPTS_VALUE) pkt->pts += off_pts;
            if (pkt->dts != AV_NOPTS_VALUE) pkt->dts += off_pts;

            if (pkt->dts == AV_NOPTS_VALUE && pending.size() < 64) {
                pending.push_back(av_packet_clone(pkt));
                av_packet_unref(pkt);
                continue;
            }
            if (!pending.empty()) {
                // First known dts: back-fill the buffered reorder window.
                int64_t dur = pkt->duration > 0 ? pkt->duration
                    : av_rescale_q(1, av_inv_q(vs->avg_frame_rate), vs->time_base);
                if (dur <= 0) dur = 1;
                int64_t base = pkt->dts != AV_NOPTS_VALUE
                    ? pkt->dts : (pkt->pts != AV_NOPTS_VALUE ? pkt->pts : off_pts);
                for (size_t i = 0; i < pending.size(); ++i) {
                    AVPacket* p = pending[i];
                    p->dts = base - (int64_t)(pending.size() - i) * dur;
                    emit(p);
                    av_packet_free(&pending[i]);
                }
                pending.clear();
            }
            emit(pkt);
            av_packet_unref(pkt);
            if ((packets & 63) == 0) {
                prog.tick(packets);
                write_audio_until(chunk_start + pts_s);
            }
        }
        // Intra-only stream where every dts stayed NOPTS: dts = pts is valid.
        for (size_t i = 0; i < pending.size(); ++i) {
            pending[i]->dts = pending[i]->pts;
            emit(pending[i]);
            av_packet_free(&pending[i]);
        }
        pending.clear();
        offset_s = chunk_start + max_end;
    }
    write_audio_until(1e18);  // drain remaining audio

    av_write_trailer(ofmt);
    if (!(ofmt->oformat->flags & AVFMT_NOFILE)) avio_closep(&ofmt->pb);
    if (afmt) avformat_close_input(&afmt);
    av_packet_free(&pkt);
    avformat_free_context(ofmt);
    prog.tick(packets, true);
    fprintf(stderr, "concatenated %zu chunks (%lld packets)\n", entries.size(),
            (long long)packets);
    return 0;
}

// ---------------------------------------------------------------- makevideo

// Synthetic test video generator (replaces `ffmpeg -f lavfi -i testsrc` for
// tests/benchmarks): moving gradient + bouncing block, optional 440 Hz tone.
int cmd_makevideo(int argc, char** argv) {
    std::string output, codec = "libx264", pix_fmt = "yuv420p", framerate = "24/1";
    int w = 320, h = 240;
    int64_t frames = 48;
    bool with_audio = false;
    int crf = 23;
    for (int i = 0; i < argc; ++i) {
        std::string a = argv[i];
        auto next = [&]() -> const char* {
            if (i + 1 >= argc) die("missing value for " + a);
            return argv[++i];
        };
        if (a == "--output") output = next();
        else if (a == "--width") w = atoi(next());
        else if (a == "--height") h = atoi(next());
        else if (a == "--frames") frames = atoll(next());
        else if (a == "--framerate") framerate = next();
        else if (a == "--codec") codec = next();
        else if (a == "--pix-fmt") pix_fmt = next();
        else if (a == "--crf") crf = atoi(next());
        else if (a == "--audio") with_audio = true;
        else die("unknown makevideo option: " + a);
    }
    if (output.empty()) die("makevideo: --output required");
    AVRational fr = parse_rational(framerate);

    const AVCodec* vcodec = avcodec_find_encoder_by_name(codec.c_str());
    if (!vcodec) die("encoder not available: " + codec);

    AVFormatContext* ofmt = nullptr;
    int ret = avformat_alloc_output_context2(&ofmt, nullptr, "matroska", output.c_str());
    if (ret < 0) die("cannot allocate output", ret);

    AVCodecContext* venc = avcodec_alloc_context3(vcodec);
    venc->width = w; venc->height = h;
    venc->pix_fmt = av_get_pix_fmt(pix_fmt.c_str());
    venc->time_base = av_inv_q(fr);
    venc->framerate = fr;
    if (ofmt->oformat->flags & AVFMT_GLOBALHEADER)
        venc->flags |= AV_CODEC_FLAG_GLOBAL_HEADER;
    if (codec == "libx264" || codec == "libx265") {
        av_opt_set(venc->priv_data, "preset", "veryfast", 0);
        av_opt_set_double(venc->priv_data, "crf", crf, 0);
        if (codec == "libx265")
            av_opt_set(venc->priv_data, "x265-params", "log-level=error", 0);
    }
    if (avcodec_open2(venc, vcodec, nullptr) < 0) die("cannot open video encoder");

    AVStream* vs = avformat_new_stream(ofmt, nullptr);
    vs->time_base = venc->time_base;
    vs->avg_frame_rate = fr;
    avcodec_parameters_from_context(vs->codecpar, venc);

    // Optional AAC tone.
    AVCodecContext* aenc = nullptr;
    AVStream* as = nullptr;
    AVFrame* aframe = nullptr;
    if (with_audio) {
        const AVCodec* acodec = avcodec_find_encoder(AV_CODEC_ID_AAC);
        if (!acodec) { fprintf(stderr, "warning: AAC encoder missing, skipping audio\n"); with_audio = false; }
        else {
            aenc = avcodec_alloc_context3(acodec);
            aenc->sample_rate = 44100;
            aenc->sample_fmt = AV_SAMPLE_FMT_FLTP;
            av_channel_layout_default(&aenc->ch_layout, 1);
            aenc->time_base = {1, aenc->sample_rate};
            if (ofmt->oformat->flags & AVFMT_GLOBALHEADER)
                aenc->flags |= AV_CODEC_FLAG_GLOBAL_HEADER;
            if (avcodec_open2(aenc, acodec, nullptr) < 0) die("cannot open AAC encoder");
            as = avformat_new_stream(ofmt, nullptr);
            as->time_base = aenc->time_base;
            avcodec_parameters_from_context(as->codecpar, aenc);
            aframe = av_frame_alloc();
            aframe->format = aenc->sample_fmt;
            aframe->nb_samples = aenc->frame_size;
            av_channel_layout_copy(&aframe->ch_layout, &aenc->ch_layout);
            av_frame_get_buffer(aframe, 0);
        }
    }

    if (!(ofmt->oformat->flags & AVFMT_NOFILE)) {
        ret = avio_open(&ofmt->pb, output.c_str(), AVIO_FLAG_WRITE);
        if (ret < 0) die("cannot open output", ret);
    }
    if (avformat_write_header(ofmt, nullptr) < 0) die("cannot write header");

    AVFrame* rgb = av_frame_alloc();
    rgb->format = AV_PIX_FMT_RGB24;
    rgb->width = w; rgb->height = h;
    av_frame_get_buffer(rgb, 32);
    SwsContext* sws = sws_getContext(w, h, AV_PIX_FMT_RGB24, w, h, venc->pix_fmt,
                                     SWS_BILINEAR, nullptr, nullptr, nullptr);
    AVFrame* yuv = av_frame_alloc();
    yuv->format = venc->pix_fmt;
    yuv->width = w; yuv->height = h;
    av_frame_get_buffer(yuv, 32);
    AVPacket* pkt = av_packet_alloc();

    auto mux = [&](AVCodecContext* enc, AVStream* st) {
        while (true) {
            int r = avcodec_receive_packet(enc, pkt);
            if (r == AVERROR(EAGAIN) || r == AVERROR_EOF) break;
            if (r < 0) die("encode error", r);
            av_packet_rescale_ts(pkt, enc->time_base, st->time_base);
            pkt->stream_index = st->index;
            av_interleaved_write_frame(ofmt, pkt);
        }
    };

    int64_t audio_pts = 0;
    double samples_per_frame = with_audio ? (double)aenc->sample_rate / av_q2d(fr) : 0;
    double audio_emitted = 0;

    for (int64_t i = 0; i < frames; ++i) {
        av_frame_make_writable(rgb);
        int bx = (int)((i * 7) % (w > 32 ? w - 32 : 1));
        int by = (int)((i * 5) % (h > 32 ? h - 32 : 1));
        for (int y = 0; y < h; ++y) {
            uint8_t* row = rgb->data[0] + y * rgb->linesize[0];
            for (int x = 0; x < w; ++x) {
                row[3 * x + 0] = (uint8_t)((x * 255) / w);
                row[3 * x + 1] = (uint8_t)((y * 255) / h);
                row[3 * x + 2] = (uint8_t)((i * 16) & 0xff);
                if (x >= bx && x < bx + 32 && y >= by && y < by + 32) {
                    row[3 * x + 0] = 255; row[3 * x + 1] = 255; row[3 * x + 2] = 255;
                }
            }
        }
        av_frame_make_writable(yuv);
        sws_scale(sws, rgb->data, rgb->linesize, 0, h, yuv->data, yuv->linesize);
        yuv->pts = i;
        avcodec_send_frame(venc, yuv);
        mux(venc, vs);

        if (with_audio) {
            audio_emitted += samples_per_frame;
            while (audio_pts + aenc->frame_size <= (int64_t)audio_emitted) {
                av_frame_make_writable(aframe);
                float* data = (float*)aframe->data[0];
                for (int s = 0; s < aenc->frame_size; ++s)
                    data[s] = 0.2f * sinf(2.0f * (float)M_PI * 440.0f *
                                          (float)(audio_pts + s) / aenc->sample_rate);
                aframe->pts = audio_pts;
                audio_pts += aenc->frame_size;
                avcodec_send_frame(aenc, aframe);
                mux(aenc, as);
            }
        }
    }
    avcodec_send_frame(venc, nullptr);
    mux(venc, vs);
    if (with_audio) {
        avcodec_send_frame(aenc, nullptr);
        mux(aenc, as);
    }
    av_write_trailer(ofmt);
    if (!(ofmt->oformat->flags & AVFMT_NOFILE)) avio_closep(&ofmt->pb);

    sws_freeContext(sws);
    av_frame_free(&rgb);
    av_frame_free(&yuv);
    if (aframe) av_frame_free(&aframe);
    av_packet_free(&pkt);
    avcodec_free_context(&venc);
    if (aenc) avcodec_free_context(&aenc);
    avformat_free_context(ofmt);
    fprintf(stderr, "wrote %lld synthetic frames\n", (long long)frames);
    return 0;
}

}  // namespace

int main(int argc, char** argv) {
    av_log_set_level(AV_LOG_ERROR);
    if (argc < 2) {
        fprintf(stderr,
                "usage: vscmedia <probe|extract|decode|encode|concat|makevideo> ...\n");
        return 1;
    }
    std::string cmd = argv[1];
    if (cmd == "probe") return cmd_probe(argc - 2, argv + 2);
    if (cmd == "extract") return cmd_extract(argc - 2, argv + 2);
    if (cmd == "decode") return cmd_decode(argc - 2, argv + 2);
    if (cmd == "encode") return cmd_encode(argc - 2, argv + 2);
    if (cmd == "concat") return cmd_concat(argc - 2, argv + 2);
    if (cmd == "makevideo") return cmd_makevideo(argc - 2, argv + 2);
    fprintf(stderr, "vscmedia: unknown command '%s'\n", cmd.c_str());
    return 1;
}
