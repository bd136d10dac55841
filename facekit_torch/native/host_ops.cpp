// facekit_torch native host runtime ops: a copy of facekit's
// (facekit/native/host_ops.cpp), kept in the port so that it imports
// nothing of facekit.
//
// The reference implements its host runtime in C++ (OpenCV preprocessing in
// src/retinaface.cpp:106-136 / src/arcface.cpp:3-17, greedy NMS in
// src/retinaface.cpp:248-271, and host argmax in src/arcface.cpp:203-217).
// This library provides the native host-side equivalents: the JPEG codec
// and resize of the server's OpenCV-free pixel backend
// (extras.server_hostOps: "native"), a fallback gallery scan, and
// verification oracles independent of OpenCV.
//
// Built with: g++ -O3 -march=native -shared -fPIC -fopenmp ... -ljpeg
// (facekit_torch/ops/_build.py); exposed via ctypes
// (facekit_torch/native/__init__.py).

#include <algorithm>
#include <cmath>
#include <csetjmp>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <vector>

#include <jpeglib.h>

namespace {
// libjpeg reports fatal errors via error_exit (default: exit()); longjmp
// back so a truncated/corrupt payload returns -1 instead of killing the
// serving process.
struct FkJpegErr {
    jpeg_error_mgr mgr;
    jmp_buf jb;
};
void fk_jpeg_fail(j_common_ptr cinfo) {
    longjmp(reinterpret_cast<FkJpegErr*>(cinfo->err)->jb, 1);
}
}  // namespace

extern "C" {

// ---------------------------------------------------------------------------
// JPEG codec (system libjpeg-turbo): the serving decode/encode path without
// OpenCV. The reference's server depends on cv::imdecode/imencode for every
// WS frame (src/app.cpp:293-352); with these the facekit server's host
// pixel work (decode -> resize -> ... -> encode reply) runs entirely in
// this library when cv2 is absent or extras.server_hostOps == "native".
// ---------------------------------------------------------------------------

int fk_jpeg_dims(const uint8_t* data, unsigned long len, int* h, int* w) {
    jpeg_decompress_struct cinfo;
    FkJpegErr err;
    cinfo.err = jpeg_std_error(&err.mgr);
    err.mgr.error_exit = fk_jpeg_fail;
    if (setjmp(err.jb)) { jpeg_destroy_decompress(&cinfo); return -1; }
    jpeg_create_decompress(&cinfo);
    jpeg_mem_src(&cinfo, const_cast<uint8_t*>(data), len);
    if (jpeg_read_header(&cinfo, TRUE) != JPEG_HEADER_OK) {
        jpeg_destroy_decompress(&cinfo);
        return -1;
    }
    *h = (int)cinfo.image_height;
    *w = (int)cinfo.image_width;
    jpeg_destroy_decompress(&cinfo);
    return 0;
}

// Full-resolution decode to interleaved BGR u8 (h*w*3, caller-sized from
// fk_jpeg_dims). Grayscale/YCbCr sources are color-converted by libjpeg.
int fk_jpeg_decode_bgr(const uint8_t* data, unsigned long len,
                       uint8_t* out) {
    jpeg_decompress_struct cinfo;
    FkJpegErr err;
    cinfo.err = jpeg_std_error(&err.mgr);
    err.mgr.error_exit = fk_jpeg_fail;
    if (setjmp(err.jb)) { jpeg_destroy_decompress(&cinfo); return -1; }
    jpeg_create_decompress(&cinfo);
    jpeg_mem_src(&cinfo, const_cast<uint8_t*>(data), len);
    if (jpeg_read_header(&cinfo, TRUE) != JPEG_HEADER_OK) {
        jpeg_destroy_decompress(&cinfo);
        return -1;
    }
    cinfo.out_color_space = JCS_EXT_BGR;
    jpeg_start_decompress(&cinfo);
    const size_t stride = (size_t)cinfo.output_width * 3;
    while (cinfo.output_scanline < cinfo.output_height) {
        JSAMPROW row = out + (size_t)cinfo.output_scanline * stride;
        jpeg_read_scanlines(&cinfo, &row, 1);
    }
    jpeg_finish_decompress(&cinfo);
    jpeg_destroy_decompress(&cinfo);
    return 0;
}

// BGR u8 (h, w, 3) -> baseline JPEG. *outbuf is malloc'd by libjpeg
// (jpeg_mem_dest); caller frees with fk_free. Returns byte size or -1.
long fk_jpeg_encode_bgr(const uint8_t* img, int h, int w, int quality,
                        uint8_t** outbuf, unsigned long* outlen) {
    jpeg_compress_struct cinfo;
    FkJpegErr err;
    cinfo.err = jpeg_std_error(&err.mgr);
    err.mgr.error_exit = fk_jpeg_fail;
    *outbuf = nullptr;
    *outlen = 0;
    if (setjmp(err.jb)) {
        jpeg_destroy_compress(&cinfo);
        if (*outbuf) { free(*outbuf); *outbuf = nullptr; }
        return -1;
    }
    jpeg_create_compress(&cinfo);
    jpeg_mem_dest(&cinfo, outbuf, outlen);
    cinfo.image_width = (JDIMENSION)w;
    cinfo.image_height = (JDIMENSION)h;
    cinfo.input_components = 3;
    cinfo.in_color_space = JCS_EXT_BGR;
    jpeg_set_defaults(&cinfo);
    jpeg_set_quality(&cinfo, quality, TRUE);
    jpeg_start_compress(&cinfo, TRUE);
    while (cinfo.next_scanline < cinfo.image_height) {
        JSAMPROW row = const_cast<uint8_t*>(img)
            + (size_t)cinfo.next_scanline * w * 3;
        jpeg_write_scanlines(&cinfo, &row, 1);
    }
    jpeg_finish_compress(&cinfo);
    jpeg_destroy_compress(&cinfo);
    return (long)*outlen;
}

void fk_free(void* p) { free(p); }

// ---------------------------------------------------------------------------
// Separable resize with OpenCV semantics (half-pixel mapping, clamped
// borders; float math, saturated uint8-compatible output range).
// ---------------------------------------------------------------------------

static inline float cubic_w(float x) {
    const float A = -0.75f;  // OpenCV INTER_CUBIC coefficient
    x = std::fabs(x);
    if (x <= 1.f) return ((A + 2.f) * x - (A + 3.f)) * x * x + 1.f;
    if (x < 2.f) return ((A * x - 5.f * A) * x + 8.f * A) * x - 4.f * A;
    return 0.f;
}

// method: 0 = bilinear (2 taps), 1 = bicubic (4 taps)
void fk_resize_u8(const uint8_t* src, int sh, int sw, int c,
                  float* dst, int dh, int dw, int method, int saturate) {
    const int taps = method ? 4 : 2;
    const int t0 = method ? -1 : 0;
    std::vector<int> xi(dw * taps);
    std::vector<float> xw(dw * taps);
    const double sx = (double)sw / dw;
    for (int x = 0; x < dw; ++x) {
        double fx = (x + 0.5) * sx - 0.5;
        int bx = (int)std::floor(fx);
        float fr = (float)(fx - bx);
        for (int t = 0; t < taps; ++t) {
            int ix = bx + t0 + t;
            xi[x * taps + t] = std::min(std::max(ix, 0), sw - 1);
            xw[x * taps + t] = method ? cubic_w((t0 + t) - fr)
                                      : (t ? fr : 1.f - fr);
        }
    }
    std::vector<float> row(sw * c);
#pragma omp parallel for schedule(static) firstprivate(row)
    for (int y = 0; y < dh; ++y) {
        double fy = (y + 0.5) * (double)sh / dh - 0.5;
        int by = (int)std::floor(fy);
        float fr = (float)(fy - by);
        // vertical pass into a row buffer
        for (int i = 0; i < sw * c; ++i) row[i] = 0.f;
        for (int t = 0; t < taps; ++t) {
            int iy = std::min(std::max(by + t0 + t, 0), sh - 1);
            float wy = method ? cubic_w((t0 + t) - fr) : (t ? fr : 1.f - fr);
            const uint8_t* sp = src + (size_t)iy * sw * c;
            for (int i = 0; i < sw * c; ++i) row[i] += wy * sp[i];
        }
        // horizontal pass
        float* dp = dst + (size_t)y * dw * c;
        for (int x = 0; x < dw; ++x) {
            for (int ch = 0; ch < c; ++ch) {
                float acc = 0.f;
                for (int t = 0; t < taps; ++t)
                    acc += xw[x * taps + t] * row[xi[x * taps + t] * c + ch];
                if (saturate)
                    acc = std::min(std::max(std::nearbyint(acc), 0.f), 255.f);
                dp[x * c + ch] = acc;
            }
        }
    }
}

// Letterbox + detector normalization fused: uint8 BGR frame -> f32 BGR
// (det_h, det_w, 3) minus channel means, pad value 128 (reference
// src/retinaface.cpp:106-136). Geometry matches letterbox_geometry().
void fk_letterbox_det(const uint8_t* frame, int fh, int fw,
                      float* out, int th, int tw,
                      float m0, float m1, float m2) {
    double scale_h = (double)th / fh, scale_w = (double)tw / fw;
    int h, w, x, y;
    if (scale_h > scale_w) {
        w = tw; h = (int)(scale_w * fh); x = 0; y = (th - h) / 2;
    } else {
        w = (int)(scale_h * fw); h = th; x = (tw - w) / 2; y = 0;
    }
    std::vector<float> resized((size_t)h * w * 3);
    fk_resize_u8(frame, fh, fw, 3, resized.data(), h, w, 0, 1);
    const float mean[3] = {m0, m1, m2};
    for (int yy = 0; yy < th; ++yy) {
        for (int xx = 0; xx < tw; ++xx) {
            for (int ch = 0; ch < 3; ++ch) {
                float v = 128.f;
                if (yy >= y && yy < y + h && xx >= x && xx < x + w)
                    v = resized[((size_t)(yy - y) * w + (xx - x)) * 3 + ch];
                out[((size_t)yy * tw + xx) * 3 + ch] = v - mean[ch];
            }
        }
    }
}

// ---------------------------------------------------------------------------
// Greedy NMS, reference semantics (+1 area, suppress at IoU >= thresh,
// descending score order). boxes: (n, 4) x1 y1 x2 y2; returns kept count,
// kept indices (into the score-sorted order's original positions).
// ---------------------------------------------------------------------------

int fk_nms(const float* boxes, const float* scores, int n,
           float iou_thresh, int max_out, int* out_idx) {
    std::vector<int> order(n);
    for (int i = 0; i < n; ++i) order[i] = i;
    std::stable_sort(order.begin(), order.end(), [&](int a, int b) {
        return scores[a] > scores[b];
    });
    std::vector<char> dead(n, 0);
    int kept = 0;
    for (int oi = 0; oi < n && kept < max_out; ++oi) {
        int i = order[oi];
        if (dead[i]) continue;
        out_idx[kept++] = i;
        const float* bi = boxes + 4 * i;
        float ai = (bi[2] - bi[0] + 1.f) * (bi[3] - bi[1] + 1.f);
        for (int oj = oi + 1; oj < n; ++oj) {
            int j = order[oj];
            if (dead[j]) continue;
            const float* bj = boxes + 4 * j;
            float xx1 = std::max(bi[0], bj[0]);
            float yy1 = std::max(bi[1], bj[1]);
            float xx2 = std::min(bi[2], bj[2]);
            float yy2 = std::min(bi[3], bj[3]);
            float iw = std::max(0.f, xx2 - xx1 + 1.f);
            float ih = std::max(0.f, yy2 - yy1 + 1.f);
            float inter = iw * ih;
            float aj = (bj[2] - bj[0] + 1.f) * (bj[3] - bj[1] + 1.f);
            if (inter / (ai + aj - inter) >= iou_thresh) dead[j] = 1;
        }
    }
    return kept;
}

// ---------------------------------------------------------------------------
// CPU fallback gallery scan: queries (b, d) x gallery (n, d) -> per-query
// top-1 (score, index). Blocked over gallery rows, OpenMP over queries.
// The no-accelerator analog of MatMul::calculate + getOutputs
// (src/matmul.cpp:36-77, src/arcface.cpp:203-217) without materializing
// the (n, b) similarity matrix.
// ---------------------------------------------------------------------------

void fk_gallery_top1(const float* gallery, int n, int d,
                     const float* queries, int b,
                     float* out_scores, int* out_idx) {
#pragma omp parallel for schedule(static)
    for (int q = 0; q < b; ++q) {
        const float* qp = queries + (size_t)q * d;
        float best = -1e30f;
        int best_i = -1;   // empty gallery (n == 0) -> idx -1, not a
                           // phantom "match" at slot 0
        for (int i = 0; i < n; ++i) {
            const float* gp = gallery + (size_t)i * d;
            float acc = 0.f;
#pragma omp simd reduction(+:acc)
            for (int k = 0; k < d; ++k) acc += qp[k] * gp[k];
            if (acc > best) { best = acc; best_i = i; }
        }
        out_scores[q] = best;
        out_idx[q] = best_i;
    }
}

}  // extern "C"
