// Reference-oracle dumper for parity tests.
//
// Compiles the ACTUAL reference CPU implementations (read-only mount at
// /root/reference, included via -I at build time — no reference code lives
// in this repo) and dumps their outputs for raw binary inputs, so the
// golden NumPy layer can be checked against the real thing bit-for-bit.
//
// Usage: ref_oracle <op> <in.bin> <H> <W> <out.bin> [args...]
//   bilateral  in(H*W*3 u8) out(H*W*3 u8)   args: ksize sigma_space sigma_color
//   joint      in(2*H*W*3 u8: src,guide) out(H*W*3 u8)  args: ksize ss sc
//   abf        in(H*W*3 u8) out(H*W*3 u8)   args: ksize ss sc
//   gradient   in(H*W*3 u8) out(H*W f32)
//   gradient1  in(H*W u8)   out(H*W f32)
//   blur_rtv   in(H*W*3 u8) out(H*W*3 f32 blurred + H*W f32 rtv)  args: ksize
//   guide      in(H*W*3 f32 blurred + H*W f32 rtv) out(H*W*3 u8)  args: ksize
//   slic       in(H*W*3 u8) out(H*W i32)    args: S nitr color_scale
//   ciede2000_ref  in(N*6 i32 Lab sextuplets, H=N W=6) out(N f32) —
//              direct CIE_DeltaE2000_square calls (the pi-scaled variant)
//   integral   in(H*W*3 u8) out((H+2r+1)*(W+2r+1)*3 i32)  args: radius
//   btf        in(H*W*3 u8) out(H*W*3 u8)   args: ksize nitr   (cpp path,
//              cv::ximgproc::jointBilateralFilter)
//   jbf_cpp    in(2*H*W*3 u8: src,joint) out(H*W*3 u8)  args: d sc ss —
//              direct cv::ximgproc::jointBilateralFilter call (the cpp BTF
//              final stage, include/cpp/bilateral_texture_filter.hpp:162)
//   wexler     in(H*W*3 u8 src + H*W u8 mask) out(H*W*3 u8)
//   wexler_contour  in(H*W*3 u8 src + H*W u8 mask)
//              out(N*3 i32: x, y, priority in pop order) — N = contour length

#include <chrono>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <iostream>  // reference headers use std::cout without including it
#include <string>
#include <vector>

#include "cpp/bilateral_filter.hpp"
#include "cpp/adaptive_bilateral_filter.hpp"
#include "cpp/gradient.hpp"
#include "cpp/border_replicated_integral_image.hpp"
#include "cpp/slic.hpp"
namespace btf_internal {
// bilateral_texture_filter.hpp needs ximgproc only for the full pipeline;
// pull just the stage internals by including it with a stub if missing.
}
#include "cpp/bilateral_texture_filter.hpp"

// Wexler's contour/priority internals are private; the parity test needs to
// observe them directly, so this test-only TU flattens access control (all
// dependency headers are fully included above, so the define only affects
// the reference header itself).
#include <algorithm>
#include <queue>
#define private public
#include "cpp/wexler_inpainting.hpp"
#undef private

static std::vector<uint8_t> read_file(const char* path) {
    FILE* f = std::fopen(path, "rb");
    if (!f) { std::perror(path); std::exit(2); }
    std::fseek(f, 0, SEEK_END);
    long n = std::ftell(f);
    std::fseek(f, 0, SEEK_SET);
    std::vector<uint8_t> buf(n);
    if (std::fread(buf.data(), 1, n, f) != static_cast<size_t>(n)) std::exit(2);
    std::fclose(f);
    return buf;
}

static void write_file(const char* path, const void* data, size_t n) {
    FILE* f = std::fopen(path, "wb");
    if (!f) { std::perror(path); std::exit(2); }
    std::fwrite(data, 1, n, f);
    std::fclose(f);
}

int main(int argc, char** argv) {
    if (argc < 6) { std::fprintf(stderr, "usage: ref_oracle op in H W out [args]\n"); return 1; }
    const std::string op = argv[1];
    const auto in = read_file(argv[2]);
    const int h = std::atoi(argv[3]);
    const int w = std::atoi(argv[4]);
    const char* out_path = argv[5];
    // deterministic f32 sums for parity ops (test/gradient.cu:39 does the
    // same); the bench op keeps OpenCV's real cv::parallel_for_ threading —
    // a timing comparison must give the reference its full parallelism
    if (op != "bench") cv::setNumThreads(1);

    if (op == "bilateral" || op == "abf") {
        const int ksize = argc > 6 ? std::atoi(argv[6]) : 9;
        const float ss = argc > 7 ? std::atof(argv[7]) : 10.f;
        const float sc = argc > 8 ? std::atof(argv[8]) : 30.f;
        cv::Mat3b src(h, w, (cv::Vec3b*)in.data());
        cv::Mat3b dst;
        if (op == "bilateral") bilateral_filter(src, dst, ksize, ss, sc);
        else adaptive_bilateral_filter(src, dst, ksize, ss, sc);
        write_file(out_path, dst.data, (size_t)h * w * 3);
    } else if (op == "joint") {
        const int ksize = argc > 6 ? std::atoi(argv[6]) : 9;
        const float ss = argc > 7 ? std::atof(argv[7]) : 10.f;
        const float sc = argc > 8 ? std::atof(argv[8]) : 30.f;
        cv::Mat3b src(h, w, (cv::Vec3b*)in.data());
        cv::Mat3b guide(h, w, (cv::Vec3b*)(in.data() + (size_t)h * w * 3));
        cv::Mat3b dst;
        joint_bilateral_filter(src, guide, dst, ksize, ss, sc);
        write_file(out_path, dst.data, (size_t)h * w * 3);
    } else if (op == "gradient" || op == "gradient1") {
        const int ch = op == "gradient" ? 3 : 1;
        cv::Mat src(h, w, CV_8UC(ch), (void*)in.data());
        cv::Mat dst;
        gradient(src, dst);
        write_file(out_path, dst.data, (size_t)h * w * 4);
    } else if (op == "blur_rtv") {
        const int ksize = argc > 6 ? std::atoi(argv[6]) : 9;
        cv::Mat3b image(h, w, (cv::Vec3b*)in.data());
        cv::Mat1f magnitude;
        gradient(image, magnitude);
        cv::Mat3f blurred;
        cv::Mat1f rtv;
        internal::compute_blur_and_rtv(image, magnitude, blurred, rtv, ksize);
        std::vector<uint8_t> out((size_t)h * w * 3 * 4 + (size_t)h * w * 4);
        std::memcpy(out.data(), blurred.data, (size_t)h * w * 3 * 4);
        std::memcpy(out.data() + (size_t)h * w * 3 * 4, rtv.data, (size_t)h * w * 4);
        write_file(out_path, out.data(), out.size());
    } else if (op == "guide") {
        const int ksize = argc > 6 ? std::atoi(argv[6]) : 9;
        cv::Mat3f blurred(h, w, (cv::Vec3f*)in.data());
        cv::Mat1f rtv(h, w, (float*)(in.data() + (size_t)h * w * 3 * 4));
        cv::Mat3b dst;
        internal::compute_guide(blurred, rtv, dst, ksize);
        write_file(out_path, dst.data, (size_t)h * w * 3);
    } else if (op == "bench") {
        // Head-to-head timing mode: run ONE
        // reference cpp algorithm n_iter+1 times on the input image, first
        // run discarded as warmup — the same semantics as the reference's
        // MEASURE macro (sample/benchmark/main.cpp:20-33; timing loop
        // written fresh here, not transcribed).  Writes the mean msec as
        // ASCII to out.  argv: bench in H W out <algo> <n_iter> [params...]
        const std::string algo = argc > 6 ? argv[6] : "";
        const int n = argc > 7 ? std::atoi(argv[7]) : 10;
        cv::Mat3b src(h, w, (cv::Vec3b*)in.data());
        const auto time_op = [&](auto&& fn) {
            fn();  // warmup
            const auto t0 = std::chrono::steady_clock::now();
            for (int i = 0; i < n; ++i) fn();
            const auto t1 = std::chrono::steady_clock::now();
            return std::chrono::duration<double, std::milli>(t1 - t0).count()
                   / std::max(n, 1);
        };
        double ms = -1.0;
        if (algo == "gradient") {
            cv::Mat dst;
            ms = time_op([&] { gradient(src, dst); });
        } else if (algo == "bilateral" || algo == "abf") {
            const int k = argc > 8 ? std::atoi(argv[8]) : 9;
            const float ss = argc > 9 ? std::atof(argv[9]) : 10.f;
            const float sc = argc > 10 ? std::atof(argv[10]) : 30.f;
            cv::Mat3b dst;
            if (algo == "bilateral")
                ms = time_op([&] { bilateral_filter(src, dst, k, ss, sc); });
            else
                ms = time_op([&] { adaptive_bilateral_filter(src, dst, k, ss, sc); });
        } else if (algo == "btf") {
            const int k = argc > 8 ? std::atoi(argv[8]) : 9;
            const int nitr = argc > 9 ? std::atoi(argv[9]) : 3;
            cv::Mat3b dst;
            ms = time_op([&] { bilateral_texture_filter(src, dst, k, nitr); });
        } else if (algo == "slic") {
            const int S = argc > 8 ? std::atoi(argv[8]) : 10;
            const int nitr = argc > 9 ? std::atoi(argv[9]) : 10;
            const float m = argc > 10 ? std::atof(argv[10]) : 20.f;
            cv::Mat1i label;
            ms = time_op([&] { superpixel_slic(src, label, S, nitr, m); });
        } else if (algo == "wexler") {
            // not in the reference's benchmark list (no CUDA version);
            // timed as an extra.  mask rides after the image like op=wexler
            cv::Mat1b mask(h, w, (uint8_t*)(in.data() + (size_t)h * w * 3));
            cv::Mat3b dst;
            ms = time_op([&] { inpainting_wexler(src, mask, dst); });
        } else {
            std::fprintf(stderr, "unknown bench algo %s\n", algo.c_str());
            return 1;
        }
        char buf[64];
        std::snprintf(buf, sizeof buf, "%.6f", ms);
        write_file(out_path, buf, std::strlen(buf));
    } else if (op == "slic") {
        const int S = argc > 6 ? std::atoi(argv[6]) : 30;
        const int nitr = argc > 7 ? std::atoi(argv[7]) : 10;
        const float m = argc > 8 ? std::atof(argv[8]) : 20.f;
        cv::Mat3b image(h, w, (cv::Vec3b*)in.data());
        cv::Mat1i label;
        superpixel_slic(image, label, S, nitr, m);
        write_file(out_path, label.data, (size_t)h * w * 4);
    } else if (op == "ciede2000_ref") {
        // scalar transcription oracle for the reference's pi-scaled
        // CIE_DeltaE2000_square (include/cpp/slic.hpp:15-112; its
        // degree_to_radian multiplies by pi, not pi/180 — :16-18).
        // in: N*6 i32 Lab sextuplets (h=N, w=6), out: N f32
        const int32_t* v = (const int32_t*)in.data();
        std::vector<float> de((size_t)h);
        for (int i = 0; i < h; i++)
            de[i] = CIE_DeltaE2000_square(v[i * 6 + 0], v[i * 6 + 1],
                                          v[i * 6 + 2], v[i * 6 + 3],
                                          v[i * 6 + 4], v[i * 6 + 5]);
        write_file(out_path, de.data(), de.size() * 4);
    } else if (op == "integral") {
        const int radius = argc > 6 ? std::atoi(argv[6]) : 4;
        cv::Mat_<cv::Vec3b> src(h, w, (cv::Vec3b*)in.data());
        BorderReplicatedIntegralImage<std::uint8_t, 3> integral(src, radius);
        // dump all window sums centred at each pixel instead of the raw
        // buffer (the buffer is private); radius-window per pixel
        std::vector<int32_t> sums((size_t)h * w * 3);
        for (int y = 0; y < h; y++)
            for (int x = 0; x < w; x++) {
                const auto v = integral.get(x - radius, y - radius, x + radius, y + radius);
                for (int c = 0; c < 3; c++) sums[((size_t)y * w + x) * 3 + c] = v[c];
            }
        write_file(out_path, sums.data(), sums.size() * 4);
    } else if (op == "btf") {
        // full cpp-path pipeline incl. cv::ximgproc::jointBilateralFilter
        // (reference include/cpp/bilateral_texture_filter.hpp:153-164)
        const int ksize = argc > 6 ? std::atoi(argv[6]) : 9;
        const int nitr = argc > 7 ? std::atoi(argv[7]) : 3;
        cv::Mat3b src(h, w, (cv::Vec3b*)in.data());
        cv::Mat3b dst;
        bilateral_texture_filter(src, dst, ksize, nitr);
        write_file(out_path, dst.data, (size_t)h * w * 3);
    } else if (op == "jbf_cpp") {
        const int d = argc > 6 ? std::atoi(argv[6]) : 17;
        const double sc = argc > 7 ? std::atof(argv[7]) : std::sqrt(3.0);
        const double ss = argc > 8 ? std::atof(argv[8]) : 8.0;
        cv::Mat3b src(h, w, (cv::Vec3b*)in.data());
        cv::Mat3b joint(h, w, (cv::Vec3b*)(in.data() + (size_t)h * w * 3));
        cv::Mat dst;
        cv::ximgproc::jointBilateralFilter(joint, src, dst, d, sc, ss);
        write_file(out_path, dst.data, (size_t)h * w * 3);
    } else if (op == "wexler") {
        cv::Mat3b src(h, w, (cv::Vec3b*)in.data());
        cv::Mat1b mask(h, w, (uint8_t*)(in.data() + (size_t)h * w * 3));
        cv::Mat3b dst;
        inpainting_wexler(src, mask, dst);
        write_file(out_path, dst.data, (size_t)h * w * 3);
    } else if (op == "wexler_contour") {
        cv::Mat3b src(h, w, (cv::Vec3b*)in.data());
        cv::Mat1b mask(h, w, (uint8_t*)(in.data() + (size_t)h * w * 3));
        WexlerInpaintingImpl impl(src, mask);  // ctor runs the fill (small)
        // first masked pixel in raster order (reference :283-296)
        int sx = -1, sy = -1;
        for (int y = 0; y < h && sx < 0; y++)
            for (int x = 0; x < w; x++)
                if (mask(y, x) > 0) { sx = x; sy = y; break; }
        auto q = impl.extract_mask_contour_with_priority(mask, sx, sy);
        std::vector<int32_t> out;
        while (!q.empty()) {
            const auto& [prio, pt] = q.top();
            out.push_back(pt.x);
            out.push_back(pt.y);
            out.push_back(prio);
            q.pop();
        }
        write_file(out_path, out.data(), out.size() * 4);
    } else {
        std::fprintf(stderr, "unknown op %s\n", op.c_str());
        return 1;
    }
    return 0;
}
