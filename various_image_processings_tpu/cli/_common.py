"""Shared CLI plumbing for the per-algorithm samples.

The reference samples display results with cv::imshow; these headless twins
write PNGs next to the input (or to --output) and print timing.
"""

from __future__ import annotations

import argparse
import os
import time

import jax
import numpy as np

from ..utils.compile_cache import enable_compile_cache
from ..utils.io import imread, imwrite


def base_parser(description: str) -> argparse.ArgumentParser:
    """The shared CLI arguments; also points JAX at its compile cache."""
    enable_compile_cache()
    p = argparse.ArgumentParser(description=description)
    p.add_argument("filename", help="input image path")
    p.add_argument("--output", "-o", default=None,
                   help="output path (default: <input>_<algo>.png)")
    p.add_argument("--impl", default="auto", choices=("auto", "xla", "pallas"))
    p.add_argument("--side-by-side", action="store_true",
                   help="also write an input|result composite PNG — the "
                        "headless twin of the reference samples' paired "
                        "cv::imshow windows (e.g. "
                        "sample/bilateral_filter/main.cpp:38-44)")
    return p


def _display_u8(a: np.ndarray) -> np.ndarray:
    """Render an output array for display: u8 passes through; float outputs
    (gradient magnitude) are min-max normalized to u8; single-channel is
    broadcast to 3 so it can sit next to a BGR input."""
    a = np.asarray(a)
    if a.dtype != np.uint8:
        lo, hi = float(a.min()), float(a.max())
        a = ((a.astype(np.float64) - lo) / max(hi - lo, 1e-12) * 255.0
             + 0.5).astype(np.uint8)
    if a.ndim == 2:
        a = np.repeat(a[:, :, None], 3, axis=2)
    return a


def load_image(path: str) -> np.ndarray:
    img = imread(path)
    print(f"input: {path} {img.shape[1]}x{img.shape[0]}")
    return img


def run_and_save(name: str, fn, args, out_default_suffix: str):
    t0 = time.perf_counter()
    out = fn()
    jax.block_until_ready(out)
    t1 = time.perf_counter()
    out2 = fn()
    jax.block_until_ready(out2)
    t2 = time.perf_counter()
    print(f"{name}: compile+run {t1 - t0:.3f}s, warm {1e3 * (t2 - t1):.3f}ms")
    out_path = args.output
    if out_path is None:
        root, _ = os.path.splitext(args.filename)
        out_path = f"{os.path.basename(root)}_{out_default_suffix}.png"
    imwrite(out_path, np.asarray(out))
    print(f"wrote {out_path}")
    if getattr(args, "side_by_side", False):
        src = _display_u8(imread(args.filename))
        res = _display_u8(out)
        sep = np.full((src.shape[0], 2, 3), 255, np.uint8)
        sbs = np.concatenate([src, sep, res], axis=1)
        root, _ = os.path.splitext(out_path)
        sbs_path = f"{root}_sbs.png"
        imwrite(sbs_path, sbs)
        print(f"wrote {sbs_path} (input | result)")
    return out
