"""Benchmark harness — twin of sample/benchmark/main.cpp (:203-243) with the
same TOML schema (config.toml: global execute_times + per-filter sections)
and the same default workload (100×100 random u8 BGR in [100, 120)); where
the reference times cpp vs cuda it times xla vs the Pallas kernel (for the
ops that have one).  Adds MP/s and an optional --size for production-scale
runs (the 100×100 default is far too small to fill a GPU)."""

from __future__ import annotations

import argparse
import sys

import jax.numpy as jnp
import numpy as np

from ..core.rng import MT19937
from ..utils.compile_cache import enable_compile_cache
from ..utils.profiling import measure

DEFAULTS = {
    "execute_times": 50,
    "BilateralFilter": {"ksize": 9},
    "AdaptiveBilateralFilter": {"ksize": 9},
    "BilateralTextureFilter": {"ksize": 9, "nitr": 3},
    "SuperpixelSLIC": {"superpixel_size": 10, "num_iteration": 10},
}


def parse_config(path: str | None):
    cfg = {k: (dict(v) if isinstance(v, dict) else v) for k, v in DEFAULTS.items()}
    if path:
        import tomllib
        with open(path, "rb") as f:
            loaded = tomllib.load(f)
        if "execute_times" in loaded:
            cfg["execute_times"] = loaded["execute_times"]
        for section in ("BilateralFilter", "AdaptiveBilateralFilter",
                        "BilateralTextureFilter", "SuperpixelSLIC"):
            cfg[section].update(loaded.get(section, {}))
    return cfg


def print_duration(name: str, msec: float, mps: float | None = None):
    extra = f"  ({mps:8.1f} MP/s)" if mps is not None else ""
    print(f"{name:<40} : {msec:10.6f} [msec]{extra}")


def main(argv=None):
    p = argparse.ArgumentParser(description="various_image_processings_tpu benchmark")
    p.add_argument("config", nargs="?", default=None, help="TOML config path")
    p.add_argument("--size", type=int, nargs=2, default=(100, 100),
                   metavar=("H", "W"), help="image size (default 100 100)")
    args = p.parse_args(argv)
    enable_compile_cache()
    cfg = parse_config(args.config)
    n = cfg["execute_times"]
    h, w = args.size

    # random u8 BGR in [100, 120) (sample/benchmark/main.cpp:210-213)
    raw = MT19937(42).raw(h * w * 3)
    img = (100 + raw % np.uint32(20)).astype(np.uint8).reshape(h, w, 3)
    img_dev = jnp.asarray(img)
    pixels = h * w

    print(f"image size        : {w}x{h}")
    print(f"execute times     : {n}")
    for section, params in cfg.items():
        if isinstance(params, dict):
            print(f"[{section}] {params}")
    print()

    from ..ops.gradient import gradient
    from ..ops.bilateral import bilateral_filter
    from ..ops.adaptive_bilateral import adaptive_bilateral_filter
    from ..ops.bilateral_texture import bilateral_texture_filter
    from ..ops.slic import superpixel_slic

    ms = measure(lambda: gradient(img_dev), n)
    print_duration("gradient (xla)", ms, pixels / ms / 1e3)

    k = cfg["BilateralFilter"]["ksize"]
    for impl in ("xla", "pallas"):
        ms = measure(lambda: bilateral_filter(img_dev, k, impl=impl), n)
        print_duration(f"bilateral_filter k={k} ({impl})", ms, pixels / ms / 1e3)

    k = cfg["AdaptiveBilateralFilter"]["ksize"]
    ms = measure(lambda: adaptive_bilateral_filter(img_dev, k), n)
    print_duration(f"adaptive_bilateral_filter k={k} (xla)", ms,
                   pixels / ms / 1e3)

    k = cfg["BilateralTextureFilter"]["ksize"]
    nitr = cfg["BilateralTextureFilter"]["nitr"]
    for impl in ("xla", "pallas"):
        ms = measure(lambda: bilateral_texture_filter(img_dev, k, nitr, impl=impl),
                     max(n // 5, 2))
        print_duration(f"bilateral_texture_filter k={k} nitr={nitr} ({impl})",
                       ms, pixels / ms / 1e3)

    s = cfg["SuperpixelSLIC"]["superpixel_size"]
    it = cfg["SuperpixelSLIC"]["num_iteration"]
    import time
    superpixel_slic(img, s, it)  # warmup/compile
    t0 = time.perf_counter()
    iters = max(n // 5, 2)
    for _ in range(iters):
        superpixel_slic(img, s, it)
    ms = (time.perf_counter() - t0) / iters * 1e3
    print_duration(f"superpixel_slic S={s} itr={it}", ms, pixels / ms / 1e3)


if __name__ == "__main__":
    sys.exit(main())
