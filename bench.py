"""Headline benchmark: bilateral filter (k=9) throughput at 4K on one GPU.

Prints ONE JSON line {"metric", "value", "unit", "device", "warm_ms",
"samples"}.  The input is device-resident and every timed call ends in
``jax.block_until_ready`` (the median of the warm calls is reported),
mirroring the reference benchmark's exclusion of cudaMemcpy from its
MEASURE loops (sample/benchmark/main.cpp:105-201).  Without a GPU it exits
non-zero: a CPU time is not this metric.
"""

import json
import sys

from various_image_processings_tpu.utils.compile_cache import enable_compile_cache


def main(samples: int = 30) -> int:
    enable_compile_cache()
    import jax

    from various_image_processings_tpu.ops.bilateral import bilateral_filter
    from various_image_processings_tpu.utils.onchip import synthetic_image
    from various_image_processings_tpu.utils.profiling import timed

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"no GPU: JAX found {dev.platform!r}", file=sys.stderr)
        return 2
    h, w = 2160, 3840
    img = jax.device_put(synthetic_image(h, w, 0))
    _, _, ms = timed(lambda x: bilateral_filter(x, 9, 10.0, 30.0), img,
                     n=samples)
    print(json.dumps({
        "metric": "bilateral_filter_4k_throughput",
        "value": h * w / ms / 1e3,
        "unit": "MP/s",
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": 1},
        "warm_ms": ms,
        "samples": samples,
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
