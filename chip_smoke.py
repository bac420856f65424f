"""Smoke run of the library's main path on one NVIDIA GPU.

    python chip_smoke.py               # every main-path op on one card
    python chip_smoke.py --four-gpus   # only the 4-card batched/sharded paths

Each phase runs a public ``vip.*`` op at a real size, checks its result
against the repository's plain reference (golden twins, the op's XLA path,
or the same code on the host CPU — see utils/onchip.py), and prints one
JSON line with the shape, the parity result, the compile-plus-first-run
seconds and the median warm time (host timer ending in
``block_until_ready``).  Any failure raises and the script exits non-zero.
The last line of standard output is the only summary:
``{"ok": true, "device": {"platform", "kind", "count"}}``.

There is no CPU fallback: without a GPU the script exits non-zero before
printing a result.  It keeps to one JAX process.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--four-gpus", action="store_true",
                   help="run only the 4-card batched and row-sharded phases")
    args = p.parse_args(argv)

    from various_image_processings_tpu.utils.compile_cache import (
        enable_compile_cache)
    cache = enable_compile_cache()

    import jax

    devices = jax.devices()
    if devices[0].platform != "gpu":
        print(f"no GPU: JAX found {devices[0].platform!r} devices",
              file=sys.stderr)
        return 2
    need = 4 if args.four_gpus else 1
    if len(devices) < need:
        print(f"need {need} GPUs, JAX found {len(devices)}", file=sys.stderr)
        return 2
    devices = devices[:need]

    from various_image_processings_tpu.utils import native, onchip

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    print(f"jax {jax.__version__}; devices {devices}; compile cache {cache}")
    print("native host helper: " + ("built (native/build/libvip_native.so)"
                                    if native.available()
                                    else "pure-Python fallback"))
    print("matmul precision: SLIC cell einsums ask for Precision.HIGHEST "
          "(f32, no TF32); the Wexler search conv takes bf16 operands that "
          "are exact integers <= 255, accumulated in f32")

    t0 = time.perf_counter()
    if args.four_gpus:
        checks = [lambda: onchip.check_four_devices(devices)]
    else:
        checks = [onchip.check_bilateral_vs_golden, onchip.check_filters_4k,
                  onchip.check_jbf_k17, onchip.check_btf, onchip.check_btf_4k, onchip.check_slic,
                  onchip.check_wexler]
    for check in checks:
        for record in check():
            print(json.dumps(record), flush=True)
    print(f"all phases passed in {time.perf_counter() - t0:.1f} s")

    print(smi.stdout.strip())
    print(json.dumps({"ok": True, "device": {
        "platform": devices[0].platform, "kind": devices[0].device_kind,
        "count": len(devices)}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
