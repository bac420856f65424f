"""Checks of the main path on the card, shared by ``chip_smoke.py`` and the
``gpu``-marked tests (tests/test_gpu.py).

Each check runs one public op at a real size through its normal entry
point, compares the result with the repository's plain reference at the
precision stated in its docstring, and returns one record per phase:
``{"phase", "shape", "parity", "compile_s", "warm_ms"}``.  A result outside
its tolerance raises ``AssertionError``; nothing is caught here.

Images come from ``synthetic_image``: seeded piecewise-smooth regions with
texture and noise (SLIC, BTF and Wexler behave differently on content, so
uniform noise is not enough).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from .. import golden
from .profiling import timed


def synthetic_image(h: int, w: int, seed: int = 0) -> np.ndarray:
    """(h, w, 3) u8: Voronoi regions, each a smooth colour ramp, half of
    them striped, plus Gaussian noise — all from ``seed``."""
    rng = np.random.default_rng(seed)
    yy = np.arange(h, dtype=np.float32)[:, None] / max(h, w)
    xx = np.arange(w, dtype=np.float32)[None, :] / max(h, w)
    n = 12
    cy, cx = rng.random(n) * h / max(h, w), rng.random(n) * w / max(h, w)
    best = np.full((h, w), np.inf, np.float32)
    label = np.zeros((h, w), np.int8)
    for i in range(n):
        d = (yy - cy[i]) ** 2 + (xx - cx[i]) ** 2
        closer = d < best
        best = np.where(closer, d, best)
        label = np.where(closer, np.int8(i), label)
    base = rng.uniform(40, 215, (n, 3)).astype(np.float32)
    ramp = rng.uniform(-60, 60, (n, 2, 3)).astype(np.float32)
    period = rng.uniform(0.004, 0.02, n).astype(np.float32)
    img = np.empty((h, w, 3), np.float32)
    for c in range(3):
        img[:, :, c] = (base[label, c] + ramp[label, 0, c] * yy
                        + ramp[label, 1, c] * xx)
    stripes = (np.sin((xx + 0.5 * yy) / period[label]) * 25.0
               * (label % 2 == 0))
    img += stripes[:, :, None]
    img += rng.normal(0.0, 6.0, img.shape).astype(np.float32)
    return np.clip(np.rint(img), 0, 255).astype(np.uint8)


def diff_stats(a, b) -> dict:
    d = np.abs(np.asarray(a).astype(np.int64) - np.asarray(b).astype(np.int64))
    return {"max": int(d.max()), "frac": float((d > 0).mean()),
            "p999": float(np.percentile(d, 99.9))}


def _fmt(s: dict) -> str:
    return (f"max {s['max']}, {s['frac']:.3e} of values differ, "
            f"p99.9 {s['p999']:g}")


def _record(phase, shape, parity, first, warm_ms):
    return {"phase": phase, "shape": list(shape), "parity": parity,
            "compile_s": round(first, 3), "warm_ms": round(warm_ms, 4)}


def _device(img):
    return jax.device_put(jnp.asarray(img))


def check_bilateral_vs_golden(h: int = 1080, w: int = 1920) -> list[dict]:
    """Bilateral and JBF (Triton kernel) and ABF (XLA) vs the golden twins:
    ±1 u8; the share of differing values is reported (the kernel is built
    to reach 0)."""
    import various_image_processings_tpu as vip

    src = synthetic_image(h, w, 1)
    guide = synthetic_image(h, w, 2)
    s, g = _device(src), _device(guide)
    cases = [
        ("bilateral k=9 [kernel] vs golden",
         lambda x: vip.bilateral_filter(x, 9, 10.0, 30.0, impl="pallas"), (s,),
         lambda: golden.bilateral_filter(src, 9, 10.0, 30.0)),
        ("joint bilateral k=9 [kernel] vs golden",
         lambda x, y: vip.joint_bilateral_filter(x, y, 9, 10.0, 30.0,
                                                 impl="pallas"), (s, g),
         lambda: golden.joint_bilateral_filter(src, guide, 9, 10.0, 30.0)),
        ("adaptive bilateral k=9 [xla] vs golden",
         lambda x: vip.adaptive_bilateral_filter(x, 9, 10.0, 30.0), (s,),
         lambda: golden.adaptive_bilateral_filter(src, 9, 10.0, 30.0)),
    ]
    out = []
    for name, fn, args, ref in cases:
        got, first, warm = timed(fn, *args)
        st = diff_stats(got, ref())
        assert got.shape == src.shape and got.dtype == jnp.uint8, name
        assert st["max"] <= 1, (name, st)
        out.append(_record(name, src.shape, _fmt(st), first, warm))
    return out


def check_filters_4k(h: int = 2160, w: int = 3840) -> list[dict]:
    """At 4K: bilateral and JBF (kernel, ``impl="auto"``) vs the same op's
    XLA path on the card, ±1 u8; ABF (XLA) on a 256² interior crop vs
    golden, ±1 u8; gradient vs golden on a 512² interior crop, ≤4 ulp."""
    import various_image_processings_tpu as vip

    src = synthetic_image(h, w, 3)
    guide = synthetic_image(h, w, 4)
    s, g = _device(src), _device(guide)
    out = []
    for name, fn, args in [
            ("bilateral k=9", lambda x, impl: vip.bilateral_filter(
                x, 9, 10.0, 30.0, impl=impl), (s,)),
            ("joint bilateral k=9", lambda x, y, impl: vip.joint_bilateral_filter(
                x, y, 9, 10.0, 30.0, impl=impl), (s, g))]:
        got, first, warm = timed(lambda *a: fn(*a, impl="auto"), *args)
        ref, xfirst, xwarm = timed(lambda *a: fn(*a, impl="xla"), *args, n=2)
        st = diff_stats(got, ref)
        assert got.shape == src.shape, name
        assert st["max"] <= 1, (name, st)
        out.append(_record(f"{name} [auto] vs xla on card", src.shape,
                           _fmt(st) + f"; xla path warm {xwarm:.4f} ms",
                           first, warm))

    r = 4
    n = min(256, h // 4)
    y0, x0 = h // 2 - n // 2, w // 3 - n // 2
    got, first, warm = timed(
        lambda x: vip.adaptive_bilateral_filter(x, 9, 10.0, 30.0), s)
    crop = src[y0 - r:y0 + n + r, x0 - r:x0 + n + r]
    ref = golden.adaptive_bilateral_filter(crop, 9, 10.0, 30.0)[r:-r, r:-r]
    st = diff_stats(np.asarray(got)[y0:y0 + n, x0:x0 + n], ref)
    assert st["max"] <= 1, ("abf", st)
    out.append(_record("adaptive bilateral k=9 [xla] crop vs golden",
                       src.shape, _fmt(st), first, warm))

    got, first, warm = timed(lambda x: vip.gradient(x), s)
    n = min(512, h // 4)
    crop = src[y0 - 1:y0 + n + 1, x0 - 1:x0 + n + 1]
    ref = golden.gradient(crop)[1:-1, 1:-1]
    mine = np.asarray(got)[y0:y0 + n, x0:x0 + n]
    ulp = np.spacing(np.maximum(np.abs(mine), np.abs(ref)))
    worst = float((np.abs(mine - ref) / ulp).max())
    assert got.shape == (h, w) and worst <= 4, ("gradient", worst)
    out.append(_record("gradient [xla] crop vs golden", src.shape,
                       f"max {worst:g} ulp", first, warm))
    return out


def check_jbf_k17(sizes=((600, 900), (2160, 3840))) -> list[dict]:
    """The BTF's closing joint bilateral (k=17, σs=8, σc=√3) alone: the
    kernel vs the XLA path's strict form (the one BTF runs) on the card,
    ±1 u8; the XLA plain and strict times are reported beside the
    kernel's."""
    import various_image_processings_tpu as vip
    from ..ops.bilateral import _bilateral_math

    sc = float(np.sqrt(3.0))

    @jax.jit
    def strict(x, y):
        return _bilateral_math(x.astype(jnp.float32), y.astype(jnp.float32),
                               17, 8.0, sc, strict=True)

    out = []
    for h, w in sizes:
        s, g = _device(synthetic_image(h, w, 11)), _device(synthetic_image(h, w, 12))
        got, first, warm = timed(lambda x, y: vip.joint_bilateral_filter(
            x, y, 17, 8.0, sc, impl="pallas"), s, g)
        _, _, pwarm = timed(lambda x, y: vip.joint_bilateral_filter(
            x, y, 17, 8.0, sc, impl="xla"), s, g, n=3)
        ref, _, swarm = timed(strict, s, g, n=3)
        st = diff_stats(got, ref)
        assert got.shape == (h, w, 3) and st["max"] <= 1, ("jbf k=17", st)
        out.append(_record(
            "joint bilateral k=17 [kernel] vs xla strict on card", (h, w, 3),
            _fmt(st) + f"; xla plain warm {pwarm:.4f} ms, xla strict warm "
            f"{swarm:.4f} ms", first, warm))
    return out


def check_btf(h: int = 600, w: int = 900) -> list[dict]:
    """BTF k=9 nitr=3 with the kernel JBF: ``variant="cuda"`` vs
    ``golden.bilateral_texture_filter``, ``variant="cpp"`` vs the same
    variant's XLA path on the card (golden has only the CUDA pipeline's
    semantics); both p99.9 ≤ 2 and max ≤ 3 (three cascaded ±1 stages).
    The XLA path's time is reported beside the kernel's."""
    import various_image_processings_tpu as vip

    src = synthetic_image(h, w, 5)
    s = _device(src)
    out = []
    for variant in ("cuda", "cpp"):
        got, first, warm = timed(lambda x: vip.bilateral_texture_filter(
            x, 9, 3, impl="pallas", variant=variant), s)
        xla, _, xwarm = timed(lambda x: vip.bilateral_texture_filter(
            x, 9, 3, impl="xla", variant=variant), s, n=3)
        if variant == "cuda":
            ref, what = golden.bilateral_texture_filter(src, 9, 3), "golden"
        else:
            ref, what = xla, "xla on card"
        st = diff_stats(got, ref)
        assert st["p999"] <= 2 and st["max"] <= 3, (variant, st)
        out.append(_record(f"bilateral texture k=9 nitr=3 variant={variant} "
                           f"[kernel] vs {what}", src.shape,
                           _fmt(st) + f"; xla path warm {xwarm:.4f} ms",
                           first, warm))
    return out


def check_btf_4k(h: int = 2160, w: int = 3840) -> list[dict]:
    """BTF k=9 nitr=3 at 4K, both variants, kernel JBF vs the op's XLA path
    on the card, p99.9 ≤ 2 and max ≤ 3; both times are reported."""
    import various_image_processings_tpu as vip

    src = synthetic_image(h, w, 6)
    s = _device(src)
    out = []
    for variant in ("cuda", "cpp"):
        got, first, warm = timed(lambda x: vip.bilateral_texture_filter(
            x, 9, 3, impl="pallas", variant=variant), s)
        ref, _, xwarm = timed(lambda x: vip.bilateral_texture_filter(
            x, 9, 3, impl="xla", variant=variant), s, n=2)
        st = diff_stats(got, ref)
        assert st["p999"] <= 2 and st["max"] <= 3, (variant, st)
        out.append(_record(f"bilateral texture k=9 nitr=3 variant={variant} "
                           "[kernel] vs xla on card", src.shape,
                           _fmt(st) + f"; xla path warm {xwarm:.4f} ms",
                           first, warm))
    return out


def _on_cpu(fn, *args):
    with jax.default_device(jax.devices("cpu")[0]):
        return fn(*args)


def check_slic(size: int = 512, sp: int = 26) -> list[dict]:
    """SLIC S=26, 10 iterations: the same code on the host CPU is the
    reference (there is no golden SLIC).  Segment counts within 2%,
    boundary recall ≥ 0.95 at 2 px, and the invariants tests/test_slic.py
    pins: labels cover the image, each label one connected component,
    every component ≥ S²/20 pixels."""
    import various_image_processings_tpu as vip

    src = synthetic_image(size, size, 7)
    got, first, warm = timed(lambda x: np.asarray(
        vip.superpixel_slic(x, sp, 10)), src, n=3)
    ref = np.asarray(_on_cpu(vip.superpixel_slic, src, sp, 10))
    n_gpu, n_cpu = int(got.max()) + 1, int(ref.max()) + 1
    sizes = np.bincount(got.reshape(-1))
    assert got.shape == (size, size) and got.min() == 0
    assert abs(n_gpu - n_cpu) <= 0.02 * n_cpu, (n_gpu, n_cpu)
    assert (sizes > 0).all() and sizes.min() >= sp * sp // 20, sizes.min()
    recall = boundary_recall(got, ref)
    assert recall >= 0.95, recall
    return [_record(f"superpixel_slic S={sp} vs same code on cpu",
                    src.shape, f"segments {n_gpu} vs {n_cpu}, boundary "
                    f"recall {recall:.4f} @2px, min segment {int(sizes.min())}",
                    first, warm)]


def boundary_recall(labels, ref, tol: int = 2) -> float:
    """Share of ``ref`` boundary pixels within ``tol`` px of a ``labels``
    boundary (4-connected dilation)."""
    def boundary(lbl):
        b = np.zeros(lbl.shape, bool)
        b[:, :-1] |= lbl[:, :-1] != lbl[:, 1:]
        b[:-1, :] |= lbl[:-1, :] != lbl[1:, :]
        return b

    mine = boundary(labels)
    for _ in range(tol):
        grown = mine.copy()
        grown[1:] |= mine[:-1]
        grown[:-1] |= mine[1:]
        grown[:, 1:] |= mine[:, :-1]
        grown[:, :-1] |= mine[:, 1:]
        mine = grown
    theirs = boundary(ref)
    return float((mine & theirs).sum() / max(theirs.sum(), 1))


def hole_psnr(out, src, mask) -> float:
    hole = mask > 0
    err = (np.asarray(out).astype(np.float64)[hole]
           - src.astype(np.float64)[hole])
    return float(10 * np.log10(255.0 ** 2 / max(np.mean(err ** 2), 1e-12)))


def check_wexler(h: int = 402, w: int = 700, hole: int = 64) -> list[dict]:
    """Wexler fill of a centred square hole vs the same code on the host
    CPU: known pixels unchanged, and hole PSNR (against the unmasked
    source) within 1.5 dB of the CPU fill's."""
    import various_image_processings_tpu as vip

    src = synthetic_image(h, w, 8)
    mask = np.zeros((h, w), np.uint8)
    y0, x0 = (h - hole) // 2, (w - hole) // 2
    mask[y0:y0 + hole, x0:x0 + hole] = 255
    got, first, warm = timed(lambda a, m: vip.inpainting_wexler(a, m),
                             src, mask, n=2)
    ref = _on_cpu(vip.inpainting_wexler, src, mask)
    known = mask == 0
    assert got.shape == src.shape
    np.testing.assert_array_equal(got[known], src[known])
    p_gpu, p_cpu = hole_psnr(got, src, mask), hole_psnr(ref, src, mask)
    assert abs(p_gpu - p_cpu) <= 1.5, (p_gpu, p_cpu)
    same = float((got[~known] == ref[~known]).mean())
    return [_record(f"inpainting_wexler {hole}x{hole} hole vs same code on cpu",
                    src.shape, f"hole PSNR {p_gpu:.2f} dB vs {p_cpu:.2f} dB, "
                    f"{same:.3f} of hole values identical", first, warm)]


def check_four_devices(devices, frame_hw=(2160, 3840), big_hw=(4320, 7680),
                       small_hw=(600, 900)) -> list[dict]:
    """Batched and row-sharded paths on a 4-device mesh vs the single-device
    result, bit for bit: bilateral over a 4×1 mesh (8 frames at 4K),
    bilateral over a 1×4 mesh (one 7680×4320 image, ppermute halos), BTF
    over a 4×1 mesh (8 frames at 900×600)."""
    import various_image_processings_tpu as vip
    from jax.sharding import NamedSharding, PartitionSpec as P
    from ..parallel import (BATCH_AXIS, SPATIAL_AXIS, bilateral_filter_batched,
                            bilateral_filter_sharded,
                            bilateral_texture_filter_batched, make_mesh)

    assert len(devices) == 4, devices
    batch_mesh = make_mesh(batch=4, spatial=1, devices=devices)
    row_mesh = make_mesh(batch=1, spatial=4, devices=devices)
    by_frame = NamedSharding(batch_mesh, P(BATCH_AXIS))
    by_row = NamedSharding(row_mesh, P(SPATIAL_AXIS))
    frames = np.stack([synthetic_image(*frame_hw, 10 + i) for i in range(8)])
    small = np.stack([synthetic_image(*small_hw, 20 + i) for i in range(8)])
    big = synthetic_image(*big_hw, 30)
    one = devices[0]
    cases = [
        ("bilateral_filter_batched 4x1 mesh", frames, by_frame,
         lambda x: bilateral_filter_batched(x, 9, 10.0, 30.0, mesh=batch_mesh),
         lambda x: vip.bilateral_filter(x, 9, 10.0, 30.0), True),
        ("bilateral_filter_sharded 1x4 mesh", big, by_row,
         lambda x: bilateral_filter_sharded(x, 9, 10.0, 30.0, mesh=row_mesh),
         lambda x: vip.bilateral_filter(x, 9, 10.0, 30.0), False),
        ("bilateral_texture_filter_batched 4x1 mesh", small, by_frame,
         lambda x: bilateral_texture_filter_batched(x, 9, 3, mesh=batch_mesh),
         lambda x: vip.bilateral_texture_filter(x, 9, 3), True),
    ]
    out = []
    for name, data, sharding, multi, single, per_frame in cases:
        # the input already sits on the mesh as the runner shards it, so
        # the warm time holds no host-to-device or device-to-device copy
        x = jax.block_until_ready(jax.device_put(data, sharding))
        got, first, warm = timed(multi, x, n=3)
        got = np.asarray(got)
        with jax.default_device(one):
            if per_frame:
                ref = np.stack([np.asarray(single(_device(f))) for f in data])
            else:
                ref = np.asarray(single(_device(data)))
        st = diff_stats(got, ref)
        assert got.shape == ref.shape and st["max"] == 0, (name, st)
        out.append(_record(f"{name} vs one device", data.shape,
                           "bit-identical", first, warm))
    return out
