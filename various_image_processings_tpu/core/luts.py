"""Precomputed filter kernels (LUTs) for the bilateral-filter family.

Twin of ``internal::pre_compute_kernels`` (reference:
include/cpp/bilateral_filter.hpp:12-37). The tables are built on host in
float64 exactly as the C++ does (the Gaussian coefficients are doubles there),
then stored as float32 — bit-identical table contents are a prerequisite for
the ±1/255 parity targets.
"""

from __future__ import annotations

import numpy as np

# Range-kernel table lengths: the bilateral/joint filters index by the L1
# distance of three u8 channels (max 3*255), the adaptive filter by an
# offset-widened distance (max ~2*3*255).  Reference:
# include/cpp/bilateral_filter.hpp:12 (256*3) and
# include/cpp/adaptive_bilateral_filter.hpp:34 (512*3).
COLOR_TABLE_SIZE_BILATERAL = 256 * 3
COLOR_TABLE_SIZE_ADAPTIVE = 512 * 3


def space_kernel(ksize: int, sigma_space: float) -> np.ndarray:
    """(ksize, ksize) f32 spatial Gaussian, zeroed outside the inscribed circle.

    Mirrors include/cpp/bilateral_filter.hpp:18-29: entries with
    ``kx²+ky² > radius²`` are exactly 0.
    """
    radius = ksize // 2
    # -1. / (2 * σs * σs): the product is evaluated in f32 (σs is float in
    # C++), the division in f64.
    denom = np.float32(np.float32(2.0 * np.float32(sigma_space)) * np.float32(sigma_space))
    coeff = -1.0 / float(denom)
    ky, kx = np.mgrid[-radius : radius + 1, -radius : radius + 1]
    r2 = (kx * kx + ky * ky).astype(np.int64)
    table = np.exp(r2 * coeff).astype(np.float32)
    table[r2 > radius * radius] = 0.0
    return table


def color_table(sigma_color: float, size: int = COLOR_TABLE_SIZE_BILATERAL) -> np.ndarray:
    """(size,) f32 range Gaussian table: ``exp(-(i*i) / (2 σc²))``.

    Mirrors include/cpp/bilateral_filter.hpp:31-34.
    """
    denom = np.float32(np.float32(2.0 * np.float32(sigma_color)) * np.float32(sigma_color))
    coeff = -1.0 / float(denom)
    i = np.arange(size, dtype=np.int64)
    return np.exp((i * i) * coeff).astype(np.float32)


def pre_compute_kernels(ksize: int, sigma_space: float, sigma_color: float,
                        color_table_size: int = COLOR_TABLE_SIZE_BILATERAL):
    """Return (space_kernel (k,k) f32, color_table (size,) f32)."""
    return space_kernel(ksize, sigma_space), color_table(sigma_color, color_table_size)


def gauss_coeff_f32(sigma: float) -> np.float32:
    """f32 value of ``-1. / (2 σ²)`` with the C++ evaluation order.

    The adaptive bilateral path recomputes its range Gaussian as
    ``exp(d² * coeff)`` (with the double-rounding twin of PARITY.md D2b)
    instead of gathering from the 1536-entry table — within 1 ulp of the
    table entries (the table is built in f64).
    """
    denom = np.float32(np.float32(2.0 * np.float32(sigma)) * np.float32(sigma))
    return np.float32(-1.0 / float(denom))


def color_table_zero_index(sigma_color: float,
                           size: int = COLOR_TABLE_SIZE_BILATERAL) -> int:
    """First index whose f32 table entry is exactly 0.0 (``size`` if none).

    The reference builds its range table in f64 and stores f32
    (include/cpp/adaptive_bilateral_filter.hpp:34-38), so entries fade
    through the f32 SUBNORMAL range (~2⁻¹²⁶..2⁻¹⁴⁹) before reaching exact
    zero — whereas an in-register f32 ``exp`` flushes that whole band to 0.
    Device kernels that recompute the Gaussian must therefore (a) scale the
    weights by an exact power of two so the subnormal band lands in normal
    range (the sums/sumk ratio is bit-invariant under a 2^S scale), and
    (b) apply this index as a hard cutoff so distances the table maps to
    exact 0 stay exactly 0.  Matters for the ADAPTIVE filter, whose
    center-tap distance is the (unbounded) box-mean offset; the plain
    bilateral center tap has distance 0 and always dominates.
    """
    tab = color_table(sigma_color, size)
    nz = np.nonzero(tab == np.float32(0.0))[0]
    return int(nz[0]) if nz.size else size


def product_zero_index(space_weight: float, sigma_color: float,
                       size: int = COLOR_TABLE_SIZE_BILATERAL) -> int:
    """First index where the f32 PRODUCT ``ws · table[i]`` is exactly 0.0.

    The reference's per-tap weight is ``kernel_space * color_table[idx]``
    evaluated in f32 (include/cpp/adaptive_bilateral_filter.hpp:68), so the
    flush-to-zero boundary depends on the SPACE weight too: a tiny ws times
    a subnormal table entry underflows to exact 0 several indices before the
    table itself reaches 0.  With small σ_color/σ_space an entire adaptive-
    bilateral window can land past this boundary — the reference then
    divides 0/0 and casts the NaN to 0 — so any cutoff-based recompute must
    use THIS per-tap index (not ``color_table_zero_index``) to replicate the
    reference's zero-weight set exactly.  The shipped device kernels don't
    need a cutoff at all: their double-rounded grid quantization reproduces
    the product's flush-to-zero boundary implicitly (PARITY.md D2b) — this
    function remains as the analytic ground truth the tests pin that
    boundary against.  f32 multiplication is correctly rounded and the table
    is non-increasing, so the product is non-increasing and first-zero is a
    sharp threshold.
    """
    tab = color_table(sigma_color, size)
    prod = (np.float32(space_weight) * tab).astype(np.float32)
    nz = np.nonzero(prod == np.float32(0.0))[0]
    return int(nz[0]) if nz.size else size
