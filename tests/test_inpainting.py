"""Wexler inpainting — functional tests.

The reference has NO inpainting tests (SURVEY.md §4 coverage gap).  These
check the sequential host pieces against hand-built cases and the end-to-end
fill on a synthetic periodic texture where the correct completion is known.
"""

import numpy as np
import pytest

from various_image_processings_tpu.models.inpainting import (
    WexlerInpainting, extract_mask_contour, calculate_weight,
    contour_with_priority)
from various_image_processings_tpu.ops.inpainting import inpainting_wexler


def square_mask(size, y0, y1, x0, x1):
    m = np.zeros((size, size), np.uint8)
    m[y0:y1, x0:x1] = 255
    return m


def test_contour_of_square():
    m = square_mask(20, 5, 10, 5, 10)  # 5×5 hole
    contour = extract_mask_contour(m, 5, 5)
    # boundary of a 5×5 square = 16 pixels
    assert len(contour) == 16
    assert set(contour) == {(x, y) for y in range(5, 10) for x in range(5, 10)
                            if y in (5, 9) or x in (5, 9)}


def test_contour_raises_on_isolated_pixel_mass():
    # single-pixel hole: the contour is that one pixel
    m = square_mask(10, 4, 5, 4, 5)
    contour = extract_mask_contour(m, 4, 4)
    assert contour == [(4, 4)]


def test_weight_decays_into_hole():
    m = square_mask(30, 10, 20, 10, 20)
    w = calculate_weight(m > 0)
    assert w[9, 15] == 0.0              # outside the hole
    assert w[10, 15] == 1.0             # on the contour: 1.2^0
    assert w[15, 15] < w[11, 15] <= 1.0  # decays toward the centre


def test_priority_prefers_known_surroundings():
    # L-shaped hole: the convex corner pixel has more known neighbours
    m = np.zeros((30, 30), np.uint8)
    m[10:20, 10:20] = 255
    ring = contour_with_priority(m)
    first_x, first_y = ring[0]
    # corners of the square have the most known pixels in their window
    assert (first_x in (10, 19)) and (first_y in (10, 19))


def test_inpaint_periodic_texture():
    # vertical stripes of period 8; a small hole must be filled with stripes
    size = 72
    img = np.zeros((size, size, 3), np.uint8)
    stripes = ((np.arange(size) // 4) % 2 * 180 + 40).astype(np.uint8)
    img[:, :, :] = stripes[None, :, None]
    mask = square_mask(size, 30, 38, 30, 38)
    out = inpainting_wexler(img, mask, verbose=False)
    assert out.shape == img.shape
    expected = img.copy()
    diff = np.abs(out.astype(int) - expected.astype(int))[30:38, 30:38]
    # exemplar fill on a perfectly periodic texture should be near-exact
    assert np.median(diff) <= 2
    assert diff.mean() <= 30


def test_inpaint_validates_shapes():
    with pytest.raises(ValueError, match="sizes differ"):
        WexlerInpainting().apply(np.zeros((10, 10, 3), np.uint8),
                                 np.zeros((9, 10), np.uint8))


def test_ring_search_energy_matches_bruteforce():
    """The single-conv masked-SSD scan (hi/lo integer split riding the same
    filters as the cross term) must reproduce the brute-force
    E[t] = min_c Σ_i m_ti (a_ci − b_ti)² over all candidates, including the
    first-minimum (raster) tie-break and the border in-range masks."""
    import jax.numpy as jnp
    from various_image_processings_tpu.models.inpainting import (
        _build_p117, _ring_targets_search, WHALF, WINDOW_SIZE)

    rng = np.random.default_rng(7)
    h, w = 33, 41
    img = rng.integers(0, 256, (h, w, 3)).astype(np.float32)
    rem = np.zeros((h, w), np.float32)
    rem[14:19, 20:25] = 1.0              # 5×5 hole
    # targets: the hole boundary AND a border-hugging pixel (partial mask)
    targets = [(14, 20), (14, 24), (18, 22), (3, 0)]
    rem[3, 0] = 1.0
    ty = np.array([t[0] for t in targets], np.int32)
    tx = np.array([t[1] for t in targets], np.int32)
    tvalid = np.ones(len(targets), bool)

    img_j = jnp.asarray(img)
    e, by, bx = _ring_targets_search(
        img_j, _build_p117(img_j, w), jnp.asarray(rem), jnp.asarray(ty),
        jnp.asarray(tx), jnp.asarray(tvalid), h, w, initial=False)
    e, by, bx = np.asarray(e), np.asarray(by), np.asarray(bx)

    # brute force
    pad = WHALF
    img_p = np.pad(img, [(pad, pad), (pad, pad), (0, 0)])
    rem_p = np.pad(rem, [(pad, pad), (pad, pad)])
    for i, (y, x) in enumerate(targets):
        b = img_p[y : y + WINDOW_SIZE, x : x + WINDOW_SIZE]
        m = np.zeros((WINDOW_SIZE, WINDOW_SIZE), np.float32)
        for ky in range(WINDOW_SIZE):
            for kx in range(WINDOW_SIZE):
                yy, xx = y + ky - pad, x + kx - pad
                m[ky, kx] = float(0 <= yy < h and 0 <= xx < w)
        best = (np.inf, -1, -1)
        for cy in range(pad, h - pad):
            for cx in range(pad, w - pad):
                if rem[cy - pad : cy + pad + 1, cx - pad : cx + pad + 1].any():
                    continue
                a = img[cy - pad : cy + pad + 1, cx - pad : cx + pad + 1]
                en = float((m[:, :, None] * (a - b) ** 2).sum())
                if en < best[0]:
                    best = (en, cy, cx)
        assert (by[i], bx[i]) == (best[1], best[2]), (i, targets[i])
        # f32/bf16-exact products, only the final Σ (≤3·10⁷) may round
        assert abs(e[i] - best[0]) <= max(4.0, 1e-6 * best[0]), (i, targets[i])


def test_wexler_bbox_bucketing_reuses_executable():
    """Two different masks with similar-size holes at different positions
    must NOT trigger a second while-loop compile: the static bbox size is
    bucketed to multiples of 64 and the origin is a traced scalar
    (each distinct static shape costs a full compile through the remote
    compiler — ADVICE r2 / VERDICT r2 item 7)."""
    from various_image_processings_tpu.models import inpainting as M
    from various_image_processings_tpu.ops.inpainting import inpainting_wexler

    if not hasattr(M._fill_pass_device, "_cache_size"):
        pytest.skip("jax.jit._cache_size private API unavailable in this "
                    "JAX version")
    size = 64
    img = np.tile(((np.arange(size) // 4) % 2 * 180 + 40)
                  .astype(np.uint8)[None, :, None], (size, 1, 3))
    m1 = np.zeros((size, size), np.uint8)
    m1[10:18, 12:20] = 255
    m2 = np.zeros((size, size), np.uint8)
    m2[34:40, 30:38] = 255

    inpainting_wexler(img, m1)
    n_fill = M._fill_pass_device._cache_size()
    n_loop = M._energy_loops_device._cache_size()
    inpainting_wexler(img, m2)
    assert M._fill_pass_device._cache_size() == n_fill
    assert M._energy_loops_device._cache_size() == n_loop


def test_p117_incremental_update_matches_rebuild():
    """The cached candidate planes must stay coherent: after mutating the
    image inside a bbox, _update_p117 must equal a from-scratch
    _build_p117 bit-for-bit (bf16 entries are exact integers <= 255), for
    boxes in the interior, flush on each border, and the full image."""
    import jax.numpy as jnp
    from various_image_processings_tpu.models.inpainting import (
        _build_p117, _update_p117)

    rng = np.random.default_rng(11)
    h, w = 40, 52
    for (by0, bx0, bh, bw) in [(10, 15, 8, 12), (0, 0, 6, 6),
                               (32, 40, 8, 12), (0, 40, 5, 12),
                               (0, 0, 40, 52)]:
        img = rng.integers(0, 256, (h, w, 3)).astype(np.float32)
        p117 = _build_p117(jnp.asarray(img), w)
        img2 = img.copy()
        img2[by0:by0 + bh, bx0:bx0 + bw] = rng.integers(
            0, 256, (bh, bw, 3)).astype(np.float32)
        upd = _update_p117(p117, jnp.asarray(img2), h, w, bh, bw,
                           jnp.int32(by0), jnp.int32(bx0))
        ref = _build_p117(jnp.asarray(img2), w)
        np.testing.assert_array_equal(np.asarray(upd), np.asarray(ref))


def _search(img, rem, targets, initial=False):
    import jax.numpy as jnp
    from various_image_processings_tpu.models import inpainting as M

    h, w = rem.shape
    img_j = jnp.asarray(img)
    ty = jnp.asarray(np.array([t[0] for t in targets], np.int32))
    tx = jnp.asarray(np.array([t[1] for t in targets], np.int32))
    tvalid = jnp.asarray(np.ones(len(targets), bool))
    return [np.asarray(v) for v in M._ring_targets_search(
        img_j, M._build_p117(img_j, w), jnp.asarray(rem), ty, tx, tvalid,
        h, w, initial=initial)]


def test_conv_search_first_minimum_raster_tie_break():
    """Vertical stripes of period 4 make every 4th candidate column an exact
    zero-energy match: the conv search must pick the FIRST one in raster
    order of window centres (the reference's scan order), i.e. the lowest
    valid row, then the lowest matching column."""
    from various_image_processings_tpu.models.inpainting import WHALF

    h, w = 34, 45
    stripes = ((np.arange(w) // 2) % 2 * 180 + 40).astype(np.float32)
    img = np.broadcast_to(stripes[None, :, None], (h, w, 3)).copy()
    rem = np.zeros((h, w), np.float32)
    rem[20:24, 25:29] = 1.0
    targets = [(20, 25), (23, 28)]
    e, by, bx = _search(img, rem, targets)
    for i, (ty, tx) in enumerate(targets):
        assert e[i] == 0.0
        assert by[i] == WHALF
        # first column ≥ WHALF with the target's stripe phase
        want_x = next(x for x in range(WHALF, w - WHALF)
                      if (x - tx) % 4 == 0)
        assert bx[i] == want_x


def test_conv_search_all_invalid_candidates_inf():
    """When every 13×13 candidate window touches the hole, the search has no
    candidate and must report +inf energy (the search-failure signal,
    PARITY.md D4) for every valid target."""
    h, w = 20, 20
    img = np.full((h, w, 3), 50, np.float32)
    rem = np.zeros((h, w), np.float32)
    rem[9, 9] = 1.0  # any 13x13 window inside a 20x20 image contains (9,9)
    e, _, _ = _search(img, rem, [(9, 9), (9, 9)])
    assert not np.isfinite(e).any()


def test_search_failure_discards_pass():
    """Failure parity (PARITY.md D4): a fill pass whose search fails reports
    energy −1, and the pipeline keeps its current image instead of
    committing a partial fill."""
    import jax.numpy as jnp
    from various_image_processings_tpu.models.inpainting import (
        _fill_pass_device)

    h, w = 20, 20
    img = np.full((h, w, 3), 50, np.uint8)
    img[9, 9] = 7
    mask = np.zeros((h, w), np.uint8)
    mask[9, 9] = 255
    _, energy = _fill_pass_device(
        jnp.asarray(img), jnp.asarray((mask > 0).astype(np.float32)),
        jnp.asarray(calculate_weight(mask > 0).astype(np.float32)), h, w,
        True, bbox_size=(h, w), bbox_origin=jnp.zeros(2, jnp.int32))
    assert float(energy) == -1.0
    out = inpainting_wexler(img, mask)
    np.testing.assert_array_equal(out, img)
