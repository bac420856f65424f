"""Wexler exemplar-based inpainting.

Counterpart of ``WexlerInpaintingImpl`` (reference:
include/cpp/wexler_inpainting.hpp:10-332): coarse-to-fine Gaussian pyramid,
per level an onion-peel fill driven by contour priority, with ≤5
energy-minimization passes that keep a pass only if the weighted energy
decreased.

Redesign of the hot path for an accelerator: the reference's ``serach_exemplar``
(:220-269) is an exhaustive per-pixel O(W·H·13²) SSD scan, called once per
filled pixel.  Here the ENTIRE fill pass is one device program
(``_fill_pass_device``): a ``lax.while_loop`` peels one contour ring per
iteration, the whole ring is batched, and the scan over ALL candidates
becomes ONE dynamic-filter convolution (a bf16 matrix-unit workload):

    E[t, c] = Σ_i m_ti (a_ci − b_ti)²
            = conv(image planes, per-target 13×13 filters)[t, c] + Σ_i m_ti b_ti²

(the a² term rides the same conv through an exact 256·hi + lo integer
split — see ``_ring_targets_search``); candidates
whose 13×13 patch touches the hole are rejected via a box-sum of the
remaining mask (the reference's reject test, :238-241).  One pass costs ONE
dispatch and ONE download — the per-ring host round-trips that dominated the
wall clock are gone.

Known divergences from the strictly sequential reference, kept deliberately
(documented for the parity budget):
- all targets of one contour ring share the ring-start image state (the
  reference fills one pixel at a time, letting each fill feed the next
  search); energies are f32 conv sums instead of exact ints;
- the ring is the morphological boundary of the remaining mask (hole pixels
  with a known 8-neighbour, image border counting as known) instead of the
  reference's Freeman chain-code trace from the first masked pixel.  For a
  simply-connected hole the sets are identical; for multi-component masks
  all components peel simultaneously (the reference does one component's
  contour per round).  Masks with known ISLANDS inside peel outside-in
  like the reference (the island may not seed the initial rings until the
  advancing front reaches it — ``_island_known`` / the seed-restricted
  ``_boundary_ring``; round-5 wexler_multi fuzz found island-seeded
  annulus fills converge ~4 dB below the reference's outer-contour
  order).  ``extract_mask_contour`` /
  ``contour_with_priority`` (the trace + priority-queue twins) remain for
  the weight computation and API/test parity;
- when a ring exceeds the batch capacity, the overflow is deferred to the
  next while-iteration in raster order rather than filled in priority order
  (within one batch the order is irrelevant — all fills read ring-start
  state; std::priority_queue's tie order is unspecified anyway);
- ENERGY passes (non-initial) batch ALL remaining pixels in raster chunks
  of ≤ENERGY_CAP instead of peeling rings: their patch context already
  exists from the previous pass, so this is the Jacobi-style simultaneous
  update of Wexler et al.'s EM iteration (PARITY.md D4) and amortizes the
  search's fixed per-dispatch cost;
- odd pyramid levels: pyrUp output is cropped to the finer level's size
  (the reference feeds a 2×-even upsample into a masked copyTo, which
  asserts on odd level sizes);
- candidate rejection is global: a candidate whose 13×13 window touches the
  hole anywhere is rejected for every target, whereas the reference only
  rejects when the offending tap maps to an in-range target tap (:229-241).
  For targets within WHALF of the image border this rejects candidates the
  reference would accept; the reference's behavior makes the valid-candidate
  set target-dependent, which would forfeit the shared candidate matrix that
  makes the batched conv work.  Border-hole fills can therefore pick a
  different exemplar (both picks minimize the same masked SSD);
- on exemplar-search failure mid-pass (every candidate window intersects the
  hole), the pass's partial fill is DISCARDED (energy −1 → the caller keeps
  its current image); the reference commits the partially-filled buffer (energy −1 passes
  its ``current_energy <= new_energy`` check, :43-49).  Deliberate: a partial
  commit leaves u8 garbage in unfilled pixels that the next pyramid level
  upsamples into the image, whereas discarding keeps the level's input
  intact for the (coarser-level-initialized) next pass.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from ..ops.pyramid import pyr_down, pyr_up

WINDOW_SIZE = 13          # include/cpp/wexler_inpainting.hpp:326
WHALF = WINDOW_SIZE // 2
PYRAMID_BOTTOM_SIZE = 32  # :324
MAX_LOOP = 5              # :325
WEIGHT_BASE = 1.2         # :172
RING_CAP = 256            # max ring targets batched per while-loop iteration
ENERGY_CAP = 1024         # max targets per chunk in energy (non-initial)
                          # passes — larger batches amortize the search's
                          # fixed per-conv cost
BEAM_MAX_DIM = 128        # multi-start beam runs on pyramid levels whose max
                          # dim is ≤ this (they cost a negligible share of
                          # the total; the top level of a bench-scale image
                          # always runs exactly once)


# ---------------------------------------------------------------------------
# host-side helpers (sequential by nature in the reference)
# ---------------------------------------------------------------------------

_CHAIN = [(1, 0), (1, -1), (0, -1), (-1, -1), (-1, 0), (-1, 1), (0, 1), (1, 1)]
_NEXT_CODE = [7, 7, 1, 1, 3, 3, 5, 5]


def extract_mask_contour(mask: np.ndarray, start_x: int, start_y: int):
    """Freeman chain-code boundary trace (reference :94-145).  Robustness
    differences: raises instead of std::exit on malformed masks; rotates past
    out-of-bounds neighbours (the reference stops rotating and then reads the
    out-of-bounds pixel); single-pixel holes yield a 1-pixel contour.

    Uses the native C++ tracer (native/src/vip_native.cpp) when built."""
    from ..utils import native
    got = native.trace_contour(np.ascontiguousarray(mask, np.uint8),
                               start_x, start_y)
    if got is not None:
        return got
    h, w = mask.shape
    contour = []
    code_index = 5
    cx, cy = start_x, start_y
    length = 0
    while True:
        if cx == start_x and cy == start_y and length > 0:
            break
        if length > h * w:
            raise RuntimeError("contour did not converge")
        contour.append((cx, cy))
        x = cx + _CHAIN[code_index][0]
        y = cy + _CHAIN[code_index][1]
        search = 0
        while (not (0 <= x < w and 0 <= y < h) or mask[y, x] == 0) and search < 8:
            code_index = (code_index + 1) % 8
            x = cx + _CHAIN[code_index][0]
            y = cy + _CHAIN[code_index][1]
            search += 1
        if search >= 8:
            if length == 0:
                return contour  # isolated single-pixel hole (the reference
                # std::exits here, :132-135; a 1-pixel contour is well defined)
            raise RuntimeError("next contour pixel not found")
        cx, cy = x, y
        code_index = _NEXT_CODE[code_index]
        length += 1
    return contour


def _first_masked(mask: np.ndarray):
    ys, xs = np.nonzero(mask)
    if len(ys) == 0:
        return None
    i = np.lexsort((xs, ys))[0]  # raster order
    return int(xs[i]), int(ys[i])


def calculate_weight(mask: np.ndarray) -> np.ndarray:
    """w = 1.2^(−min distance to contour) for hole pixels (reference :147-189)."""
    start = _first_masked(mask)
    if start is None:
        return mask.astype(np.float64)
    contour = np.array(extract_mask_contour(mask, *start), np.float64)  # (Nc, 2) x,y
    weight = np.zeros(mask.shape, np.float64)
    ys, xs = np.nonzero(mask)
    # chunked exact min-distance (hole pixels × contour points)
    for i in range(0, len(ys), 4096):
        yb = ys[i : i + 4096].astype(np.float64)
        xb = xs[i : i + 4096].astype(np.float64)
        d2 = (xb[:, None] - contour[None, :, 0]) ** 2 + (yb[:, None] - contour[None, :, 1]) ** 2
        dmin = np.minimum(np.sqrt(d2).min(axis=1), mask.shape[0] * mask.shape[1])
        weight[ys[i : i + 4096], xs[i : i + 4096]] = WEIGHT_BASE ** (-dmin)
    return weight


def contour_with_priority(mask: np.ndarray):
    """Contour pixels sorted by priority = #known pixels in the 13×13 window,
    descending (reference :191-218). Stable sort keeps contour order on ties."""
    start = _first_masked(mask)
    if start is None:
        return []
    contour = extract_mask_contour(mask, *start)
    h, w = mask.shape
    known = (mask == 0).astype(np.int32)
    # priority via box sums on a zero-padded known-map (out-of-range → 0)
    ii = np.zeros((h + 1, w + 1), np.int64)
    ii[1:, 1:] = known
    np.cumsum(ii, axis=0, out=ii)
    np.cumsum(ii, axis=1, out=ii)

    def box(y, x):
        y0, y1 = max(y - WHALF, 0), min(y + WHALF + 1, h)
        x0, x1 = max(x - WHALF, 0), min(x + WHALF + 1, w)
        return ii[y1, x1] - ii[y1, x0] - ii[y0, x1] + ii[y0, x0]

    prio = [int(box(y, x)) for x, y in contour]
    order = np.argsort(-np.array(prio), kind="stable")
    return [contour[i] for i in order]


# ---------------------------------------------------------------------------
# device-side fill pass (whole onion-peel loop in one XLA program)
# ---------------------------------------------------------------------------

def _build_p117(image_f, width):
    """Candidate-side conv input: the kx-packed (H, n_cx, 117) bf16 planes
    (see _ring_targets_search LAYOUT note).  All entries are integers ≤ 255
    (hi = floor(a²/256) ≤ 254, lo = a² mod 256, a ≤ 255), so the bf16 cast
    is exact — carrying p117 as bf16 loop state loses nothing."""
    n_cx = width - 2 * WHALF
    k = WINDOW_SIZE
    sq = image_f * image_f                                   # exact ints
    hi = jnp.floor(sq * jnp.float32(1.0 / 256.0))
    lo = sq - hi * jnp.float32(256.0)
    planes = jnp.concatenate([hi, lo, image_f], axis=2)      # (H, W, 9)
    return jnp.concatenate(
        [planes[:, kx : kx + n_cx, :] for kx in range(k)],
        axis=2).astype(jnp.bfloat16)                         # (H, n_cx, 117)


def _update_p117(p117, image_f, height, width, bh, bw, by0, bx0):
    """Refresh the (bh, bw)-at-(by0, bx0) hole-box region of the cached
    p117 after a ring fill mutated image_f there.  Image columns
    [bx0, bx0+bw) feed p117 columns [bx0−12, bx0+bw): recompute a
    (bh, uw+12) image strip and re-pack just those columns — O(box) work
    instead of the full O(H·W·117) rebuild per while-iteration."""
    n_cx = width - 2 * WHALF
    k = WINDOW_SIZE
    uw = min(bw + 2 * WHALF, n_cx)      # static (bw, n_cx static)
    # p117 col x' reads image cols [x', x'+2·WHALF], so image cols
    # [bx0, bx0+bw) feed p117 cols [bx0−2·WHALF, bx0+bw)
    ux0 = jnp.clip(bx0 - 2 * WHALF, 0, n_cx - uw)  # traced origin
    # p117 col x' ∈ [ux0, ux0+uw) reads image cols [x', x'+12] ⊆
    # [ux0, ux0+uw+12) with uw+12 ≤ n_cx+12 = width — always in bounds
    strip = jax.lax.dynamic_slice(image_f, (by0, ux0, 0),
                                  (bh, uw + 2 * WHALF, 3))
    sq = strip * strip
    hi = jnp.floor(sq * jnp.float32(1.0 / 256.0))
    lo = sq - hi * jnp.float32(256.0)
    planes = jnp.concatenate([hi, lo, strip], axis=2)
    upd = jnp.concatenate([planes[:, kx : kx + uw, :] for kx in range(k)],
                          axis=2).astype(jnp.bfloat16)       # (bh, uw, 117)
    return jax.lax.dynamic_update_slice(p117, upd, (by0, ux0, 0))


def _ring_targets_search(image_f, p117, remained, ty, tx, tvalid, height,
                         width, initial):
    """Exemplar search for ≤RING_CAP ring targets against ALL candidates.

    image_f: (H, W, 3) f32 (integer-valued); p117: the cached candidate
    planes for the SAME image (_build_p117/_update_p117); remained:
    (H, W) f32 (1 = hole); ty/tx: (T,) i32 target coords (padded entries
    anywhere in-bounds); tvalid: (T,) bool.  Returns (energy (T,) f32 —
    inf where no candidate, 0 where invalid —, best_y, best_x (T,) i32).
    """
    t = ty.shape[0]
    patch_len = WINDOW_SIZE * WINDOW_SIZE * 3

    img_pad = jnp.pad(image_f, [(WHALF, WHALF), (WHALF, WHALF), (0, 0)])
    rem_pad = jnp.pad(remained, [(WHALF, WHALF), (WHALF, WHALF)])

    # target patches + masks ------------------------------------------------
    def grab(y, x):
        # centre (y, x) → padded top-left (y, x)
        patch = jax.lax.dynamic_slice(
            img_pad, (y, x, 0), (WINDOW_SIZE, WINDOW_SIZE, 3))
        rem = jax.lax.dynamic_slice(
            rem_pad, (y, x), (WINDOW_SIZE, WINDOW_SIZE))
        return patch, rem

    patches, rems = jax.vmap(grab)(ty, tx)          # (T, 13, 13, 3), (T, 13, 13)
    dy = jnp.arange(-WHALF, WHALF + 1)
    in_range = ((ty[:, None] + dy[None, :] >= 0) & (ty[:, None] + dy[None, :] < height))
    in_range_x = ((tx[:, None] + dy[None, :] >= 0) & (tx[:, None] + dy[None, :] < width))
    m = in_range[:, :, None] & in_range_x[:, None, :]      # (T, 13, 13)
    if initial:
        m = m & (rems == 0)    # skip the target's own unknown pixels (:244-246)
    # channel-major (c, ky, kx) flattening: rows of the conv filters below
    # reshape back to (3, k, k) without a transpose
    b = patches.transpose(0, 3, 1, 2).reshape(t, patch_len)
    mflat = (jnp.broadcast_to(m[:, None, :, :],
                              (t, 3, WINDOW_SIZE, WINDOW_SIZE))
             .reshape(t, patch_len).astype(jnp.float32))

    # candidate scan: ONE channel-packed dynamic-filter conv ------------------
    # E'[t, c] = Σ_i m_ti a_ci² − 2 Σ_i m_ti b_ti a_ci is a correlation of
    # the image with per-target 13×13 filters.  bf16 inputs/filters are
    # exact (image values are u8-valued ints; a² splits 256·hi + lo with
    # hi, lo ≤ 255; the cross filter −2·m·b ≤ 510 is even → ≤8 significant
    # bits); every product is exact in the f32 accumulator and only the
    # final Σ (≤ ~3·10⁷) rounds, deterministically.
    #
    # Layout: a (13,13,9,T) conv over (H, W, 9) has only C_in=9 input
    # channels, too few to fill a matrix unit.  Packing the kx tap axis into
    # channels — p117[y, x, kx·9+c] = planes9[y, x+kx, c], 13 static shifted
    # slices — turns it into a (13, 1)-window conv with C_in = 117.
    n_cy = height - 2 * WHALF   # candidate centre rows: WHALF .. H-WHALF-1
    n_cx = width - 2 * WHALF
    ncand = n_cy * n_cx
    k = WINDOW_SIZE

    # candidate validity: no remaining pixel in the patch (box sum == 0)
    ii = jnp.pad(jnp.cumsum(jnp.cumsum(remained, axis=0), axis=1),
                 [(1, 0), (1, 0)])
    box_sum = (ii[k:, k:] - ii[k:, :-k] - ii[:-k, k:] + ii[:-k, :-k])
    valid2d = box_sum == 0                                   # (n_cy, n_cx)

    b_masked = b * mflat
    b2_const = jnp.sum(b_masked * b, axis=1)                 # Σ m b²  (T,)

    # candidate planes come in CACHED (p117 loop state, bf16-exact): the
    # O(H·W·117) pack is paid once per pass, not once per while-iteration
    m4 = mflat.reshape(t, 3, k, k)
    bm4 = b_masked.reshape(t, 3, k, k)
    filt = jnp.concatenate(
        [m4 * jnp.float32(256.0), m4, jnp.float32(-2.0) * bm4],
        axis=1)                                              # (T, 9, ky, kx)

    # (T, 9, ky, kx) → (ky, kx, 9, T) → merge (kx, 9) → (ky, 1, 117, T)
    f117 = (filt.transpose(2, 3, 1, 0).reshape(k, 1, k * 9, t)
            .astype(jnp.bfloat16))
    x = p117[None]                                           # (1, H, n_cx, 117)
    dn = jax.lax.conv_dimension_numbers(x.shape, f117.shape,
                                        ("NHWC", "HWIO", "NHWC"))
    e = jax.lax.conv_general_dilated(
        x, f117, (1, 1), "VALID", dimension_numbers=dn,
        preferred_element_type=jnp.float32)[0].reshape(ncand, t)
    e = jnp.where(valid2d.reshape(ncand)[:, None], e, jnp.float32(np.inf))
    # argmin returns the FIRST minimum → candidate scan order is raster
    # order of window top-lefts, same tie-break as the reference's loops
    idx = jnp.argmin(e, axis=0)                              # (T,)
    emin = jnp.take_along_axis(e, idx[None, :], axis=0)[0]
    best_e = jnp.where(tvalid, emin + b2_const, 0.0)
    best_y = (idx // n_cx + WHALF).astype(jnp.int32)
    best_x = (idx % n_cx + WHALF).astype(jnp.int32)
    return best_e, best_y, best_x


def _boundary_ring(rem, height, width, seed=None):
    """Hole pixels with a known 8-neighbour (image border counts as known).

    seed: optional f32 map restricting WHICH known pixels may seed the
    ring (1 = may seed).  Used by the initial pass to peel outside-in on
    masks with known islands (see _pass_core); None = every known pixel
    seeds (the original semantics)."""
    known = (1.0 - rem) if seed is None else seed
    known = jnp.pad(known, 1, constant_values=1.0)
    neigh = jnp.zeros((height, width), jnp.float32)
    for dy in range(3):
        for dx in range(3):
            if dy == 1 and dx == 1:
                continue
            neigh = jnp.maximum(neigh, known[dy : dy + height, dx : dx + width])
    return (rem > 0) & (neigh > 0)


def _island_known(hole: "np.ndarray"):
    """Known pixels NOT 8-connected to the image border (host-side, once
    per level): the 'known islands' of a cavity mask.  Returns None when
    there are none (the common case — the restricted-ring machinery in
    _pass_core is then skipped entirely, keeping simply-connected fills
    byte-identical to before) or when ALL known pixels are islands (no
    outside to peel from)."""
    known = ~hole
    if known.all() or not known.any():
        return None
    try:
        from scipy import ndimage
        lbl, _ = ndimage.label(known, structure=np.ones((3, 3), bool))
    except ImportError:  # scipy-less host: keep the original semantics
        return None
    border = np.unique(np.concatenate([lbl[0], lbl[-1], lbl[:, 0],
                                       lbl[:, -1]]))
    border = border[border > 0]
    if border.size == 0:
        return None
    island = known & ~np.isin(lbl, border)
    return island if island.any() else None


def _pass_core(img_f, rem_f, weight, height, width,
               initial: bool, cap: int, bbox_size: tuple | None,
               bbox_origin, island=None):
    """One exemplar_based_inpainting pass (reference :271-322) as traced
    jax code over f32 state: lax.while_loop peels ≤cap boundary targets per
    iteration.  Returns (filled f32 image, energy f32 — −1.0 on search
    failure, in which case the partial fill must be discarded).

    bbox_size: STATIC (bh, bw) hole bounding-box size, bucketed up to
    multiples of 64 host-side so that varied masks of similar extent reuse
    one compiled executable (each distinct static size costs a full
    while-loop compile).  bbox_origin: TRACED
    (by0, bx0) i32 scalars — the box position never forces a recompile.
    The hole never grows, so the boundary ring and its nonzero-compaction
    run on the small box instead of the whole image — on a 700×402 image
    with a 64² hole this removes ~2.5 ms of O(H·W) work from EVERY ring
    iteration.  The box margin pixels are known (rem = 0) by construction
    (host bucketing keeps the box ⊇ the tight hole box + 1), so treating
    box edges as known (the pad inside ``_boundary_ring``) matches the
    full-image semantics; where the hole touches the image border the box
    edge IS the image border, which counts as known in the reference's
    neighbour test too."""
    if bbox_size is None:
        bh, bw = height, width
        by0 = jnp.int32(0)
        bx0 = jnp.int32(0)
    else:
        bh, bw = bbox_size
        by0, bx0 = bbox_origin

    def body(carry):
        img_f, p117, rem, energy, fail = carry
        rem_box = jax.lax.dynamic_slice(rem, (by0, bx0), (bh, bw))
        if initial:
            # onion peel: only boundary pixels have known context to copy.
            # With a known ISLAND inside the hole (island != None), restrict
            # the seeds to border-connected known pixels plus pixels filled
            # during THIS pass — the fill then advances outside-in exactly
            # like the reference's chain-code trace, which walks the hole
            # component's OUTER contour (include/cpp/wexler_inpainting.hpp
            # :94-145), instead of spreading the island's few colors
            # outward (round-5 wexler_multi fuzz case 15: annulus fill
            # 21.8 dB island-seeded vs the reference's 25.6 outside-in).
            # Deadlock guard: a hole component enclosed BY an island has no
            # border-connected seed — fall back to the unrestricted ring so
            # the while_loop always progresses.
            if island is None:
                ring = _boundary_ring(rem_box, bh, bw)
            else:
                isl_box = jax.lax.dynamic_slice(island, (by0, bx0),
                                                (bh, bw))
                rem0_box = jax.lax.dynamic_slice(rem_f, (by0, bx0),
                                                 (bh, bw))
                filled = (rem0_box > 0) & (rem_box == 0)
                seed = ((rem_box == 0)
                        & (filled | (isl_box == 0))).astype(jnp.float32)
                ring_r = _boundary_ring(rem_box, bh, bw, seed=seed)
                ring = jnp.where(jnp.any(ring_r), ring_r,
                                 _boundary_ring(rem_box, bh, bw))
        else:
            # energy passes re-fill pixels whose values already exist from
            # the previous pass, so context does not depend on peel order:
            # take ALL remaining pixels in raster chunks of `cap` — this is
            # the Jacobi-style simultaneous update of Wexler et al.'s
            # original EM iteration, and it amortizes the search's fixed
            # per-conv cost over 4-30× more targets per dispatch (PARITY.md
            # D4; the reference's sequential per-pixel update is
            # Gauss-Seidel-flavored, ours per-chunk)
            ring = rem_box > 0
        count = jnp.sum(ring)
        tys, txs = jnp.nonzero(ring, size=cap, fill_value=0)  # raster order
        tys = tys + by0
        txs = txs + bx0
        tvalid = jnp.arange(cap) < count
        e, by, bx = _ring_targets_search(img_f, p117, rem, tys, txs, tvalid,
                                         height, width, initial)
        fail_now = jnp.any(tvalid & ~jnp.isfinite(e))   # :308-311
        do = tvalid & ~fail_now
        # gate the scatters through out-of-bounds indices (mode="drop"):
        # padded / failing entries write nowhere
        ty_s = jnp.where(do, tys, height)
        vals = img_f[by, bx]                            # (cap, 3)
        img_f = img_f.at[ty_s, txs].set(vals, mode="drop")
        rem = rem.at[ty_s, txs].set(0.0, mode="drop")
        p117 = _update_p117(p117, img_f, height, width, bh, bw, by0, bx0)
        energy = energy + jnp.sum(jnp.where(do, e * weight[tys, txs], 0.0))
        return img_f, p117, rem, energy, fail | fail_now

    def cond(carry):
        _, _, rem, _, fail = carry
        rem_box = jax.lax.dynamic_slice(rem, (by0, bx0), (bh, bw))
        return (jnp.sum(rem_box) > 0) & ~fail

    carry0 = (img_f, _build_p117(img_f, width), rem_f, jnp.float32(0.0),
              jnp.bool_(False))
    img_f, _, _, energy, fail = jax.lax.while_loop(cond, body, carry0)
    return img_f, jnp.where(fail, jnp.float32(-1.0), energy)


@functools.partial(jax.jit, static_argnames=("height", "width", "initial",
                                              "cap", "bbox_size"))
def _fill_pass_device(image_u8, remained0, weight, height, width,
                      initial: bool, cap: int = RING_CAP,
                      bbox_size: tuple | None = None, bbox_origin=(0, 0),
                      island=None):
    """One pass, u8 in/out (see _pass_core)."""
    img_f, energy = _pass_core(image_u8.astype(jnp.float32),
                               remained0.astype(jnp.float32), weight,
                               height, width, initial, cap, bbox_size,
                               bbox_origin, island)
    return jnp.clip(img_f, 0.0, 255.0).astype(jnp.uint8), energy


@functools.partial(jax.jit, static_argnames=("height", "width", "max_loop",
                                              "cap", "bbox_size"))
def _energy_loops_device(image_u8, remained0, weight, height, width,
                         max_loop: int, cap: int = RING_CAP,
                         bbox_size: tuple | None = None, bbox_origin=(0, 0)):
    """The whole per-level energy-minimisation loop (reference :40-50) as
    ONE device program: ≤max_loop non-initial passes, committing a pass's
    fill only when its weighted energy strictly decreased, stopping on the
    first non-decrease or search failure (whose partial fill is discarded,
    PARITY.md D4).  Returns (final u8 image, energies (max_loop,) f32 —
    NaN for passes that never ran, final committed energy f32 — +inf when
    no pass committed; the multi-start beam selects branches by it).  One
    scalar sync per LEVEL instead of per pass."""
    rem_f = remained0.astype(jnp.float32)
    energies0 = jnp.full((max_loop,), jnp.nan, jnp.float32)

    def body(carry):
        img_f, cur_e, i, stop, energies = carry
        cand_f, e = _pass_core(img_f, rem_f, weight, height, width,
                               False, cap, bbox_size, bbox_origin)
        energies = energies.at[i].set(e)
        fail = e < 0
        nondecr = cur_e <= e
        commit = jnp.logical_not(fail | nondecr)
        # a pass mutates hole pixels only, so committing is taking cand_f
        img_f = jnp.where(commit, cand_f, img_f)
        cur_e = jnp.where(commit, e, cur_e)
        return img_f, cur_e, i + 1, stop | fail | nondecr, energies

    def cond(carry):
        _, _, i, stop, _ = carry
        return (i < max_loop) & jnp.logical_not(stop)

    carry0 = (image_u8.astype(jnp.float32), jnp.float32(np.inf),
              jnp.int32(0), jnp.bool_(False), energies0)
    img_f, cur_e, _, _, energies = jax.lax.while_loop(cond, body, carry0)
    return jnp.clip(img_f, 0.0, 255.0).astype(jnp.uint8), energies, cur_e


@functools.partial(jax.jit, static_argnames=("height", "width", "bbox_size",
                                              "dither"))
def _alt_init_device(image_u8, remained0, height, width,
                     bbox_size: tuple, bbox_origin, dither: bool):
    """Alternative coarsest-level initialization for the multi-start beam:
    fill the hole with smooth Jacobi diffusion from its boundary (Wexler et
    al.'s original EM initialization is a smooth interpolant; the
    reference's onion-peel exemplar fill, :24-34, is one particular —
    sometimes poor — starting basin).  ``dither`` adds a deterministic
    per-pixel jitter (±12, coordinate-hashed) on top, giving the energy
    loop a third, symmetry-broken basin.  Runs on the static hole bbox."""
    bh, bw = bbox_size
    by0, bx0 = bbox_origin
    img = image_u8.astype(jnp.float32)
    box_img = jax.lax.dynamic_slice(img, (by0, bx0, jnp.int32(0)),
                                    (bh, bw, 3))
    box_rem = jax.lax.dynamic_slice(remained0.astype(jnp.float32),
                                    (by0, bx0), (bh, bw))
    hole = box_rem > 0
    known = 1.0 - box_rem
    mean = ((box_img * known[:, :, None]).sum((0, 1))
            / jnp.maximum(known.sum(), 1.0))
    cur = jnp.where(hole[:, :, None], mean, box_img)

    def step(_, cur):
        p = jnp.pad(cur, ((1, 1), (1, 1), (0, 0)), mode="edge")
        s = jnp.zeros_like(cur)
        for dy in range(3):
            for dx in range(3):
                s = s + p[dy : dy + bh, dx : dx + bw]
        return jnp.where(hole[:, :, None], s * jnp.float32(1.0 / 9.0), cur)

    cur = jax.lax.fori_loop(0, bh + bw, step, cur)
    if dither:
        yy = jax.lax.broadcasted_iota(jnp.int32, (bh, bw), 0)
        xx = jax.lax.broadcasted_iota(jnp.int32, (bh, bw), 1)
        h32 = (yy + by0) * np.int32(92837111) ^ (xx + bx0) * np.int32(
            689287499)  # i32 wrap is defined in XLA — a cheap coord hash
        jit8 = ((jax.lax.shift_right_logical(h32, 8) % 25) - 12).astype(
            jnp.float32)
        cur = jnp.where(hole[:, :, None], cur + jit8[:, :, None], cur)
    cur = jnp.where(hole[:, :, None], cur, box_img)
    out = jax.lax.dynamic_update_slice(
        img, cur, (by0, bx0, jnp.int32(0)))
    return jnp.clip(out, 0.0, 255.0).astype(jnp.uint8)


# ---------------------------------------------------------------------------
# orchestration
# ---------------------------------------------------------------------------

class WexlerInpainting:
    """checkpoint_dir: if set, the per-level filled state is saved after each
    pyramid level and ``apply`` resumes from the deepest completed level — the
    checkpoint/resume story the reference lacks (SURVEY.md §5: its closest
    analog is keeping per-level pyramid state in memory,
    include/cpp/wexler_inpainting.hpp:45-49)."""

    def __init__(self, max_loop: int = MAX_LOOP,
                 pyramid_bottom_size: int = PYRAMID_BOTTOM_SIZE,
                 verbose: bool = False, checkpoint_dir: str | None = None,
                 multi_start: int = 3):
        self.max_loop = max_loop
        self.pyramid_bottom_size = pyramid_bottom_size
        self.verbose = verbose
        self.checkpoint_dir = checkpoint_dir
        # multi-start beam width (1 disables): the coarsest level's fill is
        # branched over `multi_start` initializations (reference-style
        # onion-peel exemplar fill, smooth diffusion, dithered diffusion),
        # each branch is refined through the cheap ≤BEAM_MAX_DIM levels,
        # and the beam collapses to the lowest-weighted-energy branch
        # before the first expensive level.  Deterministic (the dither is a
        # coordinate hash).  Beyond-reference quality feature: round-4 fuzz
        # found coarse-level Jacobi fills settling local minima up to
        # 3.6 dB below the reference's sequential refill (PARITY.md D4) —
        # energy-selected multi-start escapes those basins.  A resumed
        # checkpoint continues single-branch from the saved state.
        self.multi_start = multi_start

    def _log(self, *args):
        if self.verbose:
            print(*args, flush=True)

    def _construct_pyramid(self, src: np.ndarray, mask: np.ndarray):
        """Reference :68-91: pyrDown until the next level's floor-halved
        min dimension drops below pyramid_bottom_size.  The source pyramid
        stays DEVICE-RESIDENT (the fill loop rebinds levels rather than
        mutating); the mask pyramid is fetched to the host in ONE round
        trip (weights/bbox/contours are host work)."""
        import jax as _jax

        srcs = [jnp.asarray(src)]
        masks_dev = [jnp.asarray(mask)]
        while min(srcs[-1].shape[0] // 2, srcs[-1].shape[1] // 2) >= self.pyramid_bottom_size:
            srcs.append(pyr_down(srcs[-1]))
            masks_dev.append(pyr_down(masks_dev[-1]))
        return srcs, _jax.device_get(masks_dev)

    @staticmethod
    def _hole_bbox(hole: np.ndarray):
        """((bh, bw) static size, (by0, bx0) traced origin) for the hole's
        1-margin bounding box.  The SIZE is bucketed up to multiples of 64
        (clamped to the image) so different masks of similar extent share
        one compiled executable — each distinct static size costs a full
        while-loop compile; the origin is a
        runtime value and never forces a recompile."""
        h, w = hole.shape
        ys, xs = np.nonzero(hole)
        if len(ys) == 0:
            return (min(64, h), min(64, w)), (0, 0)
        y0 = max(int(ys.min()) - 1, 0)
        y1 = min(int(ys.max()) + 2, h)
        x0 = max(int(xs.min()) - 1, 0)
        x1 = min(int(xs.max()) + 2, w)
        bh = min(-(-(y1 - y0) // 64) * 64, h)
        bw = min(-(-(x1 - x0) // 64) * 64, w)
        # keep the (grown) box inside the image; growth keeps margin ⊇ 1
        by0 = min(y0, h - bh)
        bx0 = min(x0, w - bw)
        return (bh, bw), (by0, bx0)

    def _fill_pass(self, image_dev, hole_dev, weight_dev, bbox,
                   initial: bool, island_dev=None):
        """One exemplar_based_inpainting pass (reference :271-322) on
        DEVICE-RESIDENT state.  Returns (filled device image, float energy —
        −1.0 on failure, in which case the caller keeps its current image:
        the discard-partial-fill semantics of PARITY.md D4).  The only
        host↔device traffic per pass is the scalar energy readback."""
        h, w = hole_dev.shape
        bbox_size, bbox_origin = bbox
        filled, energy = _fill_pass_device(
            image_dev, hole_dev, weight_dev, h, w, initial,
            bbox_size=bbox_size,
            bbox_origin=jnp.asarray(bbox_origin, jnp.int32),
            island=island_dev)
        return filled, float(energy)  # scalar sync: the pass is complete

    def apply(self, src, mask) -> np.ndarray:
        """(H, W, 3) u8 image + (H, W) u8 mask (hole > 0) → (H, W, 3) u8."""
        src = np.asarray(src)
        mask = np.asarray(mask)
        if src.shape[:2] != mask.shape:
            raise ValueError("src and mask sizes differ")
        srcs, masks = self._construct_pyramid(src, mask)
        num_layers = len(srcs)

        do_initial = True
        start_layer = num_layers - 1
        ckpt_path = None
        if self.checkpoint_dir is not None:
            import os
            os.makedirs(self.checkpoint_dir, exist_ok=True)
            ckpt_path = os.path.join(self.checkpoint_dir, "wexler_state.npz")
            if os.path.exists(ckpt_path):
                state = np.load(ckpt_path)
                if (int(state["num_layers"]) == num_layers
                        and state["src_0"].shape == srcs[0].shape):
                    start_layer = int(state["next_layer"])
                    do_initial = bool(state["do_initial"])
                    for i in range(num_layers):
                        srcs[i] = state[f"src_{i}"]
                    self._log(f"resuming from layer {start_layer}")

        branches = None  # multi-start beam states at the current layer
        branch_layer = None  # the layer the beam was created at
        for layer in range(start_layer, -1, -1):
            self._log(f"Layer {layer}...")
            hole = masks[layer] > 0
            weight = calculate_weight(hole)
            bbox = self._hole_bbox(hole)
            # device-resident level state: upload once per layer, download
            # once at the end; each pass syncs only the scalar energy
            img_dev = jnp.asarray(srcs[layer])
            hole_dev = jnp.asarray(hole.astype(np.float32))
            weight_dev = jnp.asarray(weight.astype(np.float32))
            island = _island_known(hole)  # None unless the mask has
            island_dev = (None if island is None  # known islands (cavities)
                          else jnp.asarray(island.astype(np.float32)))

            if do_initial:
                filled, energy = self._fill_pass(img_dev, hole_dev,
                                                 weight_dev, bbox,
                                                 initial=True,
                                                 island_dev=island_dev)
                if energy < 0:
                    self._log(f"failed to inpaint layer {layer}")
                else:
                    img_dev = filled
                    do_initial = False
                    if (self.multi_start > 1 and hole.any()
                            and max(hole.shape) <= BEAM_MAX_DIM):
                        branches = [img_dev]
                        branch_layer = layer
                        for dither in (False, True)[: self.multi_start - 1]:
                            branches.append(_alt_init_device(
                                jnp.asarray(srcs[layer]), hole_dev,
                                *hole.shape, bbox_size=bbox[0],
                                bbox_origin=jnp.asarray(bbox[1], jnp.int32),
                                dither=dither))

            # the whole ≤max_loop energy loop runs on device; the energies
            # come back for logging in one sync with the final image.
            # cap: the chunk size is a QUALITY knob, not just a perf one —
            # within a chunk the refill is Jacobi (no target sees another's
            # update) while the reference's per-pixel refill is sequential
            # Gauss-Seidel (PARITY.md D4).  A 96-px hole filled as ONE
            # Jacobi chunk converged 5.2 dB below the reference (round-4
            # fuzz case 51; ~8 sequential chunks recovered it to +1 dB
            # ABOVE).  Small holes therefore get fine chunks (~8 per pass,
            # pow-2 bucketed: 16/32/64/128 — chunks run inside one device
            # program, so the extra sequentialism costs no dispatches and
            # trivial absolute compute at these sizes); large holes keep
            # whole-hole chunks bucketed to multiples of 256 (few compile
            # variants, amortizing the fixed per-search conv cost — at
            # bench scale the conv wants the big T dim).
            nhole = int(hole.sum())
            if nhole <= 1024:
                ecap = 16
                while ecap * 8 < nhole:
                    ecap *= 2
            else:
                ecap = max(RING_CAP,
                           min(ENERGY_CAP, -(-nhole // 256) * 256))
            cand_states = branches if branches is not None else [img_dev]
            if branches is not None and layer != branch_layer and hole.any():
                # the "pyramid-skip" branch: a from-scratch onion-peel
                # exemplar fill AT THIS LEVEL (the upsampled hole content is
                # ignored — rem marks it unknown), competing on energy with
                # the coarse-seeded branches.  Round-4 fuzz case 150's
                # coarse-level local minimum matched the reference only with
                # the pyramid disabled — this branch makes that basin
                # reachable without a global mode switch.  Stays async (the
                # initial fill's failure case simply loses the selection).
                fresh, _fe = _fill_pass_device(
                    img_dev, hole_dev, weight_dev, *hole.shape, True,
                    bbox_size=bbox[0],
                    bbox_origin=jnp.asarray(bbox[1], jnp.int32),
                    island=island_dev)
                cand_states = branches + [fresh]
            results = []
            for b in cand_states:
                results.append(_energy_loops_device(
                    b, hole_dev, weight_dev, *hole.shape,
                    max_loop=self.max_loop, cap=ecap, bbox_size=bbox[0],
                    bbox_origin=jnp.asarray(bbox[1], jnp.int32)))
            if len(results) == 1:
                img_dev, energies = results[0][0], results[0][1]
            else:
                # branch selection ON DEVICE (a host sync here would break
                # the level loop's async stream): lowest final committed
                # weighted energy; argmin's
                # first-occurrence tie-break gives the reference-style
                # branch (index 0) priority on ties and on all-failed +inf
                fins = jnp.stack([r[2] for r in results])
                best = jnp.argmin(fins)
                img_dev = jnp.stack([r[0] for r in results])[best]
                energies = jnp.stack([r[1] for r in results])[best]
                if self.verbose:  # sync is acceptable in debug mode
                    self._log("  multi-start energies: "
                              + ", ".join(f"{float(e):.6g}"
                                          for e in np.asarray(fins))
                              + f" -> branch {int(best)}")
            srcs[layer] = img_dev   # device-resident; no per-level download
            if self.verbose:
                for i, e in enumerate(np.asarray(energies)):
                    if np.isnan(e):
                        break
                    self._log(f"  loop {i + 1}: energy {e}")

            if layer > 0:
                # pyrUp masked copy ON DEVICE (reference :52-57): the whole
                # level loop stays one async stream — the only forced syncs
                # are the coarsest level's initial-fill energy scalar and
                # the final download
                hole_next = jnp.asarray(masks[layer - 1] > 0)
                base_next = jnp.asarray(srcs[layer - 1])

                def lift(b):
                    up = pyr_up(b, out_shape=masks[layer - 1].shape[:2])
                    return jnp.where(hole_next[:, :, None], up, base_next)

                if (branches is not None
                        and max(masks[layer - 1].shape) <= BEAM_MAX_DIM):
                    # next level is still cheap: carry the whole beam up
                    branches = [lift(r[0]) for r in results]
                    srcs[layer - 1] = lift(img_dev)  # = best branch, lifted
                else:
                    branches = None
                    srcs[layer - 1] = lift(img_dev)

            if ckpt_path is not None:
                np.savez(ckpt_path, num_layers=num_layers,
                         next_layer=layer - 1, do_initial=do_initial,
                         **{f"src_{i}": np.asarray(srcs[i])
                            for i in range(num_layers)})

        return np.array(srcs[0])
