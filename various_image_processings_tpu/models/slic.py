"""SLIC superpixels on the accelerator.

Counterpart of ``SuperpixelSLIC`` (reference: include/cpp/slic.hpp:114-480)
with the sequential per-center window scans reformulated as vectorized,
race-free k-means:

- **association** (reference :236-281): instead of each center scattering
  into a global distance/label map (order-dependent), every pixel gathers its
  ≤25 candidate centers from the 5×5 grid-cell neighborhood (upsampled center
  planes — no gathers), takes the masked min, and compares against the
  *persistent* distance map (the reference's map carries across iterations —
  quirk preserved).  Tie-breaks match: strictly-smaller wins, so the lowest
  center index wins ties, like the reference's ascending center loop.
  **Bounded-drift assumption**: the reference scans the ±S window around each
  center's *current* position (:243-246); the 5×5 home-cell gather covers
  that window for any center drift up to TWO cells (drift beyond one cell is
  common on textured regions; beyond two was never observed — centers are
  pulled toward their cell-local pixel mass each step).
- **center means**: accumulated DURING the prefix-min scan at each center's
  own turn, exactly like the reference's in-scan accumulation (:262-269):
  a pixel stolen by a later center still counts in the earlier center's
  mean, and stale labels outside every scanned window count in none.
  Integer truncation preserved (the reference's ClusterCenter fields are
  ints, :273-277).  A center that loses all its pixels keeps its previous
  state (the reference divides by zero — UB).
- **updateCenters snap** (reference :283-306): each center snaps to the pixel
  whose color is closest to the new mean.  The reference stores the running
  minimum through an int vector (`min_dist[label] = dist` truncates), which
  is provably equivalent to a first-occurrence argmin over floor(dist) keys —
  implemented as two segment_mins.
- **early exit** (reference :143-147): lax.while_loop on (it < n) & updated.
- **enforce_connectivity** (reference :386-458): host-side connected
  components (scipy sparse union) + raster-order small-segment merge into the
  nearest-color neighbor; the recursive flood fills become vectorized edge
  extraction, so no stack-depth hazard on large segments.

The distance metric is the reference's default euclidean with L×2.55
(include/cpp/slic.hpp:8-13, fixed at :138); ΔE2000 exists in the reference
but is never selectable, and is provided here as an optional metric.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from ..core.colors import bgr2lab_u8_exact
from ..core.pad import cdiv


def _color_dist_euclid(l1, a1, b1, l2, a2, b2):
    """Reference euclidean_distance (include/cpp/slic.hpp:8-13): L scaled 2.55."""
    dl = (l1 - l2) * jnp.float32(2.55)
    da = a1 - a2
    db = b1 - b2
    return dl * dl + da * da + db * db


def _color_dist_fn(metric: str):
    if metric == "euclidean":
        return _color_dist_euclid
    if metric == "ciede2000":
        from ..core.ciede2000 import ciede2000_square
        return ciede2000_square
    if metric == "ciede2000_ref":  # the reference's π-scaled variant
        from ..core.ciede2000 import ciede2000_ref_square
        return ciede2000_ref_square
    raise ValueError(f"unknown SLIC metric {metric!r}")


def _init_centers(lab_f: jax.Array, height: int, width: int, sp_size: int,
                  per_col: int, per_row: int):
    """Grid seeding + color re-sampling at the 3×3 min-Laplacian pixel.

    Reference: include/cpp/slic.hpp:165-223.  Note the reference perturbs
    only the *color* (re-sampled at the min-gradient pixel) — the seed
    position stays at the cell center (:217-222).
    """
    gy = jnp.arange(per_col)
    gx = jnp.arange(per_row)
    top = gy * sp_size
    left = gx * sp_size
    bottom = jnp.minimum(top + sp_size - 1, height - 1)
    right = jnp.minimum(left + sp_size - 1, width - 1)
    cy = (top + bottom) // 2          # (per_col,)
    cx = (left + right) // 2          # (per_row,)
    cyy = jnp.repeat(cy, per_row)     # (N,) row-major over cells
    cxx = jnp.tile(cx, per_col)

    # 4-neighbour Laplacian of the Lab image, BORDER_REFLECT_101, summed
    # over channels (cv::Laplacian ksize=1, :187-188), one (H, W) plane per
    # channel.
    grad = jnp.zeros((height, width), jnp.float32)
    for ch in range(3):
        c = lab_f[:, :, ch]
        p = jnp.pad(c, [(1, 1), (1, 1)], mode="reflect")
        grad = grad + (p[:-2, 1:-1] + p[2:, 1:-1] + p[1:-1, :-2]
                       + p[1:-1, 2:] - 4.0 * c)

    flat_grad = grad.reshape(-1)
    lab_flat = lab_f.reshape(-1, 3)

    # candidates: centre first (ties keep the centre), then the 3×3 window
    # in (dy, dx) scan order with clamped coords (duplicates are harmless
    # under strict-less).
    offsets = [(0, 0)] + [(dy, dx) for dy in (-1, 0, 1) for dx in (-1, 0, 1)]
    cand_vals = []
    cand_idx = []
    for dy, dx in offsets:
        yy = jnp.clip(cyy + dy, 0, height - 1)
        xx = jnp.clip(cxx + dx, 0, width - 1)
        idx = yy * width + xx
        cand_idx.append(idx)
        cand_vals.append(jnp.take(flat_grad, idx))
    vals = jnp.stack(cand_vals)       # (10, N)
    idxs = jnp.stack(cand_idx)
    best = jnp.argmin(vals, axis=0)   # first occurrence of the minimum
    pick = jnp.take_along_axis(idxs, best[None], axis=0)[0]
    colors = jnp.take(lab_flat, pick, axis=0)  # (N, 3) — color re-sample only
    return (cxx.astype(jnp.float32), cyy.astype(jnp.float32),
            colors.astype(jnp.float32))


@functools.partial(jax.jit, static_argnames=(
    "height", "width", "sp_size", "num_iteration", "color_scale", "metric"))
def slic_device(lab_u8: jax.Array, height: int, width: int, sp_size: int,
                num_iteration: int, color_scale: float,
                metric: str = "euclidean"):
    """Device part: init + assign/update loop → (labels (H,W) i32,
    centers (N,5) f32, distances (H,W) f32, max_drift_cells f32).

    ``max_drift_cells`` is the running maximum over iterations and centers
    of the Chebyshev distance (in cell units) between a center's current
    containing cell and its home cell — the quantity the 5×5 gather's
    bounded-drift assumption is about.  Values ≤ 2 mean every reference
    ±S window was fully covered; > 2 means some scans were clipped (the
    wrapper warns loudly — see SuperpixelSLIC.apply)."""
    per_row = cdiv(width, sp_size)
    per_col = cdiv(height, sp_size)
    n = per_row * per_col
    space_norm = jnp.float32(1.0) / jnp.float32(sp_size * sp_size)
    color_norm = jnp.float32(1.0) / jnp.float32(color_scale * color_scale)
    color_dist = _color_dist_fn(metric)

    lab_f = lab_u8.astype(jnp.float32)
    cx0, cy0, col0 = _init_centers(lab_f, height, width, sp_size, per_col, per_row)
    centers0 = jnp.concatenate(
        [cx0[:, None], cy0[:, None], col0], axis=1)  # (N, 5): x, y, l, a, b

    xs = jnp.arange(width, dtype=jnp.float32)[None, :].repeat(height, 0)
    ys = jnp.arange(height, dtype=jnp.float32)[:, None].repeat(width, 1)
    gx = (jnp.arange(width) // sp_size)[None, :].repeat(height, 0)
    gy = (jnp.arange(height) // sp_size)[:, None].repeat(width, 1)
    pix_l = lab_f[:, :, 0]
    pix_a = lab_f[:, :, 1]
    pix_b = lab_f[:, :, 2]
    flat_index = (jnp.arange(height * width, dtype=jnp.int32)
                  .reshape(height, width))

    big = jnp.float32(np.finfo(np.float32).max)
    # pad to whole cells so per-cell min-reductions are pure reshapes
    pad_y = per_col * sp_size - height
    pad_x = per_row * sp_size - width

    # Cell-membership indicator matrices: Ah[h, c] = 1 iff image row h lies
    # in cell-row c (ragged last cell included).  Cell↔image moves become
    # indicator matmuls, which keep every image-space array in its natural
    # (H, W) layout whatever sp_size is.
    # Precision.HIGHEST keeps the products exact: every operand is an
    # integer-valued f32 ≤ 2¹⁸ against a 0/1 indicator, covered by the
    # f32-as-bf16-triple contraction (exactness pinned by tests vs the
    # reshape formulation and the reference oracle).
    _hi = jax.lax.Precision.HIGHEST
    Ah = jnp.asarray((np.arange(height)[:, None] // sp_size
                      == np.arange(per_col)[None, :]).astype(np.float32))
    Aw = jnp.asarray((np.arange(width)[:, None] // sp_size
                      == np.arange(per_row)[None, :]).astype(np.float32))

    def upsample_pl(grid_vals):
        """(C, per_col, per_row) → (C, H, W) by cell repetition, as two
        indicator matmuls (values ≤ 511, exact under HIGHEST)."""
        return jnp.einsum("fcd,hc,wd->fhw", grid_vals, Ah, Aw,
                          precision=_hi)

    def cell_sum(masked_feats):
        """(F, H, W) → (F, per_col, per_row) per-cell sums as matmuls.
        Exact: integer-valued f32 summands, counts ≤ S², partial sums well
        below 2²⁴."""
        return jnp.einsum("fhw,hc,wd->fcd", masked_feats, Ah, Aw,
                          precision=_hi,
                          preferred_element_type=jnp.float32)

    def upsample1(grid_vals):
        """(per_col, per_row) → (H, W) by repeat — used for the snap min
        keys, whose floor(dist) values reach ~2¹⁸ and are NOT guaranteed
        exact through a bf16-split matmul."""
        up = jnp.repeat(jnp.repeat(grid_vals, sp_size, axis=0), sp_size, axis=1)
        return up[:height, :width]

    def association(centers, labels, dists):
        """One association pass + in-scan mean accumulation.

        The reference's centers scan in ascending index order against a
        SHARED persistent distance/label map (:248-271): the final labels
        are order-independent (strict-less, fixed centers), but each
        center's mean is accumulated DURING its own scan — a pixel stolen
        by a later center stays in the earlier center's mean, and a pixel
        whose stale label drifted outside every scanning window joins no
        mean.  Ascending center index == the (dy, dx) plane order below, so
        the sequential semantics vectorize as a running (dist, label)
        prefix-min with per-plane membership accumulation.
        """
        cgrid = centers.reshape(per_col, per_row, 5).transpose(2, 0, 1)
        run_d = dists
        run_l = labels
        updated = jnp.int32(0)
        feats = jnp.stack([xs, ys, pix_l, pix_a, pix_b,
                           jnp.ones((height, width), jnp.float32)], axis=0)
        sums = jnp.zeros((6, per_col, per_row), jnp.float32)
        # 5×5 cell neighbourhood: covers every center whose CURRENT position
        # drifted up to two cells from its home cell — a superset of the
        # reference's ±S windows for any drift ≤ 2S (3×3 missed drifted
        # centers; boundary recall vs the reference 0.80 → 0.94 on lenna)
        for dy in (-2, -1, 0, 1, 2):
            for dx in (-2, -1, 0, 1, 2):
                # shift the center grid so cell (gy, gx) sees neighbour
                # (gy+dy, gx+dx); out-of-range cells are invalid
                shifted = jnp.roll(cgrid, (-dy, -dx), axis=(1, 2))
                plane = upsample_pl(shifted)                   # (5, H, W)
                ncy = gy + dy
                ncx = gx + dx
                in_range = ((ncy >= 0) & (ncy < per_col)
                            & (ncx >= 0) & (ncx < per_row))
                cxp, cyp = plane[0], plane[1]
                # reference window: |x−cx| ≤ S and |y−cy| ≤ S (:243-246)
                covered = (jnp.abs(xs - cxp) <= sp_size) & (jnp.abs(ys - cyp) <= sp_size)
                scanned = in_range & covered
                d = (space_norm * ((xs - cxp) ** 2 + (ys - cyp) ** 2)
                     + color_norm * color_dist(
                         plane[2], plane[3], plane[4],
                         pix_l, pix_a, pix_b))
                d = jnp.where(scanned, d, big)
                lbl = ((ncy * per_row + ncx)).astype(jnp.int32)
                better = d < run_d  # strict: lowest center index wins ties
                updated = updated + better.sum()
                run_d = jnp.where(better, d, run_d)
                run_l = jnp.where(better, lbl, run_l)
                # membership at THIS center's turn (:262-269): scanned and
                # currently labelled with it (stolen-later pixels still count).
                # The plane's pixel→center map is regular (cell (gy,gx) →
                # center (gy+dy, gx+dx)), so the accumulation is a dense
                # per-cell indicator matmul + grid shift — no scatter.
                member = scanned & (run_l == lbl)
                contrib = jnp.where(member[None], feats, 0.0)
                cell = cell_sum(contrib)
                # out-of-range contributions are zero (member ⊆ in_range),
                # so the roll wrap-around carries only zeros
                sums = sums + jnp.roll(cell, (dy, dx), axis=(1, 2))
        return run_l, run_d, updated, sums.reshape(6, n).T

    def center_means(centers, sums):
        counts = sums[:, 5:6]
        # integer truncation like the reference's int ClusterCenter (:273-277)
        means = jnp.floor(sums[:, :5] / jnp.maximum(counts, 1.0))
        return jnp.where(counts > 0, means, centers)

    offsets_5x5 = [(dy, dx) for dy in (-2, -1, 0, 1, 2)
                   for dx in (-2, -1, 0, 1, 2)]
    big_i = jnp.int32(2**30)

    def snap_centers(centers, means, labels):
        """Snap each center to the pixel color-closest to the mean
        (reference :283-306; floor-key argmin ≡ the int min_dist quirk).

        Dense two-pass formulation: association only assigns labels from a
        pixel's 5×5 cell neighbourhood, so every center's members lie in
        ITS 5×5 neighbourhood and the per-label segment-min becomes 25
        shifted-plane per-cell reshape-mins — no scatter.  Pass A finds
        each center's min floor-key, pass B the first (raster) pixel
        attaining it."""
        mgrid = means.reshape(per_col, per_row, 5).transpose(2, 0, 1)

        def plane_info(dy, dx):
            shifted = jnp.roll(mgrid[2:], (-dy, -dx), axis=(1, 2))
            plane = upsample_pl(shifted)                       # (3, H, W)
            ncy = gy + dy
            ncx = gx + dx
            in_range = ((ncy >= 0) & (ncy < per_col)
                        & (ncx >= 0) & (ncx < per_row))
            lbl = (ncy * per_row + ncx).astype(jnp.int32)
            member = in_range & (labels == lbl)
            d = color_dist(plane[0], plane[1], plane[2],
                           pix_l, pix_a, pix_b)
            return member, jnp.floor(d)

        minkey = jnp.full((per_col, per_row), big, jnp.float32)
        for dy, dx in offsets_5x5:
            member, key = plane_info(dy, dx)
            masked = jnp.where(member, key, big)
            masked = jnp.pad(masked, [(0, pad_y), (0, pad_x)],
                             constant_values=big)
            cell = masked.reshape(per_col, sp_size, per_row,
                                  sp_size).min(axis=(1, 3))
            minkey = jnp.minimum(minkey, jnp.roll(cell, (dy, dx), axis=(0, 1)))

        first = jnp.full((per_col, per_row), big_i)
        for dy, dx in offsets_5x5:
            member, key = plane_info(dy, dx)
            mk_plane = upsample1(jnp.roll(minkey, (-dy, -dx), axis=(0, 1)))
            is_min = member & (key == mk_plane)
            pick = jnp.where(is_min, flat_index, big_i)
            pick = jnp.pad(pick, [(0, pad_y), (0, pad_x)],
                           constant_values=big_i)
            cell = pick.reshape(per_col, sp_size, per_row,
                                sp_size).min(axis=(1, 3))
            first = jnp.minimum(first, jnp.roll(cell, (dy, dx), axis=(0, 1)))

        first = first.reshape(n)
        has_pixels = first < big_i
        safe = jnp.where(has_pixels, first, 0)
        px = (safe % width).astype(jnp.float32)
        py = (safe // width).astype(jnp.float32)
        plab = jnp.take(lab_f.reshape(-1, 3), safe, axis=0)
        snapped = jnp.concatenate([px[:, None], py[:, None], plab], axis=1)
        return jnp.where(has_pixels[:, None], snapped, centers)

    # home-cell indices of every center (row-major grid, like _init_centers)
    home_cx = jnp.tile(jnp.arange(per_row), per_col).astype(jnp.float32)
    home_cy = jnp.repeat(jnp.arange(per_col), per_row).astype(jnp.float32)

    def cell_drift(centers):
        """Max Chebyshev distance (cells) of current center cells from home.

        Integer division: centers hold exact pixel coordinates, and XLA
        strength-reduces f32 division by a literal into a 1-ulp-off
        reciprocal-multiply, which at an exact multiple of S would flip
        floor() and overstate the drift by one cell (the guard asserts
        drift ≤ 2 and lenna measures exactly 2.0 — no headroom for that).
        """
        ccx = (centers[:, 0].astype(jnp.int32) // sp_size).astype(jnp.float32)
        ccy = (centers[:, 1].astype(jnp.int32) // sp_size).astype(jnp.float32)
        return jnp.maximum(jnp.abs(ccx - home_cx),
                           jnp.abs(ccy - home_cy)).max()

    def body(state):
        it, centers, labels, dists, _, drift = state
        labels, dists, num_updated, sums = association(centers, labels, dists)
        means = center_means(centers, sums)
        centers = snap_centers(centers, means, labels)
        drift = jnp.maximum(drift, cell_drift(centers))
        return (it + 1, centers, labels, dists, num_updated, drift)

    def cond(state):
        it, _, _, _, num_updated, _ = state
        return (it < num_iteration) & (num_updated > 0)

    labels0 = jnp.full((height, width), -1, jnp.int32)
    dists0 = jnp.full((height, width), big, jnp.float32)
    state = (jnp.int32(0), centers0, labels0, dists0, jnp.int32(1),
             jnp.float32(0.0))
    _, centers, labels, dists, _, drift = jax.lax.while_loop(cond, body, state)
    return labels, centers, dists, drift


def _components(labels: np.ndarray):
    """4-connected components of the label map, numbered in raster
    first-encounter order. Returns (comp_map, sizes, ncomp).

    Uses the native C++ union-find (native/src/vip_native.cpp) when built;
    falls back to a scipy sparse-graph formulation."""
    from ..utils import native
    got = native.ccl_4conn(labels)
    if got is not None:
        comp, ncomp = got
        sizes = np.bincount(comp.reshape(-1), minlength=ncomp)
        return comp, sizes, ncomp

    from scipy.sparse import coo_matrix
    from scipy.sparse.csgraph import connected_components

    h, w = labels.shape
    idx = np.arange(h * w).reshape(h, w)
    edges_src, edges_dst = [], []
    same_h = labels[:, 1:] == labels[:, :-1]
    edges_src.append(idx[:, :-1][same_h])
    edges_dst.append(idx[:, 1:][same_h])
    same_v = labels[1:, :] == labels[:-1, :]
    edges_src.append(idx[:-1, :][same_v])
    edges_dst.append(idx[1:, :][same_v])
    src = np.concatenate(edges_src)
    dst = np.concatenate(edges_dst)
    graph = coo_matrix((np.ones(len(src), np.int8), (src, dst)),
                       shape=(h * w, h * w))
    ncomp, comp = connected_components(graph, directed=False)
    comp = comp.reshape(h, w)
    # renumber by raster first-encounter
    _, first_pos, inverse = np.unique(comp.reshape(-1), return_index=True,
                                      return_inverse=True)
    order = np.argsort(np.argsort(first_pos))
    comp = order[inverse].reshape(h, w)
    sizes = np.bincount(comp.reshape(-1), minlength=ncomp)
    return comp, sizes, ncomp


def enforce_connectivity(labels: np.ndarray, lab: np.ndarray,
                         sp_size: int, metric: str = "euclidean") -> np.ndarray:
    """Reference: include/cpp/slic.hpp:386-458 — relabel 4-connected
    components, then merge components smaller than S²/20 into the
    neighbouring component with the closest mean color."""
    h, w = labels.shape
    min_area = (sp_size * sp_size) // 20

    if metric == "euclidean":
        # fused native fast path: CCL + sums + adjacency + merge + relabel
        # in ONE run-based C++ call (~4 ms at 512² vs ~17 for the staged
        # passes below — utils/native.py slic_connectivity)
        from ..utils import native
        fused = native.slic_connectivity(labels, lab.astype(np.uint8),
                                         min_area)
        if fused is not None:
            return fused
        # staged native path (kept as the equality oracle for the fused
        # call and for builds with an older .so)
        got = native.ccl_4conn(labels)
        if got is not None:
            comp, ncomp = got
            sums = native.component_sums(comp, lab.astype(np.uint8), ncomp)
            if sums is not None:
                sizes = sums[:, 5]
                means = sums[:, 2:5] // sizes[:, None]  # int trunc (:415-421)
                mapping = native.slic_merge(comp, means, sizes, min_area)
                if mapping is not None:
                    # compact the surviving roots to consecutive ids in
                    # raster first-encounter order: a region's first pixel
                    # belongs to its lowest member component id (comp ids
                    # are already raster-ordered), so ranking roots by their
                    # first occurrence over component ids is O(ncomp) —
                    # no H×W sort
                    _, first_idx, inv = np.unique(
                        mapping, return_index=True, return_inverse=True)
                    rank = np.argsort(np.argsort(first_idx)).astype(np.int32)
                    return rank[inv][comp]

    comp, sizes, ncomp = _components(labels)

    lab_i = lab.astype(np.int64)
    flat = comp.reshape(-1)
    means = np.zeros((ncomp, 3), np.int64)
    for c in range(3):
        means[:, c] = np.bincount(flat, weights=lab_i[:, :, c].reshape(-1),
                                  minlength=ncomp).astype(np.int64)
    means //= sizes[:, None]  # int truncation (:415-421)

    if metric == "euclidean":
        from ..utils import native
        mapping_native = native.slic_merge(comp, means, sizes, min_area)
        if mapping_native is not None:
            _, first_idx, inv = np.unique(
                mapping_native, return_index=True, return_inverse=True)
            rank = np.argsort(np.argsort(first_idx)).astype(np.int32)
            return rank[inv][comp]

    # component adjacency (4-connectivity), vectorized edge extraction
    ea = np.concatenate([comp[:, :-1][comp[:, :-1] != comp[:, 1:]],
                         comp[:-1, :][comp[:-1, :] != comp[1:, :]]])
    eb = np.concatenate([comp[:, 1:][comp[:, :-1] != comp[:, 1:]],
                         comp[1:, :][comp[:-1, :] != comp[1:, :]]])
    edges = np.unique(np.stack([np.concatenate([ea, eb]),
                                np.concatenate([eb, ea])], axis=1), axis=0)
    neighbors: dict[int, set] = {c: set() for c in range(ncomp)}
    for u, v in edges:
        neighbors[int(u)].add(int(v))

    mapping = np.arange(ncomp)

    def find(c):
        while mapping[c] != c:
            mapping[c] = mapping[mapping[c]]
            c = mapping[c]
        return c

    if metric == "euclidean":
        def color_dist(c1, c2):
            dl = (means[c1, 0] - means[c2, 0]) * 2.55
            da = means[c1, 1] - means[c2, 1]
            db = means[c1, 2] - means[c2, 2]
            return dl * dl + da * da + db * db
    else:
        if metric == "ciede2000_ref":
            from ..golden.ciede2000_ref import ciede2000_ref_square as _de
        else:
            from ..core.ciede2000 import ciede2000_square as _de

        def color_dist(c1, c2):
            return float(_de(means[c1, 0], means[c1, 1], means[c1, 2],
                             means[c2, 0], means[c2, 1], means[c2, 2]))

    # the neighbor sets are maintained incrementally under merges (root →
    # set of neighbor roots), keeping the whole pass near-linear; a naive
    # per-component region rescan is O(ncomp²) and took minutes on noisy
    # segmentations with thousands of fragments
    for c in range(ncomp):  # raster order of first pixels
        cur = find(c)
        if sizes[cur] >= min_area:
            continue
        # canonicalize (members may have merged since they were recorded)
        nbrs = {find(v) for v in neighbors[cur]} - {cur}
        if not nbrs:
            continue  # reference prints "Failed to extract neighbors." (:435-438)
        best = min(sorted(nbrs), key=lambda v: color_dist(cur, v))
        mapping[cur] = best
        neighbors[best] |= nbrs - {best}
        neighbors[cur] = set()

    final = np.array([find(c) for c in range(ncomp)])
    # compact to consecutive ids in raster first-encounter order of the
    # merged regions (same scheme as the native fast path above)
    _, first_idx, inv = np.unique(final, return_index=True, return_inverse=True)
    rank = np.argsort(np.argsort(first_idx)).astype(np.int32)
    return rank[inv][comp]


class SuperpixelSLIC:
    """Drop-in counterpart of the reference class (include/cpp/slic.hpp:114).

    Note the reference's constructor swaps width/height and its wrapper
    passes (rows, cols) — the double swap cancels (SURVEY.md §2); this class
    takes (height, width) directly.
    """

    def __init__(self, height: int, width: int, superpixel_size: int = 30,
                 num_iteration: int = 10, color_scale: float = 20.0,
                 metric: str = "euclidean"):
        if superpixel_size < 2:
            raise ValueError("superpixel_size must be >= 2")
        if metric not in ("euclidean", "ciede2000", "ciede2000_ref"):
            raise ValueError(f"unknown SLIC metric {metric!r}")
        self.height = height
        self.width = width
        self.superpixel_size = superpixel_size
        self.num_iteration = num_iteration
        self.color_scale = color_scale
        self.metric = metric
        self._labels = None
        self.last_max_drift_cells: float | None = None

    def apply(self, image_bgr_u8) -> np.ndarray:
        image = np.asarray(image_bgr_u8)  # host-side: only Lab goes to device
        if image.shape[:2] != (self.height, self.width):
            raise ValueError(
                f"image shape {tuple(image.shape[:2])} does not match "
                f"({self.height}, {self.width})")
        # bit-exact OpenCV Lab (native/int32 host LUTs, ~ms) — the ±1 codes
        # of the float device conversion compound over k-means iterations
        # into visibly different basins (boundary recall 0.80 → 0.94
        # measured on lenna)
        lab = bgr2lab_u8_exact(image)
        labels, _, _, drift = slic_device(
            jnp.asarray(lab), self.height, self.width,
            self.superpixel_size, self.num_iteration,
            float(self.color_scale), self.metric)
        # ONE device→host round-trip for both outputs
        labels, drift_v = jax.device_get((labels, drift))
        self.last_max_drift_cells = float(drift_v)
        if self.last_max_drift_cells > 2.0:
            import warnings
            warnings.warn(
                f"SLIC center drift reached {self.last_max_drift_cells:.0f} "
                "cells (> 2): the 5x5 cell gather no longer covers every "
                "reference +/-S scan window and some pixels may miss their "
                "nearest center (models/slic.py bounded-drift assumption)",
                RuntimeWarning, stacklevel=2)
        labels = enforce_connectivity(np.asarray(labels), lab,
                                      self.superpixel_size, self.metric)
        self._labels = labels
        return labels

    def get_label(self) -> np.ndarray:
        if self._labels is None:
            raise RuntimeError("apply() has not been called")
        return self._labels
