// Native host-side runtime for various_image_processings_tpu.
//
// The device compute path is JAX/Pallas; these are the inherently sequential
// host algorithms that sit around it (the parts the reference also runs on
// the host CPU):
//   - 4-connected component labeling in raster first-encounter order
//     (SLIC enforce_connectivity, reference include/cpp/slic.hpp:316-399,
//     reformulated as union-find instead of recursive flood fill)
//   - Freeman chain-code contour tracing (Wexler inpainting,
//     reference include/cpp/wexler_inpainting.hpp:94-145)
//
// Exposed as a plain C ABI for ctypes; built by native/Makefile.

#include <algorithm>
#include <cstdint>
#include <vector>

extern "C" {

// ---------------------------------------------------------------------------
// Union-find connected components, 4-connectivity, components numbered by
// raster first-encounter order.  labels: (h*w) int32 input segmentation;
// comp_out: (h*w) int32 output component ids.  Returns component count.
// ---------------------------------------------------------------------------
int vip_ccl_4conn(const int32_t* labels, int h, int w, int32_t* comp_out) {
    const int64_t n = static_cast<int64_t>(h) * w;
    std::vector<int32_t> parent(n);
    for (int64_t i = 0; i < n; i++) parent[i] = static_cast<int32_t>(i);

    auto find = [&](int32_t x) {
        while (parent[x] != x) {
            parent[x] = parent[parent[x]];
            x = parent[x];
        }
        return x;
    };
    auto unite = [&](int32_t a, int32_t b) {
        a = find(a); b = find(b);
        if (a == b) return;
        if (a < b) parent[b] = a; else parent[a] = b;  // keep raster-smallest root
    };

    for (int y = 0; y < h; y++) {
        const int64_t row = static_cast<int64_t>(y) * w;
        for (int x = 0; x < w; x++) {
            const int64_t i = row + x;
            if (x + 1 < w && labels[i] == labels[i + 1]) unite((int32_t)i, (int32_t)(i + 1));
            if (y + 1 < h && labels[i] == labels[i + w]) unite((int32_t)i, (int32_t)(i + w));
        }
    }

    std::vector<int32_t> remap(n, -1);
    int32_t next_id = 0;
    for (int64_t i = 0; i < n; i++) {
        const int32_t root = find(static_cast<int32_t>(i));
        if (remap[root] < 0) remap[root] = next_id++;
        comp_out[i] = remap[root];
    }
    return next_id;
}

// ---------------------------------------------------------------------------
// Freeman chain-code contour trace.  mask: (h*w) u8 (hole > 0); the trace
// starts at (start_x, start_y) (the first masked pixel in raster order).
// out_xy receives up to max_len (x, y) pairs.  Returns the contour length,
// 0 for an isolated single-pixel hole, or -1 if the trace fails to close.
// Unlike the reference this rotates past out-of-bounds neighbours instead of
// stepping onto them.
// ---------------------------------------------------------------------------
int vip_trace_contour(const uint8_t* mask, int h, int w,
                      int start_x, int start_y,
                      int32_t* out_xy, int64_t max_len) {
    static const int chain[8][2] = {{1, 0}, {1, -1}, {0, -1}, {-1, -1},
                                    {-1, 0}, {-1, 1}, {0, 1}, {1, 1}};
    static const int next_code[8] = {7, 7, 1, 1, 3, 3, 5, 5};
    int code_index = 5;
    int cx = start_x, cy = start_y;
    int64_t length = 0;

    while (true) {
        if (cx == start_x && cy == start_y && length > 0) break;
        if (length >= max_len || length > static_cast<int64_t>(h) * w) return -1;
        out_xy[2 * length] = cx;
        out_xy[2 * length + 1] = cy;

        int x = cx + chain[code_index][0];
        int y = cy + chain[code_index][1];
        int search = 0;
        while ((x < 0 || x >= w || y < 0 || y >= h || mask[(int64_t)y * w + x] == 0)
               && search < 8) {
            code_index = (code_index + 1) % 8;
            x = cx + chain[code_index][0];
            y = cy + chain[code_index][1];
            search++;
        }
        if (search >= 8) {
            // isolated pixel: 1-pixel contour
            return length == 0 ? 1 : -1;
        }
        cx = x; cy = y;
        code_index = next_code[code_index];
        length++;
    }
    return static_cast<int>(length);
}

// ---------------------------------------------------------------------------
// Per-component int64 feature sums (x, y, c0, c1, c2, count) for the SLIC
// merge step.  comp: (h*w) int32; img: (h*w*3) u8; sums: (ncomp*6) int64.
// ---------------------------------------------------------------------------
void vip_component_sums(const int32_t* comp, const uint8_t* img,
                        int h, int w, int ncomp, int64_t* sums) {
    for (int64_t i = 0; i < static_cast<int64_t>(ncomp) * 6; i++) sums[i] = 0;
    for (int y = 0; y < h; y++) {
        for (int x = 0; x < w; x++) {
            const int64_t i = static_cast<int64_t>(y) * w + x;
            int64_t* s = sums + static_cast<int64_t>(comp[i]) * 6;
            s[0] += x;
            s[1] += y;
            s[2] += img[i * 3 + 0];
            s[3] += img[i * 3 + 1];
            s[4] += img[i * 3 + 2];
            s[5] += 1;
        }
    }
}

// ---------------------------------------------------------------------------
// 8-bit BGR → Lab, bit-identical to OpenCV's fixed-point path (the tables —
// gamma LUT, cube-root LUT, 12-bit XYZ coefficients — are built once in
// Python by core/colors.py:_lab_tables and passed in).  Reference SLIC calls
// cv::cvtColor(BGR2Lab) at include/cpp/slic.hpp:166; this keeps the exact
// conversion on the host without an OpenCV runtime dependency.
// ---------------------------------------------------------------------------
void vip_bgr2lab_u8(const uint8_t* bgr, int64_t npix,
                    const int32_t* gamma_tab, const int32_t* cbrt_tab,
                    const int32_t* c, uint8_t* lab_out) {
    const int32_t lscale = (116 * 255 + 50) / 100;
    const int32_t lshift = -((16 * 255 * (1 << 15) + 50) / 100);
    const int32_t half12 = 1 << 11, half15 = 1 << 14, k128 = 128 << 15;
    for (int64_t i = 0; i < npix; i++) {
        const int32_t b = gamma_tab[bgr[i * 3 + 0]];
        const int32_t g = gamma_tab[bgr[i * 3 + 1]];
        const int32_t r = gamma_tab[bgr[i * 3 + 2]];
        const int32_t fx = cbrt_tab[(r * c[0] + g * c[1] + b * c[2] + half12) >> 12];
        const int32_t fy = cbrt_tab[(r * c[3] + g * c[4] + b * c[5] + half12) >> 12];
        const int32_t fz = cbrt_tab[(r * c[6] + g * c[7] + b * c[8] + half12) >> 12];
        int32_t L = (lscale * fy + lshift + half15) >> 15;
        int32_t A = (500 * (fx - fy) + k128 + half15) >> 15;
        int32_t B = (200 * (fy - fz) + k128 + half15) >> 15;
        lab_out[i * 3 + 0] = (uint8_t)(L < 0 ? 0 : (L > 255 ? 255 : L));
        lab_out[i * 3 + 1] = (uint8_t)(A < 0 ? 0 : (A > 255 ? 255 : A));
        lab_out[i * 3 + 2] = (uint8_t)(B < 0 ? 0 : (B > 255 ? 255 : B));
    }
}

}  // extern "C"

extern "C" {

// ---------------------------------------------------------------------------
// SLIC small-segment merge (reference include/cpp/slic.hpp:423-453), the
// euclidean-metric fast path.  comp: (h*w) int32 component map (raster
// first-encounter order); means: (ncomp*3) int64 integer-truncated Lab
// means; sizes: (ncomp,) int64.  mapping_out: (ncomp,) int32 — the merged
// root for every component.  Components are visited in id (raster) order;
// a component smaller than min_area merges into the adjacent region whose
// mean color is closest (L scaled by 2.55, ties to the lowest id).
// Known divergence (statistical parity budget): the reference keeps its
// running minimum in an int (slic.hpp:440 truncates each distance on
// assignment) and iterates neighbors in flood-fill discovery order, so
// neighbors whose distances share the same integer floor can merge
// differently there; this exact-double/lowest-id rule matches the Python
// fallback (models/slic.py enforce_connectivity), keeping native and
// fallback outputs identical to each other.
// ---------------------------------------------------------------------------
void vip_slic_merge(const int32_t* comp, int h, int w, int ncomp,
                    const int64_t* means, const int64_t* sizes,
                    int64_t min_area, int32_t* mapping_out) {
    std::vector<int32_t> mapping(ncomp);
    for (int32_t c = 0; c < ncomp; c++) mapping[c] = c;
    auto find = [&](int32_t x) {
        while (mapping[x] != x) {
            mapping[x] = mapping[mapping[x]];
            x = mapping[x];
        }
        return x;
    };

    // adjacency lists (duplicates allowed; canonicalized + deduped at use
    // via the stamp array — avoids the per-component sort/unique passes)
    std::vector<std::vector<int32_t>> nbrs(ncomp);
    auto add_edge = [&](int32_t a, int32_t b) {
        if (a == b) return;
        nbrs[a].push_back(b);
        nbrs[b].push_back(a);
    };
    for (int y = 0; y < h; y++) {
        const int64_t row = static_cast<int64_t>(y) * w;
        for (int x = 0; x < w; x++) {
            const int64_t i = row + x;
            if (x + 1 < w) add_edge(comp[i], comp[i + 1]);
            if (y + 1 < h) add_edge(comp[i], comp[i + w]);
        }
    }

    auto color_dist = [&](int32_t c1, int32_t c2) {
        const double dl = (means[c1 * 3 + 0] - means[c2 * 3 + 0]) * 2.55;
        const double da = static_cast<double>(means[c1 * 3 + 1] - means[c2 * 3 + 1]);
        const double db = static_cast<double>(means[c1 * 3 + 2] - means[c2 * 3 + 2]);
        return dl * dl + da * da + db * db;
    };

    std::vector<int32_t> stamp(ncomp, -1);
    std::vector<int32_t> cand;
    for (int32_t c = 0; c < ncomp; c++) {
        const int32_t cur = find(c);
        if (sizes[cur] >= min_area) continue;
        // canonicalized, deduped neighbor roots of the merged region;
        // best = closest mean color, ties to the LOWEST root id (matches
        // the previous sorted-scan and the Python fallback)
        cand.clear();
        for (int32_t v : nbrs[cur]) {
            const int32_t r = find(v);
            if (r != cur && stamp[r] != c) { stamp[r] = c; cand.push_back(r); }
        }
        if (cand.empty()) continue;
        int32_t best = cand[0];
        double best_d = color_dist(cur, cand[0]);
        for (size_t i = 1; i < cand.size(); i++) {
            const double d = color_dist(cur, cand[i]);
            if (d < best_d || (d == best_d && cand[i] < best)) {
                best_d = d; best = cand[i];
            }
        }
        mapping[cur] = best;
        // fold cur's (deduped) adjacency into best, small-to-large: both
        // lists describe the same merged region rooted at best, so they
        // are interchangeable and the shorter one is appended
        auto& nb = nbrs[best];
        auto& nc = nbrs[cur];
        nc.swap(cand);  // cand holds cur's canonical deduped neighbors
        if (nc.size() > nb.size()) nb.swap(nc);
        nb.insert(nb.end(), nc.begin(), nc.end());
        nc.clear();
        nc.shrink_to_fit();
    }
    for (int32_t c = 0; c < ncomp; c++) mapping_out[c] = find(c);
}

// ---------------------------------------------------------------------------
// Fused SLIC enforce_connectivity (reference include/cpp/slic.hpp:386-458):
// CCL + per-component sums + adjacency + small-segment merge + final
// raster-first-encounter relabel in ONE call, RUN-based.  Semantically
// identical to composing vip_ccl_4conn + vip_component_sums +
// vip_slic_merge + the Python compaction (equality pinned by
// tests/test_native.py), but ~4x faster: rows decompose into maximal
// equal-label runs, so the union-find works on ~#runs nodes instead of h*w,
// the Lab sums accumulate contiguously per run, adjacency edges are pushed
// per run pair instead of per boundary pixel, and the output labels are
// written run-at-a-time.  labels: (h*w) int32; lab: (h*w*3) u8;
// out: (h*w) int32.  Returns the final region count (or -1 on bad input).
// ---------------------------------------------------------------------------
int vip_slic_connectivity(const int32_t* labels, const uint8_t* lab,
                          int h, int w, int64_t min_area, int32_t* out) {
    if (h <= 0 || w <= 0) return -1;
    // ---- pass 1: split rows into maximal equal-label runs and accumulate
    // each run's Lab color sums (the ONLY pixel sweep in the whole call).
    // Two-phase (count rows, then fill at prefix offsets) so rows are
    // independent — parallelized with OpenMP on multi-core hosts; the
    // run order stays raster (deterministic) either way.  Runs being in
    // raster order makes the smallest run id in a component its raster
    // first-encounter — kept as the union-find root (a < b rule), which
    // makes component numbering trivial later.
    struct Run { int32_t x0, x1, row, label; };  // [x0, x1), row, label
    std::vector<int32_t> row_start(h + 1, 0);    // run-index range per row
#ifdef _OPENMP
#pragma omp parallel for schedule(static)
#endif
    for (int y = 0; y < h; y++) {
        const int32_t* L = labels + static_cast<int64_t>(y) * w;
        int32_t cnt = 1;
        for (int x = 0; x < w - 1; x++) cnt += (L[x] != L[x + 1]);
        row_start[y + 1] = cnt;
    }
    for (int y = 0; y < h; y++) row_start[y + 1] += row_start[y];
    const int32_t nrun = row_start[h];
    std::vector<Run> runs(nrun);
    std::vector<int32_t> rsum(static_cast<size_t>(nrun) * 3);  // Lab sums
#ifdef _OPENMP
#pragma omp parallel for schedule(static)
#endif
    for (int y = 0; y < h; y++) {
        const int32_t* L = labels + static_cast<int64_t>(y) * w;
        const uint8_t* P = lab + static_cast<int64_t>(y) * w * 3;
        int32_t r = row_start[y];
        int x = 0;
        while (x < w) {
            int x1 = x + 1;
            const int32_t v = L[x];
            while (x1 < w && L[x1] == v) x1++;
            int32_t s0 = 0, s1 = 0, s2 = 0;
            for (int k = 3 * x; k < 3 * x1; k += 3) {
                s0 += P[k]; s1 += P[k + 1]; s2 += P[k + 2];
            }
            runs[r] = {x, x1, y, v};
            rsum[3 * static_cast<size_t>(r)] = s0;
            rsum[3 * static_cast<size_t>(r) + 1] = s1;
            rsum[3 * static_cast<size_t>(r) + 2] = s2;
            r++;
            x = x1;
        }
    }

    std::vector<int32_t> parent(nrun);
    for (int32_t i = 0; i < nrun; i++) parent[i] = i;
    auto find = [&](int32_t q) {
        while (parent[q] != q) {
            parent[q] = parent[parent[q]];
            q = parent[q];
        }
        return q;
    };
    auto unite = [&](int32_t a, int32_t b) {
        a = find(a); b = find(b);
        if (a == b) return;
        if (a < b) parent[b] = a; else parent[a] = b;  // raster-smallest root
    };
    for (int y = 1; y < h; y++) {
        int32_t up = row_start[y - 1];
        const int32_t up_end = row_start[y];
        for (int32_t r = row_start[y]; r < row_start[y + 1]; r++) {
            // advance over previous-row runs ending at or before our start
            while (up < up_end && runs[up].x1 <= runs[r].x0) up++;
            for (int32_t u = up; u < up_end && runs[u].x0 < runs[r].x1; u++)
                if (runs[u].label == runs[r].label) unite(u, r);
            // the last overlapping run may also overlap the NEXT run of
            // this row, so `up` must not move past it — it only advanced
            // over runs that end before our start.
        }
    }

    // ---- pass 2 (over runs): compact component ids in raster
    // first-encounter order, accumulate int64 sums per component, and
    // collect adjacency edges (horizontal: adjacent runs in a row always
    // differ in label; vertical: overlapping runs with different labels).
    std::vector<int32_t> comp_of_run(nrun);
    std::vector<int32_t> remap(nrun, -1);
    int32_t ncomp = 0;
    for (int32_t r = 0; r < nrun; r++) {
        const int32_t root = find(r);
        if (remap[root] < 0) remap[root] = ncomp++;
        comp_of_run[r] = remap[root];
    }
    // per-component (c0, c1, c2, count) — the merge needs only Lab means
    // and sizes (unlike vip_component_sums, which also returns centroids)
    std::vector<int64_t> sums(static_cast<size_t>(ncomp) * 4, 0);
    std::vector<std::pair<int32_t, int32_t>> edges;  // undirected, once each
    edges.reserve(static_cast<size_t>(nrun) * 2);
    for (int y = 0; y < h; y++) {
        int32_t up = (y > 0) ? row_start[y - 1] : 0;
        const int32_t up_end = (y > 0) ? row_start[y] : 0;
        for (int32_t r = row_start[y]; r < row_start[y + 1]; r++) {
            const Run& run = runs[r];
            const int32_t c = comp_of_run[r];
            int64_t* s = sums.data() + static_cast<int64_t>(c) * 4;
            const int64_t len = run.x1 - run.x0;
            s[0] += rsum[3 * static_cast<size_t>(r)];
            s[1] += rsum[3 * static_cast<size_t>(r) + 1];
            s[2] += rsum[3 * static_cast<size_t>(r) + 2];
            s[3] += len;
            if (r + 1 < row_start[y + 1])          // horizontal neighbour
                edges.emplace_back(c, comp_of_run[r + 1]);
            while (up < up_end && runs[up].x1 <= run.x0) up++;
            for (int32_t u = up; u < up_end && runs[u].x0 < run.x1; u++)
                if (comp_of_run[u] != c) edges.emplace_back(comp_of_run[u], c);
        }
    }
    // CSR adjacency (duplicates kept — deduped at use via the stamp array)
    std::vector<int32_t> off(static_cast<size_t>(ncomp) + 2, 0);
    for (const auto& e : edges) { off[e.first + 2]++; off[e.second + 2]++; }
    for (size_t i = 2; i < off.size(); i++) off[i] += off[i - 1];
    std::vector<int32_t> adj(edges.size() * 2);
    for (const auto& e : edges) {
        adj[off[e.first + 1]++] = e.second;
        adj[off[e.second + 1]++] = e.first;
    }  // off[c]..off[c+1] now bounds component c's neighbors

    // ---- pass 3: small-segment merge, identical rule set to
    // vip_slic_merge (original sizes/means, id-order visits, exact-double
    // distances, ties to the lowest root id).  The merged region's
    // neighbor multiset is iterated via a member-component chain over the
    // static CSR rows (same canonicalize-at-use + stamp dedup as the
    // list-folding formulation, so the candidate SET is identical).
    std::vector<int32_t> mapping(ncomp);
    std::vector<int32_t> chain_next(ncomp, -1), chain_tail(ncomp);
    for (int32_t c = 0; c < ncomp; c++) { mapping[c] = c; chain_tail[c] = c; }
    auto mfind = [&](int32_t q) {
        while (mapping[q] != q) {
            mapping[q] = mapping[mapping[q]];
            q = mapping[q];
        }
        return q;
    };
    // integer-truncated Lab means, precomputed once (the divisions would
    // otherwise run per candidate comparison)
    std::vector<int32_t> mean3(static_cast<size_t>(ncomp) * 3);
    for (int32_t c = 0; c < ncomp; c++) {
        const int64_t* s = sums.data() + static_cast<int64_t>(c) * 4;
        mean3[3 * static_cast<size_t>(c)] = static_cast<int32_t>(s[0] / s[3]);
        mean3[3 * static_cast<size_t>(c) + 1] = static_cast<int32_t>(s[1] / s[3]);
        mean3[3 * static_cast<size_t>(c) + 2] = static_cast<int32_t>(s[2] / s[3]);
    }
    auto color_dist = [&](int32_t c1, int32_t c2) {
        const int32_t* m1 = mean3.data() + 3 * static_cast<size_t>(c1);
        const int32_t* m2 = mean3.data() + 3 * static_cast<size_t>(c2);
        const double dl = (m1[0] - m2[0]) * 2.55;
        const double da = static_cast<double>(m1[1] - m2[1]);
        const double db = static_cast<double>(m1[2] - m2[2]);
        return dl * dl + da * da + db * db;
    };
    std::vector<int32_t> stamp(ncomp, -1);
    std::vector<int32_t> cand;
    for (int32_t c = 0; c < ncomp; c++) {
        const int32_t cur = mfind(c);
        if (sums[static_cast<int64_t>(cur) * 4 + 3] >= min_area) continue;
        cand.clear();
        for (int32_t m = cur; m != -1; m = chain_next[m])
            for (int32_t k = off[m]; k < off[m + 1]; k++) {
                const int32_t r = mfind(adj[k]);
                if (r != cur && stamp[r] != c) { stamp[r] = c; cand.push_back(r); }
            }
        if (cand.empty()) continue;
        int32_t best = cand[0];
        double best_d = color_dist(cur, cand[0]);
        for (size_t i = 1; i < cand.size(); i++) {
            const double d = color_dist(cur, cand[i]);
            if (d < best_d || (d == best_d && cand[i] < best)) {
                best_d = d; best = cand[i];
            }
        }
        mapping[cur] = best;
        chain_next[chain_tail[best]] = cur;    // append cur's member chain
        chain_tail[best] = chain_tail[cur];
    }

    // ---- pass 4: compact merged roots to consecutive region ids in raster
    // first-encounter order (component ids are already raster-ordered, so
    // first occurrence over ids == raster first pixel), then write the
    // output run-at-a-time.
    std::vector<int32_t> region(ncomp, -1);
    std::vector<int32_t> final_of_comp(ncomp);
    int32_t nregion = 0;
    for (int32_t c = 0; c < ncomp; c++) {
        const int32_t root = mfind(c);
        if (region[root] < 0) region[root] = nregion++;
        final_of_comp[c] = region[root];
    }
#ifdef _OPENMP
#pragma omp parallel for schedule(static)
#endif
    for (int32_t r = 0; r < nrun; r++) {  // pure reads — parallel-safe
        const int32_t id = final_of_comp[comp_of_run[r]];
        int32_t* dst = out + static_cast<int64_t>(runs[r].row) * w;
        for (int32_t x = runs[r].x0; x < runs[r].x1; x++) dst[x] = id;
    }
    return nregion;
}

}  // extern "C"
