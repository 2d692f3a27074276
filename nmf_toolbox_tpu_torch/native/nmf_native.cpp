// Native host-side runtime components for nmf_toolbox_tpu_torch, a copy
// of nmf_toolbox_tpu/native/nmf_native.cpp (the port imports nothing of
// the JAX package, so it keeps its own).
//
// These are host-side pieces that sit off the device compute path but on
// the wall-clock path:
//
//  * convhull2d: Andrew's monotone chain over the projected sample cloud
//    (replaces MATLAB convhull, chnmf.m:100).  chnmf/chcnmf init runs it
//    for every pair of kept eigenvectors — O(E^2) hulls over up to 10^5
//    points, which is Python-loop-bound otherwise.
//  * load_bytes: multi-threaded chunked file reads for staging large
//    dense V matrices from disk into host memory before the device
//    transfer.
//
// Exposed through ctypes: native/__init__.py builds this file with g++ on
// first use, into the package's build directory under a name that hashes
// this source and the flags, and falls back to pure Python when no
// toolchain is found.
#include <algorithm>
#include <atomic>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <thread>
#include <vector>

extern "C" {

// ---------------------------------------------------------------------------
// 2-D convex hull (monotone chain).  pts: n rows of (x, y), C-contiguous.
// out_idx must have room for n entries; returns the hull size (counter-
// clockwise order, no repeated endpoint) or -1 on error.
// ---------------------------------------------------------------------------
int convhull2d(const double* pts, int64_t n, int64_t* out_idx) {
    if (n <= 0) return -1;
    if (n <= 2) {
        for (int64_t i = 0; i < n; ++i) out_idx[i] = i;
        return static_cast<int>(n);
    }
    std::vector<int64_t> order(n);
    for (int64_t i = 0; i < n; ++i) order[i] = i;
    std::sort(order.begin(), order.end(), [pts](int64_t a, int64_t b) {
        double ax = pts[2 * a], ay = pts[2 * a + 1];
        double bx = pts[2 * b], by = pts[2 * b + 1];
        return ax < bx || (ax == bx && ay < by);
    });

    auto cross = [pts](int64_t o, int64_t a, int64_t b) {
        double ox = pts[2 * o], oy = pts[2 * o + 1];
        return (pts[2 * a] - ox) * (pts[2 * b + 1] - oy)
             - (pts[2 * a + 1] - oy) * (pts[2 * b] - ox);
    };

    std::vector<int64_t> hull(2 * n);
    int64_t k = 0;
    // lower hull
    for (int64_t ii = 0; ii < n; ++ii) {
        int64_t i = order[ii];
        while (k >= 2 && cross(hull[k - 2], hull[k - 1], i) <= 0) --k;
        hull[k++] = i;
    }
    // upper hull
    int64_t lower = k + 1;
    for (int64_t ii = n - 2; ii >= 0; --ii) {
        int64_t i = order[ii];
        while (k >= lower && cross(hull[k - 2], hull[k - 1], i) <= 0) --k;
        hull[k++] = i;
    }
    --k;  // last point == first point
    std::memcpy(out_idx, hull.data(), sizeof(int64_t) * k);
    return static_cast<int>(k);
}

// ---------------------------------------------------------------------------
// Threaded raw binary load: read `count` elements of `elem_size` bytes from
// `path` at byte `offset` into `dst` using `threads` parallel readers.
// Returns 0 on success.
// ---------------------------------------------------------------------------
static int load_raw(const char* path, void* dst, int64_t offset,
                    int64_t nbytes, int threads) {
    if (threads < 1) threads = 1;
    std::atomic<int> err{0};
    int64_t chunk = (nbytes + threads - 1) / threads;
    std::vector<std::thread> pool;
    for (int t = 0; t < threads; ++t) {
        int64_t begin = t * chunk;
        int64_t end = std::min(begin + chunk, nbytes);
        if (begin >= end) break;
        pool.emplace_back([&, begin, end]() {
            FILE* f = std::fopen(path, "rb");
            if (!f) { err.store(1); return; }
            if (std::fseek(f, static_cast<long>(offset + begin), SEEK_SET)) {
                err.store(2); std::fclose(f); return;
            }
            size_t want = static_cast<size_t>(end - begin);
            size_t got = std::fread(static_cast<char*>(dst) + begin, 1, want, f);
            if (got != want) err.store(3);
            std::fclose(f);
        });
    }
    for (auto& th : pool) th.join();
    return err.load();
}

int load_bytes(const char* path, void* dst, int64_t offset, int64_t nbytes,
               int threads) {
    return load_raw(path, dst, offset, nbytes, threads);
}

}  // extern "C"
