// Native COCO-RLE codec for the data-ingest hot path (a copy of
// instaorder_tpu/native/rle_codec.cpp).
//
// The reference leans on pycocotools' C codec for every mask it touches
// (datasets/reader.py:20-66). This library provides the same wire formats
// for the port's data/rle.py, loaded via ctypes (no pybind11). Run
// lists are column-major; counts alternate 0-run/1-run starting with
// zeros, delta-packed into 6-bit ascii groups.
//
// Built at first use by native/__init__.py:
//   g++ -O3 -fPIC -shared -std=c++17 rle_codec.cpp -o _build/librle_codec_<hash>.so

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

extern "C" {

// Decode the ascii-packed counts string. Returns the number of counts
// written (<= max_counts), or -1 on overflow/malformed input.
int64_t rle_string_to_counts(const char* s, int64_t slen,
                             int64_t* counts, int64_t max_counts) {
    int64_t m = 0;
    int64_t p = 0;
    while (p < slen) {
        long long x = 0;
        int k = 0;
        bool more = true;
        while (more) {
            if (p >= slen) return -1;
            char c = s[p] - 48;
            x |= (long long)(c & 0x1f) << (5 * k);
            more = (c & 0x20) != 0;
            p++;
            k++;
            if (!more && (c & 0x10)) x |= -1LL << (5 * k);
        }
        if (m > 2) x += counts[m - 2];
        if (m >= max_counts) return -1;
        counts[m++] = x;
    }
    return m;
}

// counts -> ascii string. Returns bytes written (excl. NUL) or -1.
int64_t rle_counts_to_string(const int64_t* counts, int64_t n,
                             char* out, int64_t max_out) {
    int64_t p = 0;
    for (int64_t i = 0; i < n; i++) {
        long long x = counts[i];
        if (i > 2) x -= counts[i - 2];
        bool more = true;
        while (more) {
            char c = x & 0x1f;
            x >>= 5;
            more = (c & 0x10) ? (x != -1) : (x != 0);
            if (more) c |= 0x20;
            if (p >= max_out) return -1;
            out[p++] = c + 48;
        }
    }
    return p;
}

// Column-major run list -> row-major HxW uint8 mask.
// Returns 0 on success, -1 if the counts don't sum to h*w.
int rle_decode_counts(const int64_t* counts, int64_t n, int64_t h,
                      int64_t w, uint8_t* out) {
    std::memset(out, 0, (size_t)(h * w));
    int64_t pos = 0;
    for (int64_t i = 0; i < n; i++) {
        int64_t run = counts[i];
        if (run < 0 || pos + run > h * w) return -1;
        if (i & 1) {
            // foreground run over column-major positions [pos, pos+run)
            int64_t p = pos;
            int64_t end = pos + run;
            while (p < end) {
                int64_t col = p / h;
                int64_t row = p % h;
                // contiguous within this column
                int64_t len = end - p;
                int64_t col_left = h - row;
                if (len > col_left) len = col_left;
                uint8_t* dst = out + row * w + col;
                for (int64_t k = 0; k < len; k++) dst[k * w] = 1;
                p += len;
            }
        }
        pos += run;
    }
    return pos == h * w ? 0 : -1;
}

// Row-major HxW {0,1} mask -> counts (column-major runs).
// Returns number of counts, or -1 on overflow.
int64_t rle_encode_mask(const uint8_t* mask, int64_t h, int64_t w,
                        int64_t* counts, int64_t max_counts) {
    int64_t m = 0;
    uint8_t prev = 0;
    int64_t run = 0;
    for (int64_t col = 0; col < w; col++) {
        for (int64_t row = 0; row < h; row++) {
            uint8_t v = mask[row * w + col] ? 1 : 0;
            if (v == prev) {
                run++;
            } else {
                if (m >= max_counts) return -1;
                counts[m++] = run;
                prev = v;
                run = 1;
            }
        }
    }
    if (m >= max_counts) return -1;
    counts[m++] = run;
    return m;
}

int64_t rle_area_counts(const int64_t* counts, int64_t n) {
    int64_t area = 0;
    for (int64_t i = 1; i < n; i += 2) area += counts[i];
    return area;
}

}  // extern "C"

// Polygon -> counts rasterisation (pycocotools rleFrPoly-compatible:
// upsample-by-5 boundary walk, left-edge crossings, sorted toggles).
// xy: flat [x0,y0,...] doubles, k vertices. Writes counts; returns the
// number of counts, or -1 on overflow.
extern "C" int64_t rle_from_polygon(const double* xy, int64_t k, int64_t h,
                                    int64_t w, int64_t* counts,
                                    int64_t max_counts) {
    if (k < 1) return -1;
    const double scale = 5.0;
    // upscaled integer vertices (closed)
    std::int64_t* vx = new std::int64_t[k + 1];
    std::int64_t* vy = new std::int64_t[k + 1];
    for (int64_t j = 0; j < k; j++) {
        vx[j] = (std::int64_t)std::floor(scale * xy[2 * j] + 0.5);
        vy[j] = (std::int64_t)std::floor(scale * xy[2 * j + 1] + 0.5);
    }
    vx[k] = vx[0];
    vy[k] = vy[0];
    // dense boundary points
    int64_t m = 0;
    for (int64_t j = 0; j < k; j++) {
        int64_t dx = std::llabs(vx[j + 1] - vx[j]);
        int64_t dy = std::llabs(vy[j] - vy[j + 1]);
        m += (dx > dy ? dx : dy) + 1;
    }
    std::int64_t* u = new std::int64_t[m];
    std::int64_t* v = new std::int64_t[m];
    m = 0;
    for (int64_t j = 0; j < k; j++) {
        std::int64_t xs = vx[j], xe = vx[j + 1];
        std::int64_t ys = vy[j], ye = vy[j + 1];
        std::int64_t dx = std::llabs(xe - xs), dy = std::llabs(ys - ye);
        bool flip = (dx >= dy && xs > xe) || (dx < dy && ys > ye);
        if (flip) { std::swap(xs, xe); std::swap(ys, ye); }
        if (dx >= dy) {
            double s = dx > 0 ? (double)(ye - ys) / dx : 0.0;
            for (int64_t d = 0; d <= dx; d++) {
                std::int64_t t = flip ? dx - d : d;
                u[m] = t + xs;
                v[m] = (std::int64_t)std::floor(ys + s * t + 0.5);
                m++;
            }
        } else {
            double s = dy > 0 ? (double)(xe - xs) / dy : 0.0;
            for (int64_t d = 0; d <= dy; d++) {
                std::int64_t t = flip ? dy - d : d;
                v[m] = t + ys;
                u[m] = (std::int64_t)std::floor(xs + s * t + 0.5);
                m++;
            }
        }
    }
    // left-edge crossings, downsample by `scale`
    std::vector<std::int64_t> a;
    a.reserve(m + 1);
    for (int64_t j = 1; j < m; j++) {
        if (u[j] == u[j - 1]) continue;
        double xd = (double)(u[j] < u[j - 1] ? u[j] : u[j] - 1);
        xd = (xd + 0.5) / scale - 0.5;
        if (std::floor(xd) != xd || xd < 0 || xd > w - 1) continue;
        double yd = (double)(v[j] < v[j - 1] ? v[j] : v[j - 1]);
        yd = (yd + 0.5) / scale - 0.5;
        if (yd < 0) yd = 0;
        else if (yd > (double)h) yd = (double)h;
        yd = std::ceil(yd);
        a.push_back((std::int64_t)xd * h + (std::int64_t)yd);
    }
    a.push_back(h * w);
    std::sort(a.begin(), a.end());
    // deltas + toggle collapse into counts
    std::int64_t prev = 0;
    std::vector<std::int64_t> d;
    d.reserve(a.size());
    for (auto t : a) { d.push_back(t - prev); prev = t; }
    int64_t mm = 0;
    int64_t j = 0;
    int64_t n = (int64_t)d.size();
    if (mm >= max_counts) { delete[] vx; delete[] vy; delete[] u; delete[] v; return -1; }
    counts[mm++] = d[j++];
    while (j < n) {
        if (d[j] > 0) {
            if (mm >= max_counts) { delete[] vx; delete[] vy; delete[] u; delete[] v; return -1; }
            counts[mm++] = d[j++];
        } else {
            j++;
            if (j < n) counts[mm - 1] += d[j++];
        }
    }
    delete[] vx; delete[] vy; delete[] u; delete[] v;
    return mm;
}
