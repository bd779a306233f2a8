// Native data-preparation kernels.
//
// These are the inherently sequential row-walking loops of the data pipeline
// (the reference implements them in Cython with nogil:
// /root/reference/smcpp/_estimation_tools.pyx).  The semantics here match
// smcpp_jax/data/filters.py, which holds the reference documentation; the
// Python versions remain as a fallback and as the executable specification
// (tests compare the two).
//
// Build: see csrc/Makefile (g++ -O3 -shared -fPIC).  Exposed via ctypes
// (smcpp_jax/_native.py) — plain C ABI, no pybind11 required.

#include <cstdint>
#include <cstring>
#include <algorithm>

extern "C" {

// Thin: emit the full-SFS row only every `thinning`-th site.  Returns the
// number of output rows written, or -1 if out_cap is too small.
// data: (rows, cols) int32, cols = 1 + 3 * npop.
long thin_data(const int32_t* data, long rows, long cols, long thinning,
               long offset, int32_t* out, long out_cap) {
    const long npop = (cols - 1) / 3;
    long r = 0;
    long i = offset;
    int32_t thin[64], nonseg[64];
    if (cols - 1 > 64) return -2;
    for (long j = 0; j < rows; ++j) {
        const int32_t* row = data + j * cols;
        long span = row[0];
        long sa = 0;
        for (long n = 0; n < npop; ++n) {
            thin[3 * n] = row[1 + 3 * n];
            thin[3 * n + 1] = 0;
            thin[3 * n + 2] = 0;
            sa += row[1 + 3 * n];
            nonseg[3 * n] = nonseg[3 * n + 1] = nonseg[3 * n + 2] = 0;
        }
        if (sa == 2)
            for (long n = 0; n < npop; ++n) thin[3 * n] = 0;
        while (span > 0) {
            if (i < thinning && i + span >= thinning) {
                if (thinning - i > 1) {
                    if (r >= out_cap) return -1;
                    out[r * cols] = (int32_t)(thinning - i - 1);
                    for (long n = 0; n < cols - 1; ++n)
                        out[r * cols + 1 + n] = thin[n];
                    ++r;
                }
                if (r >= out_cap) return -1;
                out[r * cols] = 1;
                const int32_t* src = (sa == 2) ? nonseg : (row + 1);
                for (long n = 0; n < cols - 1; ++n)
                    out[r * cols + 1 + n] = src[n];
                ++r;
                span -= thinning - i;
                i = 0;
            } else {
                if (r >= out_cap) return -1;
                out[r * cols] = (int32_t)span;
                for (long n = 0; n < cols - 1; ++n)
                    out[r * cols + 1 + n] = thin[n];
                ++r;
                i += span;
                break;
            }
        }
    }
    return r;
}

// Bin observations into w-bp windows, keeping one representative row per
// window.  data is a scratch copy (mutated).  Returns rows written.
long bin_observations(int32_t* data, long rows, long cols,
                      const int64_t* na, long w, int32_t* out, long out_cap) {
    const long K = (cols - 1) / 3;
    long i = 0, j = 0, k = 0, seen = 0;

    auto process_bin = [&](long lo, long hi, long kk) {
        long max_ss = -2, mq = lo;
        for (long q = lo; q <= hi; ++q) {
            if (data[q * cols] == 0) continue;
            long ss = 0, seg = 0;
            for (long aa = 0; aa < K; ++aa) {
                const long bb = 3 * aa;
                ss += data[q * cols + bb + 3];
                ss += na[aa] * (data[q * cols + bb + 1] >= 0);
                seg += std::max<long>(0, data[q * cols + bb + 1]);
            }
            if (ss > max_ss) { mq = q; max_ss = ss; }
            if (max_ss == 2 && seg == 1) mq = q;
        }
        for (long n = 1; n < cols; ++n)
            out[kk * cols + n] = data[mq * cols + n];
    };

    while (j < rows) {
        long span = data[j * cols];
        if (seen + span > w) {
            data[j * cols] = (int32_t)(w - seen);
            if (k >= out_cap) return -1;
            process_bin(i, j, k);
            data[j * cols] = (int32_t)(span - (w - seen));
            seen = 0;
            ++k;
            i = j;
        } else {
            ++j;
            seen += span;
        }
    }
    if (k >= out_cap) return -1;
    process_bin(i, j - 1, k);
    for (long q = 0; q <= k; ++q) out[q * cols] = 1;
    return k + 1;
}

// Per-window (non-missing sites, distinguished-het sites), walking the
// reversed data.  data_rev must be the row-reversed contig.  Returns the
// number of windows written (pairs in `out`).
long windowed_mutation_counts(const int32_t* data_rev, long rows, long cols,
                              long w, int64_t* out, long out_cap) {
    const long n = (cols - 1) / 3;
    long i = 0, jout = 0;
    long seen = 0, nmiss = 0, mut = 0;
    int64_t last[256];
    if (cols > 256) return -2;
    for (long c = 0; c < cols; ++c) last[c] = data_rev[c];
    while (i < rows) {
        long span = last[0];
        long sp = std::min<long>(span, w - seen);
        long extra = seen + span - w;
        seen += sp;
        long a = 0;
        for (long kk = 0; kk < n; ++kk) {
            int64_t v = last[1 + 3 * kk];
            if (v != -1) a += v;
            else { a = -1; break; }
        }
        if (a >= 0) { mut += sp * (a % 2); nmiss += sp; }
        if (extra > 0) {
            last[0] = extra;
            if (jout >= out_cap) return -1;
            out[2 * jout] = nmiss;
            out[2 * jout + 1] = mut;
            ++jout;
            nmiss = mut = seen = 0;
        } else {
            ++i;
            if (i >= rows) break;
            for (long c = 0; c < cols; ++c) last[c] = data_rev[i * cols + c];
        }
    }
    if (jout >= out_cap) return -1;
    out[2 * jout] = nmiss;
    out[2 * jout + 1] = mut;
    return jout + 1;
}

}  // extern "C"
