// Native sector-table builders for cdmft_lanc_ed_tpu.
//
// Replaces the per-element Fortran loops of the reference Hilbert-space
// setup (/root/reference/ED_SETUP.f90:720-1097) with tight C++ kernels for
// the host-side table construction that feeds the device kernels:
//   * sector_states: colex/combinadic enumeration of all Ns-bit states with
//     fixed popcount, ascending (build_sector map order)
//   * hop_entries_multi: all matrix elements of a batch of one-body hops
//     c^+_a c_b over a sorted sector map, with fermionic signs
//   * cdm_group_keys: (imp, bath) split keys used by the cluster-density-
//     matrix bath trace
//
// Built as a plain shared library (no pybind11 in the image); loaded via
// ctypes with a NumPy fallback (cdmft_lanc_ed_tpu/native/loader.py).
#include <cstdint>
#include <cstring>

extern "C" {

// Enumerate all ns-bit integers with exactly n bits set, ascending.
// out must hold C(ns, n) entries.  Returns the count.
int64_t sector_states(int32_t ns, int32_t n, int64_t* out) {
    if (n < 0 || n > ns) return 0;
    if (n == 0) { out[0] = 0; return 1; }
    int64_t v = (int64_t(1) << n) - 1;       // smallest state
    const int64_t limit = int64_t(1) << ns;
    int64_t cnt = 0;
    while (v < limit) {
        out[cnt++] = v;
        // Gosper's hack: next integer with the same popcount
        int64_t c = v & -v;
        int64_t r = v + c;
        v = (((r ^ v) >> 2) / c) | r;
    }
    return cnt;
}

static inline int parity_below(int64_t m, int32_t b) {
    int64_t mask = (int64_t(1) << b) - 1;
    return __builtin_parityll((unsigned long long)(m & mask));
}

// Binary search in a sorted int64 array.
static inline int64_t bsearch64(const int64_t* arr, int64_t n, int64_t key) {
    int64_t lo = 0, hi = n;
    while (lo < hi) {
        int64_t mid = (lo + hi) >> 1;
        if (arr[mid] < key) lo = mid + 1; else hi = mid;
    }
    return lo;
}

// For each hop term (a[t], b[t]) emit all entries of c^+_a c_b over the
// sorted sector map `states[dim]`:  rows/cols are indices into the map,
// sign = fermionic string sign, term_id = t.  Buffers must hold up to
// nterms*dim entries.  Returns the number of entries written.
int64_t hop_entries_multi(const int64_t* states, int64_t dim,
                          const int32_t* a, const int32_t* b,
                          int32_t nterms,
                          int64_t* rows, int64_t* cols,
                          int8_t* signs, int32_t* term_id) {
    int64_t cnt = 0;
    for (int32_t t = 0; t < nterms; ++t) {
        const int32_t aa = a[t], bb = b[t];
        const int64_t abit = int64_t(1) << aa;
        const int64_t bbit = int64_t(1) << bb;
        for (int64_t j = 0; j < dim; ++j) {
            const int64_t m = states[j];
            if (!(m & bbit) || (m & abit)) continue;
            int s1 = parity_below(m, bb);
            const int64_t k1 = m & ~bbit;
            int s2 = parity_below(k1, aa);
            const int64_t k2 = k1 | abit;
            rows[cnt] = bsearch64(states, dim, k2);
            cols[cnt] = j;
            signs[cnt] = (int8_t)(((s1 ^ s2) & 1) ? -1 : 1);
            term_id[cnt] = t;
            ++cnt;
        }
    }
    return cnt;
}

// Occupation table: out[j*nlv + l] = bit lv[l] of states[j].
void number_op(const int64_t* states, int64_t dim, const int32_t* lv,
               int32_t nlv, double* out) {
    for (int64_t j = 0; j < dim; ++j)
        for (int32_t l = 0; l < nlv; ++l)
            out[j * nlv + l] = double((states[j] >> lv[l]) & 1);
}

// Split each sector state into (imp, bath) labels: imp = low nimp bits.
void imp_bath_split(const int64_t* states, int64_t dim, int32_t nimp,
                    int64_t* imp, int64_t* bath) {
    const int64_t mask = (int64_t(1) << nimp) - 1;
    for (int64_t j = 0; j < dim; ++j) {
        imp[j] = states[j] & mask;
        bath[j] = states[j] >> nimp;
    }
}

}  // extern "C"
