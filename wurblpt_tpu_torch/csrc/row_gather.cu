// P0: per-lane row gather, out[i, :] = table[clamp(idx[i], 0, R-1), :].
//
// Replaces the Pallas probe tools/probe_pallas_gather.py:20 (pl.pallas_call:
// row gather from a VMEM table, jnp.take, the 1-D take with [8, 128]
// indices), the one pallas_call of the repository, and the per-lane table
// gathers of the render path that it stands for: the packed material rows
// (render/bsdf.gather_material_rows) and the (pick probability, 1 / area)
// rows of per-light MIS (render/lights.lights_pdf_at_hit).
//
// It copies 4-byte words, so one kernel serves float32 and int32 tables and
// tables that hold int32 bit patterns among floats. Indices are clamped to
// [0, R-1], which is XLA's gather semantics. Bound on the card: bytes (one
// index read per row, C words read and written); the table is small and
// stays in cache, so the output's writes are the traffic.
//
// Design: the output rows are contiguous, so the flat output is written in
// 16-byte vectors, neighbouring threads on neighbouring vectors, even where
// a row (23 words for the material rows) is not 16-byte aligned; each
// thread finds the row and column of its vector's first word with one
// 32-bit multiply-high by a divisor's reciprocal computed on the host, and
// steps through the other three words. The last n*C mod 4 words are written
// one at a time. A launch indexes fewer than 2^31 words; the C entry splits
// larger gathers into launches of whole multiples of 4 rows.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int BLOCK = 256;
constexpr int MAX_WORDS = 0x7ffffff0;   // words of one launch

// q = (x * m) >> p = x / d for 0 <= x < 2^31 (d >= 1): p = 31 + ceil(log2 d),
// m = ceil(2^p / d) < 2^32.
struct Divider {
    unsigned m;
    int p;
};

inline Divider divider_of(int d) {
    int l = 0;
    while ((1ll << l) < d) ++l;
    const int p = 31 + l;
    return {static_cast<unsigned>(((1ull << p) + static_cast<unsigned>(d) - 1) / d), p};
}

__device__ __forceinline__ unsigned divide(unsigned x, Divider v) {
    return static_cast<unsigned>((static_cast<unsigned long long>(x) * v.m) >> v.p);
}

__device__ __forceinline__ int clamp_row(const int* __restrict__ idx, unsigned i, int rows) {
    return min(max(__ldg(idx + i), 0), rows - 1);
}

__global__ void __launch_bounds__(BLOCK)
row_gather_kernel(const int* __restrict__ table, int rows, int cols, Divider by_cols,
                  const int* __restrict__ idx, int total, int* __restrict__ out) {
    // unsigned: total + stride < 2^32
    const unsigned stride = gridDim.x * BLOCK, n_words = total, ucols = cols;
    const unsigned nvec = (reinterpret_cast<uintptr_t>(out) & 15) == 0 ? n_words / 4 : 0;
    int4* out4 = reinterpret_cast<int4*>(out);
    for (unsigned v = blockIdx.x * BLOCK + threadIdx.x; v < nvec; v += stride) {
        unsigned i = divide(4 * v, by_cols);
        unsigned c = 4 * v - i * ucols;
        int r = clamp_row(idx, i, rows);
        int w[4];
        for (int j = 0; j < 4; ++j) {
            if (c == ucols) {
                c = 0;
                r = clamp_row(idx, ++i, rows);
            }
            w[j] = __ldg(table + static_cast<size_t>(r) * cols + c);
            ++c;
        }
        out4[v] = make_int4(w[0], w[1], w[2], w[3]);
    }
    for (unsigned k = 4 * nvec + blockIdx.x * BLOCK + threadIdx.x; k < n_words; k += stride) {
        const unsigned i = divide(k, by_cols);
        const int r = clamp_row(idx, i, rows);
        out[k] = __ldg(table + static_cast<size_t>(r) * cols + (k - i * ucols));
    }
}

// Rows of one launch: a multiple of 4 (the next launch's output stays
// 16-byte aligned) whose words fit MAX_WORDS; 0 where no 4 rows do.
inline int rows_per_launch(int cols) { return (MAX_WORDS / cols) & ~3; }

inline int launch_grid(long long words) {
    const long long blocks = (words / 4 + BLOCK - 1) / BLOCK;
    return static_cast<int>(blocks < 1 ? 1 : (blocks < 65535 * 16 ? blocks : 65535 * 16));
}

}  // namespace

extern "C" int wpt_row_gather(const int* table, int rows, int cols, const int* idx, int n,
                              int* out, void* stream) {
    if (n > 0 && cols > 0) {
        const int step = rows_per_launch(cols);
        if (step == 0) return static_cast<int>(cudaErrorInvalidValue);
        const Divider by_cols = divider_of(cols);
        for (long long r0 = 0; r0 < n; r0 += step) {
            const int m = static_cast<int>(n - r0 < step ? n - r0 : step);
            row_gather_kernel<<<launch_grid(static_cast<long long>(m) * cols), BLOCK, 0,
                                static_cast<cudaStream_t>(stream)>>>(
                table, rows, cols, by_cols, idx + r0, m * cols,
                out + static_cast<size_t>(r0) * cols);
        }
    }
    return static_cast<int>(cudaGetLastError());
}
