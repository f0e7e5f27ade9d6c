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
// index read per row, C words read and written); neighbouring threads take
// neighbouring columns of a row, so reads of a row and all writes coalesce.
#include <cuda_runtime.h>

namespace {

constexpr int BLOCK = 256;

__global__ void __launch_bounds__(BLOCK)
row_gather_kernel(const int* __restrict__ table, int rows, int cols, const int* __restrict__ idx,
                  long long total, int* __restrict__ out) {
    for (long long k = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x; k < total;
         k += static_cast<long long>(gridDim.x) * blockDim.x) {
        const long long i = k / cols;
        const int c = static_cast<int>(k - i * cols);
        const int r = min(max(__ldg(idx + i), 0), rows - 1);
        out[k] = __ldg(table + static_cast<long long>(r) * cols + c);
    }
}

}  // namespace

extern "C" int wpt_row_gather(const int* table, int rows, int cols, const int* idx, int n,
                              int* out, void* stream) {
    const long long total = static_cast<long long>(n) * cols;
    if (total > 0) {
        const long long blocks = (total + BLOCK - 1) / BLOCK;
        const int grid = static_cast<int>(blocks < 65535 * 16 ? blocks : 65535 * 16);
        row_gather_kernel<<<grid, BLOCK, 0, static_cast<cudaStream_t>(stream)>>>(
            table, rows, cols, idx, total, out);
    }
    return static_cast<int>(cudaGetLastError());
}
