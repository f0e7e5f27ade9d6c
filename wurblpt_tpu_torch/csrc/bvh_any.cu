// K6: occlusion of N rays in (tmin, tmax) over the port's binary BVH (see
// bvh_common.cuh).
//
// Replaces wurblpt_tpu/accel/traverse.py bvh_any_hit / _wide_any_hit with
// its leaf branches, as K5. The same persistent walk as K5 with the ray's
// tmax as the bound throughout; a ray is done at the first valid primitive.
// A lane with tmax <= tmin (a dead path, or a lane without a shadow ray this
// bounce) is not occluded and reads no node. One instantiation per leaf
// kind and branch, as K5.
#include "bvh_common.cuh"

namespace {

using namespace wpt_bvh;

template <bool SPHERES, bool ANIMATED, bool STAGED>
__global__ void __launch_bounds__(BLOCK, MIN_BLOCKS)
bvh_any_kernel(Rays rays, Tree tree, int* counter, int2* spill, Out out) {
    walk_lanes<true, SPHERES, ANIMATED, STAGED>(rays, tree, counter, spill, out);
}

using Kernel = decltype(&bvh_any_kernel<false, false, false>);

Kernel kernel_of(int variant) {
    switch (variant & 7) {
        case 1: return bvh_any_kernel<true, false, false>;
        case 2: return bvh_any_kernel<false, true, false>;
        case 3: return bvh_any_kernel<true, true, false>;
        case 4: return bvh_any_kernel<false, false, true>;
        case 5: return bvh_any_kernel<true, false, true>;
        case 6: return bvh_any_kernel<false, true, true>;
        case 7: return bvh_any_kernel<true, true, true>;
        default: return bvh_any_kernel<false, false, false>;
    }
}

// resident_threads of the variant's kernel, asked again only when a cast's
// shared memory differs from the variant's last one.
int launch_threads(int variant, int smem) {
    static int last_smem[8] = {-1, -1, -1, -1, -1, -1, -1, -1}, threads[8] = {};
    if (last_smem[variant] != smem) {
        threads[variant] = resident_threads(kernel_of(variant), smem);
        last_smem[variant] = smem;
    }
    return threads[variant];
}

}  // namespace

// The most dynamic shared memory a staged launch of the leaf kind `variant`
// (bits 0-1) may take without costing the SM a resident block.
extern "C" int wpt_bvh_any_budget(int variant) {
    static int budget[4] = {0, 0, 0, 0};
    int& b = budget[variant & 3];
    if (b == 0) b = stage_budget(kernel_of((variant & 3) | 4));
    return b;
}

// Threads of a full persistent launch of one variant with `smem` bytes of
// dynamic shared memory: the wrapper sizes the L2 walk's spill rows with it.
extern "C" int wpt_bvh_any_threads(int variant, int smem) {
    return launch_threads(variant & 7, smem);
}

extern "C" int wpt_bvh_any_hit(int variant, const float* o, const float* d, const float* tmin,
                               const float* tmax, int n, const float* nodes, int n_nodes,
                               const float* rows, int n_rows, int n_tris, const float* frames,
                               long long lane_stride, int n_anims, int depth, int* counter,
                               int* spill, bool* occ_out, void* stream) {
    if (variant < 0 || variant > 7) return static_cast<int>(cudaErrorInvalidValue);
    if (n > 0) {
        const cudaStream_t s = static_cast<cudaStream_t>(stream);
        const Layout lay = layout(variant & 4, variant & 2, n_nodes, n_rows, n_tris, n_anims,
                                  depth, lane_stride > 0);
        const int threads = launch_threads(variant, lay.bytes);
        const int grid = min(threads / BLOCK, (n + BLOCK - 1) / BLOCK);
        if (n > grid * BLOCK) cudaMemsetAsync(counter, 0, sizeof(int), s);
        kernel_of(variant)<<<grid, BLOCK, lay.bytes, s>>>(
            Rays{o, d, tmin, tmax, n},
            Tree{reinterpret_cast<const float4*>(nodes), reinterpret_cast<const float4*>(rows),
                 frames, n_nodes, n_rows, n_tris, n_anims, depth, lane_stride},
            counter, reinterpret_cast<int2*>(spill), Out{nullptr, nullptr, nullptr, nullptr, occ_out});
    }
    return static_cast<int>(cudaGetLastError());
}
