// K4: one wavefront step of the diffuse class (Lambertian surfaces; diffuse,
// spot and ToF triangle lights with mixture or per-light MIS; no sky; a
// pinhole camera without distortion), in three kernels around K1, K3 and K2:
//
//   wpt_regen_pinhole  refill dead lanes with their pixel's next sample
//                      (wurblpt_tpu/render/integrator.py:973-1013)
//   wpt_shade_diffuse  emission with its MIS weight, the sensor deposit, the
//                      Lambertian cosine sample, light NEE up to its shadow
//                      ray and pending deposit, Russian roulette, the next
//                      state and the cast counters (integrator.py:456-752
//                      without the env sections, which need a sky)
//   wpt_nee_resolve    acc += pending where the shadow ray is not occluded,
//                      and the loop condition: does any lane have work left
//
// Replaces the JAX package's bounce body and regeneration, which XLA fuses on
// the TPU; in the port they were a chain of ~1000 PyTorch launches per step.
// One thread per lane, the lane state in structure-of-arrays tensors (each
// thread reads its lane's fields and writes them to new tensors), material
// rows, light rows and the alias table read inline from global memory (a
// few KB, cached). Bound on the card: bytes, the lane state read and written
// once per kernel (~200 B per lane for the shade); the mixture pdf loops
// over the L < 8 lights in index order, twice.
//
// Every expression is evaluated in the order of the plain PyTorch versions
// (render/wavefront.py, render/bsdf.py, render/lights.py, core/rng.py,
// render/camera.py), and the library is built with -fmad=false and without
// --use_fast_math, so each operation rounds as the corresponding PyTorch op
// does. A Python number multiplies or divides as PyTorch's CUDA kernels
// take it: rounded to float32 first. PCG4D runs in native uint32 and gives
// the words of core/rng.py. Where bits may still part: cosf and sinf (the
// cosine sample, the ToF phase) against PyTorch's own build of them.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BLOCK = 128;
constexpr float BIG = 3.0e37f;
constexpr float INV_PI = static_cast<float>(1.0 / 3.141592653589793);
constexpr float PI_4 = static_cast<float>(3.141592653589793 / 4.0);
constexpr float PI_2 = static_cast<float>(3.141592653589793 / 2.0);
constexpr int MAT_COLS = 23;        // albedo | emissive | p0 | p1 | p2 | typ, flags, rgl_id
constexpr int LAMBERTIAN = 1, MODPHONG = 5, LIGHT_DIFFUSE = 7, LIGHT_SPOT = 8, LIGHT_TOF = 9;
constexpr int TWO_SIDED = 1;
constexpr uint32_t SALT_PIXEL_JITTER = 0x01, SALT_BSDF = 0x10, SALT_BSDF_AUX = 0x13,
                   SALT_NEE_SAMPLE = 0x21;
constexpr int SENSOR_RGB = 0, SENSOR_TOF = 1;

}  // namespace

// The lane state's tensors (render/wavefront.py LoopState, plus the sample
// id and the next sample index of each lane).
struct WaveState {
    long long* bounce;        // [N]
    float* o;                 // [N, 3]
    float* d;                 // [N, 3]
    float* ior;               // [N, 4]
    float* throughput;        // [N, 4]
    bool* active;             // [N]
    float* acc;               // [N, 3]
    float* geom_len;          // [N]
    float* opt_len;           // [N, 4]
    float* prev_pdf;          // [N]
    bool* prev_random;        // [N]
    float* prev_light_pdf;    // [N]
    long long* sample;        // [N]
    long long* k_next;        // [N]
};

// SensorRGB: opl_min, opl_max, dtl_min, dtl_max. SensorTofAmcw: 2 pi, f / c,
// tau, contrast, pixel area, aperture factor, exposure time, duty cycle.
struct SensorParams {
    float v[8];
};

namespace {

// ---- elementwise helpers with PyTorch's semantics ---------------------------

__device__ __forceinline__ float clamp_min(float x, float lo) { return x < lo ? lo : x; }

__device__ __forceinline__ float clamp(float x, float lo, float hi) {
    const float y = x < lo ? lo : x;
    return y > hi ? hi : y;
}

// max over 4 channels, NaN-propagating like torch.max
__device__ __forceinline__ float max4(const float* x) {
    float m = x[0];
    for (int c = 1; c < 4; ++c) m = (x[c] > m || x[c] != x[c]) ? x[c] : m;
    return m;
}

__device__ __forceinline__ float dot3(const float* a, const float* b) {
    return a[0] * b[0] + a[1] * b[1] + a[2] * b[2];
}

__device__ __forceinline__ void cross3(const float* a, const float* b, float* r) {
    r[0] = a[1] * b[2] - a[2] * b[1];
    r[1] = a[2] * b[0] - a[0] * b[2];
    r[2] = a[0] * b[1] - a[1] * b[0];
}

// core/sampler.power_heuristic
__device__ __forceinline__ float power_heuristic(float a, float b) {
    const float a2 = a * a;
    const float denom = a2 + b * b;
    return denom > 0.f ? a2 / denom : 0.f;
}

// ---- core/rng.py: PCG4D on (pixel, sample, depth, salt) ----------------------

__device__ __forceinline__ void mix(uint32_t* v) {
    v[0] += v[1] * v[3];
    v[1] += v[2] * v[0];
    v[2] += v[0] * v[1];
    v[3] += v[1] * v[2];
}

__device__ __forceinline__ void uniform4(long long pixel, long long sample, long long depth,
                                         uint32_t salt, float* u) {
    uint32_t v[4] = {static_cast<uint32_t>(pixel), static_cast<uint32_t>(sample),
                     static_cast<uint32_t>(depth), salt};
    for (int c = 0; c < 4; ++c) v[c] = v[c] * 1664525u + 1013904223u;
    mix(v);
    for (int c = 0; c < 4; ++c) v[c] ^= v[c] >> 16;
    mix(v);
    for (int c = 0; c < 4; ++c) u[c] = static_cast<float>(v[c] >> 8) * (1.0f / 16777216.0f);
}

// ---- core/transform.quat_rotate: v + w t + u x t, t = 2 (u x v) --------------

__device__ __forceinline__ void quat_rotate(const float* q, const float* v, float* r) {
    float t[3], c[3];
    cross3(q, v, t);
    for (int k = 0; k < 3; ++k) t[k] = t[k] * 2.0f;
    cross3(q, t, c);
    for (int k = 0; k < 3; ++k) r[k] = (v[k] + q[3] * t[k]) + c[k];
}

// ---- the sensors' deposits (render/sensor.py deposit) -------------------------

// Deposit of an event with radiance `rad`, optical path length `opl` and
// distance to the light `dtl` on a lane that deposits (`active`); returns
// whether the sensor takes it.
template <int SENSOR>
__device__ __forceinline__ bool sensor_deposit(const SensorParams& sp, const float* rad,
                                               const float* opl, float dtl, bool active,
                                               float* dep) {
    if (SENSOR == SENSOR_RGB) {
        for (int c = 0; c < 3; ++c) dep[c] = rad[c];
        return active && opl[0] >= sp.v[0] && opl[0] <= sp.v[1] && dtl >= sp.v[2] &&
               dtl <= sp.v[3];
    } else {
        if (!active) return false;
        const float power = (rad[3] * sp.v[4]) * sp.v[5];
        const float energy = (power * sp.v[6]) * sp.v[7];
        const float phi = (sp.v[0] * opl[3]) * sp.v[1];
        const float cs = cosf(phi + sp.v[2]);
        const float half_e = energy * 0.5f;
        dep[0] = half_e * (cs * sp.v[3] + 1.0f);
        dep[1] = half_e * (1.0f - cs * sp.v[3]);
        dep[2] = energy;
        return true;
    }
}

// ---- the material row (render/bsdf.py MatRow) -------------------------------

struct MatRow {
    const float* f;   // albedo 0:4, emissive 4:8, p0 8:12
    int typ, flags;
};

__device__ __forceinline__ MatRow mat_row(const float* mat, int n_mat, int id) {
    const float* f = mat + static_cast<long long>(min(max(id, 0), n_mat - 1)) * MAT_COLS;
    return MatRow{f, __float_as_int(f[20]), __float_as_int(f[21])};
}

// ---- render/lights.py -------------------------------------------------------

// lights_pdf_multi for one direction: sum over the lights in index order of
// pick(i) x t^2 / (|cos| area) where the ray from o along d hits light i.
__device__ float mixture_pdf(const float* o, const float* d, const float* light_tri,
                             const float* light_w, int n_lights) {
    float s = 0.f;
    for (int l = 0; l < n_lights; ++l) {
        const float* p0 = light_tri + 9 * l;
        const float* e1 = p0 + 3;
        const float* e2 = p0 + 6;
        float tvec[3], fn[3], qvec[3], pvec[3], n_unit[3];
        for (int k = 0; k < 3; ++k) tvec[k] = o[k] - p0[k];
        cross3(e1, e2, fn);
        const float fn_len = sqrtf(dot3(fn, fn));
        const float area = fn_len * 0.5f;
        for (int k = 0; k < 3; ++k) n_unit[k] = fn[k] / clamp_min(fn_len, 1e-20f);
        cross3(tvec, e1, qvec);
        cross3(d, e2, pvec);
        const float det = dot3(e1, pvec);
        const bool ok_det = fabsf(det) > 1e-12f;
        const float inv_det = ok_det ? 1.0f / (det == 0.f ? 1.0f : det) : 0.f;
        const float u = dot3(tvec, pvec) * inv_det;
        const float v = dot3(d, qvec) * inv_det;
        const float t = dot3(e2, qvec) * inv_det;
        const bool hit = ok_det && u >= 0.f && v >= 0.f && u + v <= 1.0f && t > 1e-4f;
        const float cos_l = fabsf(dot3(d, n_unit));
        const float p = hit ? (t * t) / clamp_min(cos_l * area, 1e-12f) : 0.f;
        s = l == 0 ? p * light_w[0] : s + p * light_w[l];
    }
    return s;
}

// ---- the kernels -------------------------------------------------------------

// The pinhole camera's parameters (render/camera.py CameraParams).
struct Camera {
    const float* centre;       // [2]
    const float* focal;        // [2]
    const float* translation;  // [3]
    const float* rotation;     // [4] quaternion x, y, z, w
};

__global__ void __launch_bounds__(256)
regen_kernel(WaveState in, WaveState out, float* __restrict__ t_max, int n, Camera cam,
             long long blk, int B, int m, long long P, long long n_pix, int width, int height,
             int ssqrt, int randomize) {
    const int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n) return;
    const long long b_lane = i % B, j_lane = i / B;
    const long long pixel = blk * B + b_lane;
    const bool valid = pixel < n_pix;
    const long long p_safe = pixel < n_pix - 1 ? pixel : n_pix - 1;
    const bool act = in.active[i];
    const long long kn = in.k_next[i];
    const bool need = !act && kn < P && valid;
    const long long s_new = j_lane + kn * m;
    out.sample[i] = need ? s_new : in.sample[i];
    out.k_next[i] = kn + (need ? 1 : 0);
    const bool act_new = act || need;
    out.active[i] = act_new;
    t_max[i] = act_new ? BIG : 0.f;
    out.prev_random[i] = in.prev_random[i] && !need;
    if (!need) {
        out.bounce[i] = in.bounce[i];
        for (int k = 0; k < 3; ++k) {
            out.o[3 * i + k] = in.o[3 * i + k];
            out.d[3 * i + k] = in.d[3 * i + k];
        }
        for (int c = 0; c < 4; ++c) {
            out.ior[4 * i + c] = in.ior[4 * i + c];
            out.throughput[4 * i + c] = in.throughput[4 * i + c];
            out.opt_len[4 * i + c] = in.opt_len[4 * i + c];
        }
        out.geom_len[i] = in.geom_len[i];
        out.prev_pdf[i] = in.prev_pdf[i];
        out.prev_light_pdf[i] = in.prev_light_pdf[i];
        return;
    }
    // Pixel jitter and the pinhole ray (render/camera.py camera_rays, no
    // distortion, mono).
    float jx = 0.5f, jy = 0.5f;
    if (randomize) {
        float u[4];
        uniform4(pixel, s_new, 0, SALT_PIXEL_JITTER, u);
        const float inv = 1.0f / static_cast<float>(ssqrt);
        jx = (static_cast<float>(s_new % ssqrt) + u[0]) * inv;
        jy = (static_cast<float>(s_new / ssqrt) + u[1]) * inv;
    }
    const float px = static_cast<float>(p_safe % width) + jx;
    const float py = static_cast<float>(p_safe / width) + jy;
    const float nx = (px - cam.centre[0]) / cam.focal[0];
    const float ny = (py - cam.centre[1]) / cam.focal[1];
    float dc[3] = {nx, -ny, -1.0f};
    const float r = 1.0f / sqrtf(clamp_min(dot3(dc, dc), 1e-20f));
    for (int k = 0; k < 3; ++k) dc[k] = dc[k] * r;
    float dw[3];
    quat_rotate(cam.rotation, dc, dw);
    // A mono pinhole's origin is the camera's: the rotated eye offset (+0 in
    // every component for a positive scale) plus the translation, so a -0
    // of the translation becomes +0 as in the plain version's sum.
    for (int k = 0; k < 3; ++k) {
        out.o[3 * i + k] = 0.f + cam.translation[k];
        out.d[3 * i + k] = dw[k];
    }
    out.bounce[i] = 0;
    for (int c = 0; c < 4; ++c) {
        out.ior[4 * i + c] = 1.0f;
        out.throughput[4 * i + c] = 1.0f;
        out.opt_len[4 * i + c] = 0.f;
    }
    out.geom_len[i] = 0.f;
    out.prev_pdf[i] = 0.f;
    out.prev_light_pdf[i] = 0.f;
}

template <int SENSOR, bool PER_LIGHT>
__global__ void __launch_bounds__(BLOCK)
shade_kernel(WaveState in, WaveState out, unsigned long long* __restrict__ stats, int n,
             const long long* __restrict__ pixel, const float* __restrict__ t_hit,
             const int* __restrict__ prim_hit, const float* __restrict__ pos,
             const float* __restrict__ nrm, const float* __restrict__ gnrm,
             const bool* __restrict__ backside, const int* __restrict__ mat_hit,
             const float* __restrict__ mat, int n_mat, const float* __restrict__ pick_area,
             int n_pick, const float* __restrict__ light_tri, const int* __restrict__ light_mat,
             const float* __restrict__ light_w, const float* __restrict__ alias_prob,
             const int* __restrict__ alias_idx, int n_lights, SensorParams sp, int max_depth,
             int rr_start, float rr_threshold, float shadow_scale, float min_hit,
             float* __restrict__ shadow_d, float* __restrict__ shadow_tmax,
             float* __restrict__ pending) {
    const int i = blockIdx.x * blockDim.x + threadIdx.x;
    bool act = false, is_random = false;
    if (i < n) {
        act = in.active[i];
        const long long k = in.bounce[i];
        const float t = t_hit[i];
        const int prim = prim_hit[i];
        const bool hit = prim >= 0 && act;
        float d[3], n3[3], p[3], tp[4], ior[4];
        for (int c = 0; c < 3; ++c) {
            d[c] = in.d[3 * i + c];
            n3[c] = nrm[3 * i + c];
            p[c] = pos[3 * i + c];
        }
        for (int c = 0; c < 4; ++c) {
            tp[c] = in.throughput[4 * i + c];
            ior[c] = in.ior[4 * i + c];
        }
        const MatRow mr = mat_row(mat, n_mat, mat_hit[i]);

        // 1. path lengths (wurblpt.hpp:148-150)
        const float geom = hit ? in.geom_len[i] + t : in.geom_len[i];
        float opl[4];
        for (int c = 0; c < 4; ++c) {
            const float o_l = in.opt_len[4 * i + c];
            opl[c] = hit ? o_l + t * ior[c] : o_l;
        }

        // 2. emission with its MIS weight, deposited at once (render/bsdf.py emitted)
        const float vd[3] = {-d[0], -d[1], -d[2]};
        const float cos_view = dot3(n3, vd);
        const bool is_cone = mr.typ == LIGHT_SPOT || mr.typ == LIGHT_TOF;
        const bool is_emitter = mr.typ == LIGHT_DIFFUSE || is_cone || mr.typ == MODPHONG;
        const bool front_ok = !backside[i] || (mr.flags & TWO_SIDED) > 0;
        const bool e_ok = is_emitter && front_ok && cos_view > 0.f &&
                          (cos_view >= mr.f[8] || !is_cone);
        const bool prev_random = in.prev_random[i];
        const float prev_pdf = in.prev_pdf[i];
        float w_emit = 1.0f;
        if (PER_LIGHT) {
            // lights_pdf_at_hit: pick x t^2 / (|cos| area) of the prim hit
            const int pm = hit ? prim : -1;
            const float* row = pick_area + 2 * min(max(pm, 0), n_pick - 1);
            const float pp = pm >= 0 ? row[0] : 0.f;
            const float g[3] = {gnrm[3 * i], gnrm[3 * i + 1], gnrm[3 * i + 2]};
            const float cg = fabsf(dot3(d, g));
            const float lp_hit = pp * (((t * t) * row[1]) / clamp_min(cg, 1e-12f));
            if (prev_random) w_emit = power_heuristic(prev_pdf, lp_hit);
        } else if (prev_random) {
            w_emit = power_heuristic(prev_pdf, in.prev_light_pdf[i]);
        }
        float rad[4], dep[3];
        for (int c = 0; c < 4; ++c) rad[c] = (tp[c] * (e_ok ? mr.f[4 + c] : 0.f)) * w_emit;
        const bool take = sensor_deposit<SENSOR>(sp, rad, opl, t, hit, dep);
        for (int c = 0; c < 3; ++c)
            out.acc[3 * i + c] = in.acc[3 * i + c] + (take ? dep[c] : 0.f);

        // 3. the Lambertian cosine sample (core/sampler.cosine_direction)
        const long long px_id = pixel[i], smp = in.sample[i];
        float u4[4], ua[4], u3[4];
        uniform4(px_id, smp, k, SALT_BSDF, u4);
        uniform4(px_id, smp, k, SALT_BSDF_AUX, ua);
        uniform4(px_id, smp, k, SALT_NEE_SAMPLE, u3);
        float sdir[3] = {n3[0], n3[1], n3[2]};
        float atten[4] = {0.f, 0.f, 0.f, 0.f};
        float spdf = 0.f;
        const bool lamb = mr.typ == LAMBERTIAN;
        if (lamb) {
            // in_unit_disk (concentric map)
            const float ox = u4[0] * 2.0f - 1.0f, oy = u4[1] * 2.0f - 1.0f;
            const bool use_x = fabsf(ox) > fabsf(oy);
            const float safe_ox = fabsf(ox) > 0.f ? ox : 1.0f;
            const float safe_oy = fabsf(oy) > 0.f ? oy : 1.0f;
            const float theta = use_x ? (oy / safe_ox) * PI_4 : PI_2 - (ox / safe_oy) * PI_4;
            const float rr = (ox == 0.f && oy == 0.f) ? 0.f : (use_x ? ox : oy);
            const float lx = rr * cosf(theta), ly = rr * sinf(theta);
            const float lz = sqrtf(clamp_min((1.0f - lx * lx) - ly * ly, 1e-20f));
            // onb_from_normal (Duff et al.)
            const float sign = n3[2] >= 0.f ? 1.0f : -1.0f;
            const float a = (1.0f / (sign + n3[2])) * -1.0f;
            const float bvar = (n3[0] * n3[1]) * a;
            const float tt[3] = {((sign * n3[0]) * n3[0]) * a + 1.0f, sign * bvar,
                                 (-sign) * n3[0]};
            const float bb[3] = {bvar, sign + (n3[1] * n3[1]) * a, -n3[1]};
            for (int c = 0; c < 3; ++c) sdir[c] = (lx * tt[c] + ly * bb[c]) + lz * n3[c];
            spdf = clamp_min(dot3(sdir, n3), 0.f) * INV_PI;
            for (int c = 0; c < 4; ++c) atten[c] = mr.f[c] * spdf;
        }
        is_random = hit && lamb && spdf > 0.f;

        // 4. light NEE up to the shadow ray (render/lights.py lights_sample)
        const int cell = min(max(static_cast<int>(u3[0] * static_cast<float>(n_lights)), 0),
                             n_lights - 1);
        const float frac = u3[0] * static_cast<float>(n_lights) - static_cast<float>(cell);
        const int pick = frac >= alias_prob[cell] ? alias_idx[cell] : cell;
        const float* lt = light_tri + 9 * pick;
        const float* e1 = lt + 3;
        const float* e2 = lt + 6;
        const float su = sqrtf(clamp_min(u3[1], 1e-20f));
        const float b0 = 1.0f - su, b1 = u3[2] * su;
        float ldir[3];
        for (int c = 0; c < 3; ++c) ldir[c] = ((lt[c] + b0 * e1[c]) + b1 * e2[c]) - p[c];
        const float ldist = sqrtf(dot3(ldir, ldir));
        for (int c = 0; c < 3; ++c) ldir[c] = ldir[c] / clamp_min(ldist, 1e-12f);
        float fn[3];
        cross3(e1, e2, fn);
        const float fn_len = sqrtf(dot3(fn, fn));
        const float area = fn_len * 0.5f;
        const float cos_tri = fabsf(dot3(ldir, fn)) / clamp_min(fn_len, 1e-20f);
        const float pdf_sa = (ldist * ldist) / clamp_min(cos_tri * area, 1e-12f);
        const float t_vis = clamp_min(ldist * shadow_scale, min_hit);
        for (int c = 0; c < 3; ++c) shadow_d[3 * i + c] = ldir[c];
        shadow_tmax[i] = is_random ? t_vis : 0.f;
        float light_pdf_next = 0.f;
        bool nee_take = false;
        float ndep[3] = {0.f, 0.f, 0.f};
        if (is_random) {
            float pdf_light;
            if (PER_LIGHT) {
                pdf_light = light_w[pick] * pdf_sa;
            } else {
                pdf_light = mixture_pdf(p, ldir, light_tri, light_w, n_lights);
                light_pdf_next = mixture_pdf(p, sdir, light_tri, light_w, n_lights);
            }
            // bsdf_eval (Lambertian) toward the light
            const float pb = clamp_min(dot3(ldir, n3), 0.f) * INV_PI;
            // light_emitted_at: the light's side and cone toward the receiver
            float nl[3];
            for (int c = 0; c < 3; ++c) nl[c] = fn[c] / clamp_min(fn_len, 1e-20f);
            const float tw[3] = {-ldir[0], -ldir[1], -ldir[2]};
            const float cos_v = dot3(nl, tw);
            const MatRow lr = mat_row(mat, n_mat, light_mat[pick]);
            const bool l_cone = lr.typ == LIGHT_SPOT || lr.typ == LIGHT_TOF;
            const bool front = cos_v > 0.f || (lr.flags & TWO_SIDED) > 0;
            const bool le_ok = front && (fabsf(cos_v) >= lr.f[8] || !l_cone);
            const float w_nee = power_heuristic(pdf_light, pb);
            const float scale = w_nee / clamp_min(pdf_light, 1e-12f);
            float contrib[4], nopl[4];
            for (int c = 0; c < 4; ++c) {
                contrib[c] = ((tp[c] * (mr.f[c] * pb)) * (le_ok ? lr.f[4 + c] : 0.f)) * scale;
                nopl[c] = opl[c] + ldist * ior[c];
            }
            nee_take = sensor_deposit<SENSOR>(sp, contrib, nopl, ldist, pdf_light > 1e-12f,
                                              ndep);
        }
        for (int c = 0; c < 3; ++c) pending[3 * i + c] = nee_take ? ndep[c] : 0.f;

        // 5. throughput update, Russian roulette, the next state (wurblpt.hpp:258-273)
        float ratio[4], ntp[4];
        const float pdf_c = clamp_min(spdf, 1e-12f);
        for (int c = 0; c < 4; ++c) {
            ratio[c] = is_random ? atten[c] / pdf_c : atten[c];
            ntp[c] = tp[c] * ratio[c];
        }
        const bool cont = is_random;
        const float max_r = max4(ratio);
        const bool do_rr = k >= rr_start && max_r < rr_threshold && cont;
        const float q = clamp(1.0f - max_r, 0.f, 0.95f);
        const bool killed = do_rr && ua[2] < q;
        if (do_rr && !killed) {
            const float keep = clamp_min(1.0f - q, 0.05f);
            for (int c = 0; c < 4; ++c) ntp[c] = ntp[c] / keep;
        }
        const bool alive = cont && !killed && max4(ntp) > 0.f;
        out.bounce[i] = act ? k + 1 : k;
        for (int c = 0; c < 3; ++c) {
            out.o[3 * i + c] = hit ? p[c] : in.o[3 * i + c];
            out.d[3 * i + c] = cont ? sdir[c] : d[c];
        }
        for (int c = 0; c < 4; ++c) {
            out.throughput[4 * i + c] = cont ? ntp[c] : tp[c];
            out.opt_len[4 * i + c] = opl[c];
        }
        out.active[i] = act && alive && k + 1 < max_depth;
        out.geom_len[i] = geom;
        out.prev_pdf[i] = is_random ? spdf : 0.f;
        out.prev_random[i] = is_random;
        out.prev_light_pdf[i] = is_random ? light_pdf_next : 0.f;
    }
    // the cast counters: one closest cast per active lane, one shadow cast per RANDOM lane
    const int n_act = __syncthreads_count(act);
    const int n_rand = __syncthreads_count(is_random);
    if (threadIdx.x == 0 && n_act > 0) {
        atomicAdd(stats, static_cast<unsigned long long>(n_act));
        atomicAdd(stats + 1, static_cast<unsigned long long>(n_act + n_rand));
    }
}

__global__ void __launch_bounds__(256)
resolve_kernel(const float* __restrict__ acc, const float* __restrict__ pending,
               const bool* __restrict__ occluded, const bool* __restrict__ active,
               const long long* __restrict__ k_next, int n, int n_acc, long long blk, int B,
               long long P, long long n_pix, float* __restrict__ out, int* __restrict__ work) {
    const int i = blockIdx.x * blockDim.x + threadIdx.x;
    bool busy = false;
    if (i < n) {
        const bool occ = occluded[i];
        for (int c = 0; c < n_acc; ++c) {
            const long long j = static_cast<long long>(i) * n_acc + c;
            out[j] = acc[j] + (occ ? 0.f : pending[j]);
        }
        const long long pixel = blk * B + i % B;
        busy = active[i] || (k_next[i] < P && pixel < n_pix);
    }
    if (__syncthreads_or(busy) && threadIdx.x == 0) *work = 1;
}

}  // namespace

extern "C" int wpt_regen_pinhole(const WaveState* in, const WaveState* out, float* t_max, int n,
                                 const float* centre, const float* focal,
                                 const float* translation, const float* rotation,
                                 long long blk, int B, int m, long long P, long long n_pix,
                                 int width, int height, int ssqrt, int randomize,
                                 void* stream) {
    if (n > 0) {
        const Camera cam{centre, focal, translation, rotation};
        regen_kernel<<<(n + 255) / 256, 256, 0, static_cast<cudaStream_t>(stream)>>>(
            *in, *out, t_max, n, cam, blk, B, m, P, n_pix, width, height, ssqrt, randomize);
    }
    return static_cast<int>(cudaGetLastError());
}

extern "C" int wpt_shade_diffuse(
    const WaveState* in, const WaveState* out, long long* stats, int n, const long long* pixel,
    const float* t, const int* prim, const float* pos, const float* nrm, const float* gnrm,
    const bool* backside, const int* mat_hit, const float* mat, int n_mat,
    const float* pick_area, int n_pick, const float* light_tri, const int* light_mat,
    const float* light_w, const float* alias_prob, const int* alias_idx, int n_lights,
    int per_light, int sensor, const float* sensor_params, int max_depth, int rr_start,
    float rr_threshold, float shadow_scale, float min_hit, float* shadow_d, float* shadow_tmax,
    float* pending, void* stream) {
    if (n_lights < 1 || (sensor != SENSOR_RGB && sensor != SENSOR_TOF)) return -1;
    if (n > 0) {
        SensorParams sp;
        for (int k = 0; k < 8; ++k) sp.v[k] = sensor_params[k];
        const int grid = (n + BLOCK - 1) / BLOCK;
        cudaStream_t s = static_cast<cudaStream_t>(stream);
        unsigned long long* st = reinterpret_cast<unsigned long long*>(stats);
#define WPT_SHADE(SENSOR, PER_LIGHT)                                                          \
    shade_kernel<SENSOR, PER_LIGHT><<<grid, BLOCK, 0, s>>>(                                  \
        *in, *out, st, n, pixel, t, prim, pos, nrm, gnrm, backside, mat_hit, mat, n_mat,      \
        pick_area, n_pick, light_tri, light_mat, light_w, alias_prob, alias_idx, n_lights,    \
        sp, max_depth, rr_start, rr_threshold, shadow_scale, min_hit, shadow_d, shadow_tmax,  \
        pending)
        if (sensor == SENSOR_RGB) {
            if (per_light) WPT_SHADE(SENSOR_RGB, true); else WPT_SHADE(SENSOR_RGB, false);
        } else {
            if (per_light) WPT_SHADE(SENSOR_TOF, true); else WPT_SHADE(SENSOR_TOF, false);
        }
#undef WPT_SHADE
    }
    return static_cast<int>(cudaGetLastError());
}

extern "C" int wpt_nee_resolve(const float* acc, const float* pending, const bool* occluded,
                               const bool* active, const long long* k_next, int n, int n_acc,
                               long long blk, int B, long long P, long long n_pix, float* out,
                               int* work, void* stream) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    cudaMemsetAsync(work, 0, sizeof(int), s);
    if (n > 0) {
        resolve_kernel<<<(n + 255) / 256, 256, 0, s>>>(acc, pending, occluded, active, k_next, n,
                                                      n_acc, blk, B, P, n_pix, out, work);
    }
    return static_cast<int>(cudaGetLastError());
}
