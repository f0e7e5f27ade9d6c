// K4: one wavefront step, for three classes of scenes, in five kernels around
// the casts (K1/K5 closest hit, K3 hit assembly, K2/K6 any hit):
//
//   wpt_regen_pinhole  refill dead lanes with their pixel's next sample: the
//                      jittered pixel, the lens model's inverse (the OpenCV
//                      fixed point, RADIAL_ONLY's inverse series or
//                      RADIAL_AND_PLANAR's closed form) and the ray
//                      (wurblpt_tpu/render/integrator.py:973-1013,
//                      camera.py:140-180)
//   wpt_regen_surround the same through the 180/360-degree surround camera,
//                      mono or stereo: the equirect direction of each eye's
//                      half of the image and the ODS eye offset
//                      (camera.py:224-262); regen_kernel's other instantiation
//   wpt_shade_diffuse  the diffuse class (Lambertian surfaces; diffuse, spot
//                      and ToF triangle lights with mixture or per-light
//                      MIS; no sky): emission with its MIS weight, the
//                      sensor deposit, the Lambertian cosine sample, light
//                      NEE up to its shadow ray and pending deposit, Russian
//                      roulette, the next state and the cast counters
//                      (integrator.py:456-752 without the env sections)
//   wpt_shade_env      the env class (Lambertian, GGX, mirror and glass
//                      surfaces, triangles and analytic spheres, under an
//                      equirect, cube or constant sky, with or without
//                      importance tables; no light): the sky on a miss (MIS-
//                      weighted against env NEE when the sky is importance-
//                      sampled), emission, the Lambertian cosine / GGX VNDF /
//                      mirror / dispersive glass sample with the glass's new
//                      ray IOR, env NEE up to its shadow ray (to BIG) and
//                      pending deposit when the sky has importance tables,
//                      Russian roulette, the next state and the cast counters
//                      (integrator.py:456-752 without light NEE); K8's
//                      lookups, sample and pdf inline (envmap_common.cuh)
//   wpt_shade_lit      the lit class (the env class's surfaces, ModPhong with
//                      its opacity pass-through and measured RGL, triangle
//                      lights under per-light MIS beside an equirect or cube
//                      sky with importance tables): the sky on a miss,
//                      emission with its per-light MIS weight, the sample of
//                      the lane's lobe (RGL through K7's arithmetic inline,
//                      rgl_common.cuh), light NEE and env NEE each up to its
//                      shadow ray and pending deposit, Russian roulette, the
//                      next state with the ray IOR and the cast counters
//                      (integrator.py:400-752)
//   wpt_nee_resolve    acc += pending where the shadow ray is not occluded
//                      (the lit class's light deposit, then its sky's), and
//                      the loop condition: does any lane have work left (the
//                      condition alone where the step casts no shadow ray)
//
// Replaces the JAX package's bounce body and regeneration, which XLA fuses on
// the TPU; in the port they were a chain of ~1000-1700 PyTorch launches per
// step. One thread per lane, the lane state in structure-of-arrays tensors
// (each thread reads its lane's fields and writes them to new tensors),
// material rows, light rows, the alias tables, the sky's texels and the RGL
// tables read inline from global memory (a few KB, the sky's 96-128 KB, the
// RGL tables' 17 KB, cached). Bound on the card: bytes, the lane state read
// and written once per kernel (~200 B per lane for a shade, ~320 B for the
// lit shade with its two shadow rays); the mixture pdf loops over the L < 8
// lights in index order, twice. The shades evaluate only the lane's own
// material branch (the plain version evaluates every branch and selects), so
// GGX's VNDF sample and its two evaluations cost only the GGX lanes, the
// glass's Fresnel term and refraction only the glass lanes, RGL's two warps
// and two evaluations only the RGL lanes. The sky's kind, its importance
// sampling, the glass lobe and RGL are template parameters, so a scene
// without glass (the mesh path) keeps the registers of a kernel without it,
// and a lit scene without RGL those of a kernel without K7's arithmetic.
//
// Every expression is evaluated in the order of the plain PyTorch versions
// (render/wavefront.py, render/bsdf.py, render/lights.py, render/envmap.py,
// materials/rgl.py, core/rng.py, core/onb.py, core/vecmath.py,
// core/fresnel.py, render/camera.py), and the library is built with
// -fmad=false and without --use_fast_math, so each operation rounds as the
// corresponding PyTorch op does. A Python number multiplies or divides as
// PyTorch's CUDA kernels take it: rounded to float32 first; `c / x` is
// x.reciprocal() * c, exact for c = 1. PCG4D runs in native uint32 and gives
// the words of core/rng.py. Where bits may still part: cosf and sinf (the
// cosine sample, the GGX VNDF and power-cosine samples, the env sample, the
// surround camera, RGL's sample, the ToF phase), powf (ModPhong's lobe and
// its sample, as PyTorch's pow of two float tensors), expf (the glass's
// absorption) and atan2f / acosf / asinf (the sky's lookup and pdf, RGL's
// frame) against PyTorch's own build of them.
#include <cuda_runtime.h>
#include <stdint.h>

#include "envmap_common.cuh"
#include "rgl_common.cuh"

namespace {

constexpr int BLOCK = 128;
constexpr float BIG = 3.0e37f;
constexpr float INV_PI = static_cast<float>(1.0 / 3.141592653589793);
constexpr float PI_4 = static_cast<float>(3.141592653589793 / 4.0);
constexpr float PI_2 = static_cast<float>(3.141592653589793 / 2.0);
constexpr float PI_F = static_cast<float>(3.141592653589793);
constexpr float TWO_PI_F = static_cast<float>(2.0 * 3.141592653589793);
constexpr float INV_TWO_PI = 0x1.45f306p-3f;   // float32(1) / float32(2 pi), as XLA divides
constexpr int MAT_COLS = 23;        // albedo | emissive | p0 | p1 | p2 | typ, flags, rgl_id
constexpr int LAMBERTIAN = 1, GGX = 2, GLASS = 3, MIRROR = 4, MODPHONG = 5, LIGHT_DIFFUSE = 7,
              LIGHT_SPOT = 8, LIGHT_TOF = 9, RGL = 10;
constexpr int TWO_SIDED = 1;
constexpr int KIND_NONE = 0, KIND_RANDOM = 1, KIND_EXPLICIT = 2;   // render/bsdf.py ScatterKind
constexpr uint32_t SALT_PIXEL_JITTER = 0x01, SALT_BSDF = 0x10, SALT_BSDF_AUX = 0x13,
                   SALT_NEE_SAMPLE = 0x21, SALT_ENVMAP_SAMPLE = 0x22;
constexpr int SENSOR_RGB = 0, SENSOR_TOF = 1;
constexpr int SKY_EQUIRECT = 1, SKY_CUBE = 2, SKY_CONSTANT = 3;       // EnvMapArrays.kind
constexpr int LENS_NONE = 0, LENS_RADIAL_AND_PLANAR = 1, LENS_RADIAL_ONLY = 2,
              LENS_OPENCV = 3;                                       // camera.DistortionModel

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

// core/vecmath.normalize: a * reciprocal(sqrt(max(a . a, 1e-20)))
__device__ __forceinline__ void normalize3(const float* a, float* r) {
    const float inv = 1.0f / sqrtf(clamp_min(dot3(a, a), 1e-20f));
    for (int c = 0; c < 3; ++c) r[c] = a[c] * inv;
}

// core/vecmath.reflect: d - (2 (d . n)) n
__device__ __forceinline__ void reflect3(const float* d, const float* n, float* r) {
    const float s = 2.0f * dot3(d, n);
    for (int c = 0; c < 3; ++c) r[c] = d[c] - s * n[c];
}

// core/onb.onb_from_normal_tangent: Gram-Schmidt of the tangent against n
__device__ __forceinline__ void onb_from_tangent(const float* n, const float* tg, float* t,
                                                 float* b) {
    const float tn = dot3(tg, n);
    float u[3];
    for (int c = 0; c < 3; ++c) u[c] = tg[c] - tn * n[c];
    normalize3(u, t);
    cross3(n, t, b);
}

// core/onb.to_local and to_world in the (t, b, n) frame
__device__ __forceinline__ void to_local(const float* w, const float* t, const float* b,
                                         const float* n, float* l) {
    l[0] = dot3(w, t);
    l[1] = dot3(w, b);
    l[2] = dot3(w, n);
}

__device__ __forceinline__ void to_world(const float* l, const float* t, const float* b,
                                         const float* n, float* w) {
    for (int c = 0; c < 3; ++c) w[c] = (l[0] * t[c] + l[1] * b[c]) + l[2] * n[c];
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

// render/bsdf.py emitted: the emission seen along d at a hit with its MIS
// weight w_emit, deposited at once; acc_out = acc_in + the sensor's deposit.
template <int SENSOR>
__device__ __forceinline__ void emit_lane(const SensorParams& sp, const MatRow& mr,
                                          const float* d, const float* n3, bool backside,
                                          const float* tp, float w_emit, const float* opl,
                                          float t, bool hit, const float* acc_in,
                                          float* acc_out) {
    const float vd[3] = {-d[0], -d[1], -d[2]};
    const float cos_view = dot3(n3, vd);
    const bool is_cone = mr.typ == LIGHT_SPOT || mr.typ == LIGHT_TOF;
    const bool is_emitter = mr.typ == LIGHT_DIFFUSE || is_cone || mr.typ == MODPHONG;
    const bool front_ok = !backside || (mr.flags & TWO_SIDED) > 0;
    const bool e_ok = is_emitter && front_ok && cos_view > 0.f &&
                      (cos_view >= mr.f[8] || !is_cone);
    float rad[4], dep[3];
    for (int c = 0; c < 4; ++c) rad[c] = (tp[c] * (e_ok ? mr.f[4 + c] : 0.f)) * w_emit;
    const bool take = sensor_deposit<SENSOR>(sp, rad, opl, t, hit, dep);
    for (int c = 0; c < 3; ++c) acc_out[c] = acc_in[c] + (take ? dep[c] : 0.f);
}

// ---- render/bsdf.py: the Lambertian, GGX and mirror lobes ---------------------

// core/onb.onb_from_normal: Duff et al.'s branch-free basis (t, b) around n
__device__ __forceinline__ void onb_from_normal(const float* n3, float* tt, float* bb) {
    const float sign = n3[2] >= 0.f ? 1.0f : -1.0f;
    const float a = (1.0f / (sign + n3[2])) * -1.0f;
    const float bvar = (n3[0] * n3[1]) * a;
    tt[0] = ((sign * n3[0]) * n3[0]) * a + 1.0f;
    tt[1] = sign * bvar;
    tt[2] = (-sign) * n3[0];
    bb[0] = bvar;
    bb[1] = sign + (n3[1] * n3[1]) * a;
    bb[2] = -n3[1];
}

// core/sampler.cosine_direction: concentric disk, lifted, in Duff et al.'s
// basis around n.
__device__ __forceinline__ void cosine_direction(const float* n3, float u0, float u1,
                                                 float* sdir) {
    // in_unit_disk (concentric map)
    const float ox = u0 * 2.0f - 1.0f, oy = u1 * 2.0f - 1.0f;
    const bool use_x = fabsf(ox) > fabsf(oy);
    const float safe_ox = fabsf(ox) > 0.f ? ox : 1.0f;
    const float safe_oy = fabsf(oy) > 0.f ? oy : 1.0f;
    const float theta = use_x ? (oy / safe_ox) * PI_4 : PI_2 - (ox / safe_oy) * PI_4;
    const float rr = (ox == 0.f && oy == 0.f) ? 0.f : (use_x ? ox : oy);
    const float lx = rr * cosf(theta), ly = rr * sinf(theta);
    const float lz = sqrtf(clamp_min((1.0f - lx * lx) - ly * ly, 1e-20f));
    float tt[3], bb[3];
    onb_from_normal(n3, tt, bb);
    for (int c = 0; c < 3; ++c) sdir[c] = (lx * tt[c] + ly * bb[c]) + lz * n3[c];
}

// _ggx_ndf: anisotropic GGX D (material_ggx.hpp:89-110)
__device__ __forceinline__ float ggx_ndf(const float* h, float ax, float ay) {
    const float hx = h[0] / ax, hy = h[1] / ay;
    const float denom = (hx * hx + hy * hy) + h[2] * h[2];
    return h[2] > 0.f ? 1.0f / clamp_min((((PI_F * ax) * ay) * denom) * denom, 1e-12f) : 0.f;
}

// _ggx_lambda: Smith's Lambda
__device__ __forceinline__ float ggx_lambda(const float* w, float ax, float ay) {
    const float wz = clamp_min(fabsf(w[2]), 1e-6f);
    const float a = ax * w[0], b = ay * w[1];
    return 0.5f * (sqrtf((a * a + b * b) / (wz * wz) + 1.0f) - 1.0f);
}

// _ggx_sample_vndf: Heitz 2018 VNDF sampling (material_ggx.hpp:138-171) of
// the microfacet normal m seen from wo (local, wo.z > 0)
__device__ __forceinline__ void ggx_sample_vndf(const float* wo, float ax, float ay, float u0,
                                                float u1, float* m) {
    const float v[3] = {ax * wo[0], ay * wo[1], wo[2]};
    float vh[3];
    normalize3(v, vh);
    const float lensq = vh[0] * vh[0] + vh[1] * vh[1];
    const float inv = 1.0f / sqrtf(clamp_min(lensq, 1e-20f));
    float t1[3] = {1.0f, 0.f, 0.f};
    if (lensq > 1e-12f) {
        t1[0] = -vh[1] * inv;
        t1[1] = vh[0] * inv;
        t1[2] = 0.f;
    }
    float t2[3];
    cross3(vh, t1, t2);
    const float r = sqrtf(clamp_min(u0, 1e-20f));
    const float phi = TWO_PI_F * u1;
    const float p1 = r * cosf(phi);
    float p2 = r * sinf(phi);
    const float s = 0.5f * (1.0f + vh[2]);
    p2 = (1.0f - s) * sqrtf(clamp_min(1.0f - p1 * p1, 1e-20f)) + s * p2;
    const float sq = sqrtf(clamp_min((1.0f - p1 * p1) - p2 * p2, 1e-20f));
    float nh[3];
    for (int c = 0; c < 3; ++c) nh[c] = (p1 * t1[c] + p2 * t2[c]) + sq * vh[c];
    const float w[3] = {ax * nh[0], ay * nh[1], clamp_min(nh[2], 1e-6f)};
    normalize3(w, m);
}

// _ggx_eval_local: f * cos [4] into fcos, returns the VNDF pdf; zero below
// the horizon. f0 is the material's albedo (Schlick's F0).
__device__ __forceinline__ float ggx_eval_local(const float* wo, const float* wd,
                                                const float* f0, float ax, float ay,
                                                float* fcos) {
    const bool up = wo[2] > 1e-6f && wd[2] > 1e-6f;
    const float hs[3] = {wo[0] + wd[0], wo[1] + wd[1], wo[2] + wd[2]};
    float h[3];
    normalize3(hs, h);
    const float d_term = ggx_ndf(h, ax, ay);
    const float lam_o = ggx_lambda(wo, ax, ay);
    const float g2 = 1.0f / ((1.0f + lam_o) + ggx_lambda(wd, ax, ay));
    const float g1 = 1.0f / (1.0f + lam_o);
    // fresnel_schlick: c^5 as c * ((c * c) * (c * c))
    const float cf = clamp(1.0f - clamp_min(dot3(wo, h), 1e-6f), 0.f, 1.f);
    const float c2 = cf * cf;
    const float c5 = cf * (c2 * c2);
    const float woz4 = 4.0f * clamp_min(wo[2], 1e-6f);
    const float spec = (d_term * g2) / woz4;
    for (int c = 0; c < 4; ++c) fcos[c] = up ? (f0[c] + (1.0f - f0[c]) * c5) * spec : 0.f;
    return up ? (g1 * d_term) / woz4 : 0.f;
}

// max over 3 channels, NaN-propagating like torch.amax
__device__ __forceinline__ float max3(const float* x) {
    float m = x[0];
    for (int c = 1; c < 3; ++c) m = (x[c] > m || x[c] != x[c]) ? x[c] : m;
    return m;
}

// _modphong_spec_prob: the specular lobe's share max(ks) / (max(kd) + max(ks))
__device__ __forceinline__ float modphong_spec_prob(const float* kd, const float* ks) {
    const float kd_max = max3(kd), ks_max = max3(ks);
    const float tot = kd_max + ks_max;
    return tot > 0.f ? ks_max / clamp_min(tot, 1e-12f) : 0.f;
}

// _modphong_eval: f * cos [4] into fcos and the mixture pdf of the
// energy-normalized modified Phong (material_modphong.hpp:192-263) from
// the incident ray direction d (so reflect(-wo, n) = reflect(d, n)) into
// wd; zero below the horizon. kd is the albedo, ks p1, shin p0.x; pow as
// PyTorch's of two float tensors (powf).
__device__ __forceinline__ float modphong_eval(const float* d, const float* wd, const float* n3,
                                               const float* kd, const float* ks, float shin,
                                               float* fcos) {
    const float cos_i = dot3(wd, n3);
    const bool up = cos_i > 1e-6f;
    float r[3];
    reflect3(d, n3, r);
    const float cos_a = clamp(dot3(r, wd), 0.f, 1.f);
    const float s = clamp_min(shin, 0.f);
    const float lobe = powf(cos_a, s);
    const float spec = ((s + 2.0f) * INV_TWO_PI) * lobe;
    const float ci = clamp_min(cos_i, 0.f);
    for (int c = 0; c < 4; ++c) fcos[c] = up ? (kd[c] * INV_PI + ks[c] * spec) * ci : 0.f;
    const float ps = modphong_spec_prob(kd, ks);
    return up ? (1.0f - ps) * (ci * INV_PI) + ps * (((s + 1.0f) * INV_TWO_PI) * lobe) : 0.f;
}

// _sample_power_cosine: a direction distributed as cos^exponent around axis
__device__ __forceinline__ void power_cosine_direction(const float* axis, float exponent,
                                                       float u0, float u1, float* w) {
    const float ct = powf(clamp_min(u0, 1e-12f), 1.0f / (exponent + 1.0f));
    const float st = sqrtf(clamp_min(1.0f - ct * ct, 1e-20f));
    const float phi = TWO_PI_F * u1;
    const float l[3] = {st * cosf(phi), st * sinf(phi), ct};
    float tt[3], bb[3];
    onb_from_normal(axis, tt, bb);
    for (int c = 0; c < 3; ++c) w[c] = (l[0] * tt[c] + l[1] * bb[c]) + l[2] * axis[c];
}

// render/bsdf.py bsdf_sample's ModPhong (material_modphong.hpp:192-263,
// constant ks and opacity): opacity pass-through by u_lobe (refraction with
// the material's index, the transmissive colour p2, the ray's new IOR; total
// internal reflection absorbs), an opaque backside absorbs, else the
// specular (power-cosine about the mirror direction) or diffuse (cosine)
// lobe by u_chan with the mixture's f * cos and pdf. Returns the kind; the
// outputs are written for the RANDOM and EXPLICIT kinds only (a NONE lane's
// sample is never read).
__device__ __forceinline__ int modphong_sample(const MatRow& mr, const float* d, const float* n3,
                                               bool back, float u0, float u1, float u_lobe,
                                               float u_chan, float* sdir, float* atten,
                                               float* pdf, float* ior_out) {
    const float* kd = mr.f;
    const float* ks = mr.f + 12;
    const float shin = mr.f[8], opacity = mr.f[9], mp_ior = mr.f[11];
    if (u_lobe > opacity) {
        // core/vecmath.refract(d, n, eta), eta = n_i / n_t a true division
        const float eta = (back ? mp_ior : 1.0f) / (back ? 1.0f : mp_ior);
        const float cos_i = -dot3(d, n3);
        const float sin2_t = (eta * eta) * clamp_min(1.0f - cos_i * cos_i, 0.f);
        if (sin2_t >= 1.0f) return KIND_NONE;
        const float cos_t = sqrtf(clamp_min(1.0f - sin2_t, 1e-20f));
        const float kn = eta * cos_i - cos_t;
        float refr[3];
        for (int c = 0; c < 3; ++c) refr[c] = eta * d[c] + kn * n3[c];
        normalize3(refr, sdir);
        const float nior = back ? 1.0f : mp_ior;
        for (int c = 0; c < 4; ++c) {
            atten[c] = mr.f[16 + c];
            ior_out[c] = nior;
        }
        *pdf = 1.0f;
        return KIND_EXPLICIT;
    }
    if (back) return KIND_NONE;
    if (u_chan < modphong_spec_prob(kd, ks)) {
        float axis[3];
        reflect3(d, n3, axis);
        power_cosine_direction(axis, shin, u0, u1, sdir);
    } else {
        cosine_direction(n3, u0, u1, sdir);
    }
    *pdf = modphong_eval(d, sdir, n3, kd, ks, shin, atten);
    return KIND_RANDOM;
}

// render/wavefront.py advance: the throughput update, Russian roulette
// (wurblpt.hpp:258-273) and the lane's next state, but its previous
// mixture pdf (the shade's own). `cont` lanes (RANDOM or EXPLICIT) carry
// on along sdir.
__device__ __forceinline__ void advance_lane(const WaveState& in, const WaveState& out, int i,
                                             long long k, bool act, bool hit, const float* p,
                                             const float* d, const float* tp, const float* sdir,
                                             const float* atten, float spdf, bool is_random,
                                             bool is_explicit, float u_rr, float geom,
                                             const float* opl, int max_depth, int rr_start,
                                             float rr_threshold) {
    float ratio[4], ntp[4];
    const float pdf_c = clamp_min(spdf, 1e-12f);
    for (int c = 0; c < 4; ++c) {
        ratio[c] = is_random ? atten[c] / pdf_c : atten[c];
        ntp[c] = tp[c] * ratio[c];
    }
    const bool cont = is_random || is_explicit;
    const float max_r = max4(ratio);
    const bool do_rr = k >= rr_start && max_r < rr_threshold && cont;
    const float q = clamp(1.0f - max_r, 0.f, 0.95f);
    const bool killed = do_rr && u_rr < q;
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
}

// The path lengths after the segment to the hit (wurblpt.hpp:148-150): the
// optical one per channel at the ray's IOR into opl; returns the geometric
// one. Both grow on hit lanes only.
__device__ __forceinline__ float path_lengths(const WaveState& in, int i, bool hit, float t,
                                              const float* ior, float* opl) {
    const float geom = hit ? in.geom_len[i] + t : in.geom_len[i];
    for (int c = 0; c < 4; ++c) {
        const float o_l = in.opt_len[4 * i + c];
        opl[c] = hit ? o_l + t * ior[c] : o_l;
    }
    return geom;
}

// The cast counters of one block: a closest cast per active lane and
// N_SHADOW shadow casts per RANDOM lane. Every thread of the block calls it.
template <int N_SHADOW>
__device__ __forceinline__ void count_casts(unsigned long long* stats, bool act, bool is_random) {
    const int n_act = __syncthreads_count(act);
    const int n_rand = N_SHADOW > 0 ? __syncthreads_count(is_random) : 0;
    if (threadIdx.x == 0 && n_act > 0) {
        atomicAdd(stats, static_cast<unsigned long long>(n_act));
        atomicAdd(stats + 1, static_cast<unsigned long long>(n_act + N_SHADOW * n_rand));
    }
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

// lights_sample for one lane: the hot spot picked by u3[0] through the alias
// table, a uniform point on it by u3[1] and u3[2]; the unit direction from p
// toward it and its distance, the triangle's normal (not normalized) and its
// length, the solid-angle pdf and the shadow ray's t_max, shortened by
// shadow_scale.
struct LightSample {
    int pick;
    float ldir[3], ldist, fn[3], fn_len, pdf_sa, t_vis;
};

__device__ __forceinline__ LightSample light_sample(const float* u3, const float* p,
                                                    const float* light_tri,
                                                    const float* alias_prob,
                                                    const int* alias_idx, int n_lights,
                                                    float shadow_scale, float min_hit) {
    LightSample ls;
    const int cell = min(max(static_cast<int>(u3[0] * static_cast<float>(n_lights)), 0),
                         n_lights - 1);
    const float frac = u3[0] * static_cast<float>(n_lights) - static_cast<float>(cell);
    ls.pick = frac >= alias_prob[cell] ? alias_idx[cell] : cell;
    const float* lt = light_tri + 9 * ls.pick;
    const float* e1 = lt + 3;
    const float* e2 = lt + 6;
    const float su = sqrtf(clamp_min(u3[1], 1e-20f));
    const float b0 = 1.0f - su, b1 = u3[2] * su;
    for (int c = 0; c < 3; ++c) ls.ldir[c] = ((lt[c] + b0 * e1[c]) + b1 * e2[c]) - p[c];
    ls.ldist = sqrtf(dot3(ls.ldir, ls.ldir));
    for (int c = 0; c < 3; ++c) ls.ldir[c] = ls.ldir[c] / clamp_min(ls.ldist, 1e-12f);
    cross3(e1, e2, ls.fn);
    ls.fn_len = sqrtf(dot3(ls.fn, ls.fn));
    const float area = ls.fn_len * 0.5f;
    const float cos_tri = fabsf(dot3(ls.ldir, ls.fn)) / clamp_min(ls.fn_len, 1e-20f);
    ls.pdf_sa = (ls.ldist * ls.ldist) / clamp_min(cos_tri * area, 1e-12f);
    ls.t_vis = clamp_min(ls.ldist * shadow_scale, min_hit);
    return ls;
}

// light_emitted_at's test: whether the picked light (its material row lr)
// emits toward the receiver, by its side and its cone.
__device__ __forceinline__ bool light_seen(const LightSample& ls, const MatRow& lr) {
    float nl[3];
    for (int c = 0; c < 3; ++c) nl[c] = ls.fn[c] / clamp_min(ls.fn_len, 1e-20f);
    const float tw[3] = {-ls.ldir[0], -ls.ldir[1], -ls.ldir[2]};
    const float cos_v = dot3(nl, tw);
    const bool l_cone = lr.typ == LIGHT_SPOT || lr.typ == LIGHT_TOF;
    const bool front = cos_v > 0.f || (lr.flags & TWO_SIDED) > 0;
    return front && (fabsf(cos_v) >= lr.f[8] || !l_cone);
}

// ---- the kernels -------------------------------------------------------------

// The camera's parameters (render/camera.py CameraParams): the pinhole's
// intrinsics and lens (CameraConfig.distortion, undistort_iters), the
// surround camera's span, stereo packing and eye offset, and the pose.
struct Camera {
    const float* centre;       // [2]
    const float* focal;        // [2]
    const float* translation;  // [3]
    const float* rotation;     // [4] quaternion x, y, z, w
    const float* dist_k;       // [6] radial coefficients
    const float* dist_p;       // [2] tangential coefficients
    int lens;                  // LENS_*
    int iters;                 // the OpenCV fixed point's steps
    const float* scale;        // [3] the pose's scale (the surround camera's eye offset)
    const float* eye_distance; // [1]
    float span;                // float32(pi) (S360) or float32(pi / 2) (S180)
    float inv_width;           // float32(1) / float32(width)
    float inv_eff_height;      // float32(1) / float32(the height of one eye's half)
    int stereo;                // top half the left eye, bottom half the right
};

constexpr int CAM_PINHOLE = 0, CAM_SURROUND = 1;

// render/camera.py distort_normalized for RADIAL_AND_PLANAR and OPENCV: the
// radial polynomial and the tangential terms, in the plain version's
// product order.
__device__ __forceinline__ void distort_tangential(const Camera& cam, float x, float y,
                                                   float* dx_out, float* dy_out) {
    const float k0 = cam.dist_k[0], k1 = cam.dist_k[1], k2 = cam.dist_k[2];
    const float p1 = cam.dist_p[0], p2 = cam.dist_p[1];
    const float r2 = x * x + y * y;
    const float radial = ((1.0f + k0 * r2) + (k1 * r2) * r2) + ((k2 * r2) * r2) * r2;
    const float dx = (((2.0f * p1) * x) * y) + p2 * (r2 + (2.0f * x) * x);
    const float dy = p1 * (r2 + (2.0f * y) * y) + ((2.0f * p2) * x) * y;
    *dx_out = x * radial + dx;
    *dy_out = y * radial + dy;
}

// render/camera.py undistort_normalized: the normalized image point (x, y)
// through the inverse of the lens model, in place.
__device__ __forceinline__ void undistort(const Camera& cam, float* x, float* y) {
    const float* k = cam.dist_k;
    if (cam.lens == LENS_RADIAL_AND_PLANAR) {
        // the closed-form first-order inverse (optics.hpp:251-268)
        const float p1 = cam.dist_p[0], p2 = cam.dist_p[1];
        const float xv = *x, yv = *y;
        const float r2 = xv * xv + yv * yv;
        const float r4 = r2 * r2;
        const float d1 = k[0] * r2 + k[1] * r4;
        const float d2 = 1.0f / (((((4.0f * k[0]) * r2 + (6.0f * k[1]) * r4) + (8.0f * p1) * yv)
                                  + (8.0f * p2) * xv) + 1.0f);
        *x = xv - d2 * ((d1 * xv + ((2.0f * p1) * xv) * yv) + p2 * (r2 + (2.0f * xv) * xv));
        *y = yv - d2 * ((d1 * yv + p1 * (r2 + (2.0f * yv) * yv)) + ((2.0f * p2) * xv) * yv);
    } else if (cam.lens == LENS_RADIAL_ONLY) {
        // the Drap-Lefevre inverse series to 4 terms (optics.hpp:269-278),
        // powers in the product order of JAX's integer_pow: k^3 = k (k k)
        const float k1 = k[0], k2 = k[1], k3 = k[2];
        const float k1k1 = k1 * k1;
        const float b1 = -k1;
        const float b2 = 3.0f * k1k1 - k2;
        const float b3 = (-12.0f * (k1 * k1k1) + (8.0f * k1) * k2) - k3;
        const float b4 = ((55.0f * (k1k1 * k1k1) - ((55.0f * k1) * k1) * k2) + (5.0f * k2) * k2)
                         + (10.0f * k1) * k3;
        const float r2 = *x * *x + *y * *y;
        const float r4 = r2 * r2;
        const float radial = (((1.0f + b1 * r2) + b2 * r4) + b3 * (r2 * r4)) + b4 * (r4 * r4);
        *x = *x * radial;
        *y = *y * radial;
    } else if (cam.lens == LENS_OPENCV) {
        // the fixed point und <- xy - (distort(und) - und) from und = xy
        const float xv = *x, yv = *y;
        float ux = xv, uy = yv;
        for (int it = 0; it < cam.iters; ++it) {
            float dx, dy;
            distort_tangential(cam, ux, uy, &dx, &dy);
            ux = xv - (dx - ux);
            uy = yv - (dy - uy);
        }
        *x = ux;
        *y = uy;
    }
}

// render/camera.py camera_rays' surround branch for the pixel point (px, py):
// the equirect direction of the eye's half of the image and, in stereo, the
// eye's offset on the circle of diameter eye_distance (ODS), posed.
__device__ __forceinline__ void surround_ray(const Camera& cam, int height, float px, float py,
                                             float* o, float* dw) {
    const int eff_height = cam.stereo ? height / 2 : height;
    float eye_sign = 0.f;
    if (cam.stereo) {
        const bool top = py < static_cast<float>(eff_height);
        py = top ? py : py - static_cast<float>(eff_height);
        eye_sign = top ? -1.0f : 1.0f;
    }
    const float phi = ((px * cam.inv_width) * 2.0f - 1.0f) * cam.span;
    const float theta = (0.5f - py * cam.inv_eff_height) * PI_F;
    const float ct = cosf(theta);
    const float sp = sinf(phi), cp = cosf(phi);
    float dc[3] = {ct * sp, sinf(theta), (-ct) * cp};
    const float r = 1.0f / sqrtf(clamp_min(dot3(dc, dc), 1e-20f));
    for (int k = 0; k < 3; ++k) dc[k] = dc[k] * r;
    quat_rotate(cam.rotation, dc, dw);
    const float es = (eye_sign * 0.5f) * cam.eye_distance[0];
    const float oc[3] = {(es * cp) * cam.scale[0], (es * 0.f) * cam.scale[1],
                         (es * sp) * cam.scale[2]};
    float orot[3];
    quat_rotate(cam.rotation, oc, orot);
    for (int k = 0; k < 3; ++k) o[k] = orot[k] + cam.translation[k];
}

template <int CAMERA>
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
    // Pixel jitter and the ray (render/camera.py camera_rays): the mono
    // pinhole through its lens, or the surround camera.
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
    float dw[3];
    if (CAMERA == CAM_SURROUND) {
        float o[3];
        surround_ray(cam, height, px, py, o, dw);
        for (int k = 0; k < 3; ++k) out.o[3 * i + k] = o[k];
    } else {
        float nx = (px - cam.centre[0]) / cam.focal[0];
        float ny = (py - cam.centre[1]) / cam.focal[1];
        undistort(cam, &nx, &ny);
        float dc[3] = {nx, -ny, -1.0f};
        const float r = 1.0f / sqrtf(clamp_min(dot3(dc, dc), 1e-20f));
        for (int k = 0; k < 3; ++k) dc[k] = dc[k] * r;
        quat_rotate(cam.rotation, dc, dw);
        // A mono pinhole's origin is the camera's: the rotated eye offset (+0
        // in every component for a positive scale) plus the translation, so
        // a -0 of the translation becomes +0 as in the plain version's sum.
        for (int k = 0; k < 3; ++k) out.o[3 * i + k] = 0.f + cam.translation[k];
    }
    for (int k = 0; k < 3; ++k) out.d[3 * i + k] = dw[k];
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
        // The hit record, the material and the emission's MIS inputs feed only
        // hit lanes; the position also the shadow ray of every lane.
        act = in.active[i];
        const long long k = in.bounce[i];
        const int prim = act ? prim_hit[i] : -1;
        const bool hit = prim >= 0;
        const float t = hit ? t_hit[i] : 0.f;
        float d[3], n3[3] = {0.f, 0.f, 0.f}, p[3], tp[4], ior[4] = {0.f, 0.f, 0.f, 0.f};
        for (int c = 0; c < 3; ++c) {
            d[c] = in.d[3 * i + c];
            p[c] = pos[3 * i + c];
        }
        for (int c = 0; c < 4; ++c) tp[c] = in.throughput[4 * i + c];
        if (hit) {
            for (int c = 0; c < 3; ++c) n3[c] = nrm[3 * i + c];
            for (int c = 0; c < 4; ++c) ior[c] = in.ior[4 * i + c];
        }
        const MatRow mr = mat_row(mat, n_mat, hit ? mat_hit[i] : 0);

        // 1. path lengths
        float opl[4];
        const float geom = path_lengths(in, i, hit, t, ior, opl);

        // 2. emission with its MIS weight, deposited at once
        const bool prev_random = hit && in.prev_random[i];
        const float prev_pdf = prev_random ? in.prev_pdf[i] : 0.f;
        float w_emit = 1.0f;
        if (PER_LIGHT) {
            // lights_pdf_at_hit: pick x t^2 / (|cos| area) of the prim hit
            if (prev_random) {
                const float* row = pick_area + 2 * min(prim, n_pick - 1);
                const float g[3] = {gnrm[3 * i], gnrm[3 * i + 1], gnrm[3 * i + 2]};
                const float cg = fabsf(dot3(d, g));
                const float lp_hit = row[0] * (((t * t) * row[1]) / clamp_min(cg, 1e-12f));
                w_emit = power_heuristic(prev_pdf, lp_hit);
            }
        } else if (prev_random) {
            w_emit = power_heuristic(prev_pdf, in.prev_light_pdf[i]);
        }
        emit_lane<SENSOR>(sp, mr, d, n3, hit && backside[i], tp, w_emit, opl, t, hit,
                          in.acc + 3 * i, out.acc + 3 * i);

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
        if (hit && lamb) {
            cosine_direction(n3, u4[0], u4[1], sdir);
            spdf = clamp_min(dot3(sdir, n3), 0.f) * INV_PI;
            for (int c = 0; c < 4; ++c) atten[c] = mr.f[c] * spdf;
        }
        is_random = hit && lamb && spdf > 0.f;

        // 4. light NEE up to the shadow ray (render/lights.py lights_sample)
        const LightSample ls = light_sample(u3, p, light_tri, alias_prob, alias_idx, n_lights,
                                            shadow_scale, min_hit);
        for (int c = 0; c < 3; ++c) shadow_d[3 * i + c] = ls.ldir[c];
        shadow_tmax[i] = is_random ? ls.t_vis : 0.f;
        float light_pdf_next = 0.f;
        bool nee_take = false;
        float ndep[3] = {0.f, 0.f, 0.f};
        if (is_random) {
            float pdf_light;
            if (PER_LIGHT) {
                pdf_light = light_w[ls.pick] * ls.pdf_sa;
            } else {
                pdf_light = mixture_pdf(p, ls.ldir, light_tri, light_w, n_lights);
                light_pdf_next = mixture_pdf(p, sdir, light_tri, light_w, n_lights);
            }
            // bsdf_eval (Lambertian) toward the light
            const float pb = clamp_min(dot3(ls.ldir, n3), 0.f) * INV_PI;
            const MatRow lr = mat_row(mat, n_mat, light_mat[ls.pick]);
            const bool le_ok = light_seen(ls, lr);
            const float w_nee = power_heuristic(pdf_light, pb);
            const float scale = w_nee / clamp_min(pdf_light, 1e-12f);
            float contrib[4], nopl[4];
            for (int c = 0; c < 4; ++c) {
                contrib[c] = ((tp[c] * (mr.f[c] * pb)) * (le_ok ? lr.f[4 + c] : 0.f)) * scale;
                nopl[c] = opl[c] + ls.ldist * ior[c];
            }
            nee_take = sensor_deposit<SENSOR>(sp, contrib, nopl, ls.ldist, pdf_light > 1e-12f,
                                              ndep);
        }
        for (int c = 0; c < 3; ++c) pending[3 * i + c] = nee_take ? ndep[c] : 0.f;

        // 5. throughput update, Russian roulette, the next state (wurblpt.hpp:258-273)
        advance_lane(in, out, i, k, act, hit, p, d, tp, sdir, atten, spdf, is_random, false,
                     ua[2], geom, opl, max_depth, rr_start, rr_threshold);
        out.prev_light_pdf[i] = is_random ? light_pdf_next : 0.f;
    }
    count_casts<1>(stats, act, is_random);   // one shadow ray per RANDOM lane
}

// The sky of the env class (render/envmap.py EnvMapArrays): an equirect
// image or six cube faces with their importance tables (none: res = 0), or
// a constant radiance.
struct EnvMap {
    const float4* img;         // equirect [h, w] or cube [6, h, w] texels, 4 channels
    int h, w;
    const float4* const_rad;   // the constant sky's radiance
    const float* pdf;          // [res, res] solid-angle pdf per cell
    const float* alias_prob;   // [res * res]
    const int* alias_idx;      // [res * res]
    int res;
    const float* rot;          // [4] quaternion world-from-map
};

// render/envmap.py env_radiance_plain, by the sky's kind.
template <int SKY>
__device__ __forceinline__ float4 sky_radiance(const EnvMap& env, float3 d) {
    if (SKY == SKY_CONSTANT) return __ldg(env.const_rad);
    const float3 dm = wpt_env::to_map(env.rot, d);
    return SKY == SKY_CUBE ? wpt_env::cube_lookup(env.img, env.h, env.w, dm)
                           : wpt_env::equirect_lookup(env.img, env.h, env.w, dm);
}

// render/bsdf.py bsdf_sample's glass (material_glass.hpp:97-141) with
// core/fresnel.py fresnel_unpolarized and core/vecmath.py refract: the
// dispersion channel picked by u_chan (a dispersive material refracts that
// channel only, weighted x4), the Fresnel pick by u_lobe or total internal
// reflection, Beer-Lambert absorption exp(-absorption t) on a backside hit,
// and the continued ray's per-channel IOR: the ray's own on a reflection,
// the material's on entering, 1 on leaving.
__device__ __forceinline__ void glass_lobe(const MatRow& mr, const float* d, const float* n3,
                                           bool back, float t, const float* ray_ior,
                                           float u_lobe, float u_chan, float* sdir,
                                           float* atten, float* ior_out) {
    const float* mior = mr.f + 8;     // p0: per-channel IOR
    const float* absorb = mr.f + 12;  // p1: per-channel absorption
    const bool disp = fabsf(mior[0] - mior[1]) > 1e-6f || fabsf(mior[1] - mior[2]) > 1e-6f ||
                      fabsf(mior[2] - mior[3]) > 1e-6f;
    const int chan = min(max(static_cast<int>(u_chan * 4.0f), 0), 3);
    const float n_mat = disp ? mior[chan] : mior[0];
    const float n_i = back ? n_mat : 1.0f;
    const float n_t = back ? 1.0f : n_mat;
    // fresnel_unpolarized(clamp(dot(wo, n), 0, 1), n_i, n_t)
    const float wo[3] = {-d[0], -d[1], -d[2]};
    const float cos_f = clamp(clamp(dot3(wo, n3), 0.f, 1.f), 0.f, 1.f);
    const float eta_f = n_i / n_t;
    const float sin2_f = (eta_f * eta_f) * (1.0f - cos_f * cos_f);
    const float cos_tf = sqrtf(clamp_min(1.0f - sin2_f, 1e-20f));
    const float r_s = (n_i * cos_f - n_t * cos_tf) / clamp_min(n_i * cos_f + n_t * cos_tf, 1e-12f);
    const float r_p = (n_i * cos_tf - n_t * cos_f) / clamp_min(n_i * cos_tf + n_t * cos_f, 1e-12f);
    const float fres = sin2_f >= 1.0f ? 1.0f : 0.5f * (r_s * r_s + r_p * r_p);
    // refract(d, n, n_i / max(n_t, 1e-6)); reflect on TIR or the Fresnel pick
    const float eta = n_i / clamp_min(n_t, 1e-6f);
    const float cos_i = -dot3(d, n3);
    const float sin2_t = (eta * eta) * clamp_min(1.0f - cos_i * cos_i, 0.f);
    const bool tir = sin2_t >= 1.0f;
    const bool keep = u_lobe < fres || tir;
    if (keep) {
        reflect3(d, n3, sdir);
    } else {
        const float cos_t = sqrtf(clamp_min(1.0f - sin2_t, 1e-20f));
        const float kn = eta * cos_i - cos_t;
        float refr[3];
        for (int c = 0; c < 3; ++c) refr[c] = eta * d[c] + kn * n3[c];
        normalize3(refr, sdir);
    }
    for (int c = 0; c < 4; ++c) {
        const float a_g = disp ? (c == chan ? 4.0f : 0.f) : 1.0f;
        atten[c] = a_g * (back ? expf(-absorb[c] * t) : 1.0f);
        ior_out[c] = keep ? ray_ior[c] : (back ? 1.0f : mior[c]);
    }
}

// ---- what the env and lit shades share ----------------------------------------

// wavefront.env_miss: the sky seen by an escaped lane, MIS-weighted against
// env NEE when the sky is importance-sampled (IS) and the previous bounce
// was a RANDOM sample; the sensor's deposit added to a.
template <int SENSOR, int SKY, bool IS>
__device__ __forceinline__ void miss_lane(const WaveState& in, int i, bool escaped,
                                          const EnvMap& env, const SensorParams& sp,
                                          const float* d, const float* tp, float* a) {
    float dep[3];
    bool take = false;
    if (escaped) {
        const float3 dv = make_float3(d[0], d[1], d[2]);
        const float4 L = sky_radiance<SKY>(env, dv);
        const float Lc[4] = {L.x, L.y, L.z, L.w};
        float w_env = 1.0f;
        if (IS && in.prev_random[i]) {
            w_env = power_heuristic(in.prev_pdf[i], wpt_env::pdf(dv, env.pdf, env.res, env.rot));
        }
        float rad[4], opl0[4];
        for (int c = 0; c < 4; ++c) {
            rad[c] = (tp[c] * Lc[c]) * w_env;
            opl0[c] = in.opt_len[4 * i + c];
        }
        take = sensor_deposit<SENSOR>(sp, rad, opl0, 0.f, true, dep);
    }
    for (int c = 0; c < 3; ++c) a[c] = a[c] + (take ? dep[c] : 0.f);
}

// render/bsdf.py bsdf_sample of a hit lane's own lobe: Lambertian's cosine
// sample, GGX's VNDF sample, the mirror, and where the flags allow them
// the glass (glass_lobe, the continued ray's IOR in new_ior), ModPhong
// (modphong_sample, its pass-through's IOR in new_ior) and RGL
// (materials/rgl.py rgl_sample_lanes through rgl_common.cuh: the sample in
// the tangent frame, its direction back in the world). GGX and RGL lanes
// set the hit's tangent frame (tb_t, tb_b) from its tangent tg, GGX lanes
// their roughness (ax, ay): random_bsdf_eval reads them. Writes sdir,
// atten and spdf and returns the kind; a NONE lane's keep what they held.
template <bool HAS_GLASS, bool HAS_MODPHONG, bool HAS_RGL>
__device__ __forceinline__ int sample_lobe(const MatRow& mr, const RglTables& rgl,
                                           const float* tg, const float* d, const float* n3,
                                           bool back, float t, const float* ior,
                                           const float* u4, const float* ua, float* sdir,
                                           float* atten, float* spdf, float* new_ior,
                                           float* ax, float* ay, float* tb_t, float* tb_b) {
    int kind = KIND_NONE;
    if (mr.typ == LAMBERTIAN) {
        cosine_direction(n3, u4[0], u4[1], sdir);
        *spdf = clamp_min(dot3(sdir, n3), 0.f) * INV_PI;
        for (int c = 0; c < 4; ++c) atten[c] = mr.f[c] * *spdf;
        kind = KIND_RANDOM;
    } else if (mr.typ == GGX) {
        *ax = clamp_min(mr.f[8], 1e-4f);
        *ay = clamp_min(mr.f[9], 1e-4f);
        const float tgl[3] = {tg[0], tg[1], tg[2]};
        onb_from_tangent(n3, tgl, tb_t, tb_b);
        const float wo[3] = {-d[0], -d[1], -d[2]};
        float wl[3];
        to_local(wo, tb_t, tb_b, n3, wl);
        wl[2] = clamp_min(wl[2], 1e-4f);
        float m[3];
        ggx_sample_vndf(wl, *ax, *ay, u4[0], u4[1], m);
        const float nwl[3] = {-wl[0], -wl[1], -wl[2]};
        float wdl[3];
        reflect3(nwl, m, wdl);
        *spdf = ggx_eval_local(wl, wdl, mr.f, *ax, *ay, atten);
        to_world(wdl, tb_t, tb_b, n3, sdir);
        kind = KIND_RANDOM;
    } else if (mr.typ == MIRROR) {
        reflect3(d, n3, sdir);
        for (int c = 0; c < 4; ++c) atten[c] = mr.f[c];
        *spdf = 1.0f;
        kind = KIND_EXPLICIT;
    } else if (HAS_GLASS && mr.typ == GLASS) {
        glass_lobe(mr, d, n3, back, t, ior, ua[0], ua[1], sdir, atten, new_ior);
        *spdf = 1.0f;
        kind = KIND_EXPLICIT;
    } else if (HAS_MODPHONG && mr.typ == MODPHONG) {
        kind = modphong_sample(mr, d, n3, back, u4[0], u4[1], ua[0], ua[1], sdir, atten, spdf,
                               new_ior);
    } else if (HAS_RGL && mr.typ == RGL) {
        const float tgl[3] = {tg[0], tg[1], tg[2]};
        onb_from_tangent(n3, tgl, tb_t, tb_b);
        const float wo[3] = {-d[0], -d[1], -d[2]};
        float wl[3];
        to_local(wo, tb_t, tb_b, n3, wl);
        const int mid = min(max(__float_as_int(mr.f[22]), 0), rgl.M - 1);
        wpt_rgl::Vec3 wsl;
        float f[4], pr;
        const bool ok = wpt_rgl::sample_lane(rgl, mid, {wl[0], wl[1], wl[2]}, u4[0], u4[1], &wsl,
                                             f, &pr);
        if (ok && !back) {
            const float sl[3] = {wsl.x, wsl.y, wsl.z};
            float w[3];
            to_world(sl, tb_t, tb_b, n3, w);
            normalize3(w, sdir);
            for (int c = 0; c < 4; ++c) atten[c] = f[c];
            *spdf = pr;
            kind = KIND_RANDOM;
        }
    }
    return kind;
}

// render/bsdf.py bsdf_eval toward wd on a RANDOM lane (the lane's lobe is
// Lambertian, GGX, or where the flags allow them ModPhong or RGL): f * cos
// [4] into f, returns the pdf. GGX and RGL read the lane's tangent frame
// (tb_t, tb_b), GGX its roughness; RGL is evaluated inline through
// rgl_common.cuh, zero toward a direction below the surface or from its
// backside (materials/rgl.py rgl_eval_lanes).
template <bool HAS_MODPHONG, bool HAS_RGL>
__device__ __forceinline__ float random_bsdf_eval(const MatRow& mr, const RglTables& rgl,
                                                  const float* d, const float* n3,
                                                  const float* tb_t, const float* tb_b,
                                                  float ax, float ay, bool back, const float* wd,
                                                  float* f) {
    float pdf;
    if (mr.typ == GGX) {
        const float wo[3] = {-d[0], -d[1], -d[2]};
        float wl[3], wdl[3];
        to_local(wo, tb_t, tb_b, n3, wl);
        to_local(wd, tb_t, tb_b, n3, wdl);
        pdf = ggx_eval_local(wl, wdl, mr.f, ax, ay, f);
    } else if (HAS_MODPHONG && mr.typ == MODPHONG) {
        pdf = modphong_eval(d, wd, n3, mr.f, mr.f + 12, mr.f[8], f);
    } else if (HAS_RGL && mr.typ == RGL) {
        const float wo[3] = {-d[0], -d[1], -d[2]};
        float wl[3], wdl[3];
        to_local(wo, tb_t, tb_b, n3, wl);
        to_local(wd, tb_t, tb_b, n3, wdl);
        const int mid = min(max(__float_as_int(mr.f[22]), 0), rgl.M - 1);
        const float p = wpt_rgl::eval_lane(rgl, mid, {wl[0], wl[1], wl[2]},
                                           {wdl[0], wdl[1], wdl[2]}, f);
        const bool ok = !back && dot3(wd, n3) > 0.f;
        for (int c = 0; c < 4; ++c) f[c] = ok ? f[c] : 0.f;
        pdf = ok ? p : 0.f;
    } else {   // Lambertian
        pdf = clamp_min(dot3(wd, n3), 0.f) * INV_PI;
        for (int c = 0; c < 4; ++c) f[c] = mr.f[c] * pdf;
    }
    return pdf;
}

// wavefront.env_nee up to its shadow ray: a sky sample on every lane, its
// direction and t_max (BIG on RANDOM lanes, else 0) in row j of shadow_d
// and shadow_tmax; on RANDOM lanes the bsdf toward it, the power-heuristic
// weight and the sky's radiance make the pending deposit in row j.
template <int SENSOR, int SKY, bool HAS_MODPHONG, bool HAS_RGL>
__device__ __forceinline__ void env_nee_lane(const EnvMap& env, const SensorParams& sp,
                                             const RglTables& rgl, long long px_id,
                                             long long smp, long long k, bool is_random,
                                             const MatRow& mr, const float* d, const float* n3,
                                             const float* tb_t, const float* tb_b, float ax,
                                             float ay, bool back, const float* tp,
                                             const float* opl, int j, float* shadow_d,
                                             float* shadow_tmax, float* pending) {
    float ue[4];
    uniform4(px_id, smp, k, SALT_ENVMAP_SAMPLE, ue);
    float3 edir;
    const float epdf = wpt_env::sample(ue[0], ue[1], ue[2], env.pdf, env.alias_prob,
                                       env.alias_idx, env.res, env.rot, &edir);
    const float ed[3] = {edir.x, edir.y, edir.z};
    for (int c = 0; c < 3; ++c) shadow_d[3 * j + c] = ed[c];
    shadow_tmax[j] = is_random ? BIG : 0.f;
    bool nee_take = false;
    float ndep[3] = {0.f, 0.f, 0.f};
    if (is_random) {
        float fe[4];
        const float pb = random_bsdf_eval<HAS_MODPHONG, HAS_RGL>(mr, rgl, d, n3, tb_t, tb_b, ax,
                                                                 ay, back, ed, fe);
        const float w_e = power_heuristic(epdf, pb);
        const float scale = w_e / clamp_min(epdf, 1e-12f);
        const float4 L = sky_radiance<SKY>(env, edir);
        const float Lc[4] = {L.x, L.y, L.z, L.w};
        float contrib[4];
        for (int c = 0; c < 4; ++c) contrib[c] = ((tp[c] * fe[c]) * Lc[c]) * scale;
        nee_take = sensor_deposit<SENSOR>(sp, contrib, opl, 0.f, epdf > 1e-12f, ndep);
    }
    for (int c = 0; c < 3; ++c) pending[3 * j + c] = nee_take ? ndep[c] : 0.f;
}

// ---- the env class: a sky and no light ------------------------------------------

// SKY: the sky's kind; IS: the sky has importance tables (MIS on a miss,
// env NEE and its shadow ray); HAS_GLASS: the scene has glass (the lobe,
// and a new ray IOR written on every lane).
template <int SENSOR, int SKY, bool IS, bool HAS_GLASS>
__global__ void __launch_bounds__(BLOCK)
shade_env_kernel(WaveState in, WaveState out, unsigned long long* __restrict__ stats, int n,
                 const long long* __restrict__ pixel, const float* __restrict__ t_hit,
                 const int* __restrict__ prim_hit, const float* __restrict__ pos,
                 const float* __restrict__ nrm, const float* __restrict__ tng,
                 const bool* __restrict__ backside, const int* __restrict__ mat_hit,
                 const float* __restrict__ mat, int n_mat, EnvMap env, SensorParams sp,
                 int max_depth, int rr_start, float rr_threshold, float* __restrict__ shadow_d,
                 float* __restrict__ shadow_tmax, float* __restrict__ pending) {
    const int i = blockIdx.x * blockDim.x + threadIdx.x;
    bool act = false, is_random = false;
    if (i < n) {
        // The hit record and the material feed only hit lanes; the previous
        // bsdf sample's flag and pdf only escaped ones (with importance
        // tables); the ray IOR hit lanes, and every lane with glass (it is
        // written back).
        act = in.active[i];
        const long long k = in.bounce[i];
        const int prim = act ? prim_hit[i] : -1;
        const bool hit = prim >= 0;
        const float t = hit ? t_hit[i] : 0.f;
        float d[3], n3[3] = {0.f, 0.f, 0.f}, p[3] = {0.f, 0.f, 0.f}, tp[4],
              ior[4] = {0.f, 0.f, 0.f, 0.f}, a[3];
        for (int c = 0; c < 3; ++c) {
            d[c] = in.d[3 * i + c];
            a[c] = in.acc[3 * i + c];
        }
        for (int c = 0; c < 4; ++c) tp[c] = in.throughput[4 * i + c];
        if (hit) {
            for (int c = 0; c < 3; ++c) {
                n3[c] = nrm[3 * i + c];
                p[c] = pos[3 * i + c];
            }
        }
        if (HAS_GLASS || hit) {
            for (int c = 0; c < 4; ++c) ior[c] = in.ior[4 * i + c];
        }
        const bool back = hit && backside[i];
        const MatRow mr = mat_row(mat, n_mat, hit ? mat_hit[i] : 0);
        const RglTables no_rgl{};

        // 1. the sky on a miss
        miss_lane<SENSOR, SKY, IS>(in, i, act && prim < 0, env, sp, d, tp, a);

        // 2. path lengths
        float opl[4];
        const float geom = path_lengths(in, i, hit, t, ior, opl);

        // 3. emission (no light, so its MIS weight is 1)
        emit_lane<SENSOR>(sp, mr, d, n3, back, tp, 1.0f, opl, t, hit, a, out.acc + 3 * i);

        // 4. the bsdf sample of the lane's own lobe
        const long long px_id = pixel[i], smp = in.sample[i];
        float u4[4], ua[4];
        uniform4(px_id, smp, k, SALT_BSDF, u4);
        uniform4(px_id, smp, k, SALT_BSDF_AUX, ua);
        float sdir[3] = {n3[0], n3[1], n3[2]};
        float atten[4] = {0.f, 0.f, 0.f, 0.f};
        float new_ior[4] = {ior[0], ior[1], ior[2], ior[3]};
        float spdf = 0.f, ax = 0.f, ay = 0.f, tb_t[3], tb_b[3];
        int kind = KIND_NONE;
        if (hit) {
            kind = sample_lobe<HAS_GLASS, false, false>(mr, no_rgl, tng + 3 * i, d, n3, back, t,
                                                        ior, u4, ua, sdir, atten, &spdf, new_ior,
                                                        &ax, &ay, tb_t, tb_b);
        }
        is_random = hit && kind == KIND_RANDOM && spdf > 0.f;
        const bool is_explicit = hit && kind == KIND_EXPLICIT;

        // 5. env NEE up to the shadow ray, with importance tables only
        //    (RANDOM lanes are Lambertian or GGX)
        if (IS) {
            env_nee_lane<SENSOR, SKY, false, false>(env, sp, no_rgl, px_id, smp, k, is_random, mr,
                                                    d, n3, tb_t, tb_b, ax, ay, back, tp, opl, i,
                                                    shadow_d, shadow_tmax, pending);
        }

        // 6. throughput update, Russian roulette, the next state; the previous
        //    mixture pdf passes through (no light); the glass's ray IOR
        advance_lane(in, out, i, k, act, hit, p, d, tp, sdir, atten, spdf, is_random,
                     is_explicit, ua[2], geom, opl, max_depth, rr_start, rr_threshold);
        if (HAS_GLASS) {
            const bool cont = is_random || is_explicit;
            for (int c = 0; c < 4; ++c) out.ior[4 * i + c] = cont ? new_ior[c] : ior[c];
        }
    }
    count_casts<IS ? 1 : 0>(stats, act, is_random);   // env shadow rays with importance only
}

// ---- the lit class: triangle lights under per-light MIS beside a sky ---------

// Triangle lights with the power-weighted pick (alias table) and per-light
// MIS (render/lights.py; StepTables' light rows).
struct Lights {
    const float* pick_area;   // [P, 2] (pick probability, 1 / area) per prim
    int n_pick;
    const float* tri;         // [L, 9] p0 | e1 | e2 of each hot spot, in pick order
    const int* mat;           // [L] material of each hot spot
    const float* w;           // [L] pick probability
    const float* alias_prob;  // [L]
    const int* alias_idx;     // [L]
    int n;
};

// One bounce of the lit class: the sky on a miss (MIS-weighted against env
// NEE), emission with its per-light MIS weight, the sample of the lane's
// lobe (Lambertian, GGX, mirror, glass, ModPhong, RGL inline), light NEE
// toward a picked hot spot and env NEE toward a sky sample, each up to its
// shadow ray and pending deposit, Russian roulette, the next state (the ray
// IOR of glass and ModPhong's pass-through) and the cast counters. SKY: the
// sky's kind (equirect or cube, with importance tables); HAS_RGL: the scene
// has RGL materials (their tables in rgl). Lane i's light shadow ray is row
// i of shadow_o / shadow_d / shadow_tmax and of pending, its env shadow ray
// row n + i; both start at the hit position.
template <int SENSOR, int SKY, bool HAS_RGL>
__global__ void __launch_bounds__(BLOCK)
shade_lit_kernel(WaveState in, WaveState out, unsigned long long* __restrict__ stats, int n,
                 const long long* __restrict__ pixel, const float* __restrict__ t_hit,
                 const int* __restrict__ prim_hit, const float* __restrict__ pos,
                 const float* __restrict__ nrm, const float* __restrict__ gnrm,
                 const float* __restrict__ tng, const bool* __restrict__ backside,
                 const int* __restrict__ mat_hit, const float* __restrict__ mat, int n_mat,
                 Lights lights, EnvMap env, RglTables rgl, SensorParams sp, int max_depth,
                 int rr_start, float rr_threshold, float shadow_scale, float min_hit,
                 float* __restrict__ shadow_o, float* __restrict__ shadow_d,
                 float* __restrict__ shadow_tmax, float* __restrict__ pending) {
    const int i = blockIdx.x * blockDim.x + threadIdx.x;
    bool act = false, is_random = false;
    if (i < n) {
        // The normal and the material feed only hit lanes; the position every
        // lane's shadow rays; the ray IOR every lane (it is written back).
        act = in.active[i];
        const long long k = in.bounce[i];
        const int prim = act ? prim_hit[i] : -1;
        const bool hit = prim >= 0;
        const float t = hit ? t_hit[i] : 0.f;
        float d[3], n3[3] = {0.f, 0.f, 0.f}, p[3], tp[4], ior[4], a[3];
        for (int c = 0; c < 3; ++c) {
            d[c] = in.d[3 * i + c];
            p[c] = pos[3 * i + c];
            a[c] = in.acc[3 * i + c];
        }
        for (int c = 0; c < 4; ++c) {
            tp[c] = in.throughput[4 * i + c];
            ior[c] = in.ior[4 * i + c];
        }
        if (hit) {
            for (int c = 0; c < 3; ++c) n3[c] = nrm[3 * i + c];
        }
        const bool back = hit && backside[i];
        const MatRow mr = mat_row(mat, n_mat, hit ? mat_hit[i] : 0);

        // 1. the sky on a miss
        miss_lane<SENSOR, SKY, true>(in, i, act && prim < 0, env, sp, d, tp, a);

        // 2. path lengths
        float opl[4];
        const float geom = path_lengths(in, i, hit, t, ior, opl);

        // 3. emission with its per-light MIS weight (wavefront.emit,
        //    lights_pdf_at_hit: pick x t^2 / (|cos| area) of the prim hit)
        float w_emit = 1.0f;
        if (hit && in.prev_random[i]) {
            const float* row = lights.pick_area + 2 * min(prim, lights.n_pick - 1);
            const float g[3] = {gnrm[3 * i], gnrm[3 * i + 1], gnrm[3 * i + 2]};
            const float cg = fabsf(dot3(d, g));
            const float lp_hit = row[0] * (((t * t) * row[1]) / clamp_min(cg, 1e-12f));
            w_emit = power_heuristic(in.prev_pdf[i], lp_hit);
        }
        emit_lane<SENSOR>(sp, mr, d, n3, back, tp, w_emit, opl, t, hit, a, out.acc + 3 * i);

        // 4. the bsdf sample of the lane's own lobe
        const long long px_id = pixel[i], smp = in.sample[i];
        float u4[4], ua[4];
        uniform4(px_id, smp, k, SALT_BSDF, u4);
        uniform4(px_id, smp, k, SALT_BSDF_AUX, ua);
        float sdir[3] = {n3[0], n3[1], n3[2]};
        float atten[4] = {0.f, 0.f, 0.f, 0.f};
        float new_ior[4] = {ior[0], ior[1], ior[2], ior[3]};
        float spdf = 0.f, ax = 0.f, ay = 0.f, tb_t[3] = {0.f, 0.f, 0.f},
              tb_b[3] = {0.f, 0.f, 0.f};
        int kind = KIND_NONE;
        if (hit) {
            kind = sample_lobe<true, true, HAS_RGL>(mr, rgl, tng + 3 * i, d, n3, back, t, ior, u4,
                                                    ua, sdir, atten, &spdf, new_ior, &ax, &ay,
                                                    tb_t, tb_b);
        }
        is_random = hit && kind == KIND_RANDOM && spdf > 0.f;
        const bool is_explicit = hit && kind == KIND_EXPLICIT;

        // 5. light NEE up to its shadow ray, row i (wavefront.light_nee, per
        //    light; render/lights.py lights_sample, light_emitted_at)
        {
            float u3[4];
            uniform4(px_id, smp, k, SALT_NEE_SAMPLE, u3);
            const LightSample ls = light_sample(u3, p, lights.tri, lights.alias_prob,
                                                lights.alias_idx, lights.n, shadow_scale,
                                                min_hit);
            for (int c = 0; c < 3; ++c) {
                shadow_o[3 * i + c] = p[c];
                shadow_d[3 * i + c] = ls.ldir[c];
            }
            shadow_tmax[i] = is_random ? ls.t_vis : 0.f;
            bool nee_take = false;
            float ndep[3] = {0.f, 0.f, 0.f};
            if (is_random) {
                const float pdf_light = lights.w[ls.pick] * ls.pdf_sa;
                float fl[4];
                const float pb = random_bsdf_eval<true, HAS_RGL>(mr, rgl, d, n3, tb_t, tb_b, ax,
                                                                 ay, back, ls.ldir, fl);
                const MatRow lr = mat_row(mat, n_mat, lights.mat[ls.pick]);
                const bool le_ok = light_seen(ls, lr);
                const float w_nee = power_heuristic(pdf_light, pb);
                const float scale = w_nee / clamp_min(pdf_light, 1e-12f);
                float contrib[4], nopl[4];
                for (int c = 0; c < 4; ++c) {
                    contrib[c] = ((tp[c] * fl[c]) * (le_ok ? lr.f[4 + c] : 0.f)) * scale;
                    nopl[c] = opl[c] + ls.ldist * ior[c];
                }
                nee_take = sensor_deposit<SENSOR>(sp, contrib, nopl, ls.ldist,
                                                  pdf_light > 1e-12f, ndep);
            }
            for (int c = 0; c < 3; ++c) pending[3 * i + c] = nee_take ? ndep[c] : 0.f;
        }

        // 6. env NEE up to its shadow ray, row n + i
        const int j = n + i;
        for (int c = 0; c < 3; ++c) shadow_o[3 * j + c] = p[c];
        env_nee_lane<SENSOR, SKY, true, HAS_RGL>(env, sp, rgl, px_id, smp, k, is_random, mr, d,
                                                 n3, tb_t, tb_b, ax, ay, back, tp, opl, j,
                                                 shadow_d, shadow_tmax, pending);

        // 7. throughput update, Russian roulette, the next state; the ray IOR
        //    of glass and of ModPhong's pass-through; no mixture pdf (per light)
        advance_lane(in, out, i, k, act, hit, p, d, tp, sdir, atten, spdf, is_random,
                     is_explicit, ua[2], geom, opl, max_depth, rr_start, rr_threshold);
        const bool cont = is_random || is_explicit;
        for (int c = 0; c < 4; ++c) out.ior[4 * i + c] = cont ? new_ior[c] : ior[c];
        out.prev_light_pdf[i] = 0.f;
    }
    count_casts<2>(stats, act, is_random);   // the light's and the sky's shadow rays
}

// n_pend pending deposits per lane (none, one, or the lit class's light and
// env deposits), lane i's q-th in row q n + i of pending and occluded,
// added in that order.
__global__ void __launch_bounds__(256)
resolve_kernel(const float* __restrict__ acc, const float* __restrict__ pending,
               const bool* __restrict__ occluded, int n_pend, const bool* __restrict__ active,
               const long long* __restrict__ k_next, int n, int n_acc, long long blk, int B,
               long long P, long long n_pix, float* __restrict__ out, int* __restrict__ work) {
    const int i = blockIdx.x * blockDim.x + threadIdx.x;
    bool busy = false;
    if (i < n) {
        if (n_pend > 0) {
            for (int c = 0; c < n_acc; ++c) {
                const long long j = static_cast<long long>(i) * n_acc + c;
                float s = acc[j];
                for (int q = 0; q < n_pend; ++q) {
                    const long long r = static_cast<long long>(q) * n + i;
                    s = s + (occluded[r] ? 0.f : pending[r * n_acc + c]);
                }
                out[j] = s;
            }
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
                                 const float* dist_k, const float* dist_p, int lens, int iters,
                                 long long blk, int B, int m, long long P, long long n_pix,
                                 int width, int height, int ssqrt, int randomize,
                                 void* stream) {
    if (lens < LENS_NONE || lens > LENS_OPENCV || iters < 0) return -1;
    if (n > 0) {
        const Camera cam{centre, focal, translation, rotation, dist_k, dist_p, lens, iters,
                         nullptr, nullptr, 0.f, 0.f, 0.f, 0};
        regen_kernel<CAM_PINHOLE><<<(n + 255) / 256, 256, 0, static_cast<cudaStream_t>(stream)>>>(
            *in, *out, t_max, n, cam, blk, B, m, P, n_pix, width, height, ssqrt, randomize);
    }
    return static_cast<int>(cudaGetLastError());
}

extern "C" int wpt_regen_surround(const WaveState* in, const WaveState* out, float* t_max, int n,
                                  const float* translation, const float* rotation,
                                  const float* scale, const float* eye_distance, float span,
                                  float inv_width, float inv_eff_height, int stereo, long long blk,
                                  int B, int m, long long P, long long n_pix, int width,
                                  int height, int ssqrt, int randomize, void* stream) {
    if (height < (stereo ? 2 : 1) || width < 1) return -1;
    if (n > 0) {
        const Camera cam{nullptr, nullptr, translation, rotation, nullptr, nullptr, LENS_NONE, 0,
                         scale, eye_distance, span, inv_width, inv_eff_height, stereo};
        regen_kernel<CAM_SURROUND><<<(n + 255) / 256, 256, 0, static_cast<cudaStream_t>(stream)>>>(
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

extern "C" int wpt_shade_env(
    const WaveState* in, const WaveState* out, long long* stats, int n, const long long* pixel,
    const float* t, const int* prim, const float* pos, const float* nrm, const float* tng,
    const bool* backside, const int* mat_hit, const float* mat, int n_mat, int has_glass, int sky,
    const float* img, int h, int w, const float* const_rad, const float* pdf,
    const float* alias_prob, const int* alias_idx, int res, const float* rot, int sensor,
    const float* sensor_params, int max_depth, int rr_start, float rr_threshold, float* shadow_d,
    float* shadow_tmax, float* pending, void* stream) {
    // The kinds the route takes: an equirect sky with importance tables, a
    // cube sky with or without them, a constant sky (which has none).
    const bool ok_sky = (sky == SKY_EQUIRECT && res > 0) || sky == SKY_CUBE ||
                        (sky == SKY_CONSTANT && res == 0);
    if (!ok_sky || res < 0 || h < 1 || w < 1 || (sensor != SENSOR_RGB && sensor != SENSOR_TOF))
        return -1;
    if (n > 0) {
        SensorParams sp;
        for (int k = 0; k < 8; ++k) sp.v[k] = sensor_params[k];
        const EnvMap env{reinterpret_cast<const float4*>(img), h, w,
                         reinterpret_cast<const float4*>(const_rad), pdf, alias_prob, alias_idx,
                         res, rot};
        const int grid = (n + BLOCK - 1) / BLOCK;
        cudaStream_t s = static_cast<cudaStream_t>(stream);
        unsigned long long* st = reinterpret_cast<unsigned long long*>(stats);
#define WPT_SHADE_ENV(SENSOR, SKY, IS, GLASS_T)                                                \
    shade_env_kernel<SENSOR, SKY, IS, GLASS_T><<<grid, BLOCK, 0, s>>>(                        \
        *in, *out, st, n, pixel, t, prim, pos, nrm, tng, backside, mat_hit, mat, n_mat, env,   \
        sp, max_depth, rr_start, rr_threshold, shadow_d, shadow_tmax, pending)
#define WPT_SHADE_ENV_SKY(SENSOR, GLASS_T)                                                     \
    if (sky == SKY_EQUIRECT) WPT_SHADE_ENV(SENSOR, SKY_EQUIRECT, true, GLASS_T);               \
    else if (sky == SKY_CUBE && res > 0) WPT_SHADE_ENV(SENSOR, SKY_CUBE, true, GLASS_T);       \
    else if (sky == SKY_CUBE) WPT_SHADE_ENV(SENSOR, SKY_CUBE, false, GLASS_T);                 \
    else WPT_SHADE_ENV(SENSOR, SKY_CONSTANT, false, GLASS_T)
        if (sensor == SENSOR_RGB) {
            if (has_glass) { WPT_SHADE_ENV_SKY(SENSOR_RGB, true); }
            else { WPT_SHADE_ENV_SKY(SENSOR_RGB, false); }
        } else {
            if (has_glass) { WPT_SHADE_ENV_SKY(SENSOR_TOF, true); }
            else { WPT_SHADE_ENV_SKY(SENSOR_TOF, false); }
        }
#undef WPT_SHADE_ENV_SKY
#undef WPT_SHADE_ENV
    }
    return static_cast<int>(cudaGetLastError());
}

extern "C" int wpt_shade_lit(
    const WaveState* in, const WaveState* out, long long* stats, int n, const long long* pixel,
    const float* t, const int* prim, const float* pos, const float* nrm, const float* gnrm,
    const float* tng, const bool* backside, const int* mat_hit, const float* mat, int n_mat,
    const float* pick_area, int n_pick, const float* light_tri, const int* light_mat,
    const float* light_w, const float* alias_prob, const int* alias_idx, int n_lights, int sky,
    const float* img, int h, int w, const float* pdf, const float* env_alias_prob,
    const int* env_alias_idx, int res, const float* rot, const RglTables* rgl, int sensor,
    const float* sensor_params, int max_depth, int rr_start, float rr_threshold,
    float shadow_scale, float min_hit, float* shadow_o, float* shadow_d, float* shadow_tmax,
    float* pending, void* stream) {
    // The class's skies: an equirect or a cube sky with importance tables.
    if (n_lights < 1 || n_pick < 1 || (sky != SKY_EQUIRECT && sky != SKY_CUBE) || res < 1 ||
        h < 1 || w < 1 || (sensor != SENSOR_RGB && sensor != SENSOR_TOF) ||
        (rgl != nullptr && rgl->M < 1) || n > (1 << 28))   // rows 3 (n + i) stay in an int
        return -1;
    if (n > 0) {
        SensorParams sp;
        for (int k = 0; k < 8; ++k) sp.v[k] = sensor_params[k];
        const Lights lights{pick_area, n_pick, light_tri, light_mat, light_w, alias_prob,
                            alias_idx, n_lights};
        const EnvMap env{reinterpret_cast<const float4*>(img), h, w, nullptr, pdf, env_alias_prob,
                         env_alias_idx, res, rot};
        const RglTables tables = rgl != nullptr ? *rgl : RglTables{};
        const int grid = (n + BLOCK - 1) / BLOCK;
        cudaStream_t s = static_cast<cudaStream_t>(stream);
        unsigned long long* st = reinterpret_cast<unsigned long long*>(stats);
#define WPT_SHADE_LIT(SENSOR, SKY, RGL_T)                                                       \
    shade_lit_kernel<SENSOR, SKY, RGL_T><<<grid, BLOCK, 0, s>>>(                                \
        *in, *out, st, n, pixel, t, prim, pos, nrm, gnrm, tng, backside, mat_hit, mat, n_mat,  \
        lights, env, tables, sp, max_depth, rr_start, rr_threshold, shadow_scale, min_hit,     \
        shadow_o, shadow_d, shadow_tmax, pending)
#define WPT_SHADE_LIT_SKY(SENSOR, RGL_T)                                                        \
    if (sky == SKY_EQUIRECT) WPT_SHADE_LIT(SENSOR, SKY_EQUIRECT, RGL_T);                        \
    else WPT_SHADE_LIT(SENSOR, SKY_CUBE, RGL_T)
        if (sensor == SENSOR_RGB) {
            if (rgl != nullptr) { WPT_SHADE_LIT_SKY(SENSOR_RGB, true); }
            else { WPT_SHADE_LIT_SKY(SENSOR_RGB, false); }
        } else {
            if (rgl != nullptr) { WPT_SHADE_LIT_SKY(SENSOR_TOF, true); }
            else { WPT_SHADE_LIT_SKY(SENSOR_TOF, false); }
        }
#undef WPT_SHADE_LIT_SKY
#undef WPT_SHADE_LIT
    }
    return static_cast<int>(cudaGetLastError());
}

extern "C" int wpt_nee_resolve(const float* acc, const float* pending, const bool* occluded,
                               int n_pend, const bool* active, const long long* k_next, int n,
                               int n_acc, long long blk, int B, long long P, long long n_pix,
                               float* out, int* work, void* stream) {
    if (n_pend < 0 || n_pend > 2 || (n_pend > 0) != (pending != nullptr && occluded != nullptr))
        return -1;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    cudaMemsetAsync(work, 0, sizeof(int), s);
    if (n > 0) {
        resolve_kernel<<<(n + 255) / 256, 256, 0, s>>>(acc, pending, occluded, n_pend, active,
                                                      k_next, n, n_acc, blk, B, P, n_pix, out,
                                                      work);
    }
    return static_cast<int>(cudaGetLastError());
}
