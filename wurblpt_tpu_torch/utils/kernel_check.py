"""Hold each hand-written kernel against its plain PyTorch version on the same
inputs, at the shapes the main path gives it.

Used by ``chip_smoke.py`` and the CUDA tests. Inputs are made with numpy from
a seed. Tolerances, and why (the kernels are built with -fmad=false, so on
the same card they should agree bit for bit; the margins cover what may
still differ, such as atan2f/asinf against PyTorch's):

* K1 closest hit: prim ids equal wherever the runner-up candidate is farther
  than 1e-5 * t (nearer ones are ties up to rounding); t/u/v rtol 1e-5,
  atol 1e-6 where both hit the same prim.
* K2 any hit: equal wherever the nearest candidate is not within 1e-5 *
  t_max of t_max.
* K3 hit assembly: integer fields equal, float fields atol 1e-5 on hit lanes.
* K5 BVH closest hit: prim ids equal on every lane (kernel and plain version
  walk the same tree in the same order, so ties resolve alike); t/u/v rtol
  1e-5, atol 1e-6.
* K6 BVH any hit: equal on every lane.
* K8 envmap: radiance rtol 1e-5, atol 1e-6 (the sun is 200, the sky ~1);
  sampled directions atol 1e-6; pdfs equal (a table lookup) on all but
  1e-4 of the lanes (an ulp of atan2f can move a direction across a cell
  edge).

Also the two frames the port renders and their yardsticks: the Cornell
bench frame and the mesh frame (bench config bvh_100k), each with the JAX
package's deterministic CPU output at the bench settings, which the port's
render must meet (mean radiance within 1e-3 relative, cast counters within
0.5 %).
"""

from __future__ import annotations

import time
from typing import Callable, Dict

import numpy as np
import torch

from ..accel.traverse import bvh_any_hit, bvh_any_hit_plain, bvh_closest_hit, bvh_closest_hit_plain
from ..render.bsdf import SceneStatic
from ..render.camera import CameraConfig, camera_rays, make_camera
from ..render.envmap import (
    env_pdf,
    env_pdf_plain,
    env_radiance,
    env_radiance_plain,
    env_sample,
    env_sample_plain,
)
from ..render.integrator import RenderParams, render_frame_wavefront
from ..render.intersect import assemble_hit, assemble_hit_plain
from ..render.intersect_brute import (
    BIG,
    any_hit,
    any_hit_plain,
    candidate_t,
    closest_hit,
    closest_hit_plain,
)
from ..render.lights import lights_sample
from ..render.sensor import SensorRGB
from . import scenes

MIN_HIT = RenderParams().min_hit_distance
SHADOW_EPS = RenderParams().shadow_identity_eps

# The Cornell bench frame: 128 x 128 pixels, 16 spp, 8 path components; one
# wavefront block holds 8 sample lanes per pixel (131072 lanes).
BENCH_WIDTH = 128
BENCH_SSQRT = 4
BENCH_DEPTH = 8
BENCH_LANES_M = 8
BENCH_LANES = BENCH_WIDTH * BENCH_WIDTH * BENCH_LANES_M
# The JAX package's deterministic CPU output for it: mean radiance and the
# cast counters (closest casts, all casts).
REF_MEAN = 0.0411764
REF_STATS = (1133568, 2080420)

# The mesh frame (bench.py bench_bvh_large): terrain_city(seed=3), 102098
# triangles with a BVH, 160 x 120 pixels, 4 spp (ssqrt 2), 4 path components;
# one wavefront block of 19200 pixels x 4 sample lanes.
MESH_WIDTH = 160
MESH_HEIGHT = 120
MESH_SSQRT = 2
MESH_DEPTH = 4
MESH_LANES_M = 4
MESH_LANES = MESH_WIDTH * MESH_HEIGHT * MESH_LANES_M
# The JAX package's deterministic CPU output for it (float64 mean of the f32
# image; cast counters).
MESH_REF_MEAN = 0.345844278874743
MESH_REF_STATS = (174435, 278267)


def _frame(scene, camera, width, height, ssqrt, depth, device) -> Callable[[], tuple]:
    static = SceneStatic.from_scene(scene)
    pose, vfov = camera
    cam = make_camera(pose, vfov, width, height, device=device)
    params = RenderParams(max_path_components=depth)

    def render():
        img, stats = render_frame_wavefront(scene, static, cam, CameraConfig(), SensorRGB(),
                                            width, height, ssqrt, params=params,
                                            return_stats=True, device=device)
        if torch.device(device).type == "cuda":
            torch.cuda.synchronize()
        return img, stats

    return render


def bench_frame(device) -> Callable[[], tuple]:
    """A function that renders the Cornell bench frame on `device` through
    render_frame_wavefront and returns (image, stats) once the device is done."""
    return _frame(scenes.cornell_box_ref(device), scenes.cornell_ref_camera(device),
                  BENCH_WIDTH, BENCH_WIDTH, BENCH_SSQRT, BENCH_DEPTH, device)


def mesh_frame(device, scene=None) -> Callable[[], tuple]:
    """The same for the mesh frame; `scene` is terrain_city(seed=3) on
    `device`, built here when not given."""
    scene = scenes.terrain_city(seed=3, device=device) if scene is None else scene
    return _frame(scene, scenes.terrain_camera(device), MESH_WIDTH, MESH_HEIGHT, MESH_SSQRT,
                  MESH_DEPTH, device)


def _check_frame(img, stats, shape, ref_mean, ref_stats) -> float:
    assert tuple(img.shape) == shape, img.shape
    assert bool(torch.isfinite(img).all()), "image has non-finite values"
    mean = float(img.double().mean())
    assert abs(mean - ref_mean) <= 1e-3 * ref_mean, f"mean radiance {mean} off {ref_mean}"
    counts = [int(x) for x in stats]
    for got, ref in zip(counts, ref_stats):
        assert abs(got - ref) <= 5e-3 * ref, f"cast counters {counts} off {ref_stats}"
    return mean


def check_bench_frame(img, stats) -> float:
    """Hold a Cornell bench frame to the JAX reference; returns its mean radiance."""
    return _check_frame(img, stats, (BENCH_WIDTH, BENCH_WIDTH, 3), REF_MEAN, REF_STATS)


def check_mesh_frame(img, stats) -> float:
    """Hold a mesh frame to the JAX reference; returns its mean radiance."""
    return _check_frame(img, stats, (MESH_HEIGHT, MESH_WIDTH, 3), MESH_REF_MEAN, MESH_REF_STATS)


def _f32(x, device):
    return torch.as_tensor(np.ascontiguousarray(x, np.float32), device=device)


def camera_lanes(width: int, height: int, m: int, device, seed: int = 0, camera=None):
    """Bounce-0 rays of a bench frame: width x height pixels x m sample lanes
    (the wavefront's block), pixel jitter from numpy; `camera` is (pose,
    vfov), the Cornell bench camera by default."""
    pose, vfov = scenes.cornell_ref_camera(device) if camera is None else camera
    cam = make_camera(pose, vfov, width, height, device=device)
    n = width * height * m
    pix = np.arange(n) % (width * height)
    jit = np.random.default_rng(seed).uniform(size=(n, 2))
    pxy = np.stack([pix % width, pix // width], -1) + jit
    o, d = camera_rays(cam, CameraConfig(), _f32(pxy, device), width, height)
    return (o.contiguous(), d.contiguous(), torch.full((n,), MIN_HIT, device=device),
            torch.full((n,), BIG, device=device))


def random_lanes(n: int, device, seed: int = 1, lo=(-1.2, -0.2, -1.2), hi=(1.2, 2.2, 3.5),
                 t_far: float = 2.5):
    """Rays from the box [lo, hi] (in and around the Cornell box by default)
    in random directions; a third with a finite t_max up to `t_far`, a tenth
    dead (t_max = 0), as later bounces produce them."""
    rs = np.random.default_rng(seed)
    o = rs.uniform(lo, hi, size=(n, 3))
    d = rs.normal(size=(n, 3))
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    t_max = np.where(rs.uniform(size=n) < 0.33, rs.uniform(0.05, t_far, size=n), BIG)
    t_max = np.where(rs.uniform(size=n) < 0.1, 0.0, t_max)
    return (_f32(o, device), _f32(d, device), torch.full((n,), MIN_HIT, device=device),
            _f32(t_max, device))


def shadow_lanes(scene, bs, rays, seed: int = 2):
    """NEE shadow rays from the first hits of `rays` toward a sampled light
    point, shortened as the integrator does; lanes without a hit get t_max = 0."""
    o, d, t_min, t_max = rays
    t, prim, _, _ = closest_hit_plain(bs, o, d, t_min, t_max)
    pos = o + torch.where(prim >= 0, t, 1.0)[:, None] * d
    u3 = _f32(np.random.default_rng(seed).uniform(size=(o.shape[0], 3)), o.device)
    ldir, _, ldist, _, _ = lights_sample(scene, pos, u3)
    t_vis = torch.clamp_min(ldist * (1.0 - SHADOW_EPS), MIN_HIT)
    return (pos.contiguous(), ldir.contiguous(), t_min, torch.where(prim >= 0, t_vis, 0.0))


def check_closest_hit(bs, rays) -> Dict[str, float]:
    """K1 against its plain version; raises AssertionError on disagreement."""
    t, prim, u, v = closest_hit(bs, *rays)
    pt, pprim, pu, pv = closest_hit_plain(bs, *rays)
    c = torch.sort(candidate_t(bs, *rays), 1).values
    second = c[:, 1] if c.shape[1] > 1 else torch.full_like(c[:, 0], BIG)
    ok = (second - c[:, 0] > 1e-5 * c[:, 0]) | (c[:, 0] >= BIG)
    bad = int((ok & (prim != pprim)).sum())
    assert bad == 0, f"closest_hit: {bad} prim ids differ outside the tie margin"
    same = (prim == pprim) & (prim >= 0)
    err = 0.0
    for a, b in ((t, pt), (u, pu), (v, pv)):
        a, b = a[same], b[same]
        assert torch.allclose(a, b, rtol=1e-5, atol=1e-6), "closest_hit: t/u/v differ"
        err = max(err, float((a - b).abs().max()) if a.numel() else 0.0)
    return {"max_abs_err": err, "lanes": int(prim.shape[0]), "hits": int((prim >= 0).sum()),
            "ties": int((~ok).sum())}


def check_any_hit(bs, rays) -> Dict[str, float]:
    """K2 against its plain version; raises AssertionError on disagreement."""
    occ = any_hit(bs, *rays)
    pocc = any_hit_plain(bs, *rays)
    o, d, t_min, t_max = rays
    near = candidate_t(bs, o, d, t_min, torch.full_like(t_max, BIG)).min(1).values
    ok = ((near - t_max).abs() > 1e-5 * t_max) | (near >= BIG)
    diff = (occ != pocc) & ok
    assert not bool(diff.any()), f"any_hit: {int(diff.sum())} lanes differ outside the margin"
    return {"max_abs_err": float(diff.float().max()), "lanes": int(occ.shape[0]),
            "occluded": int(occ.sum())}


def check_assemble_hit(bs, ht, rays) -> Dict[str, float]:
    """K3 against its plain version on the winners of a plain closest-hit cast."""
    o, d = rays[0], rays[1]
    t, prim, u, v = closest_hit_plain(bs, *rays)
    hr = assemble_hit(ht, o, d, t, prim, u, v)
    ph = assemble_hit_plain(ht, o, d, t, prim, u, v)
    for f in ("hit", "prim", "mat", "backside"):
        assert torch.equal(getattr(hr, f), getattr(ph, f)), f"assemble_hit: {f} differs"
    h = ph.hit
    err = 0.0
    for f in ("position", "normal", "geom_normal", "tangent", "uv"):
        a, b = getattr(hr, f)[h], getattr(ph, f)[h]
        e = float((a - b).abs().max()) if a.numel() else 0.0
        assert e <= 1e-5, f"assemble_hit: {f} differs by {e}"
        err = max(err, e)
    return {"max_abs_err": err, "lanes": int(o.shape[0]), "hits": int(h.sum())}


def mesh_camera_lanes(device, seed: int = 0):
    """Bounce-0 rays of the mesh frame's block (76800 lanes)."""
    return camera_lanes(MESH_WIDTH, MESH_HEIGHT, MESH_LANES_M, device, seed,
                        camera=scenes.terrain_camera(device))


def terrain_random_lanes(n: int, device, seed: int = 1):
    """Random rays from above and below the terrain_city ground."""
    return random_lanes(n, device, seed, lo=(-20.0, -2.0, -20.0), hi=(20.0, 6.0, 20.0),
                        t_far=30.0)


def env_shadow_lanes(scene, rays, seed: int = 2):
    """Env-NEE shadow rays from the first hits of `rays`, toward sky directions
    that env_sample draws, to BIG; lanes without a hit get t_max = 0."""
    o, d, t_min, _ = rays
    t, prim, _, _ = bvh_closest_hit_plain(scene.bvh, *rays)
    pos = o + torch.where(prim >= 0, t, 1.0)[:, None] * d
    u3 = _f32(np.random.default_rng(seed).uniform(size=(o.shape[0], 3)), o.device)
    edir, _ = env_sample_plain(scene.envmap, u3)
    return (pos.contiguous(), edir.contiguous(), t_min,
            torch.where(prim >= 0, BIG, 0.0).to(torch.float32))


def check_bvh_closest_hit(bvh, rays) -> Dict[str, float]:
    """K5 against its plain version; raises AssertionError on disagreement."""
    t, prim, u, v = bvh_closest_hit(bvh, *rays)
    pt, pprim, pu, pv = bvh_closest_hit_plain(bvh, *rays)
    bad = int((prim != pprim).sum())
    assert bad == 0, f"bvh_closest_hit: {bad} prim ids differ"
    hit = prim >= 0
    err = 0.0
    for a, b in ((t, pt), (u, pu), (v, pv)):
        a, b = a[hit], b[hit]
        assert torch.allclose(a, b, rtol=1e-5, atol=1e-6), "bvh_closest_hit: t/u/v differ"
        err = max(err, float((a - b).abs().max()) if a.numel() else 0.0)
    return {"max_abs_err": err, "lanes": int(prim.shape[0]), "hits": int(hit.sum())}


def check_bvh_any_hit(bvh, rays) -> Dict[str, float]:
    """K6 against its plain version; raises AssertionError on disagreement."""
    occ = bvh_any_hit(bvh, *rays)
    pocc = bvh_any_hit_plain(bvh, *rays)
    diff = int((occ != pocc).sum())
    assert diff == 0, f"bvh_any_hit: {diff} lanes differ"
    return {"max_abs_err": 0.0, "lanes": int(occ.shape[0]), "occluded": int(occ.sum())}


def check_envmap(env, dirs, u3) -> Dict[str, float]:
    """K8's three entry points against their plain versions on directions
    `dirs` [N, 3] and uniforms `u3` [N, 3]; raises AssertionError on disagreement."""
    rad, prad = env_radiance(env, dirs), env_radiance_plain(env, dirs)
    assert torch.allclose(rad, prad, rtol=1e-5, atol=1e-6), "env_radiance differs"
    (sd, spdf), (psd, pspdf) = env_sample(env, u3), env_sample_plain(env, u3)
    assert torch.allclose(sd, psd, rtol=0.0, atol=1e-6), "env_sample directions differ"
    pdf, ppdf = env_pdf(env, dirs), env_pdf_plain(env, dirs)
    n = dirs.shape[0]
    for name, a, b in (("env_sample", spdf, pspdf), ("env_pdf", pdf, ppdf)):
        off = int((a != b).sum())
        assert off <= 1e-4 * n, f"{name}: {off} of {n} pdfs differ"
    err = max(float((a - b).abs().max()) for a, b in ((rad, prad), (sd, psd), (spdf, pspdf),
                                                      (pdf, ppdf)))
    return {"max_abs_err": err, "lanes": n, "pdf_lanes_off": int((pdf != ppdf).sum()),
            "sample_pdf_lanes_off": int((spdf != pspdf).sum())}


def time_ms(fn: Callable[[], object], device, n: int = 20, warmup: int = 3) -> float:
    """Mean time of one call over `n` calls after `warmup`, by CUDA events on a
    GPU (a host clock would time the enqueue), by the host clock otherwise."""
    for _ in range(warmup):
        fn()
    if torch.device(device).type == "cuda":
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        for _ in range(n):
            fn()
        stop.record()
        torch.cuda.synchronize()
        return start.elapsed_time(stop) / n
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    return (time.perf_counter() - t0) * 1e3 / n
