"""The differentiable render on the card: the backward kernels held against
their plain versions at the shapes of a differentiable frame, and the
gradient checks of ``chip_smoke.py``'s `grad` phase.

* P0T (`row_scatter`) on the Cornell block's material rows after 2
  bounces, K3T (`assemble_hit_bwd`) on that block's winners, K3aT
  (`assemble_hit_bwd` with frames) on the animated box with spheres'
  winners with the rows of one instant and per-ray rows (`anim_lanes`), K8T
  (`env_radiance_bwd`) on the envmap frame's directions (camera lanes and
  random ones) on the equirect and the cube map, each with random
  cotangents made by numpy from a seed. Beside those, shapes that take each
  of K3T's and K8T's paths: K3T on the floor step's lanes (`floor_lanes`)
  and on tables past its shared memory (`field_lanes`, also animated for
  K3aT), K8T on a constant and a 512 x 1024 sky (`sky_lanes`' kinds
  "constant", "large"). The plain versions of K3T and K8T
  run on the CPU on copies of the same inputs: PyTorch's CUDA ops contract
  a * b - c into an FMA, which turns terms that cancel to 0 (a
  Gram-Schmidt residual) into rounding noise that no -fmad=false kernel
  reproduces. Tolerances: the scattered tables (float atomics, whose order
  of summation varies) within 1e-4 of the sum of the magnitudes of their
  terms (`*_plain(..., magnitudes=True)`) plus 1e-30 (a Gram-Schmidt
  tangent near its normal divides rounding by a small length: 3e-5 seen),
  the sky's texels within 1e-3 (the card's atan2f and acosf are not the
  CPU's, and an ulp of the lookup's u moves a tap's weight by the map's
  width in ulps: 1.5e-4 seen on the 128-wide equirect map); the per-lane outputs
  (g_o, g_d, the direction's) within 1e-4 of the plain version's largest
  magnitude, the lanes that differ also counted. Every output finite.
* `bound_ms`' work of each (kernel_check.bound_ms): the bytes each input
  is read and each output written once, the tables once each way, and a
  tally of the float operations per lane stated beside each `*_work`.

* P0T also on tables past the material rows (`scatter_lanes`: one that
  takes the block's one copy in shared memory, one past it).
* K7T (`rgl_bwd`) on `rgl_lanes` (131072 lanes of two synthetic RGL
  materials, eval and sample; also on a stack of RGL_STACK_GLOBAL
  materials, its tables past the shared memory, and on the lanes the 128 x
  128 RGL tables step hands it, `rgl_quad_lanes`): its tail form against its plain version,
  autograd through K7's plain forward on the card (`check_rgl_bwd`), each
  table within 1e-4 of the sum of its entries' |term|; its full form, with
  random cotangents of the pdf and of sample's direction too
  (`rgl_full_cotangents`), against its plain version in float64
  (`check_rgl_bwd_full`, `rgl_full_reference`): each table entry within
  RGL_FULL_REL of its sum of |term| (the float64 plain version's), the
  lanes' direction cotangents within LANE_REL of the largest.
* K8T with its rotation term (`check_env_radiance_bwd(..., rotation=True)`)
  on the equirect, cube and constant skies turned by SKY_ROTATION, and its
  sample's backward (`check_env_sample_bwd`, `env_sample_lanes`: 262144
  uniforms of the turned equirect sky; and the lanes one sky-yaw step
  hands it, `sky_yaw_lanes`, with K8's pairs' inputs of each bounce), the
  rotation's four sums within SKY_SUM_REL and SUM_REL of their terms'
  magnitudes.

The frames: the Cornell bench frame through `render_frame` (the pass
renderer, 16 samples in one pass), its gradients with respect to the
emission's scale and the white walls' albedo, the envmap_spheres frame's
gradient with respect to the sky's scale, the sphere-lit floor's gradient
with respect to the camera's height, the RGL quad's with respect to its
rgb table's scale (K7T) and the textured quad's with respect to one texel,
the moving floor's gradients with respect to its vertices and a keyframe
over a shutter (K3aT, `moving_floor_loss`), the sky's yaw (`sky_yaw_loss`:
K8T's rotation term and the sample's backward), every RGL table of the
RGL quad (`rgl_tables_loss`) and its camera's height (`rgl_camera_loss`:
the lane directions), the RGL quad at RGL_QUAD_WIDTH^2 and RGL_QUAD_SSQRT^2
spp (`rgl_table_loss` and `rgl_tables_loss` at that size: K7T's tail and
full forms at the grad phase's size), the last five against the JAX
package's CPU yardsticks kept here (SKY_YAW_REF, RGL_TABLE_REFS,
RGL_CAMERA_REF, RGL_QUAD_128_REF), and
`fit` recovering the lit quad's albedo and the sky's yaw (`fit_yaw`), each
driven through the port's public entry points.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from ..core.transform import Transformation, from_lookat, quat_from_axis_angle
from ..inverse import fit, render_loss
from ..materials.rgl import (GRAD_TABLES, TAIL_TABLES, RGLTables, load_rgl_material,
                             stack_rgl_tables)
from ..render.backward import (
    assemble_hit_bwd,
    assemble_hit_bwd_plain,
    env_radiance_bwd,
    env_radiance_bwd_plain,
    env_sample_bwd,
    env_sample_bwd_plain,
    rgl_bwd,
    rgl_bwd_plain,
    row_scatter,
    row_scatter_plain,
)
from ..render.envmap import EnvironmentMapConstant, EnvironmentMapEquiRect, build_envmap_arrays
from ..render.bsdf import SceneStatic
from ..render.camera import CameraConfig, make_camera
from ..render.integrator import (
    RenderParams,
    _make_bounce_fn,
    live_tables,
    prepare_scene,
    render_frame,
)
from ..render.intersect import assemble_hit_raw, scene_raw_hit
from ..render.intersect_brute import BIG
from ..render.sensor import SensorRGB
from ..render.wavefront import LoopState
from ..scene import builder as B
from ..scene.flatten import MeshSpec, SphereSpec, flatten_meshes, material_table
from ..scene.ir import MaterialType
from ..scene import generator as G
from . import kernel_check as kc
from . import scenes

RGL_STACK_GLOBAL = 9  # rgl_lanes' stack whose tables pass K7T's shared memory in both forms
SUM_REL = 1e-4      # scattered tables: of the sum of the terms' magnitudes
RGL_FULL_REL = 1e-2  # K7T's full form against its plain version in float64: of each entry's
                     # sum of |term| (float32 and float64 forwards part at the sample's searches
                     # and quadratic inversions: 4.6e-3 seen on the host build)
SKY_SUM_REL = 1e-3  # the sky's texels: an ulp of atan2f / acosf moves a tap's weight by ~w ulps
LANE_REL = 1e-4     # per-lane outputs: of the plain version's largest magnitude

GRAD_SSQRT = 4      # the differentiable frames: 128 x 128, 16 spp, depth 8
GRAD_DEPTH = 8
FLOOR_SSQRT = 2     # the sphere-lit floor: 128 x 128, 4 spp, its difference's step
FLOOR_EPS = 1e-2
FIT_SSQRT = 2       # fit: 128 x 128, 4 spp, FIT_STEPS Adam steps
FIT_STEPS = 40
FIT_DEPTH = 2


def _f32(rng, shape, device):
    return torch.as_tensor(rng.standard_normal(shape).astype(np.float32), device=device)


def cornell_lanes(device, bounces: int = 2, seed: int = 20):
    """The Cornell block's lanes (kc.camera_lanes at bench size, 131072)
    after `bounces` bounces of the generic bounce: (hit tables, o, d, t,
    prim, u, v, backside, material ids, material table), the tables built
    from the scene's tensors as a differentiable render builds them, and
    random cotangents of K3's outputs and of the material rows."""
    scene = scenes.cornell_box_ref(device)
    static = SceneStatic.from_scene(scene)
    tables = live_tables(scene, prepare_scene(scene, static, step=False))
    o, d, t_min, _ = kc.camera_lanes(kc.BENCH_WIDTH, kc.BENCH_WIDTH, kc.BENCH_LANES_M, device)
    n = o.shape[0]
    f32 = dict(dtype=torch.float32, device=device)
    st = LoopState(
        bounce=torch.zeros((n,), dtype=torch.int64, device=device), o=o, d=d,
        ior=torch.ones((n, 4), **f32), throughput=torch.ones((n, 4), **f32),
        active=torch.ones((n,), dtype=torch.bool, device=device),
        acc=torch.zeros((n, 3), **f32), geom_len=torch.zeros((n,), **f32),
        opt_len=torch.zeros((n, 4), **f32), prev_pdf=torch.zeros((n,), **f32),
        prev_random=torch.zeros((n,), dtype=torch.bool, device=device),
        prev_light_pdf=torch.zeros((n,), **f32),
        stats=torch.zeros((2,), dtype=torch.int64, device=device))
    lane = torch.arange(n, dtype=torch.int64, device=device)
    pixel, sample = lane % (kc.BENCH_WIDTH ** 2), lane // (kc.BENCH_WIDTH ** 2)
    bounce = _make_bounce_fn(scene, static, tables, SensorRGB(),
                             RenderParams(max_path_components=GRAD_DEPTH), n)
    with torch.no_grad():
        for _ in range(bounces):
            st = bounce(st, pixel, sample)
        o, d = st.o.contiguous(), st.d.contiguous()
        t, prim, u, v = scene_raw_hit(tables.accel, o, d, t_min, torch.where(st.active, BIG, 0.0))
        ht = tables.hit._replace(**{k: getattr(tables.hit, k).detach()
                                    for k in ("tri_f", "sph_f", "tri_g")})
        rec = assemble_hit_raw(ht, o, d, t, prim, u, v)
    rng = np.random.default_rng(seed)
    cot = [_f32(rng, s, device) for s in ((n,), (n, 3), (n, 3), (n, 3), (n, 3), (n, 2))]
    return dict(ht=ht, o=o, d=d, t=t, prim=prim, u=u, v=v, backside=rec.backside,
                mat=rec.mat.contiguous(), mat_table=tables.mat.detach(), cot=cot,
                g_rows=_f32(rng, (n, tables.mat.shape[1]), device))


# A rotation of the sky for K8T's rotation term (the host tests' rotated cube map's).
SKY_ROTATION = (0.1, 0.3, -0.2, 0.9)


# A user's HDR sky, wider than the frames' 64 x 128: `procedural_sky` at 512 x
# 1024 (a texel or two a lane).
LARGE_SKY_HEIGHT = 512


def sky_lanes(device, cube: bool, seed: int = 21, kind: str = None, rotated: bool = False):
    """(map, directions, cotangents): the envmap frame's camera directions
    (kc.camera_lanes at its size, 131072) and as many random unit ones, on
    envmap_spheres' equirect or cube sky (kind "constant": a constant sky of
    radiance (0.3, 0.5, 0.7); kind "large": `procedural_sky` at
    LARGE_SKY_HEIGHT rows, twice as many columns),
    turned by SKY_ROTATION if `rotated`, with random cotangents [N, 4]."""
    if kind == "constant":
        env = build_envmap_arrays(EnvironmentMapConstant((0.3, 0.5, 0.7)), device)
    elif kind == "large":
        env = build_envmap_arrays(EnvironmentMapEquiRect(scenes.procedural_sky(LARGE_SKY_HEIGHT)),
                                  device)
    else:
        env = scenes.envmap_spheres(cube=cube, device=device).envmap
    if rotated:
        q = torch.tensor(SKY_ROTATION, dtype=torch.float32)
        env = env._replace(rotation=(q / torch.linalg.norm(q)).to(device))
    _, d, _, _ = kc.camera_lanes(kc.ENVMAP_WIDTH, kc.ENVMAP_WIDTH, kc.ENVMAP_LANES_M, device,
                                 camera=scenes.envmap_camera(device))
    rng = np.random.default_rng(seed)
    r = rng.standard_normal((d.shape[0], 3))
    r /= np.linalg.norm(r, axis=-1, keepdims=True)
    d = torch.cat([d, torch.as_tensor(r.astype(np.float32), device=device)]).contiguous()
    return env, d, _f32(rng, (d.shape[0], 4), device)


def _sum_close(name, got, ref, mag, rel=SUM_REL) -> float:
    assert bool(torch.isfinite(got).all()), f"{name}: non-finite values"
    err = (got - ref).abs()
    over = err > rel * mag + 1e-30
    if bool(over.any()):
        idx = torch.nonzero(over)[:5].tolist()
        worst = [(i, float(got[tuple(i)]), float(ref[tuple(i)]), float(mag[tuple(i)]))
                 for i in idx]
        raise AssertionError(f"{name}: {int(over.sum())} entries beyond {rel} of their "
                             f"terms' magnitudes; (entry, kernel, plain, magnitude): {worst}")
    return float(err.max()) if err.numel() else 0.0


def _lane_close(name, got, ref) -> Dict[str, float]:
    assert bool(torch.isfinite(got).all()), f"{name}: non-finite values"
    err = (got - ref).abs()
    tol = LANE_REL * float(ref.abs().max())
    assert float(err.max()) <= tol, f"{name}: {float(err.max())} beyond {tol}"
    return {"max_abs_err": float(err.max()), "lanes_differ": int((err > 0).any(-1).sum())}


def check_row_scatter(g, idx, rows) -> Dict[str, float]:
    """P0T against index_add_, within SUM_REL of each entry's |term| sum."""
    got = row_scatter(g, idx, rows)
    ref = row_scatter_plain(g, idx, rows)
    return {"max_abs_err": _sum_close("row_scatter", got, ref,
                                      row_scatter_plain(g.abs(), idx, rows))}


# P0T's tables past the Cornell block's material rows (cols 23): one that
# takes the block's one copy in shared memory, one past it (global atomics)
SCATTER_ROWS_BLOCK = 256
SCATTER_ROWS_GLOBAL = 1024


def scatter_lanes(device, rows: int, cols: int = 23, n: int = 131072, seed: int = 28):
    """P0T's inputs on a table of `rows` x `cols` words: n cotangent rows
    from numpy, normal but a third of them zero (lanes that carry none), at
    uniformly random rows (a few out of range: clamped). (g, idx, rows)."""
    rng = np.random.default_rng(seed)
    g = rng.standard_normal((n, cols)).astype(np.float32)
    g[rng.uniform(size=n) < 1.0 / 3.0] = 0.0
    idx = rng.integers(-2, rows + 2, size=n).astype(np.int32)
    return torch.as_tensor(g, device=device), torch.as_tensor(idx, device=device), rows


def _cpu(x):
    """x's tensors (a tensor, a NamedTuple of them or a list) on the CPU."""
    if isinstance(x, torch.Tensor):
        return x.cpu()
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return type(x)(*(_cpu(v) for v in x))
    if isinstance(x, (list, tuple)):
        return type(x)(_cpu(v) for v in x)
    return x


def check_assemble_hit_bwd(lanes) -> Dict[str, float]:
    """K3T against its plain version (on the CPU) on the same lanes and cotangents."""
    args = [lanes[k] for k in ("ht", "o", "d", "t", "prim", "u", "v", "backside")]
    got = _cpu(assemble_hit_bwd(*args, *lanes["cot"]))
    ref = assemble_hit_bwd_plain(*_cpu(args), *_cpu(lanes["cot"]), magnitudes=True)
    res = {}
    for name, a, b in zip(("g_o", "g_d"), got[:2], ref[:2]):
        r = _lane_close(f"assemble_hit_bwd {name}", a, b)
        res[f"{name}_lanes_differ"] = r["lanes_differ"]
        res["max_abs_err"] = max(res.get("max_abs_err", 0.0), r["max_abs_err"])
    for name, a, b, m in zip(("g_tri_g", "g_tri_f", "g_sph_f"), got[2:], ref[2:5], ref[5:]):
        res["max_abs_err"] = max(res["max_abs_err"],
                                 _sum_close(f"assemble_hit_bwd {name}", a, b, m))
    return res


def hit_lanes(scene, camera, width: int, m: int, device, seed: int, frames=None):
    """K3T's inputs (K3aT's with `frames`, [A, 30] or [N, A, 30]): `camera`'s
    (None: the Cornell bench camera's) width^2 x m camera lanes
    (kc.camera_lanes) over `scene`, cast and assembled by K3 (K3a with the
    frame rows), with random cotangents from a seed: the dict of
    cornell_lanes' K3T keys and `frames`."""
    tables = prepare_scene(scene, SceneStatic.from_scene(scene), step=False)
    o, d, t_min, t_max = kc.camera_lanes(width, width, m, device, camera=camera)
    n = o.shape[0]
    with torch.no_grad():
        t, prim, u, v = scene_raw_hit(tables.accel, o, d, t_min, t_max, frames)
        rec = assemble_hit_raw(tables.hit, o, d, t, prim, u, v, frames)
    rng = np.random.default_rng(seed)
    cot = [_f32(rng, s, device) for s in ((n,), (n, 3), (n, 3), (n, 3), (n, 3), (n, 2))]
    return dict(ht=tables.hit, o=o, d=d, t=t, prim=prim, u=u, v=v, backside=rec.backside, cot=cot,
                frames=frames)


def floor_lanes(device, seed: int = 26):
    """K3T's inputs at the differentiable floor step's shape (`floor_loss`:
    128 x 128, 4 spp, 65536 lanes): the sphere-lit floor's camera lanes, all
    of whose winners are the floor's 2 triangles."""
    return hit_lanes(scenes.sphere_lit_floor(device), scenes.sphere_lit_floor_camera(device),
                     128, FLOOR_SSQRT ** 2, device, seed)


# Tables past K3T's 48 KB of shared memory: 2048 triangles and 40 spheres
# (tri_sphere_field, 73888 words), also animated (per material, by the
# Cornell box's 4 animation rows).
FIELD_TRIS, FIELD_SPHERES = 2048, 40


def field_lanes(device, anim: str = None, seed: int = 27):
    """K3T's inputs on tables too large for its shared path (the global one):
    tri_sphere_field's 256 x 256 x 2 camera lanes (131072); with `anim` ("one
    instant" or "per ray") K3aT's, the field's meshes animated by
    `scenes.cornell_animations` (mesh m by row m) and cast with the rows of
    kc.ANIM_TIME or each lane's own."""
    cam = scenes.field_camera(device)
    if anim is None:
        return hit_lanes(scenes.tri_sphere_field(FIELD_TRIS, FIELD_SPHERES, device=device), cam,
                         256, 2, device, seed)
    tris, centers, radii, tmat, smat = scenes.field_spec(FIELD_TRIS, FIELD_SPHERES, 12)
    rows = [(MaterialType.LAMBERTIAN, a, None) for a in scenes.FIELD_ALBEDO]
    meshes = [MeshSpec(tris[tmat == m].reshape(-1, 3), None, None,
                       np.arange(3 * int((tmat == m).sum()), dtype=np.int32).reshape(-1, 3), m,
                       anim=m) for m in range(len(scenes.FIELD_ALBEDO)) if (tmat == m).any()]
    sph = [SphereSpec(tuple(c), float(r), int(m), anim=int(m)) for c, r, m in
           zip(centers, radii, smat)]
    scene = flatten_meshes(meshes, material_table(rows), device, use_bvh=False, spheres=sph,
                           animations=scenes.cornell_animations(), t0=kc.ANIM_TIME,
                           t1=kc.ANIM_TIME)
    frames = (kc.frames_per_ray_at(scene, 256 * 256 * 2) if anim == "per ray"
              else kc.frames_at(scene))
    return hit_lanes(scene, cam, 256, 2, device, seed, frames)


def anim_lanes(device, per_ray: bool, seed: int = 23):
    """K3aT's inputs: the animated box with its spheres (sweeps) seen by the
    Cornell block's camera lanes (kc.camera_lanes at bench size, 131072),
    each cast with the frame's rows at one instant (kc.ANIM_TIME: [A, 30])
    or, `per_ray`, with each lane's own rows at a random time in [0, 1)
    ([N, A, 30]), the winners assembled by K3a; random cotangents from a
    seed. The dict of cornell_lanes with `frames`."""
    scene = scenes.cornell_box_animated(device, spheres=True)
    n = kc.BENCH_WIDTH ** 2 * kc.BENCH_LANES_M
    fr = kc.frames_per_ray_at(scene, n) if per_ray else kc.frames_at(scene)
    return hit_lanes(scene, None, kc.BENCH_WIDTH, kc.BENCH_LANES_M, device, seed, fr)


def check_assemble_hit_anim_bwd(lanes) -> Dict[str, float]:
    """K3aT against its plain version (on the CPU) on the same lanes,
    cotangents and frame rows: g_o and g_d per lane within LANE_REL of the
    plain version's largest, the tables' cotangents and the atomic sums into
    the [A, 30] rows of one instant within SUM_REL of their terms'
    magnitudes, the per-ray rows' cotangents (each lane's own row, one term
    an entry, as g_o's) within LANE_REL of the largest."""
    args = [lanes[k] for k in ("ht", "o", "d", "t", "prim", "u", "v", "backside")]
    fr = lanes["frames"]
    got = _cpu(assemble_hit_bwd(*args, *lanes["cot"], frames=fr))
    ref = assemble_hit_bwd_plain(*_cpu(args), *_cpu(lanes["cot"]), magnitudes=True,
                                 frames=_cpu(fr))
    res = {}
    for name, a, b in zip(("g_o", "g_d"), got[:2], ref[:2]):
        r = _lane_close(f"assemble_hit_anim_bwd {name}", a, b)
        res[f"{name}_lanes_differ"] = r["lanes_differ"]
        res["max_abs_err"] = max(res.get("max_abs_err", 0.0), r["max_abs_err"])
    for name, a, b, m in zip(("g_tri_g", "g_tri_f", "g_sph_f"), got[2:5], ref[2:5], ref[6:9]):
        res["max_abs_err"] = max(res["max_abs_err"],
                                 _sum_close(f"assemble_hit_anim_bwd {name}", a, b, m))
    if fr.dim() == 3:   # each lane's own row: a per-lane output, one term an entry
        r = _lane_close("assemble_hit_anim_bwd g_frames", got[5].reshape(fr.shape[0], -1),
                        ref[5].reshape(fr.shape[0], -1))
        res["g_frames_lanes_differ"] = r["lanes_differ"]
        err = r["max_abs_err"]
    else:
        err = _sum_close("assemble_hit_anim_bwd g_frames", got[5], ref[5], ref[9])
    res["max_abs_err"] = max(res["max_abs_err"], err)
    res["frame_rows"] = list(fr.shape)
    return res


def check_env_radiance_bwd(env, d, g, rotation: bool = False, plain_on_card: bool = False,
                           active=None) -> Dict[str, float]:
    """K8T against its plain version (on the CPU) on the same directions and
    cotangents; with `rotation`, its rotation term too (the lanes' terms
    summed per block: within SKY_SUM_REL of their magnitudes, as the
    texels', whose lookup cells they share). `plain_on_card`: the plain
    version runs on the inputs' device, for a map wider than SKY_SUM_REL
    covers against the CPU: where PyTorch's CPU acosf or atan2f differs
    from CUDA's by an ulp, x = u w moves by ~w ulps of u, which a tap of
    small weight feels a thousandfold (the host build of the kernel, with
    the C library's, parts from the CPU plain version so on exactly the
    texels of such lanes: tests/test_torch_backward_on_host.py
    test_k8t_kernel_on_a_wide_sky); on the card the plain version calls
    CUDA's, as the kernel does, in unfused elementwise ops. `active` (a lane
    mask, where given): the plain version on the cotangents zeroed outside
    it, and the kernel's g_d 0 there."""
    got = _cpu(env_radiance_bwd(env, d, g, rotation=rotation, active=active))
    if active is not None:
        g = torch.where(active[:, None], g, 0.0)
        off = ~active.cpu()
        assert not bool(got[0][off].any()), "env_radiance_bwd: g_d on a masked lane"
        got[0][off] = 0.0
    ref = (_cpu(env_radiance_bwd_plain(env, d, g, magnitudes=True)) if plain_on_card
           else env_radiance_bwd_plain(*_cpu([env, d, g]), magnitudes=True))
    if active is not None:   # the plain version on a masked lane's zero cotangent
        ref[0][off] = 0.0
    r = _lane_close("env_radiance_bwd g_d", got[0], ref[0])
    err = max(r["max_abs_err"],
              _sum_close("env_radiance_bwd g_image", got[1], ref[1], ref[4], SKY_SUM_REL),
              _sum_close("env_radiance_bwd g_const", got[2], ref[2], ref[5]))
    out = {"lanes_differ": r["lanes_differ"]}
    if rotation:
        err = max(err, _sum_close("env_radiance_bwd g_rotation", got[3], ref[3], ref[6],
                                  SKY_SUM_REL))
        out["g_rotation"] = got[3].tolist()
    out["max_abs_err"] = err
    return out


def env_sample_lanes(device, n: int = 262144, seed: int = 24):
    """K8T's sample backward's inputs: envmap_spheres' equirect sky with its
    importance tables turned by SKY_ROTATION, n uniforms [N, 3] and random
    cotangents of the sampled directions [N, 3], from numpy."""
    env = sky_lanes(device, False, rotated=True)[0]
    rng = np.random.default_rng(seed)
    u3 = torch.as_tensor(rng.uniform(size=(n, 3)).astype(np.float32), device=device)
    return env, u3, _f32(rng, (n, 3), device)


def check_env_sample_bwd(env, u3, g_dir, active=None) -> Dict[str, float]:
    """K8T's sample backward against its plain version (on the CPU) on the
    same uniforms and cotangents (zeroed outside the lane mask `active`,
    where given): the rotation's cotangent within SUM_REL of its terms'
    magnitudes."""
    got = env_sample_bwd(env, u3, g_dir, active).cpu()
    if active is not None:
        g_dir = torch.where(active[:, None], g_dir, 0.0)
    ref, mag = env_sample_bwd_plain(*_cpu([env, u3, g_dir]), magnitudes=True)
    return {"max_abs_err": _sum_close("env_sample_bwd g_rotation", got, ref, mag),
            "g_rotation": got.tolist()}


def rgl_lanes(device, n: int = 131072, seed: int = 22, stacked: int = 2):
    """K7T's inputs at a differentiable pass's width: the synthetic RGL
    material of the material_comparison scene (scenes.synthetic_rgl_fields)
    stacked twice (the second with seed 1; with `stacked` more, the k-th
    with seed k, which no lane reads: RGL_STACK_GLOBAL takes the tables of
    both forms past K7T's shared memory, the lanes as on two), and n lanes
    from numpy: mid alternating 0 and 1, wi and wo uniform on the sphere,
    mostly above the surface (|z| flipped up on 7 of 8 lanes), u2 uniform,
    cotangents of f*cos normal. (tables, mid, wi, wo, u2, g_f)."""
    tables = stack_rgl_tables([load_rgl_material(scenes.synthetic_rgl_fields(s))
                               for s in range(stacked)], device)
    rng = np.random.default_rng(seed)

    def dirs():
        x = rng.standard_normal((n, 3))
        x /= np.linalg.norm(x, axis=-1, keepdims=True)
        up = (np.arange(n) % 8) != 7
        x[up, 2] = np.abs(x[up, 2])
        return torch.as_tensor(x.astype(np.float32), device=device)

    mid = torch.as_tensor((np.arange(n) % 2).astype(np.int32), device=device)
    wi, wo = dirs(), dirs()
    u2 = torch.as_tensor(rng.uniform(size=(n, 2)).astype(np.float32), device=device)
    return tables, mid, wi, wo, u2, _f32(rng, (n, 4), device)


def check_rgl_bwd(tables, mid, wi, x, g_f, sample: bool) -> Dict[str, float]:
    """K7T's tail form against its plain version (autograd through K7's
    plain forward) on the same lanes and cotangents, each table within
    SUM_REL of its entries' |term| sums. The plain version runs on the same
    device: K7's plain forward is K7's bits there (kernel_check.check_rgl),
    while on the CPU an ulp of sqrtf or sinf moves a sampled lane's warp
    position and its cells' weights by ~1e-4 (seen on an H100)."""
    args = [tables, mid, wi, x, g_f]
    got = rgl_bwd(*args, sample)
    ref, mag = rgl_bwd_plain(*args, sample, magnitudes=True)
    err = max(_sum_close(f"rgl_bwd {k}", got[k], ref[k], mag[k]) for k in TAIL_TABLES)
    return {"max_abs_err": err, "nonzero_rgb": int((ref["rgb"] != 0).sum())}


def rgl_full_cotangents(n: int, device, seed: int = 25):
    """Random cotangents of K7's pdf [N] and sampled direction [N, 3] for
    K7T's full form, from numpy."""
    rng = np.random.default_rng(seed)
    return _f32(rng, (n,), device), _f32(rng, (n, 3), device)


def rgl_full_reference(tables, mid, wi, x, g_f, sample: bool, g_pdf, g_wo):
    """K7T's full form's plain version in float64 on the float32 inputs
    (autograd through K7's plain forward): the yardstick K7T's full form is
    held to, (cotangents, each table's per-entry sums of |term|). In float32 the plain version differentiates the sample's
    quadratic inversions (a - sqrt(a^2 - 2 A (a - b))) / (a - b) by the
    chain rule, which keeps no correct digit where a approaches b (seen at
    |a - b| ~ 1e-3 (a + b): 100 % off its float64 value on a lane); K7T
    takes that derivative through the rationalized form 2 A / (a + sqrt(D)),
    within ~1e-5 of the float64 chain rule there."""
    f64 = torch.float64
    t64 = RGLTables(*(v.to(f64) if v.is_floating_point() else v for v in tables))
    return rgl_bwd_plain(t64, mid, wi.to(f64), x.to(f64), g_f.to(f64), sample, magnitudes=True,
                         full=True, g_pdf=g_pdf.to(f64),
                         g_wo=None if g_wo is None else g_wo.to(f64))


def check_rgl_bwd_full(tables, mid, wi, x, g_f, sample: bool, g_pdf, g_wo,
                       lane_own_rel: float = 0.0) -> Dict[str, float]:
    """K7T's full form (every table and the directions, from the cotangents
    of f*cos, the pdf and sample's wo) against its plain version in float64
    (`rgl_full_reference`) on the same lanes: each table entry within
    RGL_FULL_REL of its sum of |term|, the lanes' wi (and eval's wo)
    cotangents within LANE_REL of the largest (the lanes that differ
    counted), or, with `lane_own_rel`, a lane within that of its own
    largest component: a render's lanes (`rgl_quad_lanes`) carry cotangents
    of one size, where the sample's float32 chain keeps ~1e-3 of a lane's
    own value (9e-4 seen on 2 of the 128^2 step's 2709 live sample lanes,
    the float32 plain version 2e-1 on one of them) and 1e-4 of the largest
    is below that. Every output finite. Reported: each table's largest
    difference over its entry's sum of |term|, the entries beyond 1e-3 of
    it, and the lanes held to their own magnitude."""
    got = rgl_bwd(tables, mid, wi, x, g_f, sample, full=True, g_pdf=g_pdf, g_wo=g_wo)
    ref, mag = rgl_full_reference(tables, mid, wi, x, g_f, sample, g_pdf, g_wo)
    rel, beyond, bad, res = {}, {}, [], {"max_abs_err": 0.0}
    for k, b in ref.items():
        a = got[k].to(b.dtype)
        if not bool(torch.isfinite(a).all()):
            bad.append(f"{k}: non-finite values")
        err = (a - b).abs()
        if k in ("wi", "wo"):
            lanes = err.max(-1).values
            limit = LANE_REL * float(b.abs().max()) + 1e-30
            res[f"g_{k}_lanes_differ"] = int((lanes > 0).sum())
            over = lanes > limit
            if lane_own_rel:
                res[f"g_{k}_lanes_held_to_their_own"] = int(over.sum())
                over = over & (lanes > lane_own_rel * b.abs().max(-1).values)
            if bool(over.any()):
                bad.append(f"{k}: {int(over.sum())} lanes beyond {limit}")
        else:
            r = err / (mag[k] + 1e-30)
            rel[k], beyond[k] = float(r.max()), int((r > 1e-3).sum())
            if bool((r > RGL_FULL_REL).any()):
                bad.append(f"{k}: {int((r > RGL_FULL_REL).sum())} entries beyond {RGL_FULL_REL} "
                           "of their sums of |term|")
        res["max_abs_err"] = max(res["max_abs_err"], float(err.max()))
    assert not bad, (f"rgl_bwd full: {bad}; each table's largest difference over its entry's "
                     f"sum of |term|: {rel}")
    res["rel"], res["entries_beyond_1e-3"] = rel, beyond
    return res


def rgl_bwd_work(tables, n: int, sample: bool, full: bool = False, live: int = None):
    """K7T: per lane mid, wi, wo (eval) or u2 (sample) and the 4 cotangent
    words read (44 or 40 B; K7T writes none of the forward's outputs), the
    tables read once and their cotangents written once: the tail form's
    rgb, ndf and sigma, the full form's every float table (`GRAD_TABLES`),
    and per lane also the pdf's and sample's wo cotangents read (4 or 16 B)
    and wi's (and eval's wo's) written (12 or 24 B). Flops: the forward's
    (kernel_check.rgl_work's 450 or 900 a lane) and ~150 more for the
    tail's backward (16 corner fetches again, 64 rgb terms, 8 ndf and sigma
    terms); the full form ~700 (eval) or ~1500 (sample) more: the forward's
    reverse mode, every warp read's cotangent into its corners and its
    corner weights, the quadratic inversions' derivatives. `live`: the
    lanes that carry a cotangent (`rgl_live`; all n by default); the others
    need only their cotangents read (and the full form's direction
    cotangents written) and no operation."""
    live = n if live is None else live
    _, flops = kc.rgl_work(tables, live, sample)
    cot = 16 + ((4 + (12 if sample else 0)) if full else 0)
    lane = 4 + 12 + (8 if sample else 12) + cot
    names = GRAD_TABLES if full else TAIL_TABLES
    out = sum(getattr(tables, k).numel() * 4 for k in names)
    if not full:
        return (live * lane + (n - live) * cot + kc._table_bytes(tables) + out,
                flops + live * 150.0)
    written = 12 if sample else 24
    return (live * (lane + written) + (n - live) * (cot + written) + kc._table_bytes(tables) + out,
            flops + live * (1500.0 if sample else 700.0))


def rgl_live(g_f, g_pdf=None, g_wo=None) -> int:
    """K7T's lanes that carry a cotangent: of f*cos and, where given, of the
    pdf and of sample's wo."""
    carry = (g_f != 0).any(-1)
    if g_pdf is not None:
        carry = carry | (g_pdf != 0)
    if g_wo is not None:
        carry = carry | (g_wo != 0).any(-1)
    return int(carry.sum())


def row_scatter_work(g, idx, rows):
    """P0T: the cotangent rows (C words) and an index per lane read, the
    table's cotangent written once; one add per word."""
    n, c = g.shape
    return n * c * 4 + n * 4 + rows * c * 4, n * c


def assemble_hit_bwd_work(lanes):
    """K3T: per lane o, d, t, u, v, prim, backside and the 15 cotangent
    words read (101 B) and g_o, g_d written (24 B); the hit tables read
    once and their cotangents written once. ~260 float operations per
    triangle winner (the interpolated normal, tangent and uv and their
    Gram-Schmidt or ONB backward, the normalize backward, the rows'
    terms, Cramer's rule on the hit equation), ~120 per other lane (the
    sphere's normal, uv and tangent backward, its root's derivative)."""
    ht, prim = lanes["ht"], lanes["prim"]
    n = prim.shape[0]
    n_tri = int(((prim >= 0) & (prim < ht.n_tris)).sum())
    tables = sum(x.numel() * x.element_size() for x in (ht.tri_g, ht.tri_f, ht.sph_f))
    return (n * 125 + 2 * tables + ht.tri_i.numel() * 4,
            n_tri * 260 + (n - n_tri) * 120)


def assemble_hit_anim_bwd_work(lanes):
    """K3aT: K3T's work, and per lane the winner's frame row read (120 B)
    and, per ray, its cotangent written (120 B; at one instant the [A, 30]
    cotangents written once); ~200 more float operations per lane (the
    object-space ray, the three normalize backwards and transposed maps of
    the world frame, the rows' outer products)."""
    nbytes, flops = assemble_hit_bwd_work(lanes)
    fr = lanes["frames"]
    n = lanes["prim"].shape[0]
    rows = n * 120 + (n * 120 if fr.dim() == 3 else 2 * fr.numel() * 4)
    return nbytes + rows, flops + n * 200


def env_radiance_bwd_work(env, d, rotation: bool = False):
    """K8T: per lane the direction and 4 cotangent words read (28 B), the
    direction's cotangent written (12 B); the map's image read once and its
    cotangent written once; with `rotation` the rotation's four floats read
    and their cotangent written (32 B). ~100 float operations per lane (the
    rotation and its transpose, the lookup's coordinates and their
    derivatives, the four taps' 16 products and the two bilinear weights'
    dot products), ~40 more with the rotation's term (the rotation formula's
    backward and the lane's four terms summed). A constant sky: per lane the
    4 cotangent words read and the direction's zero cotangent written (28
    B), the constant's cotangent written once; 4 additions per lane."""
    n = d.shape[0]
    if env.kind == 3:
        return n * 28 + 16, n * 4
    return (n * 40 + 2 * env.image.numel() * 4 + (32 if rotation else 0),
            n * (140 if rotation else 100))


def env_sample_bwd_work(env, u3, g_dir=None):
    """K8T's sample backward: what any version must read, every lane's 3
    cotangent words of the sampled direction (12 B), and the uniforms (12
    B) of the lanes whose cotangent is nonzero (`g_dir`; every lane without
    it: the earlier all-lane count, 24 B a lane), the alias and pdf tables once,
    the rotation read and its cotangent written (32 B). ~60 float
    operations a live lane (the sample's map-space direction again, the
    rotation formula's backward, the lane's four terms summed)."""
    n = u3.shape[0]
    live = n if g_dir is None else int((g_dir != 0).any(-1).sum())
    tables = sum(x.numel() * x.element_size() for x in (env.pdf_table, env.alias_prob,
                                                        env.alias_idx))
    return n * 12 + live * 12 + (tables if live else 0) + 32, live * 60


# ---------------------------------------------------------------------------
# The differentiable frames
# ---------------------------------------------------------------------------

def _camera(camera, width, device):
    pose, vfov = camera
    return make_camera(pose, vfov, width, width, device=device)


def cornell_loss(device, depth: int = GRAD_DEPTH):
    """loss(emission scale, white albedo offset) = mean of the Cornell bench
    frame rendered differentiably (128 x 128, 16 spp in one pass, `depth`)."""
    scene = scenes.cornell_box_ref(device)
    static = SceneStatic.from_scene(scene)
    cam = _camera(scenes.cornell_ref_camera(device), kc.BENCH_WIDTH, device)
    tables = prepare_scene(scene, static, step=False)
    params = RenderParams(max_path_components=depth, differentiable=True)
    sel = torch.zeros_like(scene.materials.albedo)
    sel[0, :3] = 1.0   # material 0 is the white walls

    def loss(s, a):
        m = scene.materials
        sc = scene._replace(materials=m._replace(emissive=m.emissive * s, albedo=m.albedo + sel * a))
        return render_frame(sc, static, cam, CameraConfig(), SensorRGB(), kc.BENCH_WIDTH,
                            kc.BENCH_WIDTH, GRAD_SSQRT, params=params,
                            samples_per_pass=GRAD_SSQRT ** 2, device=device,
                            tables=tables).mean()

    return loss


def sky_loss(device):
    """loss(sky scale) = mean of the envmap_spheres frame (equirect sky,
    128 x 128, 16 spp in one pass, depth 8)."""
    scene = scenes.envmap_spheres(cube=False, device=device)
    static = SceneStatic.from_scene(scene)
    cam = _camera(scenes.envmap_camera(device), kc.ENVMAP_WIDTH, device)
    tables = prepare_scene(scene, static, step=False)
    params = RenderParams(max_path_components=GRAD_DEPTH, differentiable=True)

    def loss(s):
        sc = scene._replace(envmap=scene.envmap._replace(image=scene.envmap.image * s))
        return render_frame(sc, static, cam, CameraConfig(), SensorRGB(), kc.ENVMAP_WIDTH,
                            kc.ENVMAP_WIDTH, GRAD_SSQRT, params=params,
                            samples_per_pass=GRAD_SSQRT ** 2, device=device,
                            tables=tables).mean()

    return loss


SKY_YAW = 0.2                          # the sky's yaw (rad) of its gradient and the fit's target
FIT_YAW_START = SKY_YAW + np.deg2rad(8.0)  # the yaw fit's start, 8 degrees away
FIT_YAW_LR = 1e-2
FIT_YAW_BETAS = (0.5, 0.99)   # Adam's momentum kept short: the default 0.9 overshoots the target
# The yaw's view of envmap_spheres: from the far side of the spheres, (0,
# 0.6, -4) toward (0, 1.5, 0), vfov 70, so that `procedural_sky`'s sun disk
# stands in the frame beside the spheres and a yaw moves it across the
# frame. From the bench view the sun stands behind the camera and a yaw
# shows only through the shadows, whose moving edges the attached gradient
# leaves out (its estimator has no boundary term, as the JAX package's).
SKY_YAW_VIEW = ((0.0, 0.6, -4.0), (0.0, 1.5, 0.0), 70.0)


# The JAX package's CPU yardsticks of the card's new gradients, from
# jax_frame_reference.py (jax.grad on the CPU, float32): sky_yaw_grad (the
# yaw frame's mean and d(mean)/d(yaw) at SKY_YAW, 128 x 128, 16 spp, depth
# 8), rgl_camera_grad (the RGL quad's mean and d(mean)/d(camera height), 12
# x 12, 4 spp, depth 3) and rgl_grad_tables (per RGL table of the quad:
# entries above 1e-6 of its largest |entry|, sum, sum of |entry|, largest
# |entry|; phi_i gets none: P = 1).
SKY_YAW_REF = {"mean": 1.35687255859375, "grad": 2.2581355571746826}
RGL_CAMERA_REF = {"mean": 0.0921129360795021, "grad": 0.014084098860621452}
RGL_TABLE_REFS = {
    'theta_i': (2, 0.011507331859320402, 0.011507331859320402, 0.007175865583121777),
    'ndf': (102, 0.18540481523268681, 0.18540481523268681, 0.012892350554466248),
    'sigma': (117, -0.310621315492142, 0.310621315492142, 0.01557885017246008),
    'vndf_data': (204, 0.037425041337158405, 0.23201810889956676, 0.016493987292051315),
    'vndf_marg': (30, 0.011095859948909492, 0.017983252027988783, 0.003545051207765937),
    'vndf_cond': (194, 0.010378599632986152, 0.5212195931567294, 0.03555300459265709),
    'lum_data': (70, -0.014555646199819972, 0.014666192606906048, 0.0032676830887794495),
    'lum_marg': (6, -0.00022868864687097812, 0.00023553026551326184, 0.00013423842028714716),
    'lum_cond': (24, -0.031657191650083405, 0.035909328993511735, 0.012205570936203003),
    'rgb': (210, 0.18242696100861622, 0.18242696100861622, 0.00734799075871706),
}
# The RGL quad at the grad phase's size (RGL_QUAD_WIDTH^2, RGL_QUAD_SSQRT^2
# spp in one pass, 3 path components; jax_frame_reference.py
# rgl_grad_tables_128): its mean, d(mean)/d(rgb scale) and each table's
# digest as RGL_TABLE_REFS'.
RGL_QUAD_WIDTH = 128
RGL_QUAD_SSQRT = 4
RGL_QUAD_128_REF = {
    "mean": 0.09486538171768188, "grad": 0.09486600077717001,
    "tables": {
        'theta_i': (2, 0.01170760355766065, 0.011707608030483652, 0.007149888202548027),
        'ndf': (141, 0.1904202244545572, 0.1904202244545572, 0.013186207041144371),
        'sigma': (156, -0.3199100606625507, 0.3199100606625507, 0.013557570055127144),
        'vndf_data': (281, 0.08114007575630276, 0.19763375668564395, 0.014168936759233475),
        'vndf_marg': (33, 0.011380542798083315, 0.01827811122793266, 0.0036860553082078695),
        'vndf_cond': (296, 0.08714285224447582, 0.5037254123725033, 0.031955134123563766),
        'lum_data': (78, -0.0022986357409128934, 0.0027231744726625286, 0.0003128187672700733),
        'lum_marg': (14, -9.582969494204008e-05, 0.00022039808175122744, 5.4412656027125195e-05),
        'lum_cond': (78, -0.0022420572811006068, 0.010949918021005978, 0.0008206208003684878),
        'rgb': (249, 0.18756818408823825, 0.18756818408823825, 0.006928988732397556),
    }}
SCALAR_REL = 2e-2   # the card's gradients against the JAX yardsticks
TABLE_REL = 1e-2    # a table's digest: of its sum of |entry| (sum) or largest |entry|


def check_rgl_table_grads(grads: Dict[str, torch.Tensor], refs=None,
                          count_rel: float = 0.0) -> Dict[str, float]:
    """The RGL quad's table gradients (name -> tensor) against `refs` (table
    -> digest; RGL_TABLE_REFS by default): per table the count of entries
    above 1e-6 of its largest |entry| equal (within count_rel of the
    reference's count: RGL_QUAD_128_REF's 262144 lanes reach entries at
    that threshold by their last bits), its sum and sum of |entry| within
    TABLE_REL of the reference's sum of |entry|, its largest |entry| within
    TABLE_REL of the reference's; phi_i zero. Returns each table's largest
    relative difference."""
    assert float(grads["phi_i"].abs().max()) == 0.0, "phi_i got a gradient (P = 1)"
    out = {}
    for k, (above, total, total_abs, largest) in (refs or RGL_TABLE_REFS).items():
        g = grads[k].double()
        m = float(g.abs().max())
        n_above = int((g.abs() > 1e-6 * m).sum())
        d_sum = abs(float(g.sum()) - total) / total_abs
        d_abs = abs(float(g.abs().sum()) - total_abs) / total_abs
        d_max = abs(m - largest) / largest
        assert abs(n_above - above) <= count_rel * above, (
            f"RGL {k}: {n_above} entries above 1e-6 of the largest, JAX {above}")
        assert max(d_sum, d_abs, d_max) <= TABLE_REL, (
            f"RGL {k}: sum {float(g.sum())}, sum |.| {float(g.abs().sum())}, largest {m} "
            f"against JAX's {total}, {total_abs}, {largest}")
        out[k] = max(d_sum, d_abs, d_max)
    return out


def sky_yaw_camera(width: int, device):
    eye, target, vfov = SKY_YAW_VIEW
    return make_camera(from_lookat(eye, target, device=device), vfov, width, width, device=device)


def yaw_rotation(yaw):
    """The world-from-map quaternion [4] (x, y, z, w) of a turn by `yaw`
    (radians, a tensor) about +y, differentiable in yaw."""
    half = 0.5 * yaw
    return torch.stack([0.0 * yaw, torch.sin(half), 0.0 * yaw, torch.cos(half)])


def sky_yaw_loss(device, width: int = 128, ssqrt: int = GRAD_SSQRT, depth: int = GRAD_DEPTH):
    """loss(yaw) = mean of the envmap_spheres frame (equirect sky turned by
    `yaw` about +y: `procedural_sky`'s sun disk moves with it, and with it
    the spheres' shadows and reflections) from SKY_YAW_VIEW, width^2,
    ssqrt^2 spp in one pass, `depth` path components: its gradient runs
    through K8T's rotation term and the sample's backward."""
    scene = scenes.envmap_spheres(cube=False, device=device)
    static = SceneStatic.from_scene(scene)
    cam = sky_yaw_camera(width, device)
    tables = prepare_scene(scene, static, step=False)
    params = RenderParams(max_path_components=depth, differentiable=True)

    def loss(yaw):
        sc = scene._replace(envmap=scene.envmap._replace(rotation=yaw_rotation(yaw)))
        return render_frame(sc, static, cam, CameraConfig(), SensorRGB(), width, width, ssqrt,
                            params=params, samples_per_pass=ssqrt ** 2, device=device,
                            tables=tables).mean()

    return loss


def blurred_mse(img, target):
    """The mean squared error of the two images [H, W, C] after a box blur a
    quarter of the frame wide (stride 1, zero padded): the sun disk (5
    degrees across, 9 pixels of a 128-wide frame at vfov 70) has left its
    target's footprint at a start 8 degrees away, where a plain squared
    error has no slope toward it; blurred, the two disks overlap."""
    k = max(img.shape[1] // 4, 1) | 1

    def blur(x):
        return torch.nn.functional.avg_pool2d(x.permute(2, 0, 1)[None], k, 1, k // 2)

    return torch.mean((blur(img) - blur(target)) ** 2)


def fit_yaw(device, width: int = 128, steps: int = FIT_STEPS, lr: float = FIT_YAW_LR):
    """`fit` of envmap_spheres' sky yaw from FIT_YAW_START to the target
    rendered at SKY_YAW from SKY_YAW_VIEW (width^2, 4 spp, depth 2, Adam at
    `lr`): the FitResult."""
    scene = scenes.envmap_spheres(cube=False, device=device)
    cam = sky_yaw_camera(width, device)
    params = RenderParams(max_path_components=FIT_DEPTH)

    def apply_params(sc, p):
        return sc._replace(envmap=sc.envmap._replace(rotation=yaw_rotation(p["yaw"])))

    # the target with the samples every step draws (`fit`'s first window):
    # at the target's yaw the loss is 0, without the noise of other samples
    target_scene = apply_params(scene, {"yaw": torch.tensor(SKY_YAW, device=device)})
    zero = torch.zeros((width, width, 3), device=device)
    with torch.no_grad():
        target = render_loss(target_scene, SceneStatic.from_scene(target_scene), cam, zero,
                             width=width, height=width, samples_sqrt=FIT_SSQRT,
                             render_params=params, device=device)[1]
    return fit(scene, {"yaw": torch.tensor(FIT_YAW_START, dtype=torch.float32, device=device)},
               apply_params, target, cam=cam, width=width, height=width, samples_sqrt=FIT_SSQRT,
               render_params=params,
               optimizer=lambda ps: torch.optim.Adam(ps, lr=lr, betas=FIT_YAW_BETAS),
               steps=steps, loss_fn=blurred_mse, sample_offset_per_step=False, device=device)


def _lit_quad(material, half, light_at, rgl_fields=None, device="cuda"):
    """A 2 half x 2 half quad of `material` in the xy plane under a diffuse
    sphere light of radius 0.3, radiance 14, at `light_at`, built through
    the port's Scene (the scenes of the JAX package's
    tests/test_gradients_breadth.py texel and RGL table cases)."""
    sc = B.Scene()
    if rgl_fields is not None:
        sc.take_rgl_table("m", rgl_fields)
    sc.take_mesh_instance(B.MeshInstance(G.generate_quad(half, half), material))
    sc.take_sphere(B.SphereObject(light_at, 0.3, B.LightDiffuse(radiance=(14.0,) * 3)),
                   hot_spot=True)
    return sc.build(device=device)


def _breadth_loss(scene, width, vfov, replace, device, ssqrt: int = 2):
    """loss(*x) = mean of `replace(scene, x)` (one x: `replace(scene, x)`)
    rendered differentiably from (0, 0, 2.2) (width^2, ssqrt^2 spp in one
    pass, 3 path components, as the JAX test at ssqrt 2)."""
    static = SceneStatic.from_scene(scene)
    cam = make_camera(from_lookat((0.0, 0.0, 2.2), (0.0, 0.0, 0.0), device=device), vfov,
                      width, width, device=device)
    tables = prepare_scene(scene, static, step=False)
    params = RenderParams(max_path_components=3, differentiable=True)

    def loss(*x):
        return render_frame(replace(scene, x[0] if len(x) == 1 else x), static, cam,
                            CameraConfig(), SensorRGB(), width, width, ssqrt, params=params,
                            samples_per_pass=ssqrt ** 2, device=device, tables=tables).mean()

    return loss


def rgl_table_loss(device, width: int = 12, ssqrt: int = 2):
    """loss(rgb scale) = mean of tests/test_gradients_breadth.py's RGL quad
    (its synthetic measured material is scenes.synthetic_rgl_fields(),
    12 x 12 and 4 spp as the JAX test; RGL_QUAD_WIDTH and RGL_QUAD_SSQRT:
    the grad phase's size): its gradient runs through K7T's tail form."""
    return _breadth_loss(rgl_quad(device), width, 45.0,
                         lambda sc, s: sc._replace(rgl=sc.rgl._replace(rgb=sc.rgl.rgb * s)),
                         device, ssqrt)


def rgl_quad(device):
    """tests/test_gradients_breadth.py's RGL quad (its synthetic measured
    material scenes.synthetic_rgl_fields() on a 2.4 x 2.4 quad under a
    sphere light), built through the port's Scene."""
    return _lit_quad(B.RGLMaterial(table_name="m"), 1.2, (0.4, 0.9, 2.2),
                     scenes.synthetic_rgl_fields(), device)


def rgl_tables_loss(device, width: int = 12, ssqrt: int = 2):
    """loss(*tables) = mean of the RGL quad (width^2, ssqrt^2 spp in one
    pass, 3 path components) with its float tables (`GRAD_TABLES`, in that
    order) replaced: every table on the tape, K7T's full form."""
    return _breadth_loss(rgl_quad(device), width, 45.0,
                         lambda sc, tabs: sc._replace(rgl=sc.rgl._replace(
                             **dict(zip(GRAD_TABLES, tabs)))), device, ssqrt)


def rgl_quad_lanes(device, width: int = RGL_QUAD_WIDTH, ssqrt: int = RGL_QUAD_SSQRT):
    """K7T's inputs as a render hands them: one step of `rgl_tables_loss`
    at width^2, ssqrt^2 spp (K7T's full form) with materials.rgl.rgl_bwd
    wrapped to record its arguments, and of each kind the first bounce's
    (the camera lanes on the quad: the backward's last call of its kind).
    {"eval": (tables, mid, wi, wo, g_f, g_pdf, None), "sample": (tables,
    mid, wi, u2, g_f, g_pdf, g_wo)}: a render's coherent directions and its
    sparse cotangents."""
    from ..materials import rgl as rgl_mod

    calls = {}
    inner = rgl_mod.rgl_bwd

    def record(tables, mid, wi, x, g_f, sample, full=False, g_pdf=None, g_wo=None):
        calls["sample" if sample else "eval"] = tuple(
            a.detach().clone() if isinstance(a, torch.Tensor) else a
            for a in (tables, mid, wi, x, g_f, g_pdf, g_wo))
        return inner(tables, mid, wi, x, g_f, sample, full=full, g_pdf=g_pdf, g_wo=g_wo)

    quad = rgl_quad(device)
    leaves = [getattr(quad.rgl, k).clone().requires_grad_(True) for k in GRAD_TABLES]
    rgl_mod.rgl_bwd = record
    try:
        rgl_tables_loss(device, width, ssqrt)(*leaves).backward()
    finally:
        rgl_mod.rgl_bwd = inner
    return calls


def sky_yaw_lanes(device, width: int = 128, ssqrt: int = GRAD_SSQRT):
    """K8's and K8T's sample backward's inputs as the sky-yaw step hands
    them: one step of `sky_yaw_loss` at width^2, ssqrt^2 spp (forward and
    backward of d(mean)/d(yaw) at SKY_YAW) with the generic bounce's
    `env_miss` and `env_nee` (render/integrator.py's names) and
    `render.backward.env_sample_bwd` wrapped to record their inputs. A dict:
    "env" the turned sky (rotation detached), and per bounce of the
    forward, in bounce order, "miss": (directions [N, 3], escaped [N]: the
    active lanes whose ray missed, whose radiance and pdf are read, active
    [N]), "nee": (uniforms [N, 3], the RANDOM lanes [N]: those that take env
    NEE), "sample_bwd": (uniforms [N, 3], the directions' cotangent [N,
    3], zero on the lanes outside the call's mask). Only entry points every
    version of the port has are wrapped, so an older tree records the same
    lanes with this file copied over its own."""
    from ..render import backward as bw_mod
    from ..render import integrator as it_mod

    rec = {"env": None, "miss": [], "nee": [], "sample_bwd": []}
    forward = [True]
    miss, nee, sample_bwd = it_mod.env_miss, it_mod.env_nee, bw_mod.env_sample_bwd

    def env_miss(sensor, acc, st, env, prim, importance):
        if forward[0]:
            rec["env"] = env._replace(rotation=env.rotation.detach().clone())
            rec["miss"].append((st.d.detach().clone(), (st.active & (prim < 0)).clone(),
                                st.active.clone()))
        return miss(sensor, acc, st, env, prim, importance)

    def env_nee(sensor, env, st, hr, mrow, mat_types, rgl, ue, is_random, geom_len, opt_len):
        if forward[0]:
            rec["nee"].append((ue.detach().clone(), is_random.clone()))
        return nee(sensor, env, st, hr, mrow, mat_types, rgl, ue, is_random, geom_len, opt_len)

    def env_sample_bwd_rec(env, u3, g_dir, *active):
        g = g_dir.detach()   # the cotangents the kernel takes: none on a masked lane
        if active and active[0] is not None:
            g = torch.where(active[0][:, None], g, 0.0)
        rec["sample_bwd"].append((u3.detach().clone(), g.clone()))
        return sample_bwd(env, u3, g_dir, *active)

    it_mod.env_miss, it_mod.env_nee, bw_mod.env_sample_bwd = env_miss, env_nee, env_sample_bwd_rec
    try:
        yaw = torch.tensor(SKY_YAW, dtype=torch.float32, device=device, requires_grad=True)
        value = sky_yaw_loss(device, width, ssqrt)(yaw)
        forward[0] = False
        value.backward()
    finally:
        it_mod.env_miss, it_mod.env_nee, bw_mod.env_sample_bwd = miss, nee, sample_bwd
    rec["sample_bwd"].reverse()   # the backward runs the bounces last to first
    return rec


def sky_yaw_shares(lanes) -> Dict[str, list]:
    """Per bounce of `sky_yaw_lanes`, the shares of all lanes: active,
    escaped (their sky radiance is deposited), taking env NEE and carrying
    a nonzero cotangent into K8T's sample backward."""
    n = lanes["miss"][0][0].shape[0]

    def share(x):
        return float(x.sum()) / n

    return {"active": [share(a) for _, _, a in lanes["miss"]],
            "escaped": [share(e) for _, e, _ in lanes["miss"]],
            "env_nee": [share(r) for _, r in lanes["nee"]],
            "cotangent": [share((g != 0).any(-1)) for _, g in lanes["sample_bwd"]]}


def rgl_camera_loss(device, width: int = 12):
    """loss(camera height offset) = mean of the RGL quad seen from (0, dy,
    2.2) (width^2, 4 spp, 3 path components): the lane directions on the
    tape (K7T's full form, with K3T)."""
    scene = rgl_quad(device)
    static = SceneStatic.from_scene(scene)
    cam = make_camera(from_lookat((0.0, 0.0, 2.2), (0.0, 0.0, 0.0), device=device), 45.0, width,
                      width, device=device)
    tables = prepare_scene(scene, static, step=False)
    params = RenderParams(max_path_components=3, differentiable=True)
    up = torch.tensor([0.0, 1.0, 0.0], device=device)

    def loss(dy):
        t = cam.transformation
        c2 = cam._replace(transformation=t._replace(translation=t.translation + up * dy))
        return render_frame(scene, static, c2, CameraConfig(), SensorRGB(), width, width, 2,
                            params=params, samples_per_pass=4, device=device,
                            tables=tables).mean()

    return loss


def texel_loss(device):
    """loss(texel) = mean of tests/test_gradients_breadth.py's textured quad
    (a 4 x 4 image albedo of 0.5, 16 x 16) with texel (1, 1) set to the
    value (float16, as the stack holds it): the lookup's gather backward."""
    tex = B.ImageTexture(image=np.full((4, 4, 3), 0.5, np.float32), srgb=False)
    scene = _lit_quad(B.Lambertian(albedo=tex), 1.0, (0.5, 0.8, 2.5), device=device)

    def replace(sc, s):
        img = sc.textures.img_data.clone()
        img[0, 1, 1, :] = s.to(torch.float16)
        return sc._replace(textures=sc.textures._replace(img_data=img))

    return _breadth_loss(scene, 16, 45.0, replace, device)


def floor_loss(device, width: int = 128):
    """loss(camera height offset) = mean of the sphere-lit floor frame
    (width^2, 4 spp in one pass, depth 4). Its central difference at width
    128 takes eps 1e-2 (FLOOR_EPS): the NEE shadow rays that graze the
    sphere light's silhouette flip their visibility as the camera moves (a
    boundary term, which the attached estimator leaves out), and at eps
    1e-3 six such flips of one sample's whole contribution dominate the
    difference (+0.0027 against the gradient's -0.0095 on the CPU); at 1e-2
    they average to -0.0101. The JAX test's own size (12^2, eps 1e-3) sees
    none."""
    scene = scenes.sphere_lit_floor(device)
    static = SceneStatic.from_scene(scene)
    cam = _camera(scenes.sphere_lit_floor_camera(device), width, device)
    tables = prepare_scene(scene, static, step=False)
    params = RenderParams(max_path_components=4, differentiable=True)
    up = torch.tensor([0.0, 1.0, 0.0], device=device)

    def loss(dy):
        t = cam.transformation
        c2 = cam._replace(transformation=t._replace(translation=t.translation + up * dy))
        return render_frame(scene, static, c2, CameraConfig(), SensorRGB(), width, width,
                            FLOOR_SSQRT, params=params, samples_per_pass=FLOOR_SSQRT ** 2,
                            device=device, tables=tables).mean()

    return loss


def fit_albedo(device, width: int = 128, steps: int = FIT_STEPS):
    """`fit` of the lit quad's albedo from (0.4, 0.4, 0.4) to the target
    rendered with (0.7, 0.2, 0.5) (tests/test_inverse.py:29-53 at width^2,
    4 spp, depth 2, Adam at 5e-2): the FitResult."""
    cam = _camera(scenes.lit_quad_camera(device), width, device)
    params = RenderParams(max_path_components=FIT_DEPTH)
    target_scene = scenes.lit_quad((0.7, 0.2, 0.5), device=device)
    target = render_frame(target_scene, SceneStatic.from_scene(target_scene), cam, CameraConfig(),
                          SensorRGB(), width, width, FIT_SSQRT, params=params, device=device)

    def apply_params(scene, p):
        m = scene.materials
        row = torch.cat([p["albedo"], m.albedo[0, 3:]])[None]
        return scene._replace(materials=m._replace(albedo=torch.cat([row, m.albedo[1:]], 0)))

    return fit(scenes.lit_quad((0.4, 0.4, 0.4), device=device),
               {"albedo": torch.full((3,), 0.4, device=device)}, apply_params, target,
               cam=cam, width=width, height=width, samples_sqrt=FIT_SSQRT,
               render_params=params,
               optimizer=lambda ps: torch.optim.Adam(ps, lr=5e-2), steps=steps, device=device)


# ---------------------------------------------------------------------------
# A differentiable animated scene over a shutter (K3aT)
# ---------------------------------------------------------------------------

MOVING_FLOOR_KEY = 1    # the floor's animation id; its keyframe 1's y translation is a parameter


def moving_floor(device="cuda"):
    """A 10 x 10 Lambertian floor keyframed from y = -0.5 at t = 0 to y =
    -0.3 at t = 1 (animation 1) under a static 0.6 x 0.6 triangle light at
    y = 1.5 facing down, built through the port's Scene over [0, 1]. The
    camera (`moving_floor_camera`) sees the floor and the light only: no
    silhouette moves with the floor, so a frame's mean is smooth in its
    pose and a central difference agrees with the attached estimator."""
    sc = B.Scene()
    up = quat_from_axis_angle((1.0, 0.0, 0.0), -np.pi / 2)
    down = quat_from_axis_angle((1.0, 0.0, 0.0), np.pi / 2)
    aid = sc.take_animation(B.AnimationKeyframes([0.0, 1.0], [
        Transformation.make(translation=(0.0, -0.5, 0.0)),
        Transformation.make(translation=(0.0, -0.3, 0.0))]))
    sc.take_mesh_instance(B.MeshInstance(G.generate_quad(5.0, 5.0),
                                         B.Lambertian(albedo=(0.7, 0.6, 0.5)),
                                         Transformation.make(rotation=up), animation=aid))
    sc.take_mesh_instance(B.MeshInstance(G.generate_quad(0.3, 0.3),
                                         B.LightDiffuse(radiance=(12.0,) * 3),
                                         Transformation.make(translation=(0.0, 1.5, 0.0),
                                                             rotation=down)), hot_spot=True)
    return sc.build(t0=0.0, t1=1.0, device=device)


def moving_floor_camera(device="cuda"):
    """The moving floor's viewpoint: (pose, vfov_deg)."""
    return from_lookat((0.0, 0.6, 2.5), (0.0, -0.5, 0.0), device=device), 40.0


def moving_floor_loss(scene, device, width: int = 16, ssqrt: int = 2, depth: int = 3):
    """loss(vertex offset, key offset) = mean of `scene` (moving_floor, or
    the same scene built by the JAX package and carried across) rendered
    differentiably over the shutter [0, 1] (width^2, ssqrt^2 spp in one
    pass, `depth` path components): the animated floor's triangles' p0
    raised by the vertex offset in object space, and its animation's
    keyframe 1 raised by the key offset. Its gradients reach the triangles'
    rows through K3aT and the keyframe table through K3aT's frame-row
    cotangents and autograd through the per-ray rows."""
    static = SceneStatic.from_scene(scene)
    cam = _camera(moving_floor_camera(device), width, device)
    params = RenderParams(max_path_components=depth, differentiable=True)
    aid = MOVING_FLOOR_KEY
    vsel = torch.zeros_like(scene.tris.p0)
    vsel[:, 1] = (scene.tris.anim == aid).to(vsel.dtype)
    ksel = torch.zeros_like(scene.anims.trans)
    ksel[aid, 1, 1] = 1.0

    def loss(dv, dk):
        T = scene.tris
        tris = T._replace(p0=T.p0 + vsel * dv, v1=T.v1 + vsel * dv, v2=T.v2 + vsel * dv)
        sc = scene._replace(tris=tris,
                            anims=scene.anims._replace(trans=scene.anims.trans + ksel * dk))
        return render_frame(sc, static, cam, CameraConfig(), SensorRGB(), width, width, ssqrt,
                            0.0, 1.0, params=params, samples_per_pass=ssqrt ** 2,
                            device=device).mean()

    return loss
