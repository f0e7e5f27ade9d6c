"""The plain backward versions of P0T, K3T, K3aT and K8T (render/backward.py,
K8T's rotation term and its sample's backward too) against autograd
through a differentiable plain forward of the same function, their and
K7T's autograd Functions' wiring, and what the differentiable render
refuses.

Each plain backward is explicit PyTorch arithmetic; the reference is
`torch.autograd.grad` through `row_gather_diff_plain` (indexing),
`assemble_hit_diff_plain` (K3's plain version with the winner's t, u, v
recomputed on the tape: Moller-Trumbore for a triangle, the quadratic's
root for a sphere) and K8's plain version `env_radiance_plain`, on
random cotangents from a seed. Tolerances: 1e-4 of each output's largest
magnitude (1e-5 where the sums are short; 3e-4 on rtiow, whose grazing
sphere hits, |cos| down to 0.07, scale float32 rounding by 1 / |cos| in
the plain version). K3T's reference runs in float64:
in float32 the sphere root's derivative through the quadratic's
discriminant cancels (5 % off on grazing rays of rtiow, t ~ 11), which the
hit equation's derivative does not; and the cast's t of a sphere is
replaced by the exact root first (the K1 quadratic's is within ~1e-4 of it
at rtiow's distances, and the two derivatives differ by as much)."""

import ast
from pathlib import Path

import numpy as np
import pytest
import torch

from wurblpt_tpu_torch import CameraConfig, RenderParams, SceneStatic, SensorRGB, make_camera
from wurblpt_tpu_torch import render_frame, render_frame_wavefront
from wurblpt_tpu_torch.core.transform import from_lookat
from wurblpt_tpu_torch.materials import rgl
from wurblpt_tpu_torch.render import backward as bw
from wurblpt_tpu_torch.render.bsdf import gather_material_rows, pack_material_table
from wurblpt_tpu_torch.render.envmap import (EnvironmentMapConstant, build_envmap_arrays,
                                             env_radiance, env_radiance_plain, env_sample,
                                             env_sample_plain)
from wurblpt_tpu_torch.render.gather import row_gather
from wurblpt_tpu_torch.render.intersect import assemble_hit, build_hit_tables
from wurblpt_tpu_torch.render.intersect_brute import build_brute_scene, closest_hit
from wurblpt_tpu_torch.render.intersect_sweep import build_sweep_scene, closest_sweep_plain
from wurblpt_tpu_torch.scene.animation import frames_ray_to_object
from wurblpt_tpu_torch.utils import kernel_check as kc
from wurblpt_tpu_torch.utils import scenes

torch.set_num_threads(2)

REL = 1e-4
REPO = Path(__file__).resolve().parent.parent


def _close(got, ref, what, rel=REL):
    assert torch.isfinite(ref).all() and torch.isfinite(got).all(), what
    scale = float(ref.abs().max()) if ref.numel() else 0.0
    err = float((got - ref).abs().max()) if ref.numel() else 0.0
    assert err <= rel * scale + 1e-7, f"{what}: {err} against scale {scale}"


# ---------------------------------------------------------------------------
# P0T
# ---------------------------------------------------------------------------

def test_p0t_plain_matches_autograd_with_clamped_indices():
    gen = torch.Generator().manual_seed(0)
    table = torch.randn(7, 23, generator=gen, dtype=torch.float32)
    idx = torch.randint(-3, 10, (5000,), generator=gen, dtype=torch.int32)
    g = torch.randn(5000, 23, generator=gen)
    leaf = table.clone().requires_grad_(True)
    (ref,) = torch.autograd.grad((bw.row_gather_diff_plain(leaf, idx) * g).sum(), leaf)
    _close(bw.row_scatter_plain(g, idx, 7), ref, "row_scatter_plain", 1e-5)
    # the autograd Function behind row_gather takes the same backward
    leaf2 = table.clone().requires_grad_(True)
    (got,) = torch.autograd.grad((row_gather(leaf2, idx) * g).sum(), leaf2)
    assert torch.equal(got, bw.row_scatter_plain(g, idx, 7))


def test_material_rows_carry_the_float_columns_gradients():
    """The packed material table keeps its float columns on the tape; the
    int32 columns (typ, flags, rgl_id bit patterns) get none."""
    m = scenes.cornell_box_ref("cpu").materials
    albedo = m.albedo.clone().requires_grad_(True)
    packed = pack_material_table(m._replace(albedo=albedo))
    ids = torch.tensor([0, 1, 1, 3, 2, 0], dtype=torch.int32)
    rows = gather_material_rows(packed, ids)
    assert torch.equal(rows.typ, m.typ[ids.long()]) and torch.equal(rows.flags, m.flags[ids.long()])
    (g,) = torch.autograd.grad(rows.albedo.sum(), albedo)
    expect = torch.zeros_like(m.albedo).index_add_(0, ids.long(), torch.ones(6, 4))
    assert torch.equal(g, expect)


# ---------------------------------------------------------------------------
# K3T
# ---------------------------------------------------------------------------

def _lanes(name, side=24):
    build, camera = {"cornell": (scenes.cornell_box_ref, scenes.cornell_ref_camera),
                     "envmap": (scenes.envmap_spheres, scenes.envmap_camera),
                     "rtiow": (scenes.rtiow, scenes.rtiow_camera)}[name]
    scene = build(device="cpu")
    o, d, tmin, tmax = kc.camera_lanes(side, side, 1, "cpu", camera=camera("cpu"))
    t, prim, u, v = closest_hit(build_brute_scene(scene), o, d, tmin, tmax)
    ht = build_hit_tables(scene)
    # a sphere winner's exact root (float64), so that the forward point lies on it
    sph = (prim >= ht.n_tris) & (prim >= 0)
    if bool(sph.any()):
        row = ht.sph_f[(prim[sph] - ht.n_tris).long()].double()
        oc = o[sph].double() - row[:, :3]
        dd = d[sph].double()
        a, hb = (dd * dd).sum(-1), (oc * dd).sum(-1)
        disc = hb * hb - a * ((oc * oc).sum(-1) - row[:, 3] ** 2)
        r1, r2 = (-hb - disc.clamp_min(0).sqrt()) / a, (-hb + disc.clamp_min(0).sqrt()) / a
        near = (r1 - t[sph].double()).abs() <= (r2 - t[sph].double()).abs()
        t = t.clone()
        t[sph] = torch.where(near, r1, r2).float()
    return ht, o, d, t, prim, u, v


def _cotangents(n, seed, zero=()):
    gen = torch.Generator().manual_seed(seed)
    gs = [torch.randn(n, k, generator=gen) for k in (1, 3, 3, 3, 3, 2)]
    gs[0] = gs[0][:, 0].contiguous()
    return [torch.zeros_like(g) if i in zero else g for i, g in enumerate(gs)]


@pytest.mark.parametrize("name, zero", [
    ("cornell", ()),                 # triangle winners, ONB tangents, miss lanes
    ("envmap", ()),                  # triangles and spheres together
    ("rtiow", ()),                   # spheres alone, their uv and tangent
    ("rtiow", (5,)),                 # without uv's cotangent (a render's)
], ids=["cornell", "envmap", "rtiow", "rtiow_no_uv"])
def test_k3t_plain_matches_autograd(name, zero):
    ht, o, d, t, prim, u, v = _lanes(name)
    assert bool((prim < 0).any()) or name == "cornell"
    gs = _cotangents(o.shape[0], 1, zero)
    f64 = torch.float64
    leaves = [x.to(f64).requires_grad_(True) for x in (o, d, ht.tri_g, ht.tri_f, ht.sph_f)]
    rec = bw.assemble_hit_diff_plain(ht._replace(tri_g=leaves[2], tri_f=leaves[3],
                                                 sph_f=leaves[4]), leaves[0], leaves[1],
                                     t.to(f64), prim, u.to(f64), v.to(f64))
    outs = (rec.t, rec.position, rec.normal, rec.geom_normal, rec.tangent, rec.uv)
    ref = torch.autograd.grad(sum((a * g.to(f64)).sum() for a, g in zip(outs, gs)), leaves,
                              allow_unused=True)
    backside = assemble_hit(ht, o, d, t, prim, u, v).backside
    assert torch.equal(backside, rec.backside)
    got = bw.assemble_hit_bwd_plain(ht, o, d, t, prim, u, v, backside, *gs)
    rel = 3e-4 if name == "rtiow" else REL
    for what, a, b in zip(("g_o", "g_d", "g_tri_g", "g_tri_f", "g_sph_f"), got, ref):
        _close(a, torch.zeros_like(a) if b is None else b.float(), f"{name} {what}", rel)
    rec = assemble_hit(ht, o, d, t, prim, u, v)
    # the Function behind assemble_hit takes the same backward and forward
    leaves2 = [x.clone().requires_grad_(True) for x in (o, d, ht.tri_g, ht.tri_f, ht.sph_f)]
    rec2 = assemble_hit(ht._replace(tri_g=leaves2[2], tri_f=leaves2[3], sph_f=leaves2[4]),
                        leaves2[0], leaves2[1], t, prim, u, v)
    for f in ("position", "normal", "geom_normal", "tangent", "uv", "mat", "backside"):
        assert torch.equal(getattr(rec2, f), getattr(rec, f)), f
    outs2 = (rec2.t, rec2.position, rec2.normal, rec2.geom_normal, rec2.tangent, rec2.uv)
    got2 = torch.autograd.grad(sum((a * g).sum() for a, g in zip(outs2, gs)), leaves2,
                               allow_unused=True)
    for a, b in zip(got2, got):
        assert torch.equal(a, b)


def _anim_lanes(spheres, per_ray):
    """The animated box (with its two spheres) seen by 24 x 24 camera lanes,
    cast with the frame's rows at one instant or each lane's own rows at a
    random time; a sphere winner's t the exact root of its object-space
    quadratic (float64), so that the forward point lies on it."""
    scene = scenes.cornell_box_animated("cpu", spheres=spheres)
    o, d, tmin, tmax = kc.camera_lanes(24, 24, 1, "cpu")
    fr = kc.frames_per_ray_at(scene, o.shape[0]) if per_ray else kc.frames_at(scene)
    t, prim, u, v = closest_sweep_plain(build_sweep_scene(scene), o, d, tmin, tmax, fr)
    ht = build_hit_tables(scene)
    sph = (prim >= ht.n_tris) & (prim >= 0)
    if bool(sph.any()):
        si = (prim[sph] - ht.n_tris).long()
        oa, da, _ = frames_ray_to_object(fr[sph] if per_ray else fr, ht.sph_anim[si], o[sph],
                                         d[sph])
        row = ht.sph_f[si].double()
        oc, dd = oa.double() - row[:, :3], da.double()
        a, hb = (dd * dd).sum(-1), (oc * dd).sum(-1)
        disc = hb * hb - a * ((oc * oc).sum(-1) - row[:, 3] ** 2)
        r1, r2 = (-hb - disc.clamp_min(0).sqrt()) / a, (-hb + disc.clamp_min(0).sqrt()) / a
        near = (r1 - t[sph].double()).abs() <= (r2 - t[sph].double()).abs()
        t = t.clone()
        t[sph] = torch.where(near, r1, r2).float()
    return ht, o, d, t, prim, u, v, fr


@pytest.mark.parametrize("spheres", [False, True], ids=["box", "box with spheres"])
@pytest.mark.parametrize("per_ray", [False, True], ids=["one instant", "per ray"])
def test_k3at_plain_matches_autograd(spheres, per_ray):
    """K3aT's plain version (the animated assembly's backward, with the
    frame rows' cotangents) against autograd in float64 through K3a's
    plain version with the winner's t, u, v recomputed in its object space
    (`assemble_hit_diff_plain` with frames): 1e-4 of each output's largest
    (3e-4 with sphere winners, as K3T's on rtiow); and the Function behind
    assemble_hit takes the same backward and forward."""
    ht, o, d, t, prim, u, v, fr = _anim_lanes(spheres, per_ray)
    gs = _cotangents(o.shape[0], 2)
    f64 = torch.float64
    leaves = [x.to(f64).requires_grad_(True) for x in (o, d, ht.tri_g, ht.tri_f, ht.sph_f, fr)]
    rec = bw.assemble_hit_diff_plain(ht._replace(tri_g=leaves[2], tri_f=leaves[3],
                                                 sph_f=leaves[4]), leaves[0], leaves[1],
                                     t.to(f64), prim, u.to(f64), v.to(f64), leaves[5])
    outs = (rec.t, rec.position, rec.normal, rec.geom_normal, rec.tangent, rec.uv)
    ref = torch.autograd.grad(sum((a * g.to(f64)).sum() for a, g in zip(outs, gs)), leaves,
                              allow_unused=True)
    backside = assemble_hit(ht, o, d, t, prim, u, v, fr).backside
    assert torch.equal(backside, rec.backside)
    got = bw.assemble_hit_bwd_plain(ht, o, d, t, prim, u, v, backside, *gs, frames=fr)
    rel = 3e-4 if spheres else REL
    for what, a, b in zip(("g_o", "g_d", "g_tri_g", "g_tri_f", "g_sph_f", "g_frames"), got, ref):
        _close(a, torch.zeros_like(a) if b is None else b.float(), what, rel)
    assert float(got[5].abs().sum()) > 0
    leaves2 = [x.clone().requires_grad_(True) for x in (o, d, ht.tri_g, ht.tri_f, ht.sph_f, fr)]
    rec2 = assemble_hit(ht._replace(tri_g=leaves2[2], tri_f=leaves2[3], sph_f=leaves2[4]),
                        leaves2[0], leaves2[1], t, prim, u, v, leaves2[5])
    ref_rec = assemble_hit(ht, o, d, t, prim, u, v, fr)
    for f in ("position", "normal", "geom_normal", "tangent", "uv", "mat", "backside"):
        assert torch.equal(getattr(rec2, f), getattr(ref_rec, f)), f
    outs2 = (rec2.t, rec2.position, rec2.normal, rec2.geom_normal, rec2.tangent, rec2.uv)
    got2 = torch.autograd.grad(sum((a * g).sum() for a, g in zip(outs2, gs)), leaves2,
                               allow_unused=True)
    for a, b in zip(got2, got):
        assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# K8T
# ---------------------------------------------------------------------------

def _sky_dirs(n, seed):
    """Random unit directions and the cube's face centres, edges and corners
    and the equirect map's seam (x = 0, z < 0), the poles left out (atan2's
    derivative is 0 / 0 there, in both)."""
    d = torch.randn(n, 3, generator=torch.Generator().manual_seed(seed))
    edges = torch.tensor([[1.0, 0.0, 0.2], [-1.0, 0.1, 0.0], [0.2, 0.0, 1.0], [0.0, 0.3, -1.0],
                          [1.0, 1.0, 0.0], [1.0, 1.0, 1.0], [-1.0, 1.0, -1.0], [0.0, -0.2, -1.0],
                          [1e-4, 0.2, -0.98], [-1e-4, 0.2, -0.98], [0.5, 1.0, 0.0]])
    d = torch.cat([d, edges])
    return (d / torch.linalg.norm(d, dim=-1, keepdim=True)).contiguous()


def _sky(kind, rotated):
    if kind == "constant":
        env = build_envmap_arrays(EnvironmentMapConstant((0.3, 0.5, 0.7)), "cpu")
    else:
        env = scenes.envmap_spheres(cube=kind == "cube", device="cpu").envmap
    if rotated:   # grad_check.SKY_ROTATION, normalized
        q = torch.tensor([0.1, 0.3, -0.2, 0.9])
        env = env._replace(rotation=q / torch.linalg.norm(q))
    return env


@pytest.mark.parametrize("rotated", [False, True], ids=["identity", "rotated"])
@pytest.mark.parametrize("kind", ["equirect", "cube", "constant"])
def test_k8t_plain_matches_autograd(kind, rotated):
    """K8T's plain version against autograd through env_radiance_plain: the
    cotangents of the direction, the image, the constant radiance and the
    map's rotation (1e-4 of each output's largest; the rotation's, a sum
    over the lanes, of the sum of its terms' magnitudes)."""
    env = _sky(kind, rotated)
    d = _sky_dirs(4096, 2)
    g = torch.randn(d.shape[0], 4, generator=torch.Generator().manual_seed(3))
    fields = (d, env.image, env.const_radiance, env.rotation)
    leaves = [x.clone().requires_grad_(True) for x in fields]
    out = env_radiance_plain(env._replace(image=leaves[1], const_radiance=leaves[2],
                                          rotation=leaves[3]), leaves[0])
    ref = torch.autograd.grad((out * g).sum(), leaves, allow_unused=True)
    got = bw.env_radiance_bwd_plain(env, d, g, magnitudes=True)
    for what, a, b in zip(("g_d", "g_image", "g_const"), got, ref):
        _close(a, torch.zeros_like(a) if b is None else b, f"{kind} {what}")
    g_rot = torch.zeros(4) if ref[3] is None else ref[3]
    assert float((got[3] - g_rot).abs().max()) <= REL * float(got[6].max()) + 1e-7, (got[3], g_rot)
    assert (kind == "constant") == (float(got[6].max()) == 0.0)
    # the Function behind env_radiance
    leaves2 = [x.clone().requires_grad_(True) for x in fields]
    out2 = env_radiance(env._replace(image=leaves2[1], const_radiance=leaves2[2],
                                     rotation=leaves2[3]), leaves2[0])
    assert torch.equal(out2, out)
    got2 = torch.autograd.grad((out2 * g).sum(), leaves2, allow_unused=True)
    for a, b in zip(got2, got[:4]):
        assert torch.equal(torch.zeros_like(b) if a is None else a, b)


@pytest.mark.parametrize("rotated", [False, True], ids=["identity", "rotated"])
def test_k8t_sample_plain_matches_autograd(rotated):
    """K8T's sample backward (the rotation's cotangent from that of the
    sampled directions) against autograd through env_sample_plain, and the
    Function behind env_sample (its pdf carries no gradient)."""
    env = _sky("equirect", rotated)
    u3 = torch.rand(8192, 3, generator=torch.Generator().manual_seed(4))
    g = torch.randn(8192, 3, generator=torch.Generator().manual_seed(5))
    leaf = env.rotation.clone().requires_grad_(True)
    d, pdf = env_sample_plain(env._replace(rotation=leaf), u3)
    (ref,) = torch.autograd.grad((d * g).sum(), leaf)
    got, mag = bw.env_sample_bwd_plain(env, u3, g, magnitudes=True)
    assert float((got - ref).abs().max()) <= REL * float(mag.max()), (got, ref)
    leaf2 = env.rotation.clone().requires_grad_(True)
    d2, pdf2 = env_sample(env._replace(rotation=leaf2), u3)
    assert torch.equal(d2, d) and torch.equal(pdf2, pdf) and not pdf2.requires_grad
    (got2,) = torch.autograd.grad((d2 * g).sum(), leaf2)
    assert torch.equal(got2, bw.env_sample_bwd_plain(env, u3, g))


@pytest.mark.parametrize("sample", [False, True], ids=["eval", "sample"])
def test_k7t_functions_take_every_table_and_direction(sample):
    """rgl_eval / rgl_sample with every float table and the lane directions
    on the tape (K7T's full form; the plain version on CPU tensors): their
    gradients, from the cotangents of f*cos, the pdf and sample's wo, are
    autograd's through the plain forward (within 1e-5 of each output's
    largest); the pdf is on the tape. With only rgb, ndf and sigma on the tape (the tail form) the pdf
    and wo are not."""
    from wurblpt_tpu_torch.utils import grad_check as gc

    tables, mid, wi, wo, u2, g_f = gc.rgl_lanes("cpu", n=2048)
    g_pdf, g_wo = gc.rgl_full_cotangents(2048, "cpu")
    x = u2 if sample else wo
    names = rgl.GRAD_TABLES
    leaves = {k: getattr(tables, k).clone().requires_grad_(True) for k in names}
    leaves["wi"] = wi.clone().requires_grad_(True)
    if not sample:
        leaves["wo"] = x.clone().requires_grad_(True)
    t = tables._replace(**{k: leaves[k] for k in names})
    if sample:
        wo_s, f, pdf, _ = rgl.rgl_sample(t, mid, leaves["wi"], x)
        loss = (f * g_f).sum() + (pdf * g_pdf).sum() + (wo_s * g_wo).sum()
    else:
        f, pdf = rgl.rgl_eval(t, mid, leaves["wi"], leaves["wo"])
        loss = (f * g_f).sum() + (pdf * g_pdf).sum()
    assert pdf.requires_grad
    got = dict(zip(leaves, torch.autograd.grad(loss, list(leaves.values()), allow_unused=True)))
    ref = rgl.rgl_bwd_plain(tables, mid, wi, x, g_f, sample, full=True, g_pdf=g_pdf,
                            g_wo=g_wo if sample else None)
    for k, b in ref.items():   # the scatter-adds' order varies with the threads: not bits
        _close(torch.zeros_like(b) if got[k] is None else got[k], b, k, 1e-5)
    # phi_i: P = 1, no gradient; eval reads the luminance warp's density only
    unread = ("phi_i",) if sample else ("phi_i", "lum_marg", "lum_cond")
    for k in rgl.GRAD_TABLES:
        assert (float(ref[k].abs().max()) > 0) == (k not in unread), k
    tail = {k: getattr(tables, k).clone().requires_grad_(True) for k in rgl.TAIL_TABLES}
    t = tables._replace(**tail)
    out = rgl.rgl_sample(t, mid, wi, x) if sample else rgl.rgl_eval(t, mid, wi, x)
    assert out[1 if sample else 0].requires_grad
    assert not out[2 if sample else 1].requires_grad and not out[0 if sample else 1].requires_grad


# ---------------------------------------------------------------------------
# Refusals and what the port imports
# ---------------------------------------------------------------------------

DIFF = RenderParams(max_path_components=2, differentiable=True)


def _render(scene, **kw):
    pose, vfov = scenes.cornell_ref_camera("cpu")
    cam = make_camera(pose, vfov, 4, 4, device="cpu")
    return render_frame(scene, SceneStatic.from_scene(scene), cam, CameraConfig(), SensorRGB(),
                        4, 4, 1, device="cpu", **kw)


def test_differentiable_mode_refuses_what_it_cannot_take():
    """Everything the JAX package differentiates renders on the tape: an RGL
    material's warp tables and parameter grids (K7T's full form; its rgb,
    ndf and sigma take the tail form), a sky rotation (K8T's rotation term
    and the sample's backward) and an animated scene (K3aT; the JAX
    comparison is in tests/test_torch_motion_blur.py and
    test_torch_gradients_breadth.py), each with a finite, nonzero gradient.
    The wavefront renderer refuses differentiable params."""
    from wurblpt_tpu_torch.utils import grad_check as gc

    # the city: lanes of other materials hand K7T zero directions (finite: no 0 x NaN)
    city = scenes.city_night(terrain_res=8, n_buildings=3, n_windows=4, sphere_slices=4,
                             device="cpu")
    assert bool(torch.isfinite(_render(city, params=DIFF)).all())
    vndf = city.rgl.vndf_data.clone().requires_grad_(True)
    img = _render(city._replace(rgl=city.rgl._replace(vndf_data=vndf)), params=DIFF)
    (g,) = torch.autograd.grad(img.mean(), vndf)
    assert bool(torch.isfinite(g).all())
    quad = gc.rgl_quad("cpu")
    vndf = quad.rgl.vndf_data.clone().requires_grad_(True)
    theta = quad.rgl.theta_i.clone().requires_grad_(True)
    cam = make_camera(from_lookat((0.0, 0.0, 2.2), (0.0, 0.0, 0.0), device="cpu"), 45.0, 4, 4,
                      device="cpu")
    sc = quad._replace(rgl=quad.rgl._replace(vndf_data=vndf, theta_i=theta))
    img = render_frame(sc, SceneStatic.from_scene(sc), cam, CameraConfig(), SensorRGB(), 4, 4, 1,
                       params=DIFF, device="cpu")
    for leaf in torch.autograd.grad(img.mean(), (vndf, theta)):
        assert bool(torch.isfinite(leaf).all()) and float(leaf.abs().sum()) > 0
    anim = scenes.cornell_box_animated("cpu")
    trans = anim.anims.trans.clone().requires_grad_(True)
    img = _render(anim._replace(anims=anim.anims._replace(trans=trans)), params=DIFF, t0=0.0,
                  t1=1.0)
    (g,) = torch.autograd.grad(img.mean(), trans)
    assert bool(torch.isfinite(g).all()) and float(g.abs().sum()) > 0
    env_scene = scenes.envmap_spheres(device="cpu")
    rot = env_scene.envmap.rotation.clone().requires_grad_(True)
    rotated = env_scene._replace(envmap=env_scene.envmap._replace(rotation=rot))
    (g,) = torch.autograd.grad(_render(rotated, params=DIFF).mean(), rot)
    assert bool(torch.isfinite(g).all()) and float(g.abs().sum()) > 0
    (g,) = torch.autograd.grad(env_radiance(rotated.envmap, torch.tensor([[0.6, 0.0, 0.8]])).sum(),
                               rot)
    assert bool(torch.isfinite(g).all()) and float(g.abs().sum()) > 0
    cornell = scenes.cornell_box_ref("cpu")
    pose, vfov = scenes.cornell_ref_camera("cpu")
    with pytest.raises(ValueError, match="inference only"):
        render_frame_wavefront(cornell, SceneStatic.from_scene(cornell),
                               make_camera(pose, vfov, 4, 4, device="cpu"), CameraConfig(),
                               SensorRGB(), 4, 4, 1, params=DIFF, device="cpu")
    assert not [p for p in (REPO / "wurblpt_tpu_torch").rglob("*.py")
                if "ROADMAP A.9" in p.read_text()]


def test_inference_renders_keep_their_refused_scenes():
    """The same scenes still render for inference: the refusals are the
    differentiable mode's."""
    img = _render(scenes.envmap_spheres(device="cpu"), params=RenderParams(max_path_components=2))
    assert bool(torch.isfinite(img).all())


NEW_MODULES = ("render/backward.py", "render/integrator.py", "render/lights.py", "inverse.py",
               "utils/grad_check.py", "core/color.py", "scene/builder.py",
               "scene/geometryproc.py", "render/texture.py", "io/obj.py")


@pytest.mark.parametrize("module", NEW_MODULES)
def test_new_modules_import_neither_jax_nor_the_jax_package(module):
    tree = ast.parse((REPO / "wurblpt_tpu_torch" / module).read_text())
    names = [a.name for node in ast.walk(tree) if isinstance(node, ast.Import)
             for a in node.names]
    names += [node.module or "" for node in ast.walk(tree) if isinstance(node, ast.ImportFrom)
              and node.level == 0]
    bad = [n for n in names if n.split(".")[0] in ("jax", "jaxlib", "wurblpt_tpu")]
    assert not bad, bad


def test_chip_smoke_imports_neither_jax_nor_the_jax_package():
    tree = ast.parse((REPO / "chip_smoke.py").read_text())
    names = [a.name for node in ast.walk(tree) if isinstance(node, ast.Import)
             for a in node.names]
    names += [node.module or "" for node in ast.walk(tree) if isinstance(node, ast.ImportFrom)]
    assert not [n for n in names if n.split(".")[0] in ("jax", "jaxlib", "wurblpt_tpu")]


@pytest.mark.parametrize("tool", ["bwd_turns.py", "k7_turns.py", "k8_turns.py"])
def test_turns_tools_import_neither_jax_nor_the_jax_package(tool):
    tree = ast.parse((REPO / "tools" / tool).read_text())
    names = [a.name for node in ast.walk(tree) if isinstance(node, ast.Import)
             for a in node.names]
    names += [node.module or "" for node in ast.walk(tree) if isinstance(node, ast.ImportFrom)]
    assert not [n for n in names if n.split(".")[0] in ("jax", "jaxlib", "wurblpt_tpu")]


def test_the_materials_layer_imports_nothing_of_the_render_layer():
    """K7T's wrapper and autograd Functions sit beside K7's in
    materials/rgl.py (render/backward.py re-exports them): the dependency
    runs from the render layer to the materials layer only."""
    for path in sorted((REPO / "wurblpt_tpu_torch" / "materials").glob("*.py")):
        tree = ast.parse(path.read_text())
        mods = [node.module or "" for node in ast.walk(tree)
                if isinstance(node, ast.ImportFrom) and node.level > 0]
        assert not [m for m in mods if m.split(".")[0] == "render"], path.name
    assert bw.rgl_bwd is rgl.rgl_bwd and bw.rgl_bwd_plain is rgl.rgl_bwd_plain


@pytest.mark.parametrize("full", (False, True), ids=("tail", "full"))
@pytest.mark.parametrize("sample", (False, True), ids=("eval", "sample"))
def test_k7t_bound_counts_only_what_k7t_moves(sample, full):
    """K7T's bound (grad_check.rgl_bwd_work) charges a lane mid, wi, wo or
    u2 and the 4 cotangent words (44 or 40 B), none of K7's forward outputs,
    and the tables read once with the cotangents of its form's tables
    written once (the tail form's rgb, ndf and sigma; the full form's every
    float table), and the full form a lane's pdf cotangent and sample's wo
    cotangent read and wi's (and eval's wo's) written (28 B more)."""
    from wurblpt_tpu_torch.utils import grad_check as gc

    n = 64
    tables = gc.rgl_lanes("cpu", n=n)[0]
    base = gc.rgl_bwd_work(tables, 0, sample, full)[0]
    names = rgl.GRAD_TABLES if full else rgl.TAIL_TABLES
    assert base == kc._table_bytes(tables) + sum(getattr(tables, k).numel() * 4 for k in names)
    lane = (40 if sample else 44) + (28 if full else 0)
    assert gc.rgl_bwd_work(tables, n, sample, full)[0] - base == n * lane


# ---------------------------------------------------------------------------
# On the card (skipped without one)
# ---------------------------------------------------------------------------

@pytest.fixture
def gpu():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU build)")
    return "cuda"


@pytest.mark.cuda
def test_backward_kernels_match_their_plain_versions_on_the_card(gpu):
    """P0T, K3T, K8T (with its rotation term on the three kinds of sky, and
    its sample's backward) and K7T's full form (eval and sample) at a
    differentiable frame's shapes, with utils/grad_check.py's tolerances
    (chip_smoke.py's grad phase runs the same)."""
    from wurblpt_tpu_torch import native
    from wurblpt_tpu_torch.utils import grad_check as gc

    lanes = gc.cornell_lanes(gpu)
    before = dict(native.LAUNCHES)
    gc.check_row_scatter(lanes["g_rows"], lanes["mat"], lanes["mat_table"].shape[0])
    gc.check_assemble_hit_bwd(lanes)
    for cube in (False, True):
        gc.check_env_radiance_bwd(*gc.sky_lanes(gpu, cube))
    for kind in ("equirect", "cube", "constant"):
        gc.check_env_radiance_bwd(*gc.sky_lanes(gpu, kind == "cube", kind=kind, rotated=True),
                                  rotation=True)
    gc.check_env_sample_bwd(*gc.env_sample_lanes(gpu))
    tables, mid, wi, wo, u2, g_f = gc.rgl_lanes(gpu)
    g_pdf, g_wo = gc.rgl_full_cotangents(mid.shape[0], gpu)
    gc.check_rgl_bwd_full(tables, mid, wi, wo, g_f, False, g_pdf, None)
    gc.check_rgl_bwd_full(tables, mid, wi, u2, g_f, True, g_pdf, g_wo)
    assert native.LAUNCHES["row_scatter"] == before["row_scatter"] + 1
    assert native.LAUNCHES["assemble_hit_bwd"] == before["assemble_hit_bwd"] + 1
    assert native.LAUNCHES["env_radiance_bwd"] == before["env_radiance_bwd"] + 2
    assert native.LAUNCHES["env_radiance_bwd_rot"] == before["env_radiance_bwd_rot"] + 3
    assert native.LAUNCHES["env_sample_bwd"] == before["env_sample_bwd"] + 1
    assert native.LAUNCHES["rgl_bwd_full"] == before["rgl_bwd_full"] + 2


@pytest.mark.cuda
def test_a_gradient_on_the_card_is_the_cpus(gpu):
    """The floor's camera-height gradient (12 x 12, 4 spp, depth 4) on the
    card, through K1-K3, P0 and their backward kernels, equals the CPU's
    plain one to rtol 1e-3."""
    from wurblpt_tpu_torch import native
    from wurblpt_tpu_torch.utils import grad_check as gc

    grads = []
    for device in ("cpu", gpu):
        x = torch.zeros((), device=device, requires_grad=True)
        before = native.LAUNCHES["assemble_hit_bwd"]
        gc.floor_loss(device, 12)(x).backward()
        grads.append(float(x.grad))
        assert native.LAUNCHES["assemble_hit_bwd"] > before or device == "cpu"
    np.testing.assert_allclose(grads[1], grads[0], rtol=1e-3)
