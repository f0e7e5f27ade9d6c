"""Ground-truth AOVs: geometry, materials and optical flow (port of
``wurblpt_tpu/render/aov.py``).

Reference ``GroundTruth`` / ``getGroundTruth`` (wurblpt.hpp:453-769): one
pixel-centre ray per pixel, one closest hit cast to BIG (K1, KS1 or K5, as
`integrator.prepare_scene` chose the scene's cast), assembled by K3's full
form (K3a's with the frame's animation rows: every field of every lane, so
a miss lane's record is defined), then the requested channels. The material
frame goes through the normal map; the flow channels move the hit point to
t_prev and t_next by the hit primitive's animation (wurblpt.hpp:694-713) and
project it with the camera (camera.hpp:205-217). Like the JAX package, it
applies no media. No kernel of its own: the channels are PyTorch ops.

Returned as a dict of [H, W, C] (or [H, W]) tensors, only the channels asked
for.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import torch

from ..core.onb import onb_from_normal_tangent, to_world
from ..core.transform import inverse, quat_conjugate, quat_rotate, transform_point
from ..core.vecmath import dot, normalize
from ..scene.animation import eval_animation
from ..scene.ir import SceneArrays, anim_ids
from .bsdf import SceneStatic
from .camera import (
    CameraConfig,
    CameraParams,
    camera_rays,
    camera_space_to_image_space,
    world_to_camera,
)
from .integrator import SceneTables, frame_anim, prepare_scene
from .intersect import assemble_hit, scene_raw_hit
from .intersect_brute import BIG

# The reference's 20 channels (wurblpt.hpp:456-476) and hit_mask: world-space
# position, geometry normal and tangent, material (normal-mapped) normal and
# tangent; the same five in camera space; depth, distance, texcoords,
# material index; world, camera and pixel flow to the previous and next
# frame; `tangent` is geometry_tangent's old name.
ALL_AOVS = (
    "world_position", "geometry_normal", "geometry_tangent",
    "material_normal", "material_tangent",
    "camera_position", "camera_geometry_normal", "camera_geometry_tangent",
    "camera_material_normal", "camera_material_tangent",
    "depth", "distance", "texcoords", "material_index", "hit_mask",
    "world_flow_prev", "world_flow_next", "camera_flow_prev", "camera_flow_next",
    "pixel_flow_prev", "pixel_flow_next",
    "tangent",
)


def _prim_anim_id(scene: SceneArrays, prim):
    """The animation id of each lane's hit primitive (0 on a miss)."""
    n_tri = scene.n_tris
    zeros = torch.zeros_like(prim)
    aid_t = anim_ids(scene.tris)[torch.clamp(prim, 0, max(n_tri - 1, 0)).long()] if n_tri else zeros
    aid_s = (anim_ids(scene.spheres)[torch.clamp(prim - n_tri, 0, scene.n_spheres - 1).long()]
             if scene.n_spheres else zeros)
    return torch.where((prim >= 0) & (prim < n_tri), aid_t, torch.where(prim >= 0, aid_s, 0))


def get_ground_truth(scene: SceneArrays, static: SceneStatic, cam: CameraParams,
                     cam_cfg: CameraConfig, width: int, height: int, t: float = 0.0,
                     t_prev: Optional[float] = None, t_next: Optional[float] = None,
                     aovs: Sequence[str] = ("world_position", "geometry_normal", "depth",
                                            "distance", "texcoords", "material_index",
                                            "hit_mask"),
                     cam_prev: Optional[CameraParams] = None,
                     cam_next: Optional[CameraParams] = None, *, device="cuda",
                     tables: Optional[SceneTables] = None) -> Dict[str, torch.Tensor]:
    """The AOV channels `aovs` (names of ALL_AOVS) of the frame at time t
    (aov.py:70-203): [H, W, C] float32 tensors ([H, W] for depth, distance
    and hit_mask; int32 material_index, -1 on a miss), zero on miss pixels.
    The flows are taken to t_prev and t_next where given (the camera then at
    cam_prev and cam_next, or at `cam`). `scene` and `cam` must live on
    `device`; `tables` are the scene's own (`prepare_scene`), built here
    when not given."""
    device = torch.device(device)
    for name, x in (("scene", scene.tris.p0), ("camera", cam.focal_px)):
        if x.device.type != device.type:
            raise ValueError(f"{name} is on {x.device}, device is {device}")
    static.check_slice()
    if tables is None:
        tables = prepare_scene(scene, static, step=False)
    n_pix = width * height
    pixel_id = torch.arange(n_pix, dtype=torch.int64, device=device)
    px = (pixel_id % width).to(torch.float32) + 0.5
    py = (pixel_id // width).to(torch.float32) + 0.5
    f32 = dict(dtype=torch.float32, device=device)
    o, d, _ = camera_rays(cam, cam_cfg, torch.stack([px, py], -1), width, height, t, t,
                          torch.zeros((n_pix,), **f32), torch.zeros((n_pix, 2), **f32),
                          anims=scene.anims)
    o, d = o.contiguous(), d.contiguous()
    anim = frame_anim(scene, static, float(t))
    frames = None if anim is None else anim.frames
    tt, prim, u, v = scene_raw_hit(tables.accel, o, d, torch.full((n_pix,), 1e-4, **f32),
                                   torch.full((n_pix,), BIG, **f32), frames)
    hr = assemble_hit(tables.hit, o, d, tt, prim, u, v, frames)
    hitf = hr.hit
    hit3 = hitf[:, None]
    out: Dict[str, torch.Tensor] = {}

    def put(name, arr):
        out[name] = (arr.reshape(height, width, arr.shape[-1]) if arr.dim() > 1
                     else arr.reshape(height, width))

    if "hit_mask" in aovs:
        put("hit_mask", hitf.to(torch.float32))
    if "world_position" in aovs:
        put("world_position", torch.where(hit3, hr.position, 0.0))
    if "camera_position" in aovs:
        put("camera_position", torch.where(hit3, world_to_camera(cam, hr.position), 0.0))

    # The material frame (wurblpt.hpp:681 through tangentSpaceAt): without a
    # normal map the material normal is the interpolated shading normal; the
    # material tangent is the geometry tangent orthogonalised against it.
    mat_nrm = hr.normal
    need_mat = any(a in aovs for a in ("material_normal", "material_tangent",
                                       "camera_material_normal", "camera_material_tangent"))
    if need_mat and tables.tex is not None and scene.materials.normal_tex is not None:
        ntex = scene.materials.normal_tex[hr.mat.long()]
        tex_n = tables.tex.sample(torch.clamp_min(ntex, 0), hr.uv)[:, :3] * 2.0 - 1.0
        tb, bb = onb_from_normal_tangent(hr.normal, hr.tangent)
        mapped = to_world(tex_n, tb, bb, hr.normal)
        mat_nrm = torch.where((ntex >= 0)[:, None], normalize(mapped), mat_nrm)
    mat_tan = normalize(hr.tangent - dot(hr.tangent, mat_nrm, keepdim=True) * mat_nrm)

    def to_cam_dir(vec):   # directions: the camera's rotation only
        return quat_rotate(quat_conjugate(cam.transformation.rotation), vec)

    for name, vec in (("geometry_normal", hr.geom_normal), ("geometry_tangent", hr.tangent),
                      ("tangent", hr.tangent), ("material_normal", mat_nrm),
                      ("material_tangent", mat_tan)):
        if name in aovs:
            put(name, torch.where(hit3, vec, 0.0))
    for name, vec in (("camera_geometry_normal", hr.geom_normal),
                      ("camera_geometry_tangent", hr.tangent),
                      ("camera_material_normal", mat_nrm),
                      ("camera_material_tangent", mat_tan)):
        if name in aovs:
            put(name, torch.where(hit3, to_cam_dir(vec), 0.0))
    if "depth" in aovs:
        put("depth", torch.where(hitf, -world_to_camera(cam, hr.position)[:, 2], 0.0))
    if "distance" in aovs:
        put("distance", torch.where(hitf, hr.t, 0.0))
    if "texcoords" in aovs:
        put("texcoords", torch.where(hit3, hr.uv, 0.0))
    if "material_index" in aovs:
        put("material_index", torch.where(hitf, hr.mat, -1).to(torch.int32))

    # The flows (wurblpt.hpp:694-713): p_other = T_other(T_t^-1(p)) with the
    # hit primitive's animation.
    if any(a.endswith(("_prev", "_next")) for a in aovs):
        p_obj = hr.position
        if scene.anims is not None:
            aid = _prim_anim_id(scene, hr.prim)
            p_obj = transform_point(inverse(eval_animation(scene.anims, aid,
                                                           torch.full((n_pix,), t, **f32))),
                                    hr.position)
        p_cam_now = world_to_camera(cam, hr.position)
        for tag, t_other, cam_other in (("prev", t_prev, cam_prev), ("next", t_next, cam_next)):
            if t_other is None:
                continue
            p_world_o = p_obj
            if scene.anims is not None:
                p_world_o = transform_point(eval_animation(
                    scene.anims, aid, torch.full((n_pix,), t_other, **f32)), p_obj)
            if f"world_flow_{tag}" in aovs:
                put(f"world_flow_{tag}", torch.where(hit3, p_world_o - hr.position, 0.0))
            c_other = cam if cam_other is None else cam_other
            p_cam_o = world_to_camera(c_other, p_world_o)
            if f"camera_flow_{tag}" in aovs:
                put(f"camera_flow_{tag}", torch.where(hit3, p_cam_o - p_cam_now, 0.0))
            if f"pixel_flow_{tag}" in aovs:
                pix_o = camera_space_to_image_space(c_other, cam_cfg, p_cam_o, width, height)
                put(f"pixel_flow_{tag}",
                    torch.where(hit3, pix_o - torch.stack([px, py], -1), 0.0))
    return out
