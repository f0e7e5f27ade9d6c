"""Render one bench frame with the JAX package on the CPU and print its mean
radiance and cast counters: the yardsticks the PyTorch port's frames are held
to (``wurblpt_tpu_torch/utils/kernel_check.py``).

    JAX_PLATFORMS=cpu python jax_frame_reference.py city      # tens of minutes
    JAX_PLATFORMS=cpu python jax_frame_reference.py envmap    # under a minute
    JAX_PLATFORMS=cpu python jax_frame_reference.py rtiow     # under a minute
    JAX_PLATFORMS=cpu python jax_frame_reference.py tof       # under a minute
    JAX_PLATFORMS=cpu python jax_frame_reference.py cornell_animated
    JAX_PLATFORMS=cpu python jax_frame_reference.py rtiow_bvh
    JAX_PLATFORMS=cpu python jax_frame_reference.py cornell_animated_bvh
    JAX_PLATFORMS=cpu python jax_frame_reference.py noise_textures
    JAX_PLATFORMS=cpu python jax_frame_reference.py normalmap
    JAX_PLATFORMS=cpu python jax_frame_reference.py material_comparison
    JAX_PLATFORMS=cpu python jax_frame_reference.py participating_media
    JAX_PLATFORMS=cpu python jax_frame_reference.py stagelights
    JAX_PLATFORMS=cpu python jax_frame_reference.py aov_normalmap
    JAX_PLATFORMS=cpu python jax_frame_reference.py aov_cornell_animated
    JAX_PLATFORMS=cpu python jax_frame_reference.py rgl_grad_tables
    JAX_PLATFORMS=cpu python jax_frame_reference.py rgl_grad_tables_128
    JAX_PLATFORMS=cpu python jax_frame_reference.py rgl_camera_grad
    JAX_PLATFORMS=cpu python jax_frame_reference.py sky_yaw_grad
    JAX_PLATFORMS=cpu python jax_frame_reference.py rolling_marbles
    JAX_PLATFORMS=cpu python jax_frame_reference.py animations
    JAX_PLATFORMS=cpu python jax_frame_reference.py cornell_animated_blur
    JAX_PLATFORMS=cpu python jax_frame_reference.py rtiow_dof

city is bench config city_many_lights (bench.py bench_city_many_lights):
city_night(seed=7), 1920x1080, 360-degree stereo, 1 spp, 4 path components,
in host blocks of 131072 lanes; at 1 spp each pixel has one sample keyed on
(pixel, sample), so the block size does not change the image or the counters.

envmap is bench config envmap_cube_is (bench.py bench_envmap_furnace):
envmap_spheres(cube=True), 128x128, 16 spp, 8 path components. rtiow is
bench config rtiow_distortion (bench.py bench_rtiow): rtiow(), 192x128,
16 spp, 8 path components, OpenCV lens distortion with 8 undistortion steps.
Both call render_frame_wavefront as the port's tests call it, at the default
131072 lanes. bench.py wraps that call in jax.jit with the scene as an
argument: the envmap frame comes out the same, the rtiow frame at mean
0.5212673 and counters [765082, 765082], 0.03 % apart, because XLA then
rounds the re-centred sphere test otherwise and its last bits decide the
self-intersections on the small spheres.

tof is bench config tof_amcw (bench.py bench_tof): tof_box(), 96x96, 16 spp,
6 path components, SensorTofAmcw, under jax.jit with the scene as an
argument as bench.py runs it (the plain call gives mean 1.95638643e-17,
6e-8 apart, with the same counters). It prints one line per phase image (0-3:
the mean energy and the channel means a, b, energy, in float64 and, as
bench.py takes them, numpy's float32 mean; the counters), then the
4-phase distance at 1 path component (direct light only) against
get_ground_truth's distance (the first hit of the pixel-centre rays): the
median, 90th percentile and largest |error| in metres over the lit pixels.

cornell_animated is the port's animated Cornell frame: the reference Cornell
box with the keyframes of the port's `scenes.cornell_animations` (numbers in
``wurblpt_tpu_torch/utils/kernel_check.py``), built here with the JAX
package's builder (`jax_cornell_animated`, also the port's tests' JAX
side), rendered with render_frame_wavefront at t0 = t1 = 0.5 with
bench.py's Cornell settings: 128x128, 16 spp, 8 path components, the
reference camera, SensorRGB, 131072 lanes. The JAX package casts it
through its sweeps with object-space rays (36 triangles, no BVH).

rtiow_bvh is the reference RTIOW field at its own size, rtiow(seed=7, n=22)
(484 small spheres, the ground sphere and the three large ones), built
with use_bvh=True, rendered with rtiow's camera and settings: the JAX
package casts it through its BVH walk with sphere leaves.
cornell_animated_bvh is the animated Cornell box with its two spheres
(`jax_cornell_animated(spheres=True)`), built with use_bvh=True and the
tree's boxes swept over [0.5, 0.5], rendered as cornell_animated: the JAX
package casts it through its BVH walk with object-space leaf rays.

noise_textures, normalmap and material_comparison are the example apps'
scenes (examples/noise_textures.py, normalmap.py, material_comparison.py),
built here with the JAX package's builder (`jax_example_scene`, also the
port's tests' JAX side) and rendered with render_frame as the apps render
them: 480x200 (16 spp, 5 path components), 320x320 (16 spp, 4) and 560x180
(16 spp, 8), in passes of 8 samples (examples/_common.py's pick), under
jax.jit with the scene as an argument (~1-3 minutes each).
participating_media and stagelights are the example apps with
participating media (examples/participating_media.py, stagelights.py),
built as the apps build them (`jax_media_scene`) and rendered the same way:
256x192 (16 spp in one pass, 12 path components) and 480x270 (25 spp in
passes of 5, 8 path components; ~10 minutes). aov_normalmap and
aov_cornell_animated print get_ground_truth's channel means and hit count
(`_aov_report`).

rolling_marbles, animations and cornell_animated_blur are the
motion-blurred frames (kernel_check.MOTION_FRAMES): frame 0 of
examples/rolling_marbles.py (320x180, 9 spp, 8 path components, shutter
[0, 1/48]) and of examples/animations.py (192x144, 16 spp, 6, [0, 0.02]),
their scenes built as the apps build them (`jax_motion_scene`), and the
animated box with spheres in a BVH swept over [0, 1] at the Cornell
settings over [0, 1]; render_frame over the shutter under jax.jit, one
sample a pass. rtiow_dof is examples/rtiow.py's depth-of-field frame:
rtiow(), 320x200, 16 spp, 8 path components, aperture 0.08 focused at 10,
25 degrees, through render_frame_wavefront.

rgl_grad_tables is not a frame: it prints, for each table of the RGL
stack, how many of its entries get a nonzero jax.grad of the mean of
tests/test_gradients_breadth.py's RGL quad (12 x 12, 4 spp, 3 path
components, differentiable) and the digest of that gradient the card's
check reads (``wurblpt_tpu_torch/utils/grad_check.py`` RGL_TABLE_REFS): the
count of entries above 1e-6 of the table's largest |entry|, their sum, the
sum of their |.| and the largest |.| (~1 minute); before them a line with
the quad's mean and d(mean)/d(rgb scale), the rgb table's gradient
contracted with the table. rgl_grad_tables_128 prints the same for the quad
at the grad phase's size, 128 x 128 and 16 spp in one pass
(grad_check.RGL_QUAD_128_REF). rgl_camera_grad prints
the same quad's mean and its jax.grad with respect to the camera's height
(the lane directions' gradients; grad_check.RGL_CAMERA_REF), sky_yaw_grad
envmap_spheres' equirect frame (128 x 128, 16 spp in one pass, 8 path
components, grad_check.SKY_YAW_VIEW: the sun in the frame) with the sky
turned by a yaw of grad_check.SKY_YAW about +y: its mean and jax.grad with
respect to the yaw (grad_check.SKY_YAW_REF; several minutes).
"""

from __future__ import annotations

import json
import os
import sys
import time

os.environ.setdefault("JAX_PLATFORMS", "cpu")

MAX_LANES = 131072


def _frame(scene, cam, cfg, width, height, ssqrt, depth, host_blocks=False, t=0.0):
    from wurblpt_tpu import RenderParams, SceneStatic, SensorRGB
    from wurblpt_tpu.render.integrator import render_frame_wavefront

    def render():
        return render_frame_wavefront(scene, SceneStatic.from_scene(scene), cam, cfg, SensorRGB(),
                                      width, height, ssqrt, t, t,
                                      params=RenderParams(max_path_components=depth),
                                      return_stats=True, host_blocks=host_blocks,
                                      max_lanes=MAX_LANES)

    return render


def jax_cornell_animated(spheres=False, use_bvh=False, t=0.0, t1=None):
    """The animated Cornell box as the JAX package's builder makes it: the
    reference box (cornell_box_ref) with the port's keyframes
    (wurblpt_tpu_torch.utils.scenes.cornell_animations), animation ids 1-3
    for the short box, the tall box and the light; with `spheres`, the
    port's two spheres (scenes.CORNELL_ANIM_SPHERES). No BVH unless
    `use_bvh`; a BVH's boxes are swept over the build interval [t, t1]
    (t1 = t unless given)."""
    import numpy as np

    from wurblpt_tpu.core.transform import Transformation
    from wurblpt_tpu.scene import builder as B
    from wurblpt_tpu.utils import cornell_data as CD
    from wurblpt_tpu_torch.utils import scenes as port_scenes

    scene = B.Scene()
    mats = {name: scene.take_material(B.Lambertian(albedo=CD.ALBEDO[name]), name)
            for name in ("white", "red", "green")}
    mats["tall"] = mats["short"] = mats["white"]
    light = scene.take_material(B.LightDiffuse(radiance=CD.LIGHT_RADIANCE), "light")
    for a in port_scenes.cornell_animations():
        scene.take_animation(B.AnimationKeyframes(list(a.times), [
            Transformation.make(*(np.asarray(x) for x in tf)) for tf in a.transformations]))
    ids = port_scenes.CORNELL_ANIM_ID
    for pos, nrm, mat in CD.QUADS:
        mesh = B.Mesh(np.array(pos, np.float32), np.array(nrm, np.float32), CD.UV,
                      indices=CD.IDX)
        scene.take_mesh_instance(B.MeshInstance(mesh, mats[mat], animation=ids.get(mat)))
    lpos, lnrm = CD.LIGHT_QUAD
    lmesh = B.Mesh(np.array(lpos, np.float32), np.array(lnrm, np.float32), CD.UV_LIGHT,
                   indices=CD.IDX)
    scene.take_mesh_instance(B.MeshInstance(lmesh, light, animation=ids["light"]),
                             hot_spot=True)
    if spheres:
        for c, r, a in port_scenes.CORNELL_ANIM_SPHERES:
            scene.take_sphere(B.SphereObject(c, r, mats["white"], animation=a or None))
    return scene.build(use_bvh=use_bvh, t0=t, t1=t if t1 is None else t1)


def jax_motion_scene(name):
    """The motion-blurred frames' scenes built with the JAX package's
    builder (wurblpt_tpu_torch.utils.kernel_check.MOTION_FRAMES): the
    example apps' (examples/rolling_marbles.py, animations.py, frame 0) as
    the apps build them, and the animated box with spheres in a BVH swept
    over the shutter; with the (eye, center, vfov_deg) of the camera."""
    import numpy as np

    from wurblpt_tpu.core.transform import Transformation, quat_from_axis_angle
    from wurblpt_tpu.scene import builder as B
    from wurblpt_tpu.scene.ir import TextureType
    from wurblpt_tpu.utils.scenes import _quad_to
    from wurblpt_tpu_torch.utils import kernel_check as kc

    t0, t1 = kc.MOTION_FRAMES[name][5:]
    if name == "cornell_animated_blur":
        from wurblpt_tpu.utils import scenes

        pose, vfov = scenes.cornell_ref_camera()
        return jax_cornell_animated(spheres=True, use_bvh=True, t=t0, t1=t1), (pose, vfov)
    scene = B.Scene()
    if name == "animations":
        duration = 4 / 25.0
        floor = scene.take_material(B.Lambertian(albedo=(0.45, 0.45, 0.45)))
        fm, ftf = _quad_to((0, -0.5, 0), (1, 0, 0), -np.pi / 2, half=8.0)
        scene.take_mesh_instance(B.MeshInstance(fm, floor, ftf))
        light = scene.take_material(B.LightDiffuse(radiance=(10.0,) * 3))
        scene.take_sphere(B.SphereObject((0, 2.5, 0), 0.5, light), hot_spot=True)
        aid = scene.take_animation(B.AnimationKeyframes(
            times=[0.0, duration],
            transformations=[Transformation.make(translation=(-1.5, 0.0, 0.0)),
                             Transformation.make(translation=(1.5, 0.0, 0.0))]))
        red = scene.take_material(B.Lambertian(albedo=(0.8, 0.2, 0.15)))
        scene.take_sphere(B.SphereObject((0, 0, 0), 0.5, red, animation=aid))
        return scene.build(t0=t0, t1=t1), (((0, 1.0, 4.0), (0, 0, 0)), 40.0)
    duration = 4 / 24.0
    floor = scene.take_material(B.Lambertian(albedo=B.CheckerTexture(
        color1=(0.5, 0.45, 0.4), color2=(0.25, 0.25, 0.3), squares=(20, 20))))
    fm, ftf = _quad_to((0, -0.5, 0), (1, 0, 0), -np.pi / 2, half=8.0)
    scene.take_mesh_instance(B.MeshInstance(fm, floor, ftf))
    light = scene.take_material(B.LightDiffuse(radiance=(18.0,) * 3))
    scene.take_sphere(B.SphereObject((0, 4.0, 2.0), 0.6, light), hot_spot=True)
    rng = np.random.default_rng(5)
    for i in range(5):
        r, z = 0.3, -1.2 + 0.6 * i
        x0, x1 = -3.0, 3.0
        sign = 1.0 if i % 2 == 0 else -1.0
        roll = sign * (x1 - x0) / r
        aid = scene.take_animation(B.AnimationKeyframes(
            times=[0.0, duration],
            transformations=[
                Transformation.make(translation=(x0 * sign, -0.5 + r, z)),
                Transformation.make(translation=(x1 * sign, -0.5 + r, z),
                                    rotation=quat_from_axis_angle((0, 0, 1), -roll))]))
        tex = B.NoiseTexture(kind=TextureType.PERLIN_NOISE, frequency=8.0, octaves=5,
                             turbulence=True, seed=i,
                             val_scale=tuple(0.6 * rng.random(3) + 0.2) + (1.0,))
        scene.take_sphere(B.SphereObject((0.0, 0.0, 0.0), r, B.Lambertian(albedo=tex),
                                         animation=aid))
    return scene.build(t0=0.0, t1=duration), (((0, 1.8, 5.5), (0, 0, 0)), 38.0)


def jax_example_scene(name, normal_map_size=256):
    """The example apps' scenes built with the JAX package's builder, as the
    apps build them (examples/noise_textures.py, normalmap.py,
    material_comparison.py; the brick normal map and the synthetic RGL
    dataset are the port's copies, wurblpt_tpu_torch.utils.scenes): the
    SceneArrays and (eye, center, vfov_deg) of the app's camera."""
    import numpy as np

    from wurblpt_tpu.materials import rgl
    from wurblpt_tpu.scene import builder as B
    from wurblpt_tpu.scene import generator as G
    from wurblpt_tpu.scene.ir import TextureType
    from wurblpt_tpu.utils.scenes import _quad_to
    from wurblpt_tpu_torch.utils import scenes as port_scenes

    scene = B.Scene()
    if name == "normalmap":
        nmap = B.ImageTexture(image=port_scenes.brick_normal_map(normal_map_size,
                                                                 normal_map_size), srgb=False)
        scene.take_mesh_instance(B.MeshInstance(
            G.generate_quad(1.0, 1.0), B.Lambertian(albedo=(0.7, 0.45, 0.3), normal_map=nmap)))
        light = scene.take_material(B.LightDiffuse(radiance=(20.0,) * 3))
        scene.take_sphere(B.SphereObject((1.6, 1.2, 2.2), 0.25, light), hot_spot=True)
        return scene.build(), ((0.0, -0.4, 2.4), (0.0, 0.0, 0.0), 42.0)
    noise = name == "noise_textures"
    floor = scene.take_material(B.Lambertian(albedo=B.CheckerTexture(
        color1=(0.25 if noise else 0.3,) * 3, color2=(0.6 if noise else 0.55,) * 3,
        squares=(24, 24) if noise else (32, 32))))
    fm, ftf = _quad_to((0.0, -0.5, 0.0), (1.0, 0.0, 0.0), -np.pi / 2, half=12.0 if noise else 14.0)
    scene.take_mesh_instance(B.MeshInstance(fm, floor, ftf))
    if noise:
        mats = [B.Lambertian(albedo=t) for t in (
            B.NoiseTexture(kind=TextureType.VALUE_NOISE, octaves=4, frequency=6.0),
            B.NoiseTexture(kind=TextureType.GRADIENT_NOISE, octaves=4, frequency=6.0),
            B.NoiseTexture(kind=TextureType.WORLEY_NOISE, frequency=8.0),
            B.NoiseTexture(kind=TextureType.PERLIN_NOISE, frequency=8.0, turbulence=False,
                           val_scale=(0.7, 0.7, 0.7, 1.0), val_offset=(0.5, 0.5, 0.5, 0.0)),
            B.NoiseTexture(kind=TextureType.PERLIN_NOISE, octaves=7, frequency=6.0, gain=0.5,
                           turbulence=True))]
        x0, light_sphere, sky = -3.0, ((0.0, 5.0, 3.0), 0.8, (26.0, 24.0, 22.0)), (0.25, 0.28, 0.35)
        cam = ((0.0, 1.3, 5.2), (0.0, 0.0, 0.0), 32.0)
    else:
        scene.take_rgl_table("measured", rgl.load_rgl_material(port_scenes.synthetic_rgl_fields()))
        mats = [B.Lambertian(albedo=(0.7, 0.3, 0.25)),
                B.GGX(albedo=(0.9, 0.7, 0.3), roughness=0.25),
                B.GGX(albedo=(0.9, 0.9, 0.95), roughness=0.03),
                B.GGX(albedo=(0.8, 0.8, 0.9), roughness=(0.02, 0.3)),
                B.Glass(ior=(1.50, 1.52, 1.54, 1.52)),
                B.Mirror(),
                B.ModPhong(diffuse=(0.2, 0.35, 0.6), specular=(0.4,) * 3, shininess=90.0),
                B.RGLMaterial(table_name="measured")]
        x0, light_sphere, sky = -5.25, ((0.0, 6.0, 4.0), 1.0, (30.0,) * 3), (0.35, 0.4, 0.5)
        cam = ((0.0, 1.6, 9.0), (0.0, 0.0, 0.0), 16.0)
    for i, m in enumerate(mats):
        scene.take_sphere(B.SphereObject((x0 + 1.5 * i, 0.1, 0.0), 0.6, m))
    light = scene.take_material(B.LightDiffuse(radiance=light_sphere[2]))
    scene.take_sphere(B.SphereObject(light_sphere[0], light_sphere[1], light), hot_spot=True)
    scene.set_environment_map(B.EnvironmentMapConstant(radiance=sky))
    return scene.build(), cam


def jax_media_scene(name):
    """The example apps with participating media built with the JAX
    package's builder as the apps build them (examples/participating_media.py,
    stagelights.py; the bumpy normal map is the port's copy,
    wurblpt_tpu_torch.utils.scenes.bumpy_normal_map): the SceneArrays and
    the camera's pose (a Transformation) and vfov_deg."""
    import numpy as np

    from wurblpt_tpu.core.transform import Transformation, from_lookat, quat_from_axis_angle
    from wurblpt_tpu.scene import builder as B
    from wurblpt_tpu.scene import generator as G
    from wurblpt_tpu.utils.scenes import _quad_to
    from wurblpt_tpu_torch.utils import scenes as port_scenes

    scene = B.Scene()
    if name == "participating_media":
        floor = scene.take_material(B.Lambertian(albedo=(0.4, 0.4, 0.45)))
        fm, ftf = _quad_to((0, -1.0, 0), (1, 0, 0), -np.pi / 2, half=10.0)
        scene.take_mesh_instance(B.MeshInstance(fm, floor, ftf))
        light = scene.take_material(B.LightDiffuse(radiance=(14.0, 12.0, 10.0)))
        scene.take_sphere(B.SphereObject((0.0, 1.6, -2.0), 0.35, light), hot_spot=True)
        red = scene.take_material(B.Lambertian(albedo=(0.7, 0.2, 0.2)))
        scene.take_sphere(B.SphereObject((-0.8, -0.6, -0.4), 0.4, red))
        scene.take_medium(B.MediumObject(boundary=B.SphereObject((0.4, 0.0, -0.8), 1.0, 0),
                                         density=1.5, phase=B.PhaseIso(albedo=(0.9, 0.9, 0.9))))
        return scene.build(), (from_lookat((0, 0.4, 3.2), (0, 0, -0.8)), 45.0)
    white = scene.take_material(B.Lambertian(albedo=(0.8, 0.8, 0.8)))

    def wall(translate, axis, deg):
        tf = B.Transformation.make(
            translation=translate,
            rotation=quat_from_axis_angle(np.asarray(axis, np.float32), np.deg2rad(deg)),
            scale=(5.0, 5.0, 5.0))
        scene.take_mesh_instance(B.MeshInstance(G.generate_quad(1.0, 1.0), white, tf))

    wall((-2.6, 0.0, 0.0), (0, 1, 0), +90)
    wall((+2.6, 0.0, 0.0), (0, 1, 0), -90)
    wall((0.0, 0.0, +5.0), (0, 1, 0), 180)
    wall((0.0, 0.0, -4.6), (0, 1, 0), 0)
    wall((0.0, -2.499, 0.0), (1, 0, 0), +90)
    wall((0.0, -5.0, 0.0), (1, 0, 0), -90)
    modphong = B.ModPhong(diffuse=(0.5, 0.5, 0.5), specular=(0.5, 0.5, 0.5), shininess=120.0)
    tra0 = Transformation.make(translation=(-1.5, -4.7, -4.0),
                               rotation=quat_from_axis_angle((0, 1, 0), np.deg2rad(30.0)),
                               scale=(0.3,) * 3)
    scene.take_mesh_instance(B.MeshInstance(G.generate_torus(1.0, 0.4, 64, 48), modphong, tra0))
    tra1 = Transformation.make(translation=(-0.5, -4.7, -4.0),
                               rotation=quat_from_axis_angle((0, 1, 0), np.deg2rad(160.0)),
                               scale=(0.3,) * 3)
    scene.take_mesh_instance(B.MeshInstance(G.generate_octahedron(), B.Glass(ior=1.5), tra1))
    scene.take_medium(B.MediumObject(boundary=B.MeshInstance(G.generate_octahedron(), 0, tra1),
                                     density=2.5, phase=B.PhaseIso(albedo=(1.0, 1.0, 1.0))))
    nmap = B.ImageTexture(image=port_scenes.bumpy_normal_map(), srgb=False)
    scene.take_sphere(B.SphereObject((0.5, -4.7, -4.0), 0.3, B.Glass(ior=1.5, normal_map=nmap)))
    ggx = B.GGX(albedo=(1.0, 1.0, 1.0), roughness=(0.01, 0.1))
    tra3 = Transformation.make(translation=(1.5, -4.7, -4.0), scale=(0.3,) * 3)
    scene.take_mesh_instance(B.MeshInstance(G.generate_icosahedron(), ggx, tra3))
    lrot = quat_from_axis_angle((1, 0, 0), np.deg2rad(90.0))
    for i, col in enumerate(port_scenes.STAGE_SPOT_COLORS):
        lm = scene.take_material(B.LightSpot(radiance=col, half_angle=np.deg2rad(20.0)))
        lt = Transformation.make(translation=(-1.5 + i, -2.5, -4.0), rotation=lrot,
                                 scale=(0.3,) * 3)
        scene.take_mesh_instance(B.MeshInstance(G.generate_quad(1.0, 1.0), lm, lt),
                                 hot_spot=True)
    return scene.build(), (Transformation.make(translation=(0.0, -4.5, -1.2)), 50.0)


def _example(name):
    import jax

    from wurblpt_tpu import CameraConfig, RenderParams, SceneStatic, SensorRGB, make_camera
    from wurblpt_tpu.core.transform import from_lookat
    from wurblpt_tpu.render.integrator import render_frame
    from wurblpt_tpu_torch.utils import kernel_check as kc

    width, height, ssqrt, depth, spp_pass = kc.EXAMPLE_FRAMES[name]
    if name in kc.MEDIA_FRAMES:
        scene, (pose, vfov) = jax_media_scene(name)
    else:
        scene, (eye, center, vfov) = jax_example_scene(name)
        pose = from_lookat(eye, center)
    cam = make_camera(transformation=pose, vfov_deg=vfov, width=width, height=height)
    static = SceneStatic.from_scene(scene)
    fn = jax.jit(lambda s, c: render_frame(
        s, static, c, CameraConfig(), SensorRGB(), width, height, ssqrt,
        params=RenderParams(max_path_components=depth), samples_per_pass=spp_pass,
        return_stats=True))
    return scene, lambda: fn(scene, cam)


def _rgl_grad_tables(width=12, ssqrt=2, spp_pass=None):
    import jax
    import jax.numpy as jnp
    import numpy as np

    from wurblpt_tpu import CameraConfig, RenderParams, SensorRGB
    from wurblpt_tpu.render.integrator import render_frame

    scene, static, cam = _rgl_quad(width)
    params = RenderParams(max_path_components=3, differentiable=True)
    names = [k for k in scene.rgl._fields
             if jnp.issubdtype(jnp.asarray(getattr(scene.rgl, k)).dtype, jnp.floating)]

    def loss(tabs):
        return jnp.mean(render_frame(scene._replace(rgl=scene.rgl._replace(**tabs)), static, cam,
                                     CameraConfig(), SensorRGB(), width, width, ssqrt,
                                     params=params,
                                     **({} if spp_pass is None else
                                        {"samples_per_pass": spp_pass})))

    t0 = time.perf_counter()
    value, g = jax.jit(jax.value_and_grad(loss))({k: getattr(scene.rgl, k) for k in names})
    rgb = np.asarray(scene.rgl.rgb).astype(np.float64)
    # d(mean)/d(s) of rgb * s at s = 1, by the chain rule through the rgb table's gradient
    print(json.dumps({"loss": f"rgl_quad {width}x{width} {ssqrt ** 2} spp", "mean": float(value),
                      "grad_rgb_scale": float((rgb * np.asarray(g["rgb"])).sum()),
                      "seconds": time.perf_counter() - t0}))
    for k in names:
        a = np.asarray(g[k]).astype(np.float64)
        big = np.abs(a) > 1e-6 * np.abs(a).max()
        print(json.dumps({"table": k, "shape": list(a.shape), "nonzero": int((a != 0).sum()),
                          "max_abs_grad": float(np.abs(a).max()), "above_1e-6": int(big.sum()),
                          "sum": float(a.sum()), "sum_abs": float(np.abs(a).sum())}))


def _rgl_quad(width=12):
    """tests/test_gradients_breadth.py's RGL quad, its static part and camera
    (width^2 pixels)."""
    from wurblpt_tpu import SceneStatic, make_camera
    from wurblpt_tpu.core.transform import from_lookat
    from wurblpt_tpu.materials import rgl
    from wurblpt_tpu.scene import builder as B
    from wurblpt_tpu.scene import generator as G
    from wurblpt_tpu_torch.utils.scenes import synthetic_rgl_fields

    sc = B.Scene()
    sc.take_rgl_table("m", rgl.load_rgl_material(synthetic_rgl_fields()))
    sc.take_mesh_instance(B.MeshInstance(G.generate_quad(1.2, 1.2),
                                         sc.take_material(B.RGLMaterial(table_name="m"))))
    sc.take_sphere(B.SphereObject((0.4, 0.9, 2.2), 0.3, B.LightDiffuse(radiance=(14.0,) * 3)),
                   hot_spot=True)
    scene = sc.build()
    cam = make_camera(transformation=from_lookat((0, 0, 2.2), (0, 0, 0)), vfov_deg=45.0,
                      width=width, height=width)
    return scene, SceneStatic.from_scene(scene), cam


def _rgl_camera_grad():
    import jax
    import jax.numpy as jnp

    from wurblpt_tpu import CameraConfig, RenderParams, SensorRGB
    from wurblpt_tpu.render.integrator import render_frame

    scene, static, cam = _rgl_quad()
    params = RenderParams(max_path_components=3, differentiable=True)

    def loss(dy):
        t = cam.transformation
        c2 = cam._replace(transformation=t._replace(
            translation=t.translation + jnp.array([0.0, 1.0, 0.0]) * dy))
        return jnp.mean(render_frame(scene, static, c2, CameraConfig(), SensorRGB(), 12, 12, 2,
                                     params=params))

    value, g = jax.jit(jax.value_and_grad(loss))(jnp.float32(0.0))
    print(json.dumps({"loss": "rgl_camera", "mean": float(value), "grad": float(g)}))


def _sky_yaw_grad():
    import jax
    import jax.numpy as jnp

    from wurblpt_tpu import CameraConfig, RenderParams, SceneStatic, SensorRGB, make_camera
    from wurblpt_tpu.core.transform import from_lookat
    from wurblpt_tpu.render.integrator import render_frame
    from wurblpt_tpu.utils import scenes

    scene = scenes.envmap_spheres(cube=False).build()
    static = SceneStatic.from_scene(scene)
    from wurblpt_tpu_torch.utils.grad_check import SKY_YAW, SKY_YAW_VIEW

    eye, target, vfov = SKY_YAW_VIEW
    cam = make_camera(transformation=from_lookat(eye, target), vfov_deg=vfov, width=128,
                      height=128)
    params = RenderParams(max_path_components=8, differentiable=True)

    def loss(yaw):
        q = jnp.stack([0.0 * yaw, jnp.sin(0.5 * yaw), 0.0 * yaw, jnp.cos(0.5 * yaw)])
        sc = scene._replace(envmap=scene.envmap._replace(rotation=q))
        return jnp.mean(render_frame(sc, static, cam, CameraConfig(), SensorRGB(), 128, 128, 4,
                                     params=params, samples_per_pass=16))

    t0 = time.perf_counter()
    value, g = jax.jit(jax.value_and_grad(loss))(jnp.float32(SKY_YAW))
    print(json.dumps({"loss": "sky_yaw", "yaw": SKY_YAW, "mean": float(value), "grad": float(g),
                      "seconds": time.perf_counter() - t0}))


def _cornell_animated():
    from wurblpt_tpu import CameraConfig, make_camera
    from wurblpt_tpu.utils import scenes
    from wurblpt_tpu_torch.utils import kernel_check as kc

    scene = jax_cornell_animated()
    pose, vfov = scenes.cornell_ref_camera()
    cam = make_camera(transformation=pose, vfov_deg=vfov, width=128, height=128)
    return scene, _frame(scene, cam, CameraConfig(), 128, 128, 4, 8, t=kc.ANIM_TIME)


def _cornell_animated_bvh():
    from wurblpt_tpu import CameraConfig, make_camera
    from wurblpt_tpu.utils import scenes
    from wurblpt_tpu_torch.utils import kernel_check as kc

    scene = jax_cornell_animated(spheres=True, use_bvh=True, t=kc.ANIM_TIME)
    pose, vfov = scenes.cornell_ref_camera()
    cam = make_camera(transformation=pose, vfov_deg=vfov, width=128, height=128)
    return scene, _frame(scene, cam, CameraConfig(), 128, 128, 4, 8, t=kc.ANIM_TIME)


def _city():
    from wurblpt_tpu import CameraConfig, make_camera
    from wurblpt_tpu.core.transform import from_lookat
    from wurblpt_tpu.render.camera import SurroundMode
    from wurblpt_tpu.utils import scenes

    scene = scenes.city_night(seed=7).build(use_bvh=True)
    cam = make_camera(transformation=from_lookat((0.0, 3.5, 14.0), (0.0, 1.5, 0.0)),
                      vfov_deg=50.0, width=1920, height=1080, eye_distance=0.065)
    cfg = CameraConfig(surround=SurroundMode.S360, stereo=True)
    return scene, _frame(scene, cam, cfg, 1920, 1080, 1, 4, host_blocks=True)


def _envmap():
    from wurblpt_tpu import CameraConfig, make_camera
    from wurblpt_tpu.core.transform import from_lookat
    from wurblpt_tpu.utils import scenes

    scene = scenes.envmap_spheres(cube=True).build()
    cam = make_camera(transformation=from_lookat((0.0, 0.6, 4.0), (0.0, 0.0, 0.0)),
                      vfov_deg=40.0, width=128, height=128)
    return scene, _frame(scene, cam, CameraConfig(), 128, 128, 4, 8)


def _motion(name):
    import jax

    from wurblpt_tpu import CameraConfig, RenderParams, SceneStatic, SensorRGB, make_camera
    from wurblpt_tpu.core.transform import Transformation, from_lookat
    from wurblpt_tpu.render.integrator import render_frame
    from wurblpt_tpu_torch.utils import kernel_check as kc

    width, height, ssqrt, depth, _, t0, t1 = kc.MOTION_FRAMES[name]
    scene, (pose, vfov) = jax_motion_scene(name)
    if not isinstance(pose, Transformation):
        pose = from_lookat(*pose)
    cam = make_camera(transformation=pose, vfov_deg=vfov, width=width, height=height)
    static = SceneStatic.from_scene(scene)
    # one sample a pass (the image and the counters do not depend on the pass size)
    fn = jax.jit(lambda s, c: render_frame(
        s, static, c, CameraConfig(), SensorRGB(), width, height, ssqrt, t0, t1,
        params=RenderParams(max_path_components=depth), samples_per_pass=1,
        return_stats=True))
    return scene, lambda: fn(scene, cam)


def _rtiow_dof():
    from wurblpt_tpu import CameraConfig, make_camera
    from wurblpt_tpu.core.transform import from_lookat
    from wurblpt_tpu.utils import scenes
    from wurblpt_tpu_torch.utils import kernel_check as kc

    scene = scenes.rtiow().build()
    cam = make_camera(transformation=from_lookat((13.0, 2.0, 3.0), (0.0, 0.0, 0.0)),
                      vfov_deg=25.0, width=kc.DOF_WIDTH, height=kc.DOF_HEIGHT,
                      focus_distance=kc.DOF_FOCUS, aperture_diameter=kc.DOF_APERTURE)
    return scene, _frame(scene, cam, CameraConfig(dof=True), kc.DOF_WIDTH, kc.DOF_HEIGHT,
                         kc.DOF_SSQRT, kc.DOF_DEPTH)


def _rtiow(n=6, use_bvh=None):
    from wurblpt_tpu import CameraConfig, make_camera
    from wurblpt_tpu.core.transform import from_lookat
    from wurblpt_tpu.render.camera import DistortionModel
    from wurblpt_tpu.utils import scenes

    scene = scenes.rtiow(n=n).build(use_bvh=use_bvh)
    cam = make_camera(transformation=from_lookat((13.0, 2.0, 3.0), (0.0, 0.0, 0.0)),
                      vfov_deg=30.0, width=192, height=128,
                      dist_k=(-0.1, 0.02, 0.0, 0.0, 0.0, 0.0), dist_p=(0.001, -0.001))
    cfg = CameraConfig(distortion=DistortionModel.OPENCV, undistort_iters=8)
    return scene, _frame(scene, cam, cfg, 192, 128, 4, 8)


def _tof(phase_index=0, depth=6):
    import jax

    from wurblpt_tpu import CameraConfig, RenderParams, SceneStatic, make_camera
    from wurblpt_tpu.core.transform import from_lookat
    from wurblpt_tpu.render.integrator import render_frame_wavefront
    from wurblpt_tpu.render.sensor import SensorTofAmcw
    from wurblpt_tpu.utils import scenes

    scene = scenes.tof_box().build()
    cam = make_camera(transformation=from_lookat((0.0, 0.0, 1.19), (0.0, 0.0, 0.0)),
                      vfov_deg=60.0, width=96, height=96)

    static = SceneStatic.from_scene(scene)
    fn = jax.jit(lambda s, c: render_frame_wavefront(
        s, static, c, CameraConfig(), SensorTofAmcw(phase_index=phase_index), 96, 96, 4,
        params=RenderParams(max_path_components=depth), return_stats=True,
        max_lanes=MAX_LANES))
    return scene, cam, lambda: fn(scene, cam)


def _tof_report():
    import numpy as np

    from wurblpt_tpu import CameraConfig, SceneStatic
    from wurblpt_tpu.render.aov import get_ground_truth
    from wurblpt_tpu.render.sensor import SensorTofAmcw

    for i in range(4):
        t0 = time.perf_counter()
        _, _, render = _tof(i)
        img, stats = render()
        img = np.asarray(img)
        img64 = img.astype(np.float64)
        print(json.dumps({"frame": "tof", "phase_index": i, "mean": float(img64.mean()),
                          "channels": [float(img64[..., c].mean()) for c in range(3)],
                          "mean_f32": float(img.mean()),
                          "channels_f32": [float(img[..., c].mean()) for c in range(3)],
                          "stats": [int(x) for x in np.asarray(stats)],
                          "render_s": time.perf_counter() - t0}))
    phases = []
    for i in range(4):
        scene, cam, render = _tof(i, depth=1)
        phases.append(SensorTofAmcw(phase_index=i).phase(render()[0]))
    dist, _, intensity = SensorTofAmcw().result(phases)
    truth = get_ground_truth(scene, SceneStatic.from_scene(scene), cam, CameraConfig(), 96, 96,
                             aovs=("distance", "hit_mask"))
    lit = (np.asarray(intensity) > 0) & (np.asarray(truth["hit_mask"]) > 0)
    err = np.abs(np.asarray(dist) - np.asarray(truth["distance"]))[lit]
    print(json.dumps({"frame": "tof", "depth": 1, "median_abs_err_m": float(np.median(err)),
                      "p90_abs_err_m": float(np.quantile(err, 0.9)),
                      "max_abs_err_m": float(err.max()), "lit_pixels": int(lit.sum())}))


def _aov_report(name):
    """get_ground_truth with every channel of ALL_AOVS on the normalmap
    scene at 320 x 320 (its app's camera), or on the animated Cornell box
    at 128 x 128 (t 0.5, the flows to 0.25 and 0.75): each channel's float64
    mean and the hit count (kernel_check.AOV_REFS)."""
    import numpy as np

    from wurblpt_tpu import CameraConfig, SceneStatic, make_camera
    from wurblpt_tpu.core.transform import from_lookat
    from wurblpt_tpu.render.aov import ALL_AOVS, get_ground_truth
    from wurblpt_tpu_torch.utils import kernel_check as kc

    width, t, t_prev, t_next = kc.AOV_FRAMES[name]
    if name == "normalmap":
        scene, (eye, center, vfov) = jax_example_scene("normalmap")
    else:
        scene = jax_cornell_animated(t=t)
        eye, center, vfov = (0.0, 1.0, 3.2), (0.0, 1.0, -1.0), 50.0   # cornell_ref_camera
    cam = make_camera(transformation=from_lookat(eye, center), vfov_deg=vfov, width=width,
                      height=width)
    t0 = time.perf_counter()
    gt = get_ground_truth(scene, SceneStatic.from_scene(scene), cam, CameraConfig(), width,
                          width, t=t, t_prev=t_prev, t_next=t_next, aovs=ALL_AOVS)
    print(json.dumps({"aov": name, "means": {k: float(np.asarray(v, np.float64).mean())
                                             for k, v in gt.items()},
                      "hits": int(np.asarray(gt["hit_mask"]).sum()),
                      "render_s": time.perf_counter() - t0}))


FRAMES = {"city": _city, "envmap": _envmap, "rtiow": _rtiow, "tof": None,
          "cornell_animated": _cornell_animated,
          "rtiow_bvh": lambda: _rtiow(n=22, use_bvh=True),
          "cornell_animated_bvh": _cornell_animated_bvh,
          "noise_textures": lambda: _example("noise_textures"),
          "normalmap": lambda: _example("normalmap"),
          "material_comparison": lambda: _example("material_comparison"),
          "participating_media": lambda: _example("participating_media"),
          "stagelights": lambda: _example("stagelights"),
          "rolling_marbles": lambda: _motion("rolling_marbles"),
          "animations": lambda: _motion("animations"),
          "cornell_animated_blur": lambda: _motion("cornell_animated_blur"),
          "rtiow_dof": _rtiow_dof,
          "rgl_grad_tables": None, "rgl_grad_tables_128": None, "rgl_camera_grad": None,
          "sky_yaw_grad": None, "aov_normalmap": None, "aov_cornell_animated": None}


def main():
    import numpy as np

    name = sys.argv[1] if len(sys.argv) > 1 else "city"
    if name not in FRAMES:
        raise SystemExit(f"usage: jax_frame_reference.py [{'|'.join(FRAMES)}]")
    if name == "tof":
        return _tof_report()
    if name == "rgl_grad_tables":
        return _rgl_grad_tables()
    if name == "rgl_grad_tables_128":
        return _rgl_grad_tables(128, 4, 16)
    if name == "rgl_camera_grad":
        return _rgl_camera_grad()
    if name == "sky_yaw_grad":
        return _sky_yaw_grad()
    if name.startswith("aov_"):
        return _aov_report(name[4:])
    t0 = time.perf_counter()
    scene, render = FRAMES[name]()
    t_build = time.perf_counter() - t0
    t0 = time.perf_counter()
    img, stats = render()
    img = np.asarray(img)
    print(json.dumps({"frame": name, "n_tris": int(scene.n_tris),
                      "n_spheres": int(scene.n_spheres),
                      "n_lights": int(scene.light_prims.shape[0]),
                      "bvh": scene.bvh is not None,
                      "mean": float(img.astype(np.float64).mean()),
                      "stats": [int(x) for x in np.asarray(stats)], "max_lanes": MAX_LANES,
                      "build_s": t_build, "render_s": time.perf_counter() - t0}))


if __name__ == "__main__":
    main()
