"""wurblpt_tpu_torch: the PyTorch + CUDA port of the wurblpt_tpu path tracer.

It mirrors the JAX package's layout (``core/``, ``scene/``, ``render/``,
``utils/``) and function names. It imports torch and numpy, never jax: the
JAX package ``wurblpt_tpu`` is the reference it is tested against. Kernels
written by hand for Hopper live in ``csrc/`` and are built at first use
(:mod:`wurblpt_tpu_torch.native`).

Ported so far: the persistent-lane wavefront render of static scenes, and
of scenes with rigid keyframe animation at one instant, with a
pinhole camera (with lens distortion) or an equirect surround camera (mono
or stereo), SensorRGB and the AMCW time-of-flight sensor SensorTofAmcw:
Lambertian, GGX, mirror, glass, ModPhong, measured RGL, diffuse-, spot- and
ToF-light materials, triangles and analytic spheres, triangle and sphere hot
spots with mixture or per-light MIS, an importance-sampled equirect sky, a
cube-map sky with or without importance sampling, a constant sky,
homogeneous participating media with the isotropic phase function (KM,
:mod:`.render.media`; the generic bounce), on the brute-force
intersector or the port's BVH (triangle and sphere leaves, static or
animated), the ground-truth AOVs (`get_ground_truth`, :mod:`.render.aov`)
and OBJ/MTL export and import (see ROADMAP.md for the rest). Scenes of the diffuse class (Lambertian surfaces,
triangle lights, no sky, a pinhole camera without distortion) take one
wavefront step as hand-written kernels (K4, :mod:`.render.wavefront`).
The pass renderer (`render_frame`) renders the same paths, takes sphere
lights, and with `RenderParams(differentiable=True)` puts the image on the
autograd tape (backward kernels for P0, K3, K7 and K8); `inverse.fit` fits
scene or camera parameters to a target image. Users build their scenes with
`Scene` and the builder's descriptors (textures: constant, checker, image,
noise; every material, normal maps; meshes, instances, spheres, keyframe
animations, the three environment maps), as with the JAX package.
Scene, camera and table builders build on the GPU unless told otherwise.
"""

from .core.transform import Transformation, from_lookat  # noqa: F401
from .render.aov import ALL_AOVS, get_ground_truth  # noqa: F401
from .render.bsdf import SceneStatic  # noqa: F401
from .render.camera import CameraConfig, CameraParams, camera_rays, make_camera  # noqa: F401
from .render.integrator import (  # noqa: F401
    RenderParams,
    accumulate_passes,
    prepare_scene,
    render_frame,
    render_frame_progressive,
    render_frame_wavefront,
    trace_paths,
)
from .render.media import apply_media  # noqa: F401
from .render.sensor import SensorRGB, SensorTofAmcw  # noqa: F401
from .scene.builder import (  # noqa: F401
    GGX,
    AnimationKeyframes,
    CheckerTexture,
    ConstantTexture,
    EnvironmentMapConstant,
    EnvironmentMapCube,
    EnvironmentMapEquiRect,
    Glass,
    ImageTexture,
    Lambertian,
    LightDiffuse,
    LightSpot,
    LightTof,
    MediumObject,
    Mesh,
    MeshInstance,
    Mirror,
    ModPhong,
    NoiseTexture,
    PhaseIso,
    RGLMaterial,
    Scene,
    SphereObject,
)
from .scene.ir import MediumArrays, SceneArrays, TextureType, scene_from_numpy  # noqa: F401
