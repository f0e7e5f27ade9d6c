"""wurblpt_tpu_torch: the PyTorch + CUDA port of the wurblpt_tpu path tracer.

It mirrors the JAX package's layout (``core/``, ``scene/``, ``render/``,
``utils/``) and function names. It imports torch and numpy, never jax: the
JAX package ``wurblpt_tpu`` is the reference it is tested against. Kernels
written by hand for Hopper live in ``csrc/`` and are built at first use
(:mod:`wurblpt_tpu_torch.native`).

Ported so far: the persistent-lane wavefront render of static scenes with a
pinhole camera (with lens distortion) or an equirect surround camera (mono
or stereo) and SensorRGB: Lambertian, GGX, mirror, glass, ModPhong, measured
RGL and diffuse-light materials, triangles and analytic spheres, triangle
hot spots with mixture or per-light MIS, an importance-sampled equirect sky,
a cube-map sky with or without importance sampling, a constant sky, on the
brute-force intersector or the port's BVH, and OBJ/MTL export and import
(see ROADMAP.md for the rest). Scene, camera and table builders build on
the GPU unless told otherwise.
"""

from .core.transform import Transformation, from_lookat  # noqa: F401
from .render.bsdf import SceneStatic  # noqa: F401
from .render.camera import CameraConfig, CameraParams, camera_rays, make_camera  # noqa: F401
from .render.integrator import RenderParams, render_frame_wavefront  # noqa: F401
from .render.sensor import SensorRGB  # noqa: F401
from .scene.ir import SceneArrays, scene_from_numpy  # noqa: F401
