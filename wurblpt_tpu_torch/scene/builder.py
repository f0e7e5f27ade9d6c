"""Host-side scene construction (port of ``wurblpt_tpu/scene/builder.py``): the
descriptors of textures, materials, meshes, instances, spheres, media,
environment maps and keyframe animations, and `Scene`, which collects them
and builds the flat :class:`~wurblpt_tpu_torch.scene.ir.SceneArrays`.

Mirrors the reference's ``Scene::take(...)`` ownership API (scene.hpp:86-141)
and ``Mesh`` / ``MeshInstance`` (mesh.hpp). `Scene.build` lowers the scene
through the port's flattener (:func:`wurblpt_tpu_torch.scene.flatten.flatten_scene`,
which hands the meshes and the material table to `flatten_meshes`), so a
scene built here equals the JAX package's build of the same descriptors
field by field. Poses are the port's
:class:`~wurblpt_tpu_torch.core.transform.Transformation`.

    scene = Scene()
    m = scene.take_material(Lambertian(albedo=CheckerTexture(squares=(8, 8))))
    scene.take_mesh_instance(MeshInstance(generate_quad(), m))
    scene.take_sphere(SphereObject((0, 2, 1), 0.3, LightDiffuse(radiance=(10,) * 3)),
                      hot_spot=True)
    arrays = scene.build(device="cuda")
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple, Union

import numpy as np

from ..core.color import vec4
from ..core.transform import Transformation  # noqa: F401  (a descriptor's pose)
from ..render.envmap import (  # noqa: F401  (the envmap descriptors are the builder's too)
    EnvironmentMapConstant,
    EnvironmentMapCube,
    EnvironmentMapEquiRect,
)
from .ir import TextureType

_f32 = np.float32

# ---------------------------------------------------------------------------
# Textures
# ---------------------------------------------------------------------------


@dataclass
class Texture:
    uv_scale: Tuple[float, float] = (1.0, 1.0)
    uv_offset: Tuple[float, float] = (0.0, 0.0)
    val_scale: Tuple[float, float, float, float] = (1.0, 1.0, 1.0, 1.0)
    val_offset: Tuple[float, float, float, float] = (0.0, 0.0, 0.0, 0.0)


@dataclass
class ConstantTexture(Texture):
    color: Sequence[float] = (1.0, 1.0, 1.0)


@dataclass
class CheckerTexture(Texture):
    color1: Sequence[float] = (0.0, 0.0, 0.0)
    color2: Sequence[float] = (1.0, 1.0, 1.0)
    squares: Tuple[int, int] = (8, 8)


@dataclass
class ImageTexture(Texture):
    image: np.ndarray = None     # [H, W, C] float (linear) or uint8
    srgb: bool = True            # uint8 inputs are sRGB-decoded at build time
    linear_filtering: bool = True


@dataclass
class NoiseTexture(Texture):
    kind: int = TextureType.PERLIN_NOISE
    octaves: int = 4
    frequency: float = 4.0
    gain: float = 0.5
    seed: int = 0
    # PERLIN only: |sum_i gain^i perlin(2^i f uv)|, the reference's
    # TexturePerlinNoise::turbulence (texture_noise.hpp:239-251); False: one
    # signed octave (::value, :192-237).
    turbulence: bool = False


# ---------------------------------------------------------------------------
# Materials
# ---------------------------------------------------------------------------

TexOrColor = Union[Texture, Sequence[float], float, None]


@dataclass
class Material:
    normal_map: Optional[Texture] = None
    two_sided: bool = False


@dataclass
class Lambertian(Material):
    """Cosine-sampled diffuse (material_lambertian.hpp:35-120)."""
    albedo: TexOrColor = (0.5, 0.5, 0.5)


@dataclass
class GGX(Material):
    """Anisotropic GGX with VNDF sampling (material_ggx.hpp:36-278)."""
    albedo: TexOrColor = (1.0, 1.0, 1.0)   # F0
    roughness: Union[float, Tuple[float, float]] = 0.2


@dataclass
class Glass(Material):
    """Specular dielectric, per-channel IOR dispersion, Beer-Lambert
    absorption (material_glass.hpp:35-204)."""
    ior: Union[float, Sequence[float]] = 1.5
    absorption: Sequence[float] = (0.0, 0.0, 0.0, 0.0)

    @staticmethod
    def absorption_from_transparent_color(color, dist: float = 1.0) -> np.ndarray:
        """transparentColor -> absorption coefficients (material_glass.hpp:154-187)."""
        c = np.clip(vec4(color), 1e-6, 1.0)
        return (-np.log(c) / dist).astype(_f32)


@dataclass
class Mirror(Material):
    """Perfect specular reflector (material_mirror.hpp:36-82)."""
    color: TexOrColor = (1.0, 1.0, 1.0)


@dataclass
class ModPhong(Material):
    """Energy-normalized modified Phong (material_modphong.hpp:35-357); each
    colour may be a texture (map_Kd, map_Ks, map_Ke), the opacity a texture
    read in .r (map_d)."""
    diffuse: TexOrColor = (0.5, 0.5, 0.5)
    specular: TexOrColor = (0.0, 0.0, 0.0)
    shininess: float = 0.0
    opacity: TexOrColor = 1.0
    emissive: TexOrColor = (0.0, 0.0, 0.0)
    ior: float = 1.0
    transmissive: TexOrColor = (0.0, 0.0, 0.0)


@dataclass
class PhaseIso(Material):
    """Isotropic phase function of a medium (material_phase_function_isotropic.hpp)."""
    albedo: TexOrColor = (1.0, 1.0, 1.0)


@dataclass
class LightDiffuse(Material):
    """Diffuse area light (light_diffuse.hpp:33-76)."""
    radiance: TexOrColor = (1.0, 1.0, 1.0)


@dataclass
class LightSpot(Material):
    """Spot light with an opening angle (light_spot.hpp:32-75)."""
    radiance: TexOrColor = (1.0, 1.0, 1.0)
    half_angle: float = np.deg2rad(22.5)


@dataclass
class LightTof(Material):
    """NIR-only ToF illumination unit (light_tof.hpp:37-89)."""
    radiance_w: float = 1.0
    half_angle: float = np.deg2rad(22.5)


@dataclass
class RGLMaterial(Material):
    """Measured RGL BRDF (material_rgl.hpp); its tables registered with
    `Scene.take_rgl_table` under `table_name`."""
    table_name: str = ""


# ---------------------------------------------------------------------------
# Geometry
# ---------------------------------------------------------------------------


@dataclass
class Mesh:
    """Indexed triangle mesh (mesh.hpp:74-153), structure of arrays."""
    positions: np.ndarray                   # [V, 3]
    normals: Optional[np.ndarray] = None    # [V, 3]; None: area-weighted smooth normals
    texcoords: Optional[np.ndarray] = None  # [V, 2]
    tangents: Optional[np.ndarray] = None   # [V, 3]; None: from the uv gradients
    indices: np.ndarray = None              # [F, 3] int; None: consecutive triples

    def __post_init__(self):
        self.positions = np.asarray(self.positions, _f32).reshape(-1, 3)
        if self.indices is None:
            self.indices = np.arange(len(self.positions), dtype=np.int32).reshape(-1, 3)
        self.indices = np.asarray(self.indices, np.int32).reshape(-1, 3)
        if self.normals is not None:
            self.normals = np.asarray(self.normals, _f32).reshape(-1, 3)
        if self.texcoords is not None:
            self.texcoords = np.asarray(self.texcoords, _f32).reshape(-1, 2)
        if self.tangents is not None:
            self.tangents = np.asarray(self.tangents, _f32).reshape(-1, 3)


@dataclass
class MeshInstance:
    mesh: Mesh
    material: Union[Material, int, str]
    transformation: Optional[Transformation] = None   # static pose, baked at build
    animation: Optional[int] = None   # id from Scene.take_animation; applies on top


@dataclass
class SphereObject:
    center: Sequence[float]
    radius: float
    material: Union[Material, int, str]
    transformation: Optional[Transformation] = None
    animation: Optional[int] = None


@dataclass
class MediumObject:
    """Homogeneous medium inside a boundary (hitable_medium.hpp:38-99): a
    sphere (its transformation's translation and largest scale apply) or a
    mesh instance; `phase` is its phase function (`PhaseIso`)."""
    boundary: Union[MeshInstance, SphereObject]
    density: float = 1.0
    phase: Material = None


@dataclass
class AnimationKeyframes:
    """Sorted (time, Transformation) keyframes (animation_keyframes.hpp:51-216)."""
    times: Sequence[float]
    transformations: Sequence[Transformation]


# ---------------------------------------------------------------------------
# Scene
# ---------------------------------------------------------------------------

HOT_SPOT = True
COLD_SPOT = False


class Scene:
    """Collects content; `build()` flattens it to SceneArrays."""

    def __init__(self):
        self._materials: List[Material] = []
        self._material_names = {}
        self._instances: List[Tuple[MeshInstance, bool]] = []
        self._spheres: List[Tuple[SphereObject, bool]] = []
        self._media: List[MediumObject] = []
        self._animations: List[Optional[AnimationKeyframes]] = [None]   # id 0: the identity
        self._envmap = None
        self._rgl_tables = {}
        self._inline_material_ids = {}

    def take_material(self, material: Material, name: Optional[str] = None) -> int:
        idx = len(self._materials)
        self._materials.append(material)
        if name is not None:
            self._material_names[name] = idx
        return idx

    def material_index(self, name: str) -> int:
        return self._material_names[name]

    def take_animation(self, anim: AnimationKeyframes) -> int:
        self._animations.append(anim)
        return len(self._animations) - 1

    def take_mesh_instance(self, inst: MeshInstance, hot_spot: bool = False) -> None:
        self._instances.append((inst, hot_spot))

    def take_sphere(self, sph: SphereObject, hot_spot: bool = False) -> None:
        self._spheres.append((sph, hot_spot))

    def take_medium(self, medium: MediumObject) -> None:
        self._media.append(medium)

    def take_rgl_table(self, name: str, source) -> None:
        """Register a measured RGL dataset under `name` for RGLMaterial
        (MaterialRGL ctor, material_rgl.hpp:57-59): a .bsdf tensor_file path,
        a parsed field dict, or a table dict of `materials.rgl.load_rgl_material`."""
        from ..materials.rgl import load_rgl_material

        if isinstance(source, dict) and "vndf_data" in source:
            self._rgl_tables[name] = source
        else:
            self._rgl_tables[name] = load_rgl_material(source)

    def set_environment_map(self, env) -> None:
        self._envmap = env

    def _resolve_material(self, m) -> int:
        """A material's row: an index as given, a name through `material_index`,
        an inline Material registered on its first resolve (idempotent)."""
        if isinstance(m, (int, np.integer)):
            return int(m)
        if isinstance(m, str):
            return self._material_names[m]
        key = id(m)
        if key not in self._inline_material_ids:
            self._inline_material_ids[key] = self.take_material(m)
        return self._inline_material_ids[key]

    def build(self, max_image_dim: int = 2048, use_bvh=None, t0: float = 0.0, t1: float = 0.0,
              light_sampling: str = "power", device="cuda"):
        """Flatten to SceneArrays on `device` (the GPU unless told otherwise).
        `use_bvh`: None builds the port's BVH from 512 primitives on;
        animated primitives get boxes swept over [t0, t1]. `light_sampling`:
        "power" (power-proportional pick tables) or "uniform" (the
        reference's uniform hot-spot pick, wurblpt.hpp:187). `max_image_dim`
        is the JAX signature's; neither package resizes images."""
        from .flatten import flatten_scene

        return flatten_scene(self, max_image_dim=max_image_dim, use_bvh=use_bvh, t0=t0, t1=t1,
                             light_sampling=light_sampling, device=device)
