#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port (``wurblpt_tpu_torch``) on one GPU.

    python3 chip_smoke.py          # from the repository root, one NVIDIA GPU

Phases, each a function, any failure exits non-zero and names its phase:

1. build  - compile the hand-written kernels of csrc/ with nvcc (sm_90a), one
   nvcc per source, all at once; compile the host BVH builder with g++.
2. scenes - terrain_city(seed=3) (102098 triangles) and city_night(seed=7)
   (249218 triangles after its OBJ/MTL round trip, 192 light triangles, an
   RGL sphere), each built on the card's host with its BVH (its nodes, leaf
   rows, depth and table size printed);
   envmap_spheres(cube=True) (2 triangles, 3 spheres, a cube-map sky with a
   64 x 64 importance table), rtiow() (40 spheres, no triangle, a constant
   sky), tof_box() (54 triangles, 32 of them the ToF light),
   cornell_box_animated() (36 triangles, 4 animation rows: the short box
   turning, the tall box and the light sliding), the same with two spheres
   (one riding the short box's turn), and ROADMAP C.1's brute-force fields:
   sphere_field() with 3000 and 4096 spheres (the K1 form's 6144 and 8192
   columns) and tri_sphere_field() (2000 triangles and 40 spheres, 8448
   columns: the sweeps), tri_sphere_field(2048, 0) (8192 columns: K1's
   largest table, 128 KB) and tri_sphere_field(3600, 40) (a sweep table
   KS1 stages in chunks); and the two scenes cast through a BVH with sphere
   and object-space leaves: rtiow(n=22, use_bvh=True) (the reference's
   full RTIOW field, 488 spheres) and cornell_box_animated(spheres=True,
   use_bvh=True) (36 triangles and 2 spheres, the boxes swept at t = 0.5).
3. kernels - each kernel against its plain PyTorch version on the card, at
   its path's shapes, with the tolerances of utils/kernel_check.py; each
   kernel's wrapper-call time beside the plain version's and, where one
   PyTorch call computes the same function, that call's (CUDA events around
   20 calls after warm-up), and its bound: the least time an H100 could take
   for the same work (kernel_check.bound_ms). K1-K3 on the Cornell frame's
   block (128 x 128 pixels x 8 sample lanes = 131072 lanes); K5 on the mesh
   frame's 76800 camera rays and random rays, K6 on env-NEE shadow rays from
   their first hits and random rays, both also with every lane dead and on
   1000 lanes (bit-equal); K8's equirect branch on the city
   frame's night sky, its block's 1048576 camera directions and uniforms;
   K7 bit-equal on 1048576 lanes of the city frame's block (camera hits
   and their bounce directions, random tangent-space lanes), on the lanes
   of each of its calls in one pass of material_comparison (its main path:
   every lane of a bounce, the other materials' with id -1, which K7
   skips; the pass's RGL share printed) and on 262144 lanes of two wide
   synthetic tables (128 x 128 and 33 x 33 rows, ids -1, 0 and 1), its two
   records timed on the pass's calls with the most RGL lanes and its
   device us a launch printed on every call and set; P0 on the Pallas
   probe's shapes and on the city's material rows at 1048576 lanes (K8's
   equirect branch, K7 and the material rows now run inside K4's shades;
   their stand-alone kernels stay checked here). K1-K3
   also on the rtiow frame's 98304 camera rays (spheres alone, no triangle),
   K1 and K3 on the envmap frame's 131072 camera rays (triangles and spheres
   together) and K2 on its env-NEE shadow rays; K8 on the cube map
   (the envmap frame's 131072 camera directions, random directions, and
   the axis, diagonal, face-edge and texel-boundary directions) and on the
   constant map, both bit-equal. K1, K2 and K3 also on the C.1 sphere
   fields' 98304 camera rays (3000 and 4096 spheres; K2 on shadow rays from
   their first hits to random sky directions). K2 also on its edge cases
   (kernel_check.k2_edge_sets: every lane dead, one live lane, blockers
   that are the table's last triangle or last sphere, rays at the tests'
   edges: triangle edges and corners, |det| about 1e-12, t_max and t_min at
   a hit's distance or a float either side), and KS1 on its own
   (kernel_check.ks1_edge_sets: the same lanes, ties across the threads of
   one ray, animation ids that change at every primitive, 12 animation
   rows, edges on the static walls) and on a 3600-triangle field that it
   stages in chunks, and KS2 likewise (kernel_check.ks2_edge_sets: a
   static and an animated table whose last primitive is the only blocker,
   blockers only in one animation's object space, one live lane, grazing
   rays, t a float either side of the bounds, dead rows with stale
   directions; the same field's sky shadow rays in chunks). K1 and K2 also on the
   2048-triangle field's camera rays (K1 with half of them dead too) and
   sky shadow rays, and on the Cornell block's camera and shadow rays and
   rtiow's camera rays with dead lanes scattered at the K1 frames' live
   shares (kc.scatter_dead: t_max 0, t_min or NaN); K1 and K2 are held bit
   for bit there and everywhere (no lane's outputs differ in a bit). P0
   also on [37, C] tables of random words and NaN payloads, C = 1, 3, 23
   and 128, with indices outside the table; its device time
   (kernel_check.device_ms) beside index_select's on the city's material
   rows. The sweeps KS1 and KS2 and the hit assembly (K3 static, K3a
   animated) against their plain versions, bit-equal, on three sets of
   rays: the cornell_animated frame's block
   (131072 camera rays, random rays, and NEE shadow rays toward the light
   where it is at t = 0.5), tri_sphere_field's camera rays (static sweeps)
   and the animated Cornell box with spheres (the camera rays: the sphere
   branches in object space); KS1, KS2 and K3a timed on the
   cornell_animated block. K5 and K6 with sphere rows and object-space
   rays, bit-equal, on the rtiow_bvh block (98304 camera rays, random rays,
   sky shadow rays; sphere rows, world rays) and the cornell_animated_bvh
   block (131072 camera rays, random rays and the moving light's NEE
   shadow rays, with the frame's animation rows and, on the same rows at
   rest, without them), each also with every lane dead, and the animated
   box without spheres (triangle rows in object space and at rest), each
   on the branch its tree's size picks (all of them staged in shared
   memory) and again on the L2 walk; and on kernel_check.bvh_leaf_edge_sets
   on both branches (grazing, inside and tangent rays on the RTIOW field,
   rays aimed at every row of the animated box, axis rays at vertices with
   signed zeros, a triangle and a sphere tied, t_max at and a float beyond
   a hit, one live lane, every lane dead, lane counts about the launch's
   resident threads, a tree just past the staging budget); timed there.
   K3's K4 form (the fields of one shade class's set, on hit lanes only)
   with each frame's set on the winners before each K4 frame's shade, and
   with every set, static and animated, on kernel_check.k3_edge_sets (no
   hit lane in a tile, one, every lane hit, triangle and sphere winners
   alternating, degenerate tangents and sphere poles, backside hits,
   animations side by side, 1111 lanes): its outputs filled first, the
   set's fields bit-equal to the plain version's on hit lanes and every
   miss lane as it was filled; timed on the Cornell, mesh, city and
   cornell_animated blocks. Motion blur (each lane's own frame rows,
   anim_frames_per_ray): KS1, KS2 and K3a's full form bit-equal (K3a
   within K3's tolerance) on the rolling_marbles pass's 518400 camera rays
   (times in its shutter), random rays and sphere-light shadow rays, and
   on the cornell_animated block's camera and random rays (times in [0,
   1]); K5 and K6 on the cornell_animated_blur tree (swept over [0, 1]:
   camera, random and moving-light shadow rays, every lane dead) on the
   branch its size picks and on the L2 walk; timed there (records
   `*_per_ray`, each with its device us a launch). The thin lens in the
   pinhole regeneration (record `regen_dof`) with the other K4 kernels on
   the rtiow_dof frame's first block.
4. main path - the Cornell bench frame (128 x 128, 16 spp, 8 path
   components, SensorRGB) through render_frame_wavefront on the GPU. K1,
   K2, K3's K4 form and K4 must be launched and P0 and K3's full form not, the image must be finite, its
   mean within 1e-3 relative of the JAX package's deterministic CPU output,
   and the cast counters within 0.5 % of it.
5. mesh path - the bvh_100k bench frame (160 x 120, 4 spp, 4 path
   components, GGX and mirror spheres under the importance-sampled equirect
   sky) through K4's env class: the regeneration, K5, K3's K4 form, the env shade
   and K6 must be launched, and neither P0, the resolve nor K8's
   stand-alone kernels (the shade reads the sky inline); the frame held to its JAX
   reference as in phase 4.
6. city path - the city_many_lights bench frame (1920 x 1080, 360-degree
   stereo, 1 spp, 4 path components; ModPhong, RGL, 192 window triangles
   under per-light MIS beside the importance-sampled night sky) through
   K4's lit class: the surround regeneration, K5, K3's K4 form, the lit shade (RGL,
   the sky and the material rows inline) and K6 (the light and sky shadow
   rays in one cast) must be launched, and neither P0, the resolve, K7's
   nor K8's stand-alone kernels; the frame held to its JAX reference
   as in phase 4.
7. envmap path - the envmap_cube_is bench frame (128 x 128, 16 spp, 8 path
   components; glass, mirror and GGX spheres under the importance-sampled
   cube-map sky) through K4's env class: the regeneration, K1, K3's K4 form, the env
   shade (its cube-sky and glass instantiation) and K2 must be launched,
   and neither P0, the resolve nor K8's stand-alone kernels; the frame
   held to its JAX reference as in phase 4.
8. rtiow path - the rtiow_distortion bench frame (192 x 128, 16 spp, 8 path
   components, OpenCV lens, 40 spheres under a constant sky) through K4's
   env class: the regeneration (with the lens's fixed point), K1, K3's K4 form, the
   env shade (its constant-sky and glass instantiation) must be launched,
   and neither K2 (no light, no sky importance: no shadow ray), P0, the
   resolve nor K8's stand-alone kernels; the frame held to its JAX
   reference as in phase 4.
9. tof path - the tof_amcw bench frame (96 x 96, 16 spp, 6 path components,
   SensorTofAmcw, the ToF cone light with per-light MIS) at phase 0: K1,
   K2, K3's K4 form and K4 (regeneration, shade) must be launched and neither P0
   nor the resolve, and the frame held to its JAX reference (mean energy, the three
   channel means, counters); phases 1-3 keep the counters and the mean
   and phase 2 swaps the buckets a and b; the 4-phase distance at depth 1
   is held to the first-hit distance of the pixel-centre rays (median
   under 2 mm).
10. cornell_animated path - the animated Cornell frame (128 x 128, 16 spp,
   8 path components, SensorRGB, t0 = t1 = 0.5) through render_frame_wavefront
   on K4's diffuse class with the scene's casts: the regeneration, KS1, K3a's K4 form,
   the diffuse shade (the moving light placed at t = 0.5 in the frame's step
   tables) and KS2 must be launched, and neither K1, K2, K3, P0 nor the
   resolve; the frame held to its JAX reference as in phase 4
   (`jax_frame_reference.py cornell_animated`), at most 6.00 launches per
   step of the loop and 310 per frame.
11. rtiow_bvh path - the full RTIOW field in a BVH (rtiow(n=22,
   use_bvh=True), rtiow's settings: 192 x 128, 16 spp, 8 path components,
   the OpenCV lens, the constant sky) through K4's env class: the lens
   regeneration, K5 (its sphere rows), K3's K4 form, the env shade (constant sky,
   glass) must be launched, and neither K1, KS1, K6 (no shadow ray), P0,
   the resolve nor K8's stand-alone kernels; the frame held to its JAX
   reference (`jax_frame_reference.py rtiow_bvh`: the JAX package's BVH
   route) as in phase 4, at most 4.00 launches per step of the loop and 8
   per step of the frame.
12. cornell_animated_bvh path - the animated box with its two spheres in a
   BVH swept at t = 0.5, rendered as cornell_animated through K4's diffuse
   class: the regeneration, K5 and K6 (object-space rays over triangle and
   sphere rows, static and animated), K3a's K4 form and the diffuse shade must be
   launched, and neither K1, K2, K3, KS1, KS2, P0 nor the resolve; the
   frame held to its JAX reference (`jax_frame_reference.py
   cornell_animated_bvh`), at most 5.00 launches per step of the loop and
   295 per frame.

A K4 step is the regeneration, which first adds the step before's NEE
deposits (the NEE resolve, folded in) and flags the loop condition, then
the closest-hit cast, the hit assembly (K3's K4 form: the fields the
class's shade reads, on hit lanes only; no hit mask), the shade and the
any-hit cast;
each block's loop ends at a regeneration that finds no work, and the
stand-alone resolve (wpt_nee_resolve) launches on no path. The Cornell
frame (phase 4) and the ToF frame take K4's diffuse class (regeneration,
K1, K3, wpt_shade_diffuse, K2), the cornell_animated frame the same class
around the sweeps (regeneration, KS1, K3a, wpt_shade_diffuse, KS2), the
cornell_animated_bvh frame around K5 and K6 in object space
(regeneration, K5, K3a, wpt_shade_diffuse, K6), the rtiow_bvh frame the
env class around K5's sphere rows (regeneration, K5, K3, wpt_shade_env),
the mesh frame K4's env class (regeneration, K5, K3, wpt_shade_env, K6),
the envmap and rtiow frames the env class on the brute-force casts
(regeneration, K1, K3, wpt_shade_env, K2 where the sky is
importance-sampled), the city frame K4's lit class (wpt_regen_surround
adding two pending deposits per lane, K5, K3, wpt_shade_lit, K6 on 2 x
1048576 shadow rays).
The kernels phase holds each K4 kernel against its plain version on the
first block of the nine frames after 2 steps (lanes live, dead and, where
a lane has samples left, due for regeneration) and on the city block as
the frame starts it (at 1 spp the one step where its lanes regenerate: the
surround regeneration is checked and timed there), the env shade also
with the ToF sensor on the mesh, envmap and rtiow blocks, the lit shade
with the ToF sensor on the city block, the regeneration also with the
RADIAL_ONLY and RADIAL_AND_PLANAR lenses on the rtiow block; a
regeneration is timed only on lanes that regenerate. K5 and K6 are also
held against their plain versions (bit-equal) and timed beside their bound
at every cast of the mesh frame (4 steps), the city frame (2 blocks of 4
steps), the rtiow_bvh frame and the cornell_animated_bvh frame, on the
rays each step gives, with each cast's live lanes (`utils/cast_steps.py`),
and so are K1 and K2 at every cast of the Cornell, ToF, envmap and rtiow
frames and KS1 and KS2 at every cast of the cornell_animated frame; the
lit shade and the surround regeneration at
every step of the city frame and the regeneration and the diffuse or env
shade at every step of the other eight frames' first block likewise, with
their live and regenerated lanes and their bounds in place and copying
(`utils/k4_steps.py`). The regenerations and
the shades update the lane state in place: each check gives every call
its own copy of the inputs, and each time restores them before every
call, outside the timed window (the device's time per call); a shade's
shadow directions are compared on the rows that cast (t_max > 0). Every path
prints its frame time, paths/s, Mrays/s, device time and kernel launches
per wavefront step, and apart from them the copies and memsets, and each
hand-written kernel's device time per launch (one more frame under
torch.profiler; the scene's tables are built once per scene, before the
frames); every path also the launches of one step of the loop
and of the frame's set-up, from the difference to the same frame at 1
path component. Cornell, ToF, envmap, rtiow and rtiow_bvh fail above 8
kernel launches per step of the frame; the mesh frame (4 steps, so its 32
launches of set-up alone come to 8 per step) above 56 per frame, the two
animated frames (the animations' and the moving light's rows, ~171
launches once per frame) above 295; every frame above 5.00 per step of
the loop (4.00 on rtiow and rtiow_bvh: no shadow ray; the city's 2 blocks
of 4 steps carry the set-up of two blocks). Each path's counters are set to 0 just before
it and read just after; a kernel's `launches` in the JSON line is the sum
over the paths that use it. The stand-alone K8 and K7 kernels run on no
path (their work runs inside K4's shades), so their records count 0
launches, and so do P0's and the resolve's; their `inline_in` lists the
kernel that does their work on a K4 path, the path and its launches there
(the resolve's: the regenerations of each path):
the equirect K8 record the env shade on the mesh path and the lit shade on
the city path; the cube and constant K8 records the env shade on the
envmap and rtiow paths; K7's two records and P0's (the material rows) the
lit shade on the city path. Each shade and regeneration record counts
those of its own paths (the diffuse shade and the pinhole regeneration
also the two animated paths', the lens
regeneration and the constant-sky env shade also the rtiow_bvh path's);
the sweeps' records those of the cornell_animated path, K3a's those of
both animated paths; K5's and K6's static triangle records those of the
mesh and city paths, their sphere-row record the rtiow_bvh path's and
their object-space records the cornell_animated_bvh path's.

13. rtiow_dof path - examples/rtiow.py's depth-of-field frame (rtiow(),
   320 x 200, 16 spp, 8 path components, aperture 0.08 focused at 10, 25
   degrees) through render_frame_wavefront on K4's env class: the pinhole
   regeneration through the thin lens, K1, K3's K4 form and the env shade
   must launch, and neither K2, P0, the resolve nor K8's stand-alone
   kernels; held to its JAX yardstick (`jax_frame_reference.py
   rtiow_dof`) as in phase 4, at most 4.00 launches per step of the loop
   and 8 per step of the frame.
14. motion - the motion-blurred frames (kernel_check.MOTION_FRAMES), one
   path each: rolling_marbles (examples/rolling_marbles.py frame 0: 320 x
   180, 9 spp, 8 path components, shutter [0, 1/48], five textured
   rolling spheres under a sphere light, one pass of 9 samples) and
   animations (examples/animations.py frame 0: 192 x 144, 16 spp, 6 path
   components, [0, 0.02]) through render_frame, and cornell_animated_blur
   (the animated box with its spheres in a BVH swept over [0, 1], the
   Cornell settings over [0, 1]) through render_frame_wavefront, which
   hands it to render_frame: KS1/KS2 (K5/K6 on the BVH), K3a's full form
   and P0 must launch with each lane's own frame rows, and no K4 kernel;
   each held to its JAX CPU yardstick (kernel_check.MOTION_REFS: mean
   within 1e-3, counters within 0.5 %); frame ms, peak memory and a
   profiled frame's launches and device time printed.
15. scene_api - the example apps' three scenes built through the port's
   Scene on the card (scenes.noise_textures: a checker floor and the five
   noise textures on spheres, a sphere light, a constant sky;
   scenes.normalmap: a 256 x 256 brick normal map on a quad; and
   scenes.material_comparison: a checker floor, anisotropic GGX,
   dispersive glass, mirror, ModPhong and an RGL sphere), one path each
   ("scene_api <name>"), rendered with render_frame at the apps' sizes
   (480 x 200, 320 x 320, 560 x 180; 16 spp in passes of 8; depth 5, 4,
   8) on the generic bounce with the counters at 0: K1, K2, K3's full
   form and P0 (the material rows and the texture ids) must launch on
   each, K8's constant branch on the two with a sky, K7's two kernels on
   material_comparison; each frame held to its JAX CPU yardstick
   (kernel_check.EXAMPLE_REFS: mean within 1e-3, counters within 0.5 %),
   material_comparison's also to its bits as K7 rendered it before it
   skipped the lanes without an RGL material (kernel_check.EXAMPLE_DIGESTS:
   the sha256 of its image and stats);
   frame ms (median of 5 after the first), and the CUDA kernel launches and
   device time of one profiled pass printed.
16. grad - the pass renderer and the differentiable render
   (utils/grad_check.py): first the backward kernels against their
   plain versions at a differentiable frame's shapes, each timed (wrapper
   call, device time a launch, plain version, `index_add_` for P0T)
   beside its bound: P0T on the Cornell block's material rows after 2
   bounces, K3T on that block's winners, on the floor step's 65536 camera
   winners (2 triangles) and on tri_sphere_field(2048, 40)'s 131072 camera
   lanes (tables past the 48 KB shared path: global atomics), K3aT on the
   animated box with spheres' 131072 camera winners and on the field
   animated by the box's rows, each with the rows of one instant and with
   per-ray rows (timed per ray), K8T on the envmap frame's
   directions on the equirect, the cube and the constant sky and a 512 x
   1024 procedural sky, K8T with its rotation term on the same skies
   turned by grad_check.SKY_ROTATION (timed on the equirect); K3T, K3aT
   and K8T timed on every one of those shapes beside their bounds, with
   the instantiation a profiled call launched (K3T and K3aT must each run
   both <ANIM, SHARED>: the tables in shared memory and global atomics)
   and the constant sky's g.sum(0), K8T's sample backward
   on 262144 uniforms of the turned equirect sky, K7T's tail form on
   131072 lanes of two synthetic RGL materials (eval and sample; timed on
   sample) and its full form on the same lanes with cotangents of the pdf
   and of sample's direction too (eval and sample; timed on sample, eval
   printed) (random cotangents; the scattered tables within 1e-4 of the
   sum of their terms' magnitudes, the sky's texels and rotation 1e-3,
   the per-lane cotangents within 1e-4 of the largest; K7T's full form
   against its plain version in float64, each table within 2e-3 of its
   largest |entry|). Then, with the counters at 0 (the grad path): `render_frame`
   on the Cornell bench frame (16 samples in one pass) held to its
   yardstick; the differentiable Cornell frame (128 x 128, 16 spp, depth
   8), d(mean)/d(emission scale) equal to the loss (rtol 1e-3) and
   d(mean)/d(white albedo) against a central difference (eps 5e-3, rtol
   5e-2); the envmap_spheres frame (equirect sky, the same size), d(mean)
   /d(sky scale) equal to the loss (rtol 5e-2); the sphere-lit floor at
   128 x 128 and at the JAX test's 12 x 12 (4 spp, depth 4), d(mean)
   /d(camera height) against a central difference (rtol 0.08; eps 1e-2 at
   128 x 128, whose shadow rays at the light's silhouette flip at eps
   1e-3); the RGL quad's d(mean)/d(rgb table scale) (K7T) and the
   textured quad's d(mean)/d(one texel) against central differences (eps
   1e-2 and 1/16, rtol 3e-2 and 8e-2: tests/test_gradients_breadth.py's
   scenes and tolerances); the moving floor over the shutter [0, 1]
   (utils/grad_check.moving_floor, 64 x 64, 4 spp, depth 3: per-ray rows,
   K3a and K3aT) with d(mean)/d(its vertices' y) and d(mean)/d(a keyframe's
   y translation) against central differences (eps 1e-2, rtol 3e-2); the
   sky's yaw on envmap_spheres' equirect from grad_check.SKY_YAW_VIEW
   (128 x 128, 16 spp, depth 8: K8T's rotation term and the sample's
   backward), its mean within 1e-3 and d(mean)/d(yaw) within 2e-2 of the
   JAX CPU yardstick (grad_check.SKY_YAW_REF); every float table of the
   RGL quad on the tape (K7T's full form), each table's digest against
   jax.grad's (grad_check.RGL_TABLE_REFS: the count of entries above 1e-6
   of its largest equal, sum, sum of |entry| and largest within 1e-2); the
   RGL quad's d(mean)/d(camera height) (the lane directions: K7T's full
   form with K3T) within 2e-2 of JAX's and 3e-2 of its central difference
   (eps 1e-3); `fit` recovering the lit quad's albedo at 128 x 128 (4 spp,
   40 Adam steps) within 0.06, and the sky's yaw from 8 degrees away
   (128 x 128, 4 spp, depth 2, 40 steps) within 1 degree, each with its
   last loss under a quarter of its first.
   Each differentiable step prints its forward and backward ms, the
   port's kernel launches, peak memory and, from a profiled step, the
   CUDA kernel launches, device ms and busy share of each pass, with the
   backward kernels' launches and device ms (BWD_KERNELS). The JSON
   line's records of the backward kernels and of K3's full form,
   P0 and K1/K2/K8 count the grad path's launches (those of K1-K3, P0 and
   K7 the scene_api paths' too, K8's constant branch the scene_api paths').

Output, at the end: the card's name and power limit as nvidia-smi reports
them, one JSON line with the kernels, and as the last line
{"ok": true, "device": {...}}. No result is printed without a CUDA device.
"""

from __future__ import annotations

import collections
import json
import re
import statistics
import subprocess
import sys
import time
import traceback

DEVICE = "cuda"
kc = np = torch = None   # bound in main(): nothing is imported before the CUDA check

K4_PATHS = ("main path", "mesh path", "city path", "envmap path", "rtiow path", "tof path",
            "cornell_animated path", "rtiow_bvh path", "cornell_animated_bvh path",
            "rtiow_dof path")
GRAD_PATH = "grad path"
# The backward kernels by name (their share of a differentiable step's device time).
BWD_KERNELS = ("row_scatter_kernel", "assemble_hit_bwd_kernel", "env_radiance_bwd_kernel",
               "env_sample_bwd_kernel", "rgl_bwd_kernel")
BWD_NAME = r"(?:row_scatter|\w+_bwd)_kernel<[^>]*>"   # an instantiation's name in a profile
# The grad phase's K8T sky beside envmap_spheres' (a user's HDR sky, wider
# than the frames') and its K3T/K3aT tables past their shared path.
LARGE_SKY = "equirect 512 x 1024"
FIELD = "tri_sphere_field 2048 + 40"
# The example apps' scenes built through the port's Scene, one path each
# (phase scene_api): render_frame on the generic bounce, and the hand
# kernels each must launch there.
SCENE_API = {"noise_textures": ("closest_hit", "any_hit", "assemble_hit", "row_gather",
                                "env_radiance"),
             "normalmap": ("closest_hit", "any_hit", "assemble_hit", "row_gather"),
             "material_comparison": ("closest_hit", "any_hit", "assemble_hit", "row_gather",
                                     "env_radiance", "rgl_eval", "rgl_sample")}
SCENE_PATHS = tuple(f"scene_api {name}" for name in SCENE_API)
# The motion-blurred frames (kernel_check.MOTION_FRAMES), one path each
# (phase motion): render_frame over the shutter (cornell_animated_blur
# through render_frame_wavefront, which hands it to render_frame), each ray
# at its own time, on the generic bounce; the hand kernels each must launch
# there: the casts and K3a's full form with per-ray rows.
MOTION = {"rolling_marbles": ("sweep_closest", "sweep_any", "assemble_hit_anim", "row_gather"),
          "animations": ("sweep_closest", "sweep_any", "assemble_hit_anim", "row_gather"),
          "cornell_animated_blur": ("bvh_closest_hit", "bvh_any_hit", "assemble_hit_anim",
                                    "row_gather")}
MOTION_PATHS = tuple(f"{name} path" for name in MOTION)
MOTION_ABSENT = ("regen_pinhole", "regen_surround", "shade_diffuse", "shade_env", "shade_lit",
                 "assemble_hit_k4", "assemble_hit_k4_anim", "assemble_hit", "closest_hit",
                 "any_hit")
PATHS = K4_PATHS + SCENE_PATHS + MOTION_PATHS + (GRAD_PATH,)
# the paths whose animated casts read each ray's own rows (the grad path's
# animated step is over a shutter too), and the others
PER_RAY = MOTION_PATHS + (GRAD_PATH,)
ONE_INSTANT = tuple(p for p in PATHS if p not in PER_RAY)
# Kernel launches per step of a K4 frame's loop: the regeneration (which
# first adds the step before's NEE deposits and flags the loop condition),
# the closest-hit cast, K3's K4 form (K3a's animated; no hit mask: the
# record's readers test prim themselves), the shade and the any-hit cast; the two rtiow frames cast no shadow ray. Each block's loop ends with
# one more regeneration, which the frame's set-up counts (K5's and K6's
# lane counters and the loop flag's clear are memsets, not kernels).
K4_LOOP_LAUNCHES = 5.0
K4_LOOP_LAUNCHES_NO_SHADOW = 4.0
# Kernel launches per step of the frame with its set-up and its blocks'
# last regenerations (Cornell, envmap 7.00, ToF 7.67, rtiow and rtiow_bvh
# 5.00; the mesh frame, whose 4 steps carry 32 launches of set-up, is held
# to MESH_MAX_FRAME_LAUNCHES instead, the animated frames to
# ANIM_MAX_FRAME_LAUNCHES).
K4_MAX_LAUNCHES_PER_STEP = 8
MESH_MAX_FRAME_LAUNCHES = 56           # kernel launches of one mesh frame (52)
# kernel launches of one cornell_animated (or cornell_animated_bvh) frame
# (283): 16 steps, the lane state's set-up and, once per frame, the
# animations' rows at the frame's instant and the moving light's rows (~171
# PyTorch launches)
ANIM_MAX_FRAME_LAUNCHES = 295
PROFILE_TRIES = 10                     # profiles of a frame taken while the profiler loses events
# K1's live shares (t_max > t_min) on the Cornell, ToF, envmap and rtiow
# frames: closest casts over launches x lanes (PERF.md)
LIVE_SHARES = (0.54, 0.77, 0.26, 0.24)
ENV_ALL = ("env_radiance", "env_sample", "env_pdf")
# name -> (source, TPU kernel it replaces, launch counters, paths whose launches count)
KERNELS = {
    "closest_hit": ("wurblpt_tpu_torch/csrc/closest_hit.cu",
                    "wurblpt_tpu/render/intersect_mxu.py:164", ("closest_hit",), PATHS),
    "any_hit": ("wurblpt_tpu_torch/csrc/any_hit.cu",
                "wurblpt_tpu/render/intersect_mxu.py:259", ("any_hit",), PATHS),
    "assemble_hit": ("wurblpt_tpu_torch/csrc/assemble_hit.cu",
                     "wurblpt_tpu/render/intersect_mxu.py:345", ("assemble_hit",), PATHS),
    "bvh_closest_hit": ("wurblpt_tpu_torch/csrc/bvh_closest.cu",
                        "wurblpt_tpu/accel/traverse.py:511", ("bvh_closest_hit",),
                        ("mesh path", "city path")),
    "bvh_any_hit": ("wurblpt_tpu_torch/csrc/bvh_any.cu",
                    "wurblpt_tpu/accel/traverse.py:597", ("bvh_any_hit",),
                    ("mesh path", "city path")),
    # B.1.3: the leaf branches, K5's <spheres, animated> instantiations
    "bvh_closest_hit_spheres": ("wurblpt_tpu_torch/csrc/bvh_closest.cu",
                                "wurblpt_tpu/accel/traverse.py:165", ("bvh_closest_hit",),
                                ("rtiow_bvh path",)),
    "bvh_closest_hit_object": ("wurblpt_tpu_torch/csrc/bvh_closest.cu",
                               "wurblpt_tpu/accel/traverse.py:152", ("bvh_closest_hit",),
                               ("cornell_animated_bvh path",)),
    "bvh_any_hit_object": ("wurblpt_tpu_torch/csrc/bvh_any.cu",
                           "wurblpt_tpu/accel/traverse.py:152", ("bvh_any_hit",),
                           ("cornell_animated_bvh path",)),
    "envmap": ("wurblpt_tpu_torch/csrc/envmap.cu", "wurblpt_tpu/render/envmap.py:166", ENV_ALL,
               K4_PATHS + (GRAD_PATH,)),
    # the grad path's sky is an equirect map: its stand-alone launches count as the record
    # above's; the scene_api paths' skies are constant ones, theirs as the constant record's
    "envmap_cube": ("wurblpt_tpu_torch/csrc/envmap.cu", "wurblpt_tpu/render/envmap.py:118",
                    ENV_ALL, K4_PATHS),
    "envmap_constant": ("wurblpt_tpu_torch/csrc/envmap.cu", "wurblpt_tpu/render/envmap.py:181",
                        ENV_ALL, K4_PATHS + SCENE_PATHS),
    "rgl_eval": ("wurblpt_tpu_torch/csrc/rgl.cu", "wurblpt_tpu/materials/rgl.py:633",
                 ("rgl_eval",), PATHS),
    "rgl_sample": ("wurblpt_tpu_torch/csrc/rgl.cu", "wurblpt_tpu/materials/rgl.py:650",
                   ("rgl_sample",), PATHS),
    "row_gather": ("wurblpt_tpu_torch/csrc/row_gather.cu", "tools/probe_pallas_gather.py:20",
                   ("row_gather",), PATHS),
    "regen_pinhole": ("wurblpt_tpu_torch/csrc/wavefront.cu", "wurblpt_tpu/render/integrator.py:973",
                      ("regen_pinhole",), ("main path", "mesh path", "envmap path", "tof path",
                                           "cornell_animated path",
                                           "cornell_animated_bvh path")),
    "regen_lens": ("wurblpt_tpu_torch/csrc/wavefront.cu", "wurblpt_tpu/render/camera.py:140",
                   ("regen_pinhole",), ("rtiow path", "rtiow_bvh path")),
    "regen_surround": ("wurblpt_tpu_torch/csrc/wavefront.cu", "wurblpt_tpu/render/camera.py:244",
                       ("regen_surround",), ("city path",)),
    "shade_diffuse": ("wurblpt_tpu_torch/csrc/wavefront.cu", "wurblpt_tpu/render/integrator.py:400",
                      ("shade_diffuse",), ("main path", "tof path", "cornell_animated path",
                                           "cornell_animated_bvh path")),
    "shade_env": ("wurblpt_tpu_torch/csrc/wavefront.cu", "wurblpt_tpu/render/integrator.py:400",
                  ("shade_env",), ("mesh path",)),
    "shade_env_glass_cube": ("wurblpt_tpu_torch/csrc/wavefront.cu",
                             "wurblpt_tpu/render/integrator.py:400", ("shade_env",),
                             ("envmap path",)),
    "shade_env_glass_constant": ("wurblpt_tpu_torch/csrc/wavefront.cu",
                                 "wurblpt_tpu/render/integrator.py:400", ("shade_env",),
                                 ("rtiow path", "rtiow_bvh path", "rtiow_dof path")),
    "shade_lit": ("wurblpt_tpu_torch/csrc/wavefront.cu", "wurblpt_tpu/render/integrator.py:400",
                  ("shade_lit",), ("city path",)),
    "nee_resolve": ("wurblpt_tpu_torch/csrc/wavefront.cu", "wurblpt_tpu/render/integrator.py:648",
                    ("nee_resolve",), tuple(p for p in K4_PATHS if p != "city path")),
    "nee_resolve_lit": ("wurblpt_tpu_torch/csrc/wavefront.cu",
                        "wurblpt_tpu/render/integrator.py:648", ("nee_resolve",), ("city path",)),
    "sweep_closest": ("wurblpt_tpu_torch/csrc/sweep_closest.cu",
                      "wurblpt_tpu/render/intersect.py:216", ("sweep_closest",), ONE_INSTANT),
    "sweep_any": ("wurblpt_tpu_torch/csrc/sweep_any.cu", "wurblpt_tpu/render/intersect.py:397",
                  ("sweep_any",), ONE_INSTANT),
    "assemble_hit_anim": ("wurblpt_tpu_torch/csrc/assemble_hit.cu",
                          "wurblpt_tpu/render/intersect.py:510", ("assemble_hit_anim",),
                          ONE_INSTANT),
    # motion blur: the sweeps, K3a and K5/K6 with each lane's own frame rows
    "sweep_closest_per_ray": ("wurblpt_tpu_torch/csrc/sweep_closest.cu",
                              "wurblpt_tpu/render/intersect.py:216", ("sweep_closest",),
                              ("rolling_marbles path", "animations path", GRAD_PATH)),
    "sweep_any_per_ray": ("wurblpt_tpu_torch/csrc/sweep_any.cu",
                          "wurblpt_tpu/render/intersect.py:397", ("sweep_any",),
                          ("rolling_marbles path", "animations path", GRAD_PATH)),
    "assemble_hit_anim_per_ray": ("wurblpt_tpu_torch/csrc/assemble_hit.cu",
                                  "wurblpt_tpu/render/intersect.py:510", ("assemble_hit_anim",),
                                  PER_RAY),
    "bvh_closest_hit_per_ray": ("wurblpt_tpu_torch/csrc/bvh_closest.cu",
                                "wurblpt_tpu/accel/traverse.py:152", ("bvh_closest_hit",),
                                ("cornell_animated_blur path",)),
    "bvh_any_hit_per_ray": ("wurblpt_tpu_torch/csrc/bvh_any.cu",
                            "wurblpt_tpu/accel/traverse.py:152", ("bvh_any_hit",),
                            ("cornell_animated_blur path",)),
    # the thin lens in the pinhole regeneration (depth of field)
    "regen_dof": ("wurblpt_tpu_torch/csrc/wavefront.cu", "wurblpt_tpu/render/camera.py:260",
                  ("regen_pinhole",), ("rtiow_dof path",)),
    # K3's K4 form, one record per shade class's field set, and K3a's
    "assemble_hit_k4_diffuse": ("wurblpt_tpu_torch/csrc/assemble_hit.cu",
                                "wurblpt_tpu/render/intersect_mxu.py:345", ("assemble_hit_k4",),
                                ("main path", "tof path")),
    "assemble_hit_k4_env": ("wurblpt_tpu_torch/csrc/assemble_hit.cu",
                            "wurblpt_tpu/render/intersect_mxu.py:345", ("assemble_hit_k4",),
                            ("mesh path", "envmap path", "rtiow path", "rtiow_bvh path",
                             "rtiow_dof path")),
    "assemble_hit_k4_lit": ("wurblpt_tpu_torch/csrc/assemble_hit.cu",
                            "wurblpt_tpu/render/intersect_mxu.py:345", ("assemble_hit_k4",),
                            ("city path",)),
    "assemble_hit_k4_anim": ("wurblpt_tpu_torch/csrc/assemble_hit.cu",
                             "wurblpt_tpu/render/intersect.py:510", ("assemble_hit_k4_anim",),
                             ("cornell_animated path", "cornell_animated_bvh path")),
}
# The backward kernels of a differentiable render (phase `grad`), whose
# launches count on the grad path.
GRAD_KERNELS = {
    "row_scatter": ("wurblpt_tpu_torch/csrc/backward.cu", "tools/probe_pallas_gather.py:20",
                    ("row_scatter",), (GRAD_PATH,)),
    "assemble_hit_bwd": ("wurblpt_tpu_torch/csrc/backward.cu",
                         "wurblpt_tpu/render/intersect.py:489", ("assemble_hit_bwd",),
                         (GRAD_PATH,)),
    # K3aT: the backward of K3a, the animated branch (:489, :505-530, :605-620)
    "assemble_hit_anim_bwd": ("wurblpt_tpu_torch/csrc/backward.cu",
                              "wurblpt_tpu/render/intersect.py:505", ("assemble_hit_anim_bwd",),
                              (GRAD_PATH,)),
    "env_radiance_bwd": ("wurblpt_tpu_torch/csrc/backward.cu",
                         "wurblpt_tpu/render/envmap.py:166", ("env_radiance_bwd",),
                         (GRAD_PATH,)),
    # K8T with the map's rotation on the tape (its rotation term, reduced per block)
    "env_radiance_bwd_rot": ("wurblpt_tpu_torch/csrc/backward.cu",
                             "wurblpt_tpu/render/envmap.py:166", ("env_radiance_bwd_rot",),
                             (GRAD_PATH,)),
    # K8T's sample backward: the rotation's cotangent from the sampled directions'
    "env_sample_bwd": ("wurblpt_tpu_torch/csrc/backward.cu", "wurblpt_tpu/render/envmap.py:201",
                       ("env_sample_bwd",), (GRAD_PATH,)),
    # K7T: the backward of rgl_eval (:633) and rgl_sample (:650), its tail form
    "rgl_bwd": ("wurblpt_tpu_torch/csrc/backward.cu", "wurblpt_tpu/materials/rgl.py:633",
                ("rgl_bwd",), (GRAD_PATH,)),
    # K7T's full form: every table and the lane directions (timed on sample)
    "rgl_bwd_full": ("wurblpt_tpu_torch/csrc/backward.cu", "wurblpt_tpu/materials/rgl.py:650",
                     ("rgl_bwd_full",), (GRAD_PATH,)),
}
KERNELS.update(GRAD_KERNELS)
GRAD_RECORDS = []   # filled by phase_grad
# K3's K4 form: the record of each frame's class on the frame's K4 path.
K3_K4_RECORDS = {"cornell": "assemble_hit_k4_diffuse", "tof": "assemble_hit_k4_diffuse",
                 "mesh": "assemble_hit_k4_env", "envmap": "assemble_hit_k4_env",
                 "rtiow": "assemble_hit_k4_env", "rtiow_bvh": "assemble_hit_k4_env",
                 "city": "assemble_hit_k4_lit", "cornell_animated": "assemble_hit_k4_anim",
                 "cornell_animated_bvh": "assemble_hit_k4_anim",
                 "rtiow_dof": "assemble_hit_k4_env"}
# The full form of K3 and K3a (every field of every lane), which no K4 path
# launches: checked and timed in phase 3.
K3_FULL = ("assemble_hit", "assemble_hit_anim")
# The stand-alone kernels whose work a K4 shade or regeneration does inline,
# and K3's and K3a's full forms, whose work the K4 form does on each K4
# path: record -> (kernel, path) pairs. Their records count their own
# launches (none on any path) and list in `inline_in` each kernel that does
# their work, on which path, with its launches there.
INLINE = {"envmap": (("shade_env", "mesh path"), ("shade_lit", "city path")),
          "envmap_cube": (("shade_env", "envmap path"),),
          "envmap_constant": (("shade_env", "rtiow path"), ("shade_env", "rtiow_bvh path"),
                              ("shade_env", "rtiow_dof path")),
          "rgl_eval": (("shade_lit", "city path"),), "rgl_sample": (("shade_lit", "city path"),),
          "row_gather": (("shade_lit", "city path"),),
          # the NEE resolve: inside the next step's regeneration since PR 16
          "nee_resolve": tuple(("regen_pinhole", p) for p in K4_PATHS if p != "city path"),
          "nee_resolve_lit": (("regen_surround", "city path"),),
          # K3's and K3a's full forms: their K4 form on every K4 path
          "assemble_hit": tuple(("assemble_hit_k4", p) for p in K4_PATHS
                                if p not in ("cornell_animated path", "cornell_animated_bvh path")),
          "assemble_hit_anim": (("assemble_hit_k4_anim", "cornell_animated path"),
                                ("assemble_hit_k4_anim", "cornell_animated_bvh path"))}
# The record of each K4 frame's shade, regeneration and resolve, where not
# the kernel's own name (the mesh, Cornell and ToF frames).
K4_RECORDS = {("shade_env", "envmap"): "shade_env_glass_cube",
              ("shade_env", "rtiow"): "shade_env_glass_constant",
              ("shade_env", "rtiow_bvh"): "shade_env_glass_constant",
              ("shade_env", "rtiow_dof"): "shade_env_glass_constant",
              ("regen_pinhole", "rtiow_dof"): "regen_dof",
              ("regen_pinhole", "rtiow"): "regen_lens",
              ("regen_pinhole", "rtiow_bvh"): "regen_lens",
              ("nee_resolve", "city"): "nee_resolve_lit"}
MAIN_PATH = ("closest_hit", "any_hit", "assemble_hit_k4", "regen_pinhole", "shade_diffuse")
TOF_PATH = MAIN_PATH
MESH_PATH = ("regen_pinhole", "bvh_closest_hit", "assemble_hit_k4", "shade_env", "bvh_any_hit")
CITY_PATH = ("regen_surround", "bvh_closest_hit", "assemble_hit_k4", "shade_lit", "bvh_any_hit")
# The stand-alone kernels whose work the lit shade and the regeneration do
# inline (the regenerations add the step before's NEE deposits: no resolve).
CITY_ABSENT = ("row_gather", "rgl_eval", "rgl_sample", "nee_resolve") + ENV_ALL + K3_FULL
ENVMAP_PATH = ("regen_pinhole", "closest_hit", "assemble_hit_k4", "shade_env", "any_hit")
RTIOW_PATH = ("regen_pinhole", "closest_hit", "assemble_hit_k4", "shade_env")
# The animated frame: K4's diffuse class around the sweeps and K3a; no K1-K3
# (the scene is swept) and no P0 (the shade reads the material rows itself).
ANIM_PATH = ("regen_pinhole", "sweep_closest", "assemble_hit_k4_anim", "shade_diffuse",
             "sweep_any")
ANIM_ABSENT = ("closest_hit", "any_hit", "assemble_hit_k4", "row_gather", "shade_env",
               "shade_lit", "nee_resolve") + K3_FULL
# The BVH paths: the full RTIOW field on the env class around K5's sphere
# rows (no shadow ray: no K6), the animated box with spheres on the diffuse
# class around K5/K6 in object space and K3a; neither takes K1/K2 or the sweeps.
RTIOW_BVH_PATH = ("regen_pinhole", "bvh_closest_hit", "assemble_hit_k4", "shade_env")
RTIOW_BVH_ABSENT = ("closest_hit", "any_hit", "sweep_closest", "sweep_any", "bvh_any_hit",
                    "row_gather", "nee_resolve") + ENV_ALL + K3_FULL
ANIM_BVH_PATH = ("regen_pinhole", "bvh_closest_hit", "assemble_hit_k4_anim", "shade_diffuse",
                 "bvh_any_hit")
ANIM_BVH_ABSENT = ("closest_hit", "any_hit", "assemble_hit_k4", "sweep_closest", "sweep_any",
                   "row_gather", "shade_env", "shade_lit", "nee_resolve") + K3_FULL
# The K4 kernels that update the lane state in place (render/wavefront.py).
IN_PLACE = ("regen_pinhole", "regen_surround", "shade_diffuse", "shade_env", "shade_lit")


def phase_build():
    from wurblpt_tpu_torch import native

    t0 = time.perf_counter()
    lib = native.build_kernels()
    native.load_kernels()
    dt = time.perf_counter() - t0
    print(f"build: {dt:.1f} s -> {lib.relative_to(native.BUILD_DIR.parent.parent)}")
    t0 = time.perf_counter()
    native.load_bvh_builder()
    print(f"build: host BVH builder {time.perf_counter() - t0:.1f} s")
    lines = (lib.parent / "build.log").read_text().splitlines()
    entries = [line.split("'")[1] for line in lines if "Compiling entry function" in line]
    try:   # demangled, without the parameter list: "shade_env_kernel<1>"
        names = subprocess.run(["c++filt"], input="\n".join(entries), capture_output=True,
                               text=True, check=True).stdout.splitlines()
        names = dict(zip(entries, (n.split("(anonymous namespace)::", 1)[-1].split("(")[0]
                                   for n in names)))
    except (OSError, subprocess.CalledProcessError):
        names = {}
    entry = ""
    for line in lines:
        if "Compiling entry function" in line:
            entry = line.split("'")[1]
        elif "Used" in line or "spill" in line:
            print(f"  ptxas: {names.get(entry, entry)}:",
                  line.split("ptxas info    :")[-1].strip())


def _timed_records(timed, errs, lanes):
    """name -> (kernel call, plain call, (bytes, flops) of the work, library call or None).
    A kernel that writes its inputs comes as (function, arguments): it is
    timed on the same inputs each call, restored outside the timed window
    (kc.time_restored_ms: the device's time per call)."""
    records = []
    for name, (kernel, plain, work, library) in timed.items():
        ms = (kc.time_restored_ms(*kernel, DEVICE) if isinstance(kernel, tuple)
              else kc.time_ms(kernel, DEVICE))
        plain_ms = kc.time_ms(plain, DEVICE)
        library_ms = None if library is None else kc.time_ms(library, DEVICE)
        bound, bound_by = kc.bound_ms(*work)
        how = "device, inputs restored" if isinstance(kernel, tuple) else "wrapper call"
        print(f"kernels: {name} {ms:.4f} ms ({how}) vs plain {plain_ms:.4f} ms"
              f"{'' if library is None else f', library {library_ms:.4f} ms'}; bound "
              f"{bound:.6f} ms by {bound_by} ({work[0]:.4g} bytes, {work[1]:.4g} flops) "
              f"at {lanes} lanes")
        src, replaces, _, _ = KERNELS[name]
        records.append({"name": name, "route": "cuda", "source": src, "replaces": replaces,
                        "launches": 0, "max_abs_err": errs[name], "ms": ms,
                        "plain_ms": plain_ms, "bound_ms": bound, "bound_by": bound_by,
                        "library_ms": library_ms})
    return records


def _bit_equal(res):
    """A K1 or K2 check's result, once no lane's outputs differ in a bit."""
    assert res["differ"] == 0, f"{res['differ']} lanes differ from the plain version"
    return res


def _run_checks(checks):
    errs = {}
    for name, check, sets in checks:
        err = 0.0
        for label, args in sets.items():
            res = check(*args)
            torch.cuda.synchronize()
            print(f"kernels: {name} [{label}] ok {res}")
            err = max(err, res["max_abs_err"])
        errs[name] = err
    return errs


def phase_kernels(scenes_on_card):
    from wurblpt_tpu_torch.accel import traverse
    from wurblpt_tpu_torch.materials import rgl
    from wurblpt_tpu_torch.render import bsdf, envmap, gather, intersect, intersect_brute
    from wurblpt_tpu_torch.utils import scenes

    mesh_scene, city_scene = scenes_on_card["mesh"], scenes_on_card["city"]

    # K1-K3 on the Cornell frame's block.
    scene = scenes.cornell_box_ref(DEVICE)
    bs = intersect_brute.build_brute_scene(scene)
    ht = intersect.build_hit_tables(scene)
    cam = kc.camera_lanes(kc.BENCH_WIDTH, kc.BENCH_WIDTH, kc.BENCH_LANES_M, DEVICE)
    rnd = kc.random_lanes(cam[0].shape[0], DEVICE)
    shadow = kc.shadow_lanes(scene, bs, cam)
    # The same on the sphere scenes: rtiow's camera rays (no triangle at all),
    # and the envmap frame's camera rays (triangles and spheres together) and
    # env-NEE shadow rays from their first hits.
    rt_scene, env_scene = scenes_on_card["rtiow"], scenes_on_card["envmap"]
    rt_bs = intersect_brute.build_brute_scene(rt_scene)
    rt_ht = intersect.build_hit_tables(rt_scene)
    rt_cam = kc.rtiow_camera_lanes(DEVICE)
    env_bs = intersect_brute.build_brute_scene(env_scene)
    env_ht = intersect.build_hit_tables(env_scene)
    env_cam = kc.envmap_camera_lanes(DEVICE)
    env_shadow = kc.env_shadow_lanes(env_scene, env_cam, env_bs)
    # ROADMAP C.1's sphere fields, the K1 form at 6144 and 8192 columns.
    fcam = kc.field_camera_lanes(DEVICE)
    fields = {}
    for n_sph in (3000, 4096):
        f_scene = scenes_on_card[f"sphere_field {n_sph}"]
        f_bs = intersect_brute.build_brute_scene(f_scene)
        assert intersect_brute.brute_eligible(f_scene), f"{n_sph} spheres: not the K1 form's"
        f_shadow = kc.sky_shadow_lanes(
            lambda *r, b=f_bs: intersect_brute.closest_hit_plain(b, *r), fcam)
        fields[n_sph] = (f_bs, intersect.build_hit_tables(f_scene), f_shadow)
    # K1's largest table, 2048 triangles (128 KB, staged whole), and blocks
    # whose dead lanes are scattered at the live shares of the K1 frames.
    tri_scene = scenes_on_card["tri_field 2048"]
    assert intersect_brute.brute_eligible(tri_scene), "2048 triangles: not the K1 form's"
    tri_bs = intersect_brute.build_brute_scene(tri_scene)
    tri_shadow = kc.sky_shadow_lanes(
        lambda *r, b=tri_bs: intersect_brute.closest_hit_plain(b, *r), fcam)
    errs = _run_checks((
        ("closest_hit", lambda b, r: _bit_equal(kc.check_closest_hit(b, r)),
         {"camera": (bs, cam), "random": (bs, rnd), "rtiow camera, spheres only": (rt_bs, rt_cam),
          "envmap camera": (env_bs, env_cam),
          **{f"{k}-sphere field camera": (f[0], fcam) for k, f in fields.items()},
          "2048-triangle field camera, 128 KB table": (tri_bs, fcam),
          "2048-triangle field camera, half the lanes dead": (tri_bs, kc.scatter_dead(fcam, 0.5)),
          **{f"camera, {round(100 * (1 - x))} % of the lanes dead, scattered":
             (bs, kc.scatter_dead(cam, 1 - x)) for x in LIVE_SHARES},
          "rtiow camera, 76 % of the lanes dead, scattered":
              (rt_bs, kc.scatter_dead(rt_cam, 0.76))}),
        ("any_hit", lambda b, r: _bit_equal(kc.check_any_hit(b, r)),
         {"shadow": (bs, shadow), "random": (bs, rnd),
          "rtiow camera, spheres only": (rt_bs, rt_cam), "envmap env shadow": (env_bs, env_shadow),
          **{f"{k}-sphere field sky shadow": (f[0], f[2]) for k, f in fields.items()},
          "2048-triangle field sky shadow": (tri_bs, tri_shadow),
          **{f"shadow, {round(100 * (1 - x))} % of the lanes dead, scattered":
             (bs, kc.scatter_dead(shadow, 1 - x)) for x in LIVE_SHARES},
          **{f"edge: {k}": v for k, v in kc.k2_edge_sets(DEVICE).items()}}),
        ("assemble_hit", lambda b, h, r: kc.check_assemble_hit(b, h, r),
         {"camera": (bs, ht, cam), "random": (bs, ht, rnd),
          "rtiow camera, spheres only": (rt_bs, rt_ht, rt_cam),
          "envmap camera": (env_bs, env_ht, env_cam),
          **{f"{k}-sphere field camera": (f[0], f[1], fcam) for k, f in fields.items()}})))
    sweep_records = _sweep_records(scenes_on_card, fcam, errs)
    t, prim, u, v = intersect_brute.closest_hit_plain(bs, *cam)
    o, d = cam[0], cam[1]
    records = _timed_records({
        "closest_hit": (lambda: intersect_brute.closest_hit(bs, *cam),
                        lambda: intersect_brute.closest_hit_plain(bs, *cam),
                        kc.closest_hit_work(bs, cam), None),
        "any_hit": (lambda: intersect_brute.any_hit(bs, *shadow),
                    lambda: intersect_brute.any_hit_plain(bs, *shadow),
                    kc.any_hit_work(bs, shadow), None),
        "assemble_hit": (lambda: intersect.assemble_hit(ht, o, d, t, prim, u, v),
                         lambda: intersect.assemble_hit_plain(ht, o, d, t, prim, u, v),
                         kc.assemble_hit_work(ht, prim), None),
    }, errs, cam[0].shape[0]) + sweep_records

    # K5 and K6 on the mesh frame's block.
    bvh = mesh_scene.bvh
    mcam = kc.mesh_camera_lanes(DEVICE)
    n = mcam[0].shape[0]
    mrnd = kc.terrain_random_lanes(n, DEVICE)
    eshadow = kc.env_shadow_lanes(mesh_scene, mcam)
    dead = mrnd[:3] + (torch.zeros_like(mrnd[3]),)
    ragged = tuple(x[:1000] for x in mrnd)
    errs = _run_checks((
        ("bvh_closest_hit", lambda r: kc.check_bvh_closest_hit(bvh, r),
         {"camera": (mcam,), "random": (mrnd,), "every lane dead": (dead,),
          "1000 lanes": (ragged,)}),
        ("bvh_any_hit", lambda r: kc.check_bvh_any_hit(bvh, r),
         {"env shadow": (eshadow,), "random": (mrnd,), "every lane dead": (dead,),
          "1000 lanes": (ragged,)})))
    k56 = _timed_records({
        "bvh_closest_hit": (lambda: traverse.bvh_closest_hit(bvh, *mcam),
                            lambda: traverse.bvh_closest_hit_plain(bvh, *mcam),
                            kc.bvh_work(bvh, mcam, any_hit=False), None),
        "bvh_any_hit": (lambda: traverse.bvh_any_hit(bvh, *eshadow),
                        lambda: traverse.bvh_any_hit_plain(bvh, *eshadow),
                        kc.bvh_work(bvh, eshadow, any_hit=True), None),
    }, errs, n)
    for r, entry in zip(k56, ("bvh_closest", "bvh_any")):
        r["branch"] = traverse.plan(bvh, None, entry)[1]
    records += k56 + _bvh_leaf_records(scenes_on_card)

    # K8's equirect branch on the city frame's block and its night sky (the
    # mesh path's env shade and the city path's lit shade read their skies
    # inline; the stand-alone kernels stay checked here).
    env = city_scene.envmap
    cdirs, cu3 = kc.city_env_lanes(DEVICE)
    nc = cdirs.shape[0]
    errs = _run_checks((
        ("envmap", lambda dirs, uni: kc.check_envmap(env, dirs, uni),
         {"city camera directions, uniforms": (cdirs, cu3)}),))

    def env_all(radiance, sample, pdf, env=env, dirs=cdirs, uni=cu3):
        return lambda: (radiance(env, dirs), sample(env, uni), pdf(env, dirs))

    records += _timed_records({
        "envmap": (env_all(envmap.env_radiance, envmap.env_sample, envmap.env_pdf),
                   env_all(envmap.env_radiance_plain, envmap.env_sample_plain,
                           envmap.env_pdf_plain), kc.envmap_work(env, nc), None),
    }, errs, nc)

    # K8's cube branch on the envmap frame's sky (with its importance tables)
    # and its constant branch on rtiow's sky.
    cube, const = env_scene.envmap, rt_scene.envmap
    ecam = env_cam[1]
    ne = ecam.shape[0]
    eu3 = torch.as_tensor(np.random.default_rng(4).uniform(size=(ne, 3)), dtype=torch.float32,
                          device=DEVICE)
    rdirs = kc.random_directions(ne, DEVICE)
    edges = kc.cube_edge_directions(DEVICE)
    errs = _run_checks((
        ("envmap_cube", lambda dirs, uni: kc.check_envmap(cube, dirs, uni),
         {"envmap camera directions, uniforms": (ecam, eu3), "random directions": (rdirs, eu3),
          "axes, diagonals, face edges, texel boundaries": (edges, eu3[:edges.shape[0]])}),
        ("envmap_constant", lambda dirs: kc.check_envmap(const, dirs),
         {"rtiow camera directions": (rt_cam[1],), "random directions": (rdirs,)})))
    records += _timed_records({
        "envmap_cube": (env_all(envmap.env_radiance, envmap.env_sample, envmap.env_pdf, cube, ecam,
                                eu3),
                        env_all(envmap.env_radiance_plain, envmap.env_sample_plain,
                                envmap.env_pdf_plain, cube, ecam, eu3),
                        kc.envmap_work(cube, ne), None),
    }, errs, ne)
    nr = rt_cam[1].shape[0]
    records += _timed_records({
        "envmap_constant": (lambda: envmap.env_radiance(const, rt_cam[1]),
                            lambda: envmap.env_radiance_plain(const, rt_cam[1]),
                            kc.env_radiance_work(const, nr),
                            lambda: const.const_radiance.repeat(nr, 1)),
    }, errs, nr)

    # K7 on the lanes of material_comparison's pass (its main path: every
    # lane of a bounce, those of other materials with id -1), on the city
    # frame's block (every lane live) and on 128-wide warps; P0 on the
    # probe's shapes and the city's material rows (the lit shade evaluates,
    # samples and reads them inline).
    mc_calls = _material_comparison_rgl_calls()
    m_tables = mc_calls[0][1]
    tables = city_scene.rgl
    mid, wi, wo, u2 = kc.city_rgl_lanes(city_scene, DEVICE)
    wide = kc.wide_rgl_lanes(DEVICE)
    packed = bsdf.pack_material_table(city_scene.materials)
    mat_idx = torch.as_tensor(np.random.default_rng(9).integers(0, packed.shape[0], kc.CITY_LANES),
                              dtype=torch.int32, device=DEVICE)
    probe_rows, probe_vec = kc.probe_gather_inputs(DEVICE)
    errs = _run_checks((
        ("rgl", lambda t, lanes: kc.check_rgl(t, lanes),
         {"city camera hits and random lanes": (tables, (mid, wi, wo, u2)),
          **{f"material_comparison pass, {c[0]} call {k} ({int((c[2] >= 0).sum())} of "
             f"{c[2].shape[0]} lanes RGL)": (c[1], _both_lanes(*c))
             for k, c in enumerate(mc_calls)},
          "wide tables: 128 x 128 and 33 x 33 rows, ids -1, 0 and 1": (wide[0], wide[1:])}),
        ("row_gather", kc.check_row_gather,
         {"probe rows [512, 128] x 256": probe_rows, "probe vector [512] x [8, 128]": probe_vec,
          "city material rows": (packed, mat_idx),
          **{f"[37, {c}] NaN payloads, indices out of range": kc.gather_words(c, DEVICE, seed=c)
             for c in (1, 3, 23, 128)}})))
    errs["rgl_eval"] = errs["rgl_sample"] = errs.pop("rgl")
    # K7's records on the pass's calls with the most RGL lanes
    ev, sa = (max((c for c in mc_calls if c[0] == kind), key=lambda c: int((c[2] >= 0).sum()))
              for kind in ("eval", "sample"))
    records += _timed_records({
        "rgl_eval": (lambda: rgl.rgl_eval(*ev[1:]), lambda: rgl.rgl_eval_plain(*ev[1:]),
                     kc.rgl_work(m_tables, ev[2].shape[0], False, int((ev[2] >= 0).sum())),
                     None),
        "rgl_sample": (lambda: rgl.rgl_sample(*sa[1:]), lambda: rgl.rgl_sample_plain(*sa[1:]),
                       kc.rgl_work(m_tables, sa[2].shape[0], True, int((sa[2] >= 0).sum())),
                       None),
    }, errs, ev[2].shape[0])
    _rgl_device_times(mc_calls, (tables, mid, wi, wo, u2), wide)
    records += _timed_records({
        "row_gather": (lambda: gather.row_gather(packed, mat_idx),
                       lambda: gather.row_gather_plain(packed, mat_idx),
                       kc.row_gather_work(packed, mat_idx),
                       lambda: torch.index_select(packed, 0, mat_idx)),
    }, errs, mid.shape[0])
    # P0's device time beside index_select's: the wrapper call above also
    # times the host's ctypes call and checks.
    p0 = next(r for r in records if r["name"] == "row_gather")
    p0["device_ms"] = kc.device_ms(lambda: gather.row_gather(packed, mat_idx))
    p0["library_device_ms"] = kc.device_ms(lambda: torch.index_select(packed, 0, mat_idx))
    print(f"kernels: row_gather device {p0['device_ms'] * 1e3:.2f} us per call vs index_select "
          f"{p0['library_device_ms'] * 1e3:.2f} us (CUDA events, 20 calls behind a spin), city material "
          f"rows [{packed.shape[0]}, {packed.shape[1]}] x {mat_idx.shape[0]}")
    return records + _per_ray_records(scenes_on_card) + _k4_records(scenes_on_card)


def _material_comparison_rgl_calls():
    """K7's calls of one pass of material_comparison at the app's size
    (kernel_check.EXAMPLE_FRAMES: the generic bounce, 806400 lanes a
    bounce), each call's (kind, tables, mid, wi, x) as the bsdf lane
    adapters hand them (kernel_check.capture_rgl_calls); prints each call's
    RGL lanes and the pass's share."""
    from wurblpt_tpu_torch.utils import scenes

    render = kc.example_frame("material_comparison", DEVICE,
                              scenes.material_comparison(device=DEVICE))
    calls = kc.capture_rgl_calls(lambda: render(one_pass=True))
    live = [int((c[2] >= 0).sum()) for c in calls]
    lanes = sum(c[2].shape[0] for c in calls)
    print(f"kernels: rgl on material_comparison's pass: {len(calls)} calls "
          f"({[c[0] for c in calls].count('sample')} sample) of {calls[0][2].shape[0]} lanes, "
          f"RGL lanes per call {live}: {sum(live)} of {lanes} ({sum(live) / lanes:.4%})")
    return calls


def _both_lanes(kind, tables, mid, wi, x, seed=12):
    """(mid, wi, wo, u2) of a K7 call of one kind, the other kind's input
    (wo on the sphere or u2) made from numpy `seed`, so that both kernels
    run on the call's ids and directions."""
    rs = np.random.default_rng(seed)
    n = mid.shape[0]
    if kind == "sample":
        d = rs.standard_normal((n, 3))
        d /= np.linalg.norm(d, axis=-1, keepdims=True)
        return mid, wi, torch.as_tensor(d.astype(np.float32), device=DEVICE), x
    return mid, wi, x, torch.as_tensor(rs.uniform(size=(n, 2)).astype(np.float32),
                                       device=DEVICE)


def _rgl_device_times(mc_calls, city_lanes, wide):
    """K7's device us a launch (kc.device_ms) beside the bound of its
    work: each call of material_comparison's pass, the city's lanes and the
    wide tables' lanes."""
    from wurblpt_tpu_torch.materials import rgl

    cases = {f"material_comparison pass {c[0]} call {k}": (c[0] == "sample", *c[1:])
             for k, c in enumerate(mc_calls)}
    t, mid, wi, wo, u2 = city_lanes
    cases["city lanes eval"], cases["city lanes sample"] = (False, t, mid, wi, wo), (
        True, t, mid, wi, u2)
    t, mid, wi, wo, u2 = wide
    cases["wide tables eval"], cases["wide tables sample"] = (False, t, mid, wi, wo), (
        True, t, mid, wi, u2)
    for label, (sample, t, mid, wi, x) in cases.items():
        fn = rgl.rgl_sample if sample else rgl.rgl_eval
        us = kc.device_ms(lambda f=fn, a=(t, mid, wi, x): f(*a)) * 1e3
        live = int((mid >= 0).sum())
        bound, by = kc.bound_ms(*kc.rgl_work(t, mid.shape[0], sample, live))
        print(f"kernels: {'rgl_sample' if sample else 'rgl_eval'} {label}: {us:.2f} us device "
              f"(CUDA events, 20 calls behind a spin), bound {bound * 1e3:.2f} us by {by}, "
              f"{live} of {mid.shape[0]} lanes RGL")


def _per_ray_records(scenes_on_card):
    """Motion blur: KS1, KS2, K3a's full form and K5/K6 with each lane's own
    frame rows (anim_frames_per_ray, [N, A, 30]) against their plain
    versions, bit-equal (K3a within K3's tolerance): the sweeps and K3a on
    the rolling_marbles pass's camera rays (320 x 180 x 9 samples, 518400
    lanes, times in its shutter), their random rays and NEE shadow rays
    toward its sphere light, and on the cornell_animated block (camera and
    random rays, times in [0, 1]); K5/K6 on the cornell_animated_blur tree
    (camera, random and moving-light shadow rays; on the branch its size
    picks and on the L2 walk, every lane dead too). Timed at those shapes:
    KS1, KS2 and K3a on the rolling_marbles pass, K5 and K6 on the
    cornell_animated_blur block."""
    from wurblpt_tpu_torch.accel import traverse
    from wurblpt_tpu_torch.render import intersect, intersect_sweep as sw

    rm = scenes_on_card["rolling_marbles"]
    w, h, ssqrt, _, per_pass, t0, t1 = kc.MOTION_FRAMES["rolling_marbles"]
    cam = kc.camera_lanes(w, h, per_pass, DEVICE, camera=kc.motion_camera("rolling_marbles",
                                                                           DEVICE))
    n = cam[0].shape[0]
    fr = kc.frames_per_ray_at(rm, n, t0=t0, t1=t1)
    ss, ht = sw.build_sweep_scene(rm), intersect.build_hit_tables(rm)
    rnd = kc.random_lanes(n, DEVICE, lo=(-4.0, -0.5, -2.0), hi=(4.0, 2.0, 2.0))
    shadow = kc.anim_shadow_lanes(rm, ss, fr, cam)
    an = scenes_on_card["cornell_animated"]
    acam = kc.camera_lanes(kc.BENCH_WIDTH, kc.BENCH_WIDTH, kc.BENCH_LANES_M, DEVICE)
    na = acam[0].shape[0]
    afr = kc.frames_per_ray_at(an, na)
    ass, aht = sw.build_sweep_scene(an), intersect.build_hit_tables(an)
    arnd = kc.random_lanes(na, DEVICE)
    blur = scenes_on_card["cornell_animated_blur"]
    bfr = kc.frames_per_ray_at(blur, na)
    bshadow = kc.anim_shadow_lanes(blur, blur.bvh, bfr, acam)

    def dead(rays):
        return rays[:3] + (torch.zeros_like(rays[3]),)

    casts = {"rolling_marbles pass camera": (ss, cam, fr), "rolling_marbles random": (ss, rnd, fr),
             "cornell_animated block camera": (ass, acam, afr),
             "cornell_animated random": (ass, arnd, afr)}
    anys = {"rolling_marbles sphere-light shadow": (ss, shadow, fr),
            "rolling_marbles random": (ss, rnd, fr),
            "cornell_animated random": (ass, arnd, afr)}
    bvh = {"cornell_animated_blur camera": (blur.bvh, acam, bfr),
           "cornell_animated_blur random": (blur.bvh, arnd, bfr),
           "cornell_animated_blur every lane dead": (blur.bvh, dead(arnd), bfr)}
    bvh_any = {"cornell_animated_blur moving-light shadow": (blur.bvh, bshadow, bfr),
               "cornell_animated_blur random": (blur.bvh, arnd, bfr)}
    for sets in (bvh, bvh_any):
        sets.update({f"{k}, L2 walk": v + ("L2",) for k, v in list(sets.items())})
    print(f"kernels: per-ray rows: rolling_marbles {tuple(fr.shape)} "
          f"({fr.numel() * 4 / 1e6:.1f} MB), cornell_animated_blur {tuple(bfr.shape)}; "
          f"K5 plan {traverse.plan(blur.bvh, bfr)} against "
          f"{traverse.plan(blur.bvh, kc.frames_at(blur))} at one instant")
    errs = _run_checks((
        ("sweep_closest_per_ray", kc.check_sweep_closest, casts),
        ("sweep_any_per_ray", kc.check_sweep_any, anys),
        ("assemble_hit_anim_per_ray", kc.check_assemble_hit_sweep,
         {"rolling_marbles pass camera": (ss, ht, cam, fr),
          "cornell_animated block camera": (ass, aht, acam, afr)}),
        ("bvh_closest_hit_per_ray", kc.check_bvh_closest_hit, bvh),
        ("bvh_any_hit_per_ray", kc.check_bvh_any_hit, bvh_any)))
    t, prim, u, v = sw.closest_sweep_plain(ss, *cam, fr)
    o, d = cam[0], cam[1]
    records = _timed_records({
        "sweep_closest_per_ray": (lambda: sw.closest_sweep(ss, *cam, fr),
                                  lambda: sw.closest_sweep_plain(ss, *cam, fr),
                                  kc.sweep_work(ss, cam, fr), None),
        "sweep_any_per_ray": (lambda: sw.any_sweep(ss, *shadow, fr),
                              lambda: sw.any_sweep_plain(ss, *shadow, fr),
                              kc.sweep_work(ss, shadow, fr, any_hit=True), None),
        "assemble_hit_anim_per_ray": (
            lambda: intersect.assemble_hit(ht, o, d, t, prim, u, v, fr),
            lambda: intersect.assemble_hit_plain(ht, o, d, t, prim, u, v, fr),
            kc.assemble_hit_work(ht, prim, fr), None),
    }, errs, n)
    records += _timed_records({
        "bvh_closest_hit_per_ray": (lambda: traverse.bvh_closest_hit(blur.bvh, *acam, bfr),
                                    lambda: traverse.bvh_closest_hit_plain(blur.bvh, *acam, bfr),
                                    kc.bvh_work(blur.bvh, acam, any_hit=False, frames=bfr), None),
        "bvh_any_hit_per_ray": (lambda: traverse.bvh_any_hit(blur.bvh, *bshadow, bfr),
                                lambda: traverse.bvh_any_hit_plain(blur.bvh, *bshadow, bfr),
                                kc.bvh_work(blur.bvh, bshadow, any_hit=True, frames=bfr), None),
    }, errs, na)
    for r in records:
        name = r["name"]
        fn = {"sweep_closest_per_ray": lambda: sw.closest_sweep(ss, *cam, fr),
              "sweep_any_per_ray": lambda: sw.any_sweep(ss, *shadow, fr),
              "assemble_hit_anim_per_ray": lambda: intersect.assemble_hit(ht, o, d, t, prim, u, v,
                                                                          fr),
              "bvh_closest_hit_per_ray": lambda: traverse.bvh_closest_hit(blur.bvh, *acam, bfr),
              "bvh_any_hit_per_ray": lambda: traverse.bvh_any_hit(blur.bvh, *bshadow, bfr)}[name]
        r["device_us"] = kc.device_ms(fn) * 1e3
        print(f"kernels: {name} device {r['device_us']:.2f} us a launch on {_nvidia_smi()}")
    return records


def _sweep_records(scenes_on_card, fcam, errs):
    """KS1, KS2 and the hit assembly (K3a animated, K3 static: its error joins
    `errs["assemble_hit"]`) against their plain versions on the
    cornell_animated block, the animated box with spheres and
    tri_sphere_field's camera rays; KS1, KS2 and K3a timed on the
    cornell_animated block."""
    from wurblpt_tpu_torch.render import intersect, intersect_sweep as sw

    sets = {}
    for label, key, rays in (("cornell_animated", "cornell_animated", None),
                             ("animated box with spheres", "cornell_animated spheres", None),
                             ("tri_sphere_field", "tri_sphere_field", fcam)):
        scene = scenes_on_card[key]
        ss, ht = sw.build_sweep_scene(scene), intersect.build_hit_tables(scene)
        fr = kc.frames_at(scene) if scene.n_anims > 1 else None
        if rays is None:
            rays = kc.camera_lanes(kc.BENCH_WIDTH, kc.BENCH_WIDTH, kc.BENCH_LANES_M, DEVICE)
        if fr is None:
            shadow = kc.sky_shadow_lanes(lambda *r, s=ss: sw.closest_sweep_plain(s, *r), rays)
        else:
            shadow = kc.anim_shadow_lanes(scene, ss, fr, rays)
        sets[label] = (ss, ht, fr, rays, shadow)
    cam = sets["cornell_animated"][3]
    rnd = kc.random_lanes(cam[0].shape[0], DEVICE)
    ss, ht, fr, _, shadow = sets["cornell_animated"]
    sets["cornell_animated random"] = (ss, ht, fr, rnd, rnd)
    assemble = lambda v: kc.check_assemble_hit_sweep(v[0], v[1], v[3], v[2])  # noqa: E731
    # KS1's edges, and a static table past what it stages whole (chunks)
    edges = {f"edge: {k}": ((ss_, None, fr_, rays_, None),)
             for k, (ss_, rays_, fr_) in kc.ks1_edge_sets(DEVICE).items()}
    big = sw.build_sweep_scene(scenes_on_card["tri_field 3600"])
    edges["3600-triangle field camera, half the lanes dead (chunks)"] = (
        (big, None, None, kc.scatter_dead(fcam, 0.5), None),)
    # KS2's edges, and the same table's sky shadow rays in chunks
    any_edges = {f"edge: {k}": ((ss_, None, fr_, None, rays_),)
                 for k, (ss_, rays_, fr_) in kc.ks2_edge_sets(DEVICE).items()}
    big_shadow = kc.sky_shadow_lanes(lambda *r: sw.closest_sweep_plain(big, *r), fcam)
    any_edges["3600-triangle field sky shadow, half the lanes dead (chunks)"] = (
        (big, None, None, None, kc.scatter_dead(big_shadow, 0.5)),)
    sweep_errs = _run_checks((
        ("sweep_closest", lambda v: kc.check_sweep_closest(v[0], v[3], v[2]),
         {**{k: (v,) for k, v in sets.items()}, **edges}),
        ("sweep_any", lambda v: kc.check_sweep_any(v[0], v[4], v[2]),
         {**{(k if k.endswith("random") else k + " shadow"): (v,) for k, v in sets.items()},
          **any_edges}),
        ("assemble_hit_anim", assemble,
         {k: (v,) for k, v in sets.items() if v[2] is not None}),
        ("assemble_hit", assemble, {"tri_sphere_field, the sweep's winners":
                                    (sets["tri_sphere_field"],)})))
    errs["assemble_hit"] = max(errs["assemble_hit"], sweep_errs.pop("assemble_hit"))
    t, prim, u, v = sw.closest_sweep_plain(ss, *cam, fr)
    o, d = cam[0], cam[1]
    return _timed_records({
        "sweep_closest": (lambda: sw.closest_sweep(ss, *cam, fr),
                          lambda: sw.closest_sweep_plain(ss, *cam, fr),
                          kc.sweep_work(ss, cam, fr), None),
        "sweep_any": (lambda: sw.any_sweep(ss, *shadow, fr),
                      lambda: sw.any_sweep_plain(ss, *shadow, fr),
                      kc.sweep_work(ss, shadow, fr, any_hit=True), None),
        "assemble_hit_anim": (lambda: intersect.assemble_hit(ht, o, d, t, prim, u, v, fr),
                              lambda: intersect.assemble_hit_plain(ht, o, d, t, prim, u, v, fr),
                              kc.assemble_hit_work(ht, prim, fr), None),
    }, sweep_errs, o.shape[0])


def _bvh_leaf_records(scenes_on_card):
    """K5 and K6 with sphere rows and object-space rays (B.1.3) against their
    plain versions, bit-equal: on the rtiow_bvh block (camera, random and
    sky shadow rays; sphere rows, world rays) and the cornell_animated_bvh
    block (camera, random and the moving light's NEE shadow rays, with the
    frame's animation rows, and without them on the same rows at rest:
    every instantiation of the walk), each also with every lane dead.
    Timed: K5 on the rtiow_bvh camera rays, K5 and K6 with animation rows
    on the cornell_animated_bvh camera and shadow rays."""
    from wurblpt_tpu_torch.accel import traverse

    from wurblpt_tpu_torch import native
    from wurblpt_tpu_torch.utils import scenes

    rt = scenes_on_card["rtiow_bvh"].bvh
    an_scene = scenes_on_card["cornell_animated_bvh"]
    an, fr = an_scene.bvh, kc.frames_at(an_scene)
    at_rest = an._replace(n_anims=1)     # the same rows as a static tree
    # the box without spheres: triangle rows in object space, and at rest
    box = scenes.cornell_box_animated(DEVICE, use_bvh=True).bvh
    box_rest = box._replace(n_anims=1)
    rt_cam = kc.rtiow_camera_lanes(DEVICE)
    rt_rnd = kc.rtiow_bvh_random_lanes(rt_cam[0].shape[0], DEVICE)
    rt_shadow = kc.sky_shadow_lanes(lambda *r: traverse.bvh_closest_hit_plain(rt, *r), rt_cam)
    an_cam = kc.camera_lanes(kc.BENCH_WIDTH, kc.BENCH_WIDTH, kc.BENCH_LANES_M, DEVICE)
    an_rnd = kc.random_lanes(an_cam[0].shape[0], DEVICE)
    an_shadow = kc.anim_shadow_lanes(an_scene, an, fr, an_cam)

    def dead(rays):
        return rays[:3] + (torch.zeros_like(rays[3]),)

    spheres = {"rtiow_bvh camera, sphere rows": (rt, rt_cam, None),
               "rtiow_bvh random": (rt, rt_rnd, None),
               "rtiow_bvh every lane dead": (rt, dead(rt_rnd), None)}
    objects = {"cornell_animated_bvh camera, object rays": (an, an_cam, fr),
               "cornell_animated_bvh random, object rays": (an, an_rnd, fr),
               "cornell_animated_bvh every lane dead": (an, dead(an_rnd), fr),
               "cornell_animated_bvh camera, rows at rest": (at_rest, an_cam, None),
               "cornell_animated_bvh random, rows at rest": (at_rest, an_rnd, None)}
    any_ = {"rtiow_bvh sky shadow, sphere rows": (rt, rt_shadow, None),
            "rtiow_bvh random": (rt, rt_rnd, None),
            "cornell_animated_bvh moving-light shadow, object rays": (an, an_shadow, fr),
            "cornell_animated_bvh random, object rays": (an, an_rnd, fr),
            "cornell_animated_bvh every lane dead": (an, dead(an_rnd), fr),
            "cornell_animated_bvh moving-light shadow, rows at rest": (at_rest, an_shadow, None),
            "cornell_animated_bvh random, rows at rest": (at_rest, an_rnd, None)}
    box_cam = (box, an_cam, fr)
    objects.update({"the box without spheres, camera, object rays": box_cam,
                    "the box without spheres, random, object rays": (box, an_rnd, fr),
                    "the box without spheres, camera, rows at rest": (box_rest, an_cam, None)})
    any_.update({"the box without spheres, random, object rays": (box, an_rnd, fr),
                 "the box without spheres, random, rows at rest": (box_rest, an_rnd, None)})
    # Each tree takes its branch by its size (all of these: the staged walk);
    # the same sets again on the L2 walk, so that every instantiation of both
    # branches is held here.
    for name, (bvh, _, f) in {**spheres, **objects}.items():
        assert traverse.plan(bvh, f)[1] == "shared", f"{name}: not staged"
    for sets in (spheres, objects, any_):
        sets.update({f"{k}, L2 walk": v + ("L2",) for k, v in list(sets.items())})
    # The edge sets, on the branch each tree's size picks and on the L2 walk:
    # lane counts about the resident threads of the cornell_animated_bvh
    # launches, a tree just past the budget of a static sphere tree.
    lib = native.load_kernels()
    waves = []
    for entry in ("bvh_closest", "bvh_any"):
        var, _, smem = traverse.plan(an, fr, entry)
        waves.append(getattr(lib, f"wpt_{entry}_threads")(var, smem))
    edge = kc.bvh_leaf_edge_sets(
        rt, an, fr, DEVICE, waves=sorted(set(waves)), budget=lib.wpt_bvh_closest_budget(1),
        frames_bytes=lambda b: traverse.layout_bytes(b, None, True))
    past = edge["a tree just past the staging budget"][0]
    assert traverse.plan(past, None)[1] == "L2", "the tree past the budget is staged"
    print(f"kernels: B.1.3 staging budgets (B) K5 {[lib.wpt_bvh_closest_budget(v) for v in range(4)]}"
          f", K6 {[lib.wpt_bvh_any_budget(v) for v in range(4)]}; waves {waves}; the tree past "
          f"the budget: {traverse.layout_bytes(past, None, True)} B staged")
    errs = _run_checks((
        ("bvh_closest_hit_spheres", kc.check_bvh_closest_hit, spheres),
        ("bvh_closest_hit_object", kc.check_bvh_closest_hit, objects),
        ("bvh_any_hit_object", kc.check_bvh_any_hit, any_),
        ("bvh_leaf_edge_sets", kc.check_bvh_edge_sets, {"by size": (edge,),
                                                        "L2 walk": (edge, "L2")})))
    for name in ("bvh_closest_hit_spheres", "bvh_closest_hit_object", "bvh_any_hit_object"):
        errs[name] = max(errs[name], errs["bvh_leaf_edge_sets"])
    records = _timed_records({
        "bvh_closest_hit_spheres": (lambda: traverse.bvh_closest_hit(rt, *rt_cam),
                                    lambda: traverse.bvh_closest_hit_plain(rt, *rt_cam),
                                    kc.bvh_work(rt, rt_cam, any_hit=False), None),
    }, errs, rt_cam[0].shape[0])
    records += _timed_records({
        "bvh_closest_hit_object": (lambda: traverse.bvh_closest_hit(an, *an_cam, fr),
                                   lambda: traverse.bvh_closest_hit_plain(an, *an_cam, fr),
                                   kc.bvh_work(an, an_cam, any_hit=False, frames=fr), None),
        "bvh_any_hit_object": (lambda: traverse.bvh_any_hit(an, *an_shadow, fr),
                               lambda: traverse.bvh_any_hit_plain(an, *an_shadow, fr),
                               kc.bvh_work(an, an_shadow, any_hit=True, frames=fr), None),
    }, errs, an_cam[0].shape[0])
    for r, (bvh, f, entry) in zip(records, ((rt, None, "bvh_closest"), (an, fr, "bvh_closest"),
                                            (an, fr, "bvh_any"))):
        r["branch"] = traverse.plan(bvh, f, entry)[1]
    return records


def _k4_records(scenes_on_card):
    """K4's kernels against their plain versions on the first block after 2
    steps of the Cornell, cornell_animated, cornell_animated_bvh, rtiow_bvh,
    ToF, mesh, envmap, rtiow and city frames, and on
    the city block as the frame starts it (at 1 spp only that step
    regenerates, every lane); the env shade also seen by the ToF sensor on
    the mesh, envmap and rtiow blocks (its other instantiations), the lit
    shade by the ToF sensor on the city block, the regeneration also through
    the RADIAL_ONLY and RADIAL_AND_PLANAR lenses on the rtiow block. Timed:
    the regeneration and the resolve on the Cornell block, the regeneration
    through the OpenCV lens on the rtiow block, the surround regeneration on
    the fresh city block, the lit shade and the resolve of two pending
    deposits on the city block after 2 steps, each other shade on its
    frames' blocks; a regeneration is timed only where lanes regenerate.
    Then K5 and K6 at every cast of the mesh and city frames."""
    from wurblpt_tpu_torch.render import wavefront as wf
    from wurblpt_tpu_torch.render.camera import CameraConfig, DistortionModel
    from wurblpt_tpu_torch.render.sensor import SensorTofAmcw

    tof, rgb = SensorTofAmcw(), None
    cases = [("cornell", "cornell", rgb, None, 2),
             ("cornell_animated", "cornell_animated", rgb, None, 2),
             ("cornell_animated_bvh", "cornell_animated_bvh", rgb, None, 2),
             ("rtiow_bvh", "rtiow_bvh", rgb, None, 2), ("tof", "tof", rgb, None, 2),
             ("mesh", "mesh", rgb, None, 2), ("mesh, ToF sensor,", "mesh", tof, None, 2),
             ("envmap", "envmap", rgb, None, 2), ("envmap, ToF sensor,", "envmap", tof, None, 2),
             ("rtiow", "rtiow", rgb, None, 2), ("rtiow, ToF sensor,", "rtiow", tof, None, 2),
             ("rtiow_dof", "rtiow_dof", rgb, None, 2),
             ("city", "city", rgb, None, 2), ("city, ToF sensor,", "city", tof, None, 2),
             # 1 spp: only the block's first step regenerates (every lane)
             ("city", "city", rgb, None, 0)]
    cases += [(f"rtiow, lens model {model},", "rtiow", rgb,
               CameraConfig(distortion=model, undistort_iters=kc.RTIOW_CAMERA.undistort_iters), 2)
              for model in (DistortionModel.RADIAL_ONLY, DistortionModel.RADIAL_AND_PLANAR)]
    errs, inputs = {}, {}
    for label, frame, sensor, cfg, steps in cases:
        inp = kc.k4_inputs(DEVICE, frame, steps=steps, scene=scenes_on_card.get(frame),
                           sensor=sensor, cfg=cfg)
        inputs.setdefault((frame, steps), inp)
        res = kc.check_k4(inp)
        torch.cuda.synchronize()
        regenerated = kc.regenerated_lanes(inp)
        for name, fields in res.items():
            print(f"kernels: {name} [{label} block after {steps} steps, "
                  f"{inp.regen[0].active.shape[0]} lanes"
                  f"{f', {regenerated} regenerated' if name.startswith('regen') else ''}] "
                  f"ok {fields}")
            record = K4_RECORDS.get((name, frame), name)
            errs[record] = max([errs.get(record, 0.0)]
                               + [v for v in fields.values() if isinstance(v, float)])
    records = _k3_k4_records(inputs, errs)
    for record, frame, kernel in (("regen_pinhole", ("cornell", 2), "regen_pinhole"),
                                  ("regen_lens", ("rtiow", 2), "regen_pinhole"),
                                  ("regen_dof", ("rtiow_dof", 2), "regen_pinhole"),
                                  ("regen_surround", ("city", 0), "regen_surround"),
                                  ("shade_diffuse", ("cornell", 2), "shade_diffuse"),
                                  ("shade_env", ("mesh", 2), "shade_env"),
                                  ("shade_env_glass_cube", ("envmap", 2), "shade_env"),
                                  ("shade_env_glass_constant", ("rtiow", 2), "shade_env"),
                                  ("shade_lit", ("city", 2), "shade_lit"),
                                  ("nee_resolve", ("cornell", 2), "nee_resolve"),
                                  ("nee_resolve_lit", ("city", 2), "nee_resolve")):
        inp = inputs[frame]
        if kernel.startswith("regen"):   # a regeneration timed where no lane regenerates is a copy
            assert kc.regenerated_lanes(inp) > 0, f"{record}: no lane to regenerate on {frame}"
        args = {"regen_pinhole": inp.regen, "regen_surround": inp.regen,
                "nee_resolve": inp.resolve}.get(kernel, inp.shade)
        plain = getattr(wf, "regen_plain" if kernel.startswith("regen") else kernel + "_plain")
        fn = getattr(wf, kernel)
        # the in-place kernels on the same inputs each call; the others as they are
        call = ((fn, args) if kernel in IN_PLACE else lambda f=fn, a=args: f(*a))
        records += _timed_records({record: (
            call, lambda f=plain, a=args: f(*a), kc.k4_work(inp, kernel), None)}, errs,
            inp.regen[0].active.shape[0])
        if kernel in IN_PLACE:
            copy_work = kc.k4_work(inp, kernel, in_place=False)
            bound, bound_by = kc.bound_ms(*copy_work)
            print(f"kernels: {record} copy-contract bound {bound:.6f} ms by {bound_by} "
                  f"({copy_work[0]:.4g} bytes, {copy_work[1]:.4g} flops)")
    _frame_casts(scenes_on_card)
    _frame_k4_steps(scenes_on_card)
    return records


def _k3_k4_records(inputs, errs):
    """K3's K4 form against its plain version (kc.check_assemble_hit_k4: the
    set's fields bit-equal on hit lanes, every miss lane as it was filled)
    with each frame's field set on the winners before each K4 frame's shade
    (its first block after 2 steps, the city block also as the frame starts
    it), and with every field set, static and animated, on
    kc.k3_edge_sets; timed on the Cornell (diffuse), mesh (env), city (lit)
    and cornell_animated (K3a's, diffuse) blocks."""
    from wurblpt_tpu_torch.render import intersect

    for (frame, steps), inp in inputs.items():
        ht, args, frames, fields = inp.assemble
        record = K3_K4_RECORDS[frame]
        res = kc.check_assemble_hit_k4(ht, args, frames, fields)
        torch.cuda.synchronize()
        print(f"kernels: {record} [{frame} block after {steps} steps, winners before the shade] "
              f"ok {res}")
        errs[record] = max(errs.get(record, 0.0), res["max_abs_err"])
    for label, (ht, args, frames) in kc.k3_edge_sets(DEVICE).items():
        for cls, fields in intersect.K4_FIELDS.items():
            for fr in (None, frames):
                res = kc.check_assemble_hit_k4(ht, args, fr, fields)
                torch.cuda.synchronize()
                print(f"kernels: assemble_hit_k4 [edge: {label}, {cls} fields, "
                      f"{'animated' if fr is not None else 'static'}] ok {res}")
    records = []
    for record, frame in (("assemble_hit_k4_diffuse", "cornell"), ("assemble_hit_k4_env", "mesh"),
                          ("assemble_hit_k4_lit", "city"),
                          ("assemble_hit_k4_anim", "cornell_animated")):
        ht, args, frames, fields = inputs[(frame, 2)].assemble
        n = args[0].shape[0]
        out = intersect.hit_buffers(fields, n, DEVICE)
        records += _timed_records({record: (
            lambda h=ht, a=args, f=frames, b=out: intersect.assemble_hit_k4(h, *a, f, b),
            lambda h=ht, a=args, f=frames: intersect.assemble_hit_plain(h, *a, f),
            kc.assemble_hit_work(ht, args[3], frames, fields), None)}, errs, n)
    return records


def _frame_casts(scenes_on_card):
    """K5 and K6 at every cast of the mesh frame (4 steps), the city frame
    (2 blocks of 4 steps), the rtiow_bvh frame and the cornell_animated_bvh
    frame, K1 and K2 at every cast of the Cornell, ToF, envmap and rtiow
    frames, and KS1 and KS2 at every cast of the cornell_animated frame, on
    the rays each step really gives: each cast held against its plain
    version (bit-equal), its time beside the bound of the same work
    (kc.bvh_work, kc.closest_hit_work / any_hit_work, kc.sweep_work), with
    its lanes and live lanes (K5/K6 by the wrapper call, the others by
    kc.device_ms)."""
    from wurblpt_tpu_torch.utils import cast_steps

    for frame, make in (("mesh", kc.mesh_frame), ("city", kc.city_frame),
                        ("rtiow_bvh", kc.rtiow_bvh_frame),
                        ("cornell_animated_bvh", kc.cornell_animated_bvh_frame),
                        ("cornell", lambda dev, _: kc.bench_frame(dev)), ("tof", kc.tof_frame),
                        ("envmap", kc.envmap_frame), ("rtiow", kc.rtiow_frame),
                        ("cornell_animated", kc.cornell_animated_frame)):
        render = make(DEVICE, scenes_on_card.get(frame))
        render()
        rows = cast_steps.cast_rows(frame, render, DEVICE) + cast_steps.k3_rows(frame, render)
        for r in rows:
            print(f"kernels: {cast_steps.format_row(r)}, bit-equal to the plain version")
        for line in cast_steps.summary(rows):
            print(f"kernels: {line}")


def _frame_k4_steps(scenes_on_card):
    """The lit shade and the surround regeneration at every step of the city
    frame (2 blocks of 4 steps), and the regeneration and the diffuse or env
    shade at every step of the other eight frames' first block, on the lanes
    each step really gives (`utils/k4_steps.py`):
    each call held against its plain version (bit-equal), its device time
    per call on restored inputs beside its bounds, in place and copying."""
    from wurblpt_tpu_torch.utils import k4_steps

    for frame in k4_steps.FRAMES:
        rows = k4_steps.frame_rows(frame, DEVICE, scenes_on_card.get(frame))
        for r in rows:
            assert r["max_abs_err"] == 0.0 and r["discrete_differ"] == 0, r
            print(f"kernels: {k4_steps.format_row(r)}, bit-equal to the plain version")
        for line in k4_steps.summary(rows):
            print(f"kernels: {line}")


def _drive(label, render, names, absent=()):
    """Render once with the counters at 0, check that `names` launched and
    `absent` did not, then time 5 more frames; returns (first image, stats,
    counters, frame times)."""
    from wurblpt_tpu_torch import native

    native.reset_launch_counts()
    t0 = time.perf_counter()
    img, stats = render()
    first_s = time.perf_counter() - t0
    launches = dict(native.LAUNCHES)
    print(f"{label}: launches {launches}, first frame {first_s * 1e3:.1f} ms")
    for name in names:
        assert launches[name] > 0, f"kernel {name} was not launched on the {label}"
    for name in absent:
        assert launches[name] == 0, f"kernel {name} was launched on the {label}"
    times = []
    for _ in range(5):
        t0 = time.perf_counter()
        render()
        times.append(time.perf_counter() - t0)
    return img, [int(x) for x in stats.tolist()], launches, times


def _count_launches(render, setup=None):
    """(CUDA kernel launches, copies and memsets, wavefront steps, device ms,
    {hand-written kernel: (device us per launch, launches)}, {other kernel:
    launches}) of one frame rendered under torch.profiler; a step is one
    closest-hit cast, the device time the sum over its kernels, copies and
    memsets. The profiler at times loses events, most often on short frames
    and late in a process: a profile in which it saw another number of the
    port's kernels than the wrappers launched (native.LAUNCHES) is taken
    again, up to PROFILE_TRIES times, and each kernel counts its largest
    number over the profiles that saw them all (a lost event only ever
    lowers a count, of the port's kernels or PyTorch's); if none saw them
    all, the phase fails rather than gate on an undercount. At least two
    such profiles are taken, and more, up to PROFILE_TRIES, while a set-up
    kernel counts fewer than in the full frame: `setup` is the full frame's
    ({other kernel: launches}, steps), and a set-up kernel is one of those
    that the first complete profile here saw short of its full-frame count
    by fewer launches than the frames differ in steps (a kernel of the loop
    falls short by one a step; a lost event by one); a line names those
    still short after PROFILE_TRIES. The device ms and the port's kernels'
    device us are those of the complete profile that saw the most events,
    the counts each kernel's largest over all of them."""
    from torch.profiler import ProfilerActivity, profile

    from wurblpt_tpu_torch import native
    from wurblpt_tpu_torch.utils.profile_frame import OURS

    def steps():
        return (native.LAUNCHES["closest_hit"] + native.LAUNCHES["bvh_closest_hit"]
                + native.LAUNCHES["sweep_closest"])

    counts, device, complete, want = collections.Counter(), None, 0, {}
    for _ in range(PROFILE_TRIES):
        native.reset_launch_counts()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            render()
        events = [e for e in prof.key_averages()
                  if e.device_type == torch.autograd.DeviceType.CUDA]
        seen = sum(e.count for e in events if any(k in e.key for k in OURS))
        if seen != sum(native.LAUNCHES.values()):
            print(f"profiler: saw {seen} of the {sum(native.LAUNCHES.values())} launches of the "
                  f"port's kernels; profiling the frame again")
            continue
        here = collections.Counter({e.key: e.count for e in events})
        if complete and here != counts:
            print(f"profiler: {sum(here.values())} launches, copies and memsets against "
                  f"{sum(counts.values())} in another profile of the frame; each kernel's "
                  f"largest count counts")
        if device is None or sum(here.values()) > sum(e.count for e in device):
            device = events
        counts |= here
        complete += 1
        if complete == 1 and setup is not None:
            full, full_steps = setup
            want = {k: v for k, v in full.items() if v - here[k] < full_steps - steps()}
        if complete >= 2 and all(counts[k] >= v for k, v in want.items()):
            break
    if device is None:
        raise AssertionError(f"profiler: lost events in all {PROFILE_TRIES} profiles; the "
                             f"frame's launches and device time are not measured")
    short = sorted(k for k, v in want.items() if counts[k] < v)
    if short:
        print(f"profiler: after {PROFILE_TRIES} profiles {len(short)} set-up kernels count fewer "
              f"than in the full frame: {[(k[:60], counts[k], want[k]) for k in short[:3]]}")
    is_copy = lambda key: key.startswith(("Memcpy", "Memset"))  # noqa: E731
    copies = sum(v for k, v in counts.items() if is_copy(k))
    kernels = sum(counts.values()) - copies
    others = {k: v for k, v in counts.items() if not is_copy(k) and not any(o in k for o in OURS)}
    device_us = {e.key: (getattr(e, "self_device_time_total", None)
                         or getattr(e, "self_cuda_time_total", 0), e.count) for e in device}
    device_ms = sum(us for us, _ in device_us.values()) / 1e3
    ours = {re.search(r"\w+_kernel(<[^>]*>)?", key).group(0): (us / count, count)
            for key, (us, count) in device_us.items() if any(k in key for k in OURS)}
    return kernels, copies, steps(), device_ms, ours, others


def _report(label, stats, times, paths, render, short=None, max_per_step=None,
            max_loop_per_step=None, max_frame=None):
    """Frame time, paths/s, Mrays/s and the kernel launches (and apart from
    them the copies and memsets) of one more frame per step; with `short`,
    the same frame at 1 path component, also the launches of one step of
    the loop, (launches - short's) / (steps - short's), and those of the
    frame's set-up (the lane state), which a step does not repeat. Fails if
    the kernel launches per step of the frame exceed `max_per_step`, those
    per step of the loop `max_loop_per_step`, or those of the frame
    `max_frame`."""
    dt = statistics.median(times)
    n, c, steps, device_ms, ours, others = _count_launches(render)
    per_step = (f", device time {device_ms:.3f} ms (profiled frame), {n} kernel launches and "
                f"{c} copies/memsets in {steps} steps "
                f"({n / max(steps, 1):.2f} and {c / max(steps, 1):.2f} per step")
    n1 = None
    if short is not None:
        n0, c0, steps0, _, _, _ = _count_launches(short, setup=(others, steps))
        n1, c1 = (n - n0) / (steps - steps0), (c - c0) / (steps - steps0)
        per_step += (f"; {n1:.2f} and {c1:.2f} per step of the loop, {n - n1 * steps:.0f} and "
                     f"{c - c1 * steps:.0f} of set-up")
    print(f"{label}: frame {dt * 1e3:.2f} ms (median of 5; all "
          f"{[round(t * 1e3, 2) for t in times]}), {paths / dt:.4g} paths/s, "
          f"{stats[1] / dt / 1e6:.4g} Mrays/s{per_step}) on {_nvidia_smi()}")
    print(f"{label}: hand-written kernels, device us per launch (launches): "
          + ", ".join(f"{k} {us:.2f} ({count})" for k, (us, count) in sorted(ours.items())))
    if max_per_step is not None:
        assert n <= max_per_step * steps, (
            f"{label}: {n / steps:.2f} kernel launches per step, more than {max_per_step}")
    if max_loop_per_step is not None:
        assert n1 <= max_loop_per_step, (
            f"{label}: {n1:.2f} kernel launches per step of the loop, more than "
            f"{max_loop_per_step}")
    if max_frame is not None:
        assert n <= max_frame, f"{label}: {n} kernel launches per frame, more than {max_frame}"


def phase_main_path():
    render = kc.bench_frame(DEVICE)
    img, stats, launches, times = _drive("main path", render, MAIN_PATH,
                                         ("row_gather", "nee_resolve") + K3_FULL)
    print(f"main path: mean radiance {float(img.double().mean())!r} (reference {kc.REF_MEAN}), "
          f"stats {stats} (reference {list(kc.REF_STATS)})")
    kc.check_bench_frame(img, stats)
    _report("main path", stats, times, kc.BENCH_WIDTH ** 2 * kc.BENCH_SSQRT ** 2, render,
            kc.bench_frame(DEVICE, depth=1), K4_MAX_LAUNCHES_PER_STEP, K4_LOOP_LAUNCHES)
    return launches


def phase_city_path(city_scene):
    render = kc.city_frame(DEVICE, city_scene)
    img, stats, launches, times = _drive("city path", render, CITY_PATH, CITY_ABSENT)
    print(f"city path: mean radiance {float(img.double().mean())!r} "
          f"(reference {kc.CITY_REF_MEAN}), stats {stats} (reference {list(kc.CITY_REF_STATS)})")
    kc.check_city_frame(img, stats)
    _report("city path", stats, times, kc.CITY_WIDTH * kc.CITY_HEIGHT * kc.CITY_SSQRT ** 2,
            render, kc.city_frame(DEVICE, city_scene, depth=1),
            max_loop_per_step=K4_LOOP_LAUNCHES)
    return launches


def phase_mesh_path(mesh_scene):
    render = kc.mesh_frame(DEVICE, mesh_scene)
    img, stats, launches, times = _drive("mesh path", render, MESH_PATH,
                                         ("row_gather", "nee_resolve") + ENV_ALL + K3_FULL)
    print(f"mesh path: mean radiance {float(img.double().mean())!r} "
          f"(reference {kc.MESH_REF_MEAN}), stats {stats} (reference {list(kc.MESH_REF_STATS)})")
    kc.check_mesh_frame(img, stats)
    _report("mesh path", stats, times, kc.MESH_WIDTH * kc.MESH_HEIGHT * kc.MESH_SSQRT ** 2,
            render, kc.mesh_frame(DEVICE, mesh_scene, depth=1),
            max_loop_per_step=K4_LOOP_LAUNCHES, max_frame=MESH_MAX_FRAME_LAUNCHES)
    return launches


def phase_envmap_path(env_scene):
    render = kc.envmap_frame(DEVICE, env_scene)
    img, stats, launches, times = _drive("envmap path", render, ENVMAP_PATH,
                                         ("row_gather", "nee_resolve") + ENV_ALL + K3_FULL)
    print(f"envmap path: mean radiance {float(img.double().mean())!r} "
          f"(reference {kc.ENVMAP_REF_MEAN}), stats {stats} "
          f"(reference {list(kc.ENVMAP_REF_STATS)})")
    kc.check_envmap_frame(img, stats)
    _report("envmap path", stats, times, kc.ENVMAP_WIDTH ** 2 * kc.ENVMAP_SSQRT ** 2,
            render, kc.envmap_frame(DEVICE, env_scene, depth=1), K4_MAX_LAUNCHES_PER_STEP,
            K4_LOOP_LAUNCHES)
    return launches


def phase_rtiow_path(rt_scene):
    render = kc.rtiow_frame(DEVICE, rt_scene)
    img, stats, launches, times = _drive("rtiow path", render, RTIOW_PATH,
                                         ("row_gather", "any_hit", "nee_resolve") + ENV_ALL
                                         + K3_FULL)
    print(f"rtiow path: mean radiance {float(img.double().mean())!r} "
          f"(reference {kc.RTIOW_REF_MEAN}), stats {stats} (reference {list(kc.RTIOW_REF_STATS)})")
    kc.check_rtiow_frame(img, stats)
    _report("rtiow path", stats, times, kc.RTIOW_WIDTH * kc.RTIOW_HEIGHT * kc.RTIOW_SSQRT ** 2,
            render, kc.rtiow_frame(DEVICE, rt_scene, depth=1), K4_MAX_LAUNCHES_PER_STEP,
            K4_LOOP_LAUNCHES_NO_SHADOW)
    return launches


def phase_tof_path(tof_scene):
    render = kc.tof_frame(DEVICE, tof_scene)
    img, stats, launches, times = _drive("tof path", render, TOF_PATH,
                                         ("row_gather", "nee_resolve") + K3_FULL)
    channels = [float(img[..., c].double().mean()) for c in range(3)]
    print(f"tof path: phase 0 mean energy {float(img.double().mean())!r} J (reference "
          f"{kc.TOF_REF_MEAN}), channels a, b, energy {channels} (reference "
          f"{list(kc.TOF_REF_CHANNELS)}), stats {stats} (reference {list(kc.TOF_REF_STATS)})")
    kc.check_tof_frame(img, stats)
    _report("tof path", stats, times, kc.TOF_WIDTH ** 2 * kc.TOF_SSQRT ** 2, render,
            kc.tof_frame(DEVICE, tof_scene, depth=1), K4_MAX_LAUNCHES_PER_STEP,
            K4_LOOP_LAUNCHES)
    # Phases 1-3: the same paths (the counters), the same energy; tau = pi
    # swaps the two buckets.
    for i in (1, 2, 3):
        img_i, stats_i = kc.tof_frame(DEVICE, tof_scene, phase_index=i)()
        mean_i = float(img_i.double().mean())
        ch = [float(img_i[..., c].double().mean()) for c in range(3)]
        print(f"tof path: phase {i} mean energy {mean_i!r} J, channels {ch}, stats "
              f"{stats_i.tolist()}")
        assert [int(x) for x in stats_i.tolist()] == stats, f"phase {i}: counters differ"
        assert abs(mean_i - kc.TOF_REF_MEAN) <= 1e-3 * kc.TOF_REF_MEAN, f"phase {i}: mean"
        assert abs(ch[2] - channels[2]) <= 1e-6 * channels[2], f"phase {i}: energy differs"
        if i == 2:
            for c in (0, 1):
                assert abs(ch[c] - channels[1 - c]) <= 1e-3 * channels[1 - c], "a, b not swapped"
    dist = kc.tof_distance_check(DEVICE, tof_scene)
    print(f"tof path: 4-phase distance at depth 1 against the pixel-centre first hits: {dist}")
    return launches


def phase_anim_path(scene):
    render = kc.cornell_animated_frame(DEVICE, scene)
    img, stats, launches, times = _drive("cornell_animated path", render, ANIM_PATH, ANIM_ABSENT)
    print(f"cornell_animated path: mean radiance {float(img.double().mean())!r} "
          f"(reference {kc.ANIM_REF_MEAN}), stats {stats} (reference {list(kc.ANIM_REF_STATS)})")
    kc.check_cornell_animated_frame(img, stats)
    _report("cornell_animated path", stats, times, kc.BENCH_WIDTH ** 2 * kc.BENCH_SSQRT ** 2,
            render, kc.cornell_animated_frame(DEVICE, scene, depth=1),
            max_loop_per_step=K4_LOOP_LAUNCHES, max_frame=ANIM_MAX_FRAME_LAUNCHES)
    return launches


def phase_rtiow_bvh_path(scene):
    render = kc.rtiow_bvh_frame(DEVICE, scene)
    img, stats, launches, times = _drive("rtiow_bvh path", render, RTIOW_BVH_PATH,
                                         RTIOW_BVH_ABSENT)
    print(f"rtiow_bvh path: mean radiance {float(img.double().mean())!r} "
          f"(reference {kc.RTIOW_BVH_REF_MEAN}), stats {stats} "
          f"(reference {list(kc.RTIOW_BVH_REF_STATS)})")
    kc.check_rtiow_bvh_frame(img, stats)
    _report("rtiow_bvh path", stats, times, kc.RTIOW_WIDTH * kc.RTIOW_HEIGHT * kc.RTIOW_SSQRT ** 2,
            render, kc.rtiow_bvh_frame(DEVICE, scene, depth=1), K4_MAX_LAUNCHES_PER_STEP,
            K4_LOOP_LAUNCHES_NO_SHADOW)
    return launches


def phase_anim_bvh_path(scene):
    render = kc.cornell_animated_bvh_frame(DEVICE, scene)
    img, stats, launches, times = _drive("cornell_animated_bvh path", render, ANIM_BVH_PATH,
                                         ANIM_BVH_ABSENT)
    print(f"cornell_animated_bvh path: mean radiance {float(img.double().mean())!r} "
          f"(reference {kc.ANIM_BVH_REF_MEAN}), stats {stats} "
          f"(reference {list(kc.ANIM_BVH_REF_STATS)})")
    kc.check_cornell_animated_bvh_frame(img, stats)
    _report("cornell_animated_bvh path", stats, times, kc.BENCH_WIDTH ** 2 * kc.BENCH_SSQRT ** 2,
            render, kc.cornell_animated_bvh_frame(DEVICE, scene, depth=1),
            max_loop_per_step=K4_LOOP_LAUNCHES, max_frame=ANIM_MAX_FRAME_LAUNCHES)
    return launches


def phase_rtiow_dof_path(rt_scene):
    """examples/rtiow.py's depth-of-field frame (rtiow(), 320 x 200, 16 spp,
    8 path components, aperture 0.08 focused at 10) through
    render_frame_wavefront on K4's env class: the pinhole regeneration
    through the thin lens, K1, K3's K4 form and the env shade (constant sky,
    glass) must launch, and neither K2 (no shadow ray), P0, the resolve nor
    K8's stand-alone kernels; held to its JAX yardstick as in phase 4, at
    most 4.00 launches per step of the loop and 8 per step of the frame."""
    render = kc.rtiow_dof_frame(DEVICE, rt_scene)
    img, stats, launches, times = _drive("rtiow_dof path", render, RTIOW_PATH,
                                         ("row_gather", "any_hit", "nee_resolve") + ENV_ALL
                                         + K3_FULL)
    print(f"rtiow_dof path: mean radiance {float(img.double().mean())!r} "
          f"(reference {kc.DOF_REF_MEAN}), stats {stats} (reference {list(kc.DOF_REF_STATS)})")
    kc.check_rtiow_dof_frame(img, stats)
    _report("rtiow_dof path", stats, times, kc.DOF_WIDTH * kc.DOF_HEIGHT * kc.DOF_SSQRT ** 2,
            render, kc.rtiow_dof_frame(DEVICE, rt_scene, depth=1), K4_MAX_LAUNCHES_PER_STEP,
            K4_LOOP_LAUNCHES_NO_SHADOW)
    return launches


def phase_motion_path(name, scene):
    """Phase motion, one path per motion-blurred frame
    (kernel_check.MOTION_FRAMES): the scene rendered over its shutter with
    render_frame on the card (cornell_animated_blur through
    render_frame_wavefront, which hands it to render_frame), each ray at its
    own time, with the counters at 0: the casts and K3a's full form with
    per-ray rows (MOTION[name]) must launch and no K4 kernel; held to its
    JAX CPU yardstick (mean within 1e-3, each counter within 0.5 %); frame
    ms (median of 5 after the first), peak memory, and the CUDA kernel
    launches, device time and each hand-written kernel's device us per
    launch of one profiled frame. Returns the counters of the first frame."""
    label = f"{name} path"
    width, height, ssqrt, depth, per_pass, t0, t1 = kc.MOTION_FRAMES[name]
    render = kc.motion_frame(name, DEVICE, scene, wavefront=name == "cornell_animated_blur")
    torch.cuda.reset_peak_memory_stats()
    img, stats, launches, times = _drive(label, render, MOTION[name], MOTION_ABSENT)
    peak = torch.cuda.max_memory_allocated() / 2 ** 20
    mean = float(img.double().mean())
    ref_mean, ref_stats = kc.MOTION_REFS[name]
    print(f"{label}: {width} x {height}, {ssqrt * ssqrt} spp in passes of {per_pass}, depth "
          f"{depth}, shutter [{t0}, {t1}]: mean radiance {mean!r} (JAX yardstick {ref_mean!r}), "
          f"stats {stats} (JAX {list(ref_stats)}); {scene.n_anims} animation rows, per-ray rows "
          f"{width * height * per_pass * scene.n_anims * 120 / 1e6:.1f} MB a pass, peak memory "
          f"{peak:.0f} MiB")
    kc.check_motion_frame(name, img, stats)
    dt = statistics.median(times)
    kernels, copies, _, device_ms, ours, _ = _count_launches(render)
    print(f"{label}: frame {dt * 1e3:.2f} ms (median of 5; all "
          f"{[round(t * 1e3, 2) for t in times]}), {width * height * ssqrt * ssqrt / dt:.4g} "
          f"paths/s, {stats[1] / dt / 1e6:.4g} Mrays/s; a profiled frame: {kernels} CUDA kernel "
          f"launches and {copies} copies/memsets, device time {device_ms:.3f} ms (busy "
          f"{device_ms / (dt * 1e3):.3f} of the median frame) on {_nvidia_smi()}")
    print(f"{label}: hand-written kernels launched {{"
          + ", ".join(f"{k}: {v}" for k, v in sorted(launches.items()) if v) + "}, device us "
          "per launch (launches): "
          + ", ".join(f"{k} {us:.2f} ({count})" for k, (us, count) in sorted(ours.items())))
    return launches


def _grad_records():
    """Phase grad, part 1: P0T, K3T, K3aT (rows of one instant and per ray),
    K8T (with and without its rotation term), its sample's backward and
    K7T (its tail and its full form) against their plain backward versions
    at a differentiable frame's shapes (utils/grad_check.py), each timed
    (wrapper call, device time a launch, plain version, index_add_ for
    P0T) beside its bound. P0T on each of its three paths (a copy of the
    table per warp, the block's copy, global atomics) and K7T on both of
    its (the block's copy, global atomics), also on the lanes the 128^2 RGL
    tables step hands K7T, each path's instantiation read from a profiled
    call's kernel name."""
    from wurblpt_tpu_torch.render import backward as bw
    from wurblpt_tpu_torch.utils import grad_check as gc

    lanes = gc.cornell_lanes(DEVICE)
    rows = lanes["mat_table"].shape[0]
    g_rows, mat = lanes["g_rows"], lanes["mat"]
    k3 = [lanes[k] for k in ("ht", "o", "d", "t", "prim", "u", "v", "backside")] + lanes["cot"]
    skies = {"equirect": gc.sky_lanes(DEVICE, cube=False), "cube": gc.sky_lanes(DEVICE, cube=True),
             "constant": gc.sky_lanes(DEVICE, cube=False, kind="constant"),
             # held to the plain version on the card (CUDA's atan2f and acosf:
             # grad_check.check_env_radiance_bwd)
             LARGE_SKY: gc.sky_lanes(DEVICE, cube=False, kind="large") + (False, True)}
    rotated = {f"{kind}, rotated": gc.sky_lanes(DEVICE, cube=kind == "cube", kind=kind,
                                                rotated=True) + (True,)
               for kind in ("equirect", "cube", "constant")}
    rotated[f"{LARGE_SKY}, rotated"] = gc.sky_lanes(DEVICE, cube=False, kind="large",
                                                    rotated=True) + (True, True)
    floor, field = gc.floor_lanes(DEVICE), gc.field_lanes(DEVICE)
    field_anim = {k: gc.field_lanes(DEVICE, anim=k) for k in ("one instant", "per ray")}
    senv, su3, sgd = gc.env_sample_lanes(DEVICE)
    rtab, rmid, rwi, rwo, ru2, rg = gc.rgl_lanes(DEVICE)
    rgp, rgwo = gc.rgl_full_cotangents(rmid.shape[0], DEVICE)
    # K7T's global path: the same lanes on a stack of materials whose tables
    # pass its shared memory; and the lanes the 128^2 RGL tables step hands
    # it (its first bounce's eval and sample: a render's cotangents)
    rtab_g = gc.rgl_lanes(DEVICE, stacked=gc.RGL_STACK_GLOBAL)[0]
    quad = gc.rgl_quad_lanes(DEVICE)
    # P0T past the material rows: the block's one copy, and global atomics
    scatter = {f"table of {r} x 23": gc.scatter_lanes(DEVICE, r)
               for r in (gc.SCATTER_ROWS_BLOCK, gc.SCATTER_ROWS_GLOBAL)}
    anim = {"one instant": gc.anim_lanes(DEVICE, per_ray=False),
            "per ray": gc.anim_lanes(DEVICE, per_ray=True)}
    rgl_sets = {"eval": (rtab, rmid, rwi, rwo, rg, False),
                "sample": (rtab, rmid, rwi, ru2, rg, True),
                f"eval, {gc.RGL_STACK_GLOBAL} materials stacked": (rtab_g, rmid, rwi, rwo, rg,
                                                                    False),
                f"sample, {gc.RGL_STACK_GLOBAL} materials stacked": (rtab_g, rmid, rwi, ru2, rg,
                                                                      True),
                **{f"RGL quad 128^2 {k} lanes": (*v[:5], k == "sample") for k, v in quad.items()}}
    rgl_full_sets = {"eval": (rtab, rmid, rwi, rwo, rg, False, rgp, None),
                     "sample": (rtab, rmid, rwi, ru2, rg, True, rgp, rgwo),
                     f"eval, {gc.RGL_STACK_GLOBAL} materials stacked": (rtab_g, rmid, rwi, rwo, rg,
                                                                        False, rgp, None),
                     f"sample, {gc.RGL_STACK_GLOBAL} materials stacked": (rtab_g, rmid, rwi, ru2,
                                                                          rg, True, rgp, rgwo),
                     **{f"RGL quad 128^2 {k} lanes": (*v[:5], k == "sample", *v[5:],
                                                       gc.RGL_FULL_REL)
                        for k, v in quad.items()}}
    checks = [("row_scatter", gc.check_row_scatter, {"cornell material rows": (g_rows, mat, rows),
                                                    **scatter}),
              ("assemble_hit_bwd", gc.check_assemble_hit_bwd,
               {"cornell block": (lanes,), "floor step": (floor,), FIELD: (field,)}),
              ("assemble_hit_anim_bwd", gc.check_assemble_hit_anim_bwd,
               {**{f"animated box with spheres, rows of {k}": (v,) for k, v in anim.items()},
                **{f"animated {FIELD}, rows of {k}": (v,) for k, v in field_anim.items()}}),
              ("env_radiance_bwd", gc.check_env_radiance_bwd, skies),
              ("env_radiance_bwd_rot", gc.check_env_radiance_bwd, rotated),
              ("env_sample_bwd", gc.check_env_sample_bwd, {"equirect, rotated": (senv, su3, sgd)}),
              ("rgl_bwd", gc.check_rgl_bwd, rgl_sets),
              ("rgl_bwd_full", gc.check_rgl_bwd_full, rgl_full_sets)]
    errs = _run_checks(checks)
    env, d, g = skies["equirect"]
    renv, rd, rgg, _ = rotated["equirect, rotated"]
    k3a = ([anim["per ray"][k] for k in ("ht", "o", "d", "t", "prim", "u", "v", "backside")]
           + anim["per ray"]["cot"])
    cases = {
        "row_scatter": (lambda: bw.row_scatter(g_rows, mat, rows),
                        lambda: bw.row_scatter_plain(g_rows, mat, rows),
                        gc.row_scatter_work(g_rows, mat, rows),
                        lambda: torch.zeros((rows, g_rows.shape[1]), device=DEVICE).index_add_(
                            0, mat.long(), g_rows), g_rows.shape[0]),
        "assemble_hit_bwd": (lambda: bw.assemble_hit_bwd(*k3),
                             lambda: bw.assemble_hit_bwd_plain(*k3),
                             gc.assemble_hit_bwd_work(lanes), None, lanes["o"].shape[0]),
        # K3aT timed with per-ray rows (the motion-blurred render's)
        "assemble_hit_anim_bwd": (
            lambda: bw.assemble_hit_bwd(*k3a, frames=anim["per ray"]["frames"]),
            lambda: bw.assemble_hit_bwd_plain(*k3a, frames=anim["per ray"]["frames"]),
            gc.assemble_hit_anim_bwd_work(anim["per ray"]), None,
            anim["per ray"]["o"].shape[0]),
        "env_radiance_bwd": (lambda: bw.env_radiance_bwd(env, d, g, rotation=False),
                             lambda: bw.env_radiance_bwd_plain(env, d, g),
                             gc.env_radiance_bwd_work(env, d), None, d.shape[0]),
        "env_radiance_bwd_rot": (
            lambda: bw.env_radiance_bwd(renv, rd, rgg, rotation=True),
            lambda: bw.env_radiance_bwd_plain(renv, rd, rgg),
            gc.env_radiance_bwd_work(renv, rd, rotation=True), None, rd.shape[0]),
        "env_sample_bwd": (lambda: bw.env_sample_bwd(senv, su3, sgd),
                           lambda: bw.env_sample_bwd_plain(senv, su3, sgd),
                           gc.env_sample_bwd_work(senv, su3), None, su3.shape[0]),
        # the sample's backward: its lanes recompute the two warps' sampling
        "rgl_bwd": (lambda: bw.rgl_bwd(rtab, rmid, rwi, ru2, rg, True),
                    lambda: bw.rgl_bwd_plain(rtab, rmid, rwi, ru2, rg, True),
                    gc.rgl_bwd_work(rtab, rmid.shape[0], True), None, rmid.shape[0]),
        "rgl_bwd_full": (
            lambda: bw.rgl_bwd(rtab, rmid, rwi, ru2, rg, True, full=True, g_pdf=rgp, g_wo=rgwo),
            lambda: bw.rgl_bwd_plain(rtab, rmid, rwi, ru2, rg, True, full=True, g_pdf=rgp,
                                     g_wo=rgwo),
            gc.rgl_bwd_work(rtab, rmid.shape[0], True, full=True), None, rmid.shape[0]),
    }
    # K8T's rotation term's cost: both kernels on the turned equirect sky's
    # lanes, device time a launch in turns (without, with, with, without)
    turns = [kc.device_ms(lambda r=r: bw.env_radiance_bwd(renv, rd, rgg, rotation=r)) * 1e3
             for r in (False, True, True, False)]
    print(f"grad: env_radiance_bwd on the turned equirect sky, device us a launch in turns: "
          f"without the rotation term {turns[0]:.2f}, {turns[3]:.2f}; with it {turns[1]:.2f}, "
          f"{turns[2]:.2f} at {rd.shape[0]} lanes on {_nvidia_smi()}")
    # K7T and P0T at every shape checked above, device us a launch beside
    # the bound and the instantiation a profiled call launched, read from
    # one profiled session of all their calls (`_launched_kernels`: many
    # short sessions in one process lose events): K7T must
    # have run each form on both of its paths (rgl_bwd_kernel<SAMPLE, FULL,
    # SHARED>: the block's copy of the tables in shared memory, or the warps'
    # sums added to the tables), P0T its three (row_scatter_kernel<COPIES>:
    # a copy per warp, the block's copy, the table)
    bcases = []   # (label, call, work, lanes)
    for label, (tb, md, w, x, gf, smp) in rgl_sets.items():
        for full in (False, True):
            a = rgl_full_sets[label][6:8]
            bcases.append((
                f"rgl_bwd {'full' if full else 'tail'} {label}",
                lambda tb=tb, md=md, w=w, x=x, gf=gf, smp=smp, full=full, a=a: bw.rgl_bwd(
                    tb, md, w, x, gf, smp, full=full, g_pdf=a[0] if full else None,
                    g_wo=a[1] if full else None),
                gc.rgl_bwd_work(tb, md.shape[0], smp, full=full, live=gc.rgl_live(
                    gf, *(a if full else (None, None)))), md.shape[0]))
    for label, (sg, si, sr) in {"cornell material rows": (g_rows, mat, rows), **scatter}.items():
        bcases.append((f"row_scatter {label}",
                       lambda sg=sg, si=si, sr=sr: bw.row_scatter(sg, si, sr),
                       gc.row_scatter_work(sg, si, sr), sg.shape[0]))
    names = _launched_kernels([c for _, c, _, _ in bcases])
    for (label, call, work, n), name in zip(bcases, names):
        _bwd_case(label, call, work, n, ran=[name])
    print(f"grad: K7T and P0T ran {sorted(set(names))}")
    want = {f"rgl_bwd_kernel<{s_}, {f_}, {h_}>" for s_ in ("true", "false")
            for f_ in ("true", "false") for h_ in ("true", "false")}
    want |= {f"row_scatter_kernel<{c}>" for c in (8, 1, 0)}
    assert want <= set(names), f"{sorted(want - set(names))} did not launch"
    # K3T, K3aT and K8T at every shape checked above: device us a launch
    # beside the bound and the instantiation that ran; a constant sky's also
    # beside g.sum(0), the one PyTorch call of its function. K3T and K3aT
    # must each have run both of their paths: the block's tables in shared
    # memory (assemble_hit_bwd_kernel<ANIM, true>) and the warps' sums added
    # to the tables (<ANIM, false>).
    keys = ("ht", "o", "d", "t", "prim", "u", "v", "backside")
    k3_cases = {"assemble_hit_bwd cornell block": lanes, "assemble_hit_bwd floor step": floor,
                f"assemble_hit_bwd {FIELD}": field,
                **{f"assemble_hit_anim_bwd animated box, rows of {k}": v for k, v in anim.items()},
                **{f"assemble_hit_anim_bwd animated {FIELD}, rows of {k}": v
                   for k, v in field_anim.items()}}
    shared = collections.defaultdict(set)   # ANIM -> the SHARED values that ran
    for label, ln in k3_cases.items():
        fr = ln.get("frames")
        work = gc.assemble_hit_bwd_work(ln) if fr is None else gc.assemble_hit_anim_bwd_work(ln)
        args = [ln[k] for k in keys] + ln["cot"]
        for name in _bwd_case(label, lambda a=args, f=fr: bw.assemble_hit_bwd(*a, frames=f),
                              work, ln["o"].shape[0]):
            m = re.fullmatch(r"assemble_hit_bwd_kernel<(\w+), (\w+)>", name)
            shared[m.group(1)].add(m.group(2))
    for label, (sky, sky_d, sky_g, *flags) in {**skies, **rotated}.items():
        rot = bool(flags and flags[0])
        _bwd_case(f"env_radiance_bwd {label}",
                  lambda e=sky, a=sky_d, b=sky_g, r=rot: bw.env_radiance_bwd(e, a, b, rotation=r),
                  gc.env_radiance_bwd_work(sky, sky_d, rotation=rot), sky_d.shape[0],
                  (lambda b=sky_g: b.sum(0)) if sky.kind == 3 else None)
    print(f"grad: assemble_hit_bwd_kernel<ANIM, SHARED> ran SHARED "
          f"{({k: sorted(v) for k, v in shared.items()})}")
    for anim_, name in (("false", "assemble_hit_bwd"), ("true", "assemble_hit_anim_bwd")):
        assert shared[anim_] == {"true", "false"}, (
            f"{name} ran only SHARED {sorted(shared[anim_])}: one of its paths did not launch")
    # K7T's full form on eval's lanes: timed beside the record (sample's)
    eval_full = lambda: bw.rgl_bwd(rtab, rmid, rwi, rwo, rg, False, full=True, g_pdf=rgp)  # noqa: E731
    bound, bound_by = kc.bound_ms(*gc.rgl_bwd_work(rtab, rmid.shape[0], False, full=True))
    print(f"grad: rgl_bwd_full eval {kc.time_ms(eval_full, DEVICE):.4f} ms (wrapper call), "
          f"{kc.device_ms(eval_full) * 1e3:.2f} us device a launch; bound {bound:.6f} ms by "
          f"{bound_by} at {rmid.shape[0]} lanes on {_nvidia_smi()}")
    for name, (kernel, plain, work, library, n) in cases.items():
        ms, plain_ms = kc.time_ms(kernel, DEVICE), kc.time_ms(plain, DEVICE)
        dev_us = kc.device_ms(kernel) * 1e3
        library_ms = None if library is None else kc.time_ms(library, DEVICE)
        bound, bound_by = kc.bound_ms(*work)
        print(f"grad: {name} {ms:.4f} ms (wrapper call), {dev_us:.2f} us device a launch, vs "
              f"plain {plain_ms:.4f} ms{'' if library is None else f', index_add_ {library_ms:.4f} ms'}"
              f"; bound {bound:.6f} ms by {bound_by} ({work[0]:.4g} bytes, {work[1]:.4g} flops)"
              f" at {n} lanes on {_nvidia_smi()}")
        src, replaces, _, _ = KERNELS[name]
        GRAD_RECORDS.append({"name": name, "route": "cuda", "source": src, "replaces": replaces,
                             "launches": 0, "max_abs_err": errs[name], "ms": ms,
                             "plain_ms": plain_ms, "bound_ms": bound, "bound_by": bound_by,
                             "library_ms": library_ms, "device_us": dev_us})


def _launched_kernels(calls):
    """The backward kernel (`<name>_bwd_kernel<...>`, `row_scatter_kernel<...>`)
    each of `calls` launched, one each, in the order of the calls: read from
    one profiled session of them all, profiled again, up to PROFILE_TRIES
    times, while it saw another number of them."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(PROFILE_TRIES):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for call in calls:
                call()
                torch.cuda.synchronize()
        seen = sorted((e.time_range.start, m.group(0)) for e in prof.events()
                      if e.device_type == torch.autograd.DeviceType.CUDA
                      and (m := re.search(BWD_NAME, e.name)))
        if len(seen) == len(calls):
            return [name for _, name in seen]
    raise AssertionError(f"profiler: {len(seen)} backward kernels seen of {len(calls)} calls "
                         f"in each of {PROFILE_TRIES} profiles")


def _bwd_case(label, kernel, work, n, library=None, ran=None):
    """Prints a backward kernel's device us a launch (kc.device_ms) on one
    case beside its bound, the instantiation that ran and, where given, the
    device time of the library call of the same function; returns the names
    (`<name>_bwd_kernel<...>`) of the kernels a profiled call launched
    (profiled again, up to PROFILE_TRIES times, while the profiler saw none),
    or `ran` where given."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(0 if ran else PROFILE_TRIES):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            kernel()
            torch.cuda.synchronize()
        ran = sorted({m.group(0) for e in prof.key_averages()
                      if e.device_type == torch.autograd.DeviceType.CUDA
                      and (m := re.search(BWD_NAME, e.key))})
        if ran:
            break
    assert ran, f"profiler: no backward kernel seen in {PROFILE_TRIES} profiles of {label}"
    dev_us = kc.device_ms(kernel) * 1e3
    bound, bound_by = kc.bound_ms(*work)
    lib = "" if library is None else f", g.sum(0) {kc.device_ms(library) * 1e3:.2f} us device"
    print(f"grad: {label} ({', '.join(ran)}): {dev_us:.2f} us device a launch{lib}; bound "
          f"{bound * 1e3:.2f} us by {bound_by} ({dev_us / (bound * 1e3):.1f}x) at {n} lanes on "
          f"{_nvidia_smi()}")
    return ran


def _timed_step(label, loss, args):
    """One differentiable step: (loss value, the args' gradients), with its
    forward and backward wall ms, the port's kernel launches, the card's
    peak memory, and from a profiled step each pass's CUDA kernel launches,
    device ms and busy share, printed."""
    from torch.profiler import ProfilerActivity, profile

    from wurblpt_tpu_torch import native

    def leaves():
        return [a.detach().clone().requires_grad_(True) if isinstance(a, torch.Tensor)
                else torch.tensor(a, device=DEVICE, requires_grad=True) for a in args]

    warm = leaves()
    loss(*warm).backward()   # the first step's one-time costs left out of the times
    xs = leaves()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = dict(native.LAUNCHES)
    t0 = time.perf_counter()
    value = loss(*xs)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    value.backward()
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    ours = {k: v - before[k] for k, v in native.LAUNCHES.items() if v != before[k]}
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    prof_line = []
    ys = leaves()
    for part in ("forward", "backward"):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            w0 = time.perf_counter()
            if part == "forward":
                out = loss(*ys)
            else:
                out.backward()
            torch.cuda.synchronize()
            wall = (time.perf_counter() - w0) * 1e3
        dev = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
        kern = sum(e.count for e in dev if not e.key.startswith(("Memcpy", "Memset")))

        def device_ms(events):
            return sum((getattr(e, "self_device_time_total", None)
                        or getattr(e, "self_cuda_time_total", 0)) for e in events) / 1e3

        dms = device_ms(dev)
        # the backward kernels' share: launches and device ms by kernel
        mine = {k: [e for e in dev if f"{k}<" in e.key or f"{k}(" in e.key]
                for k in BWD_KERNELS}
        share = {k: (sum(e.count for e in es), round(device_ms(es), 4),
                     round(device_ms(es) * 1e3 / max(sum(e.count for e in es), 1), 2))
                 for k, es in mine.items() if es}
        of = f", of which (launches, device ms, us a launch) {share}" if share else ""
        prof_line.append(f"{part} {kern} CUDA kernel launches, {dms:.2f} device ms in "
                         f"{wall:.2f} wall ms (busy {dms / wall:.3f}){of}")
    print(f"{label}: forward {(t1 - t0) * 1e3:.2f} ms, backward (recompute included) "
          f"{(t2 - t1) * 1e3:.2f} ms, peak memory {peak:.3f} GiB, the port's kernel launches "
          f"{ours}; profiled: {'; '.join(prof_line)}; on {_nvidia_smi()}")
    return float(value.detach()), [x.grad if x.dim() else float(x.grad) for x in xs]


def phase_grad():
    """Phase grad: the backward kernels against their plain versions, then,
    with the launch counters at 0, the pass renderer and the differentiable
    render driven through render_frame and fit: the Cornell bench frame
    held to its yardstick, d(mean)/d(emission scale) = the loss at scale 1
    (rtol 1e-3), d(mean)/d(white albedo) against a central difference (eps
    5e-3, rtol 5e-2), the equirect sky's d(mean)/d(scale) = the loss (rtol
    5e-2), the sphere-lit floor's d(mean)/d(camera height) against a
    central difference (eps 1e-3, rtol 0.08), the RGL rgb table's and one
    texel's gradients and the moving floor's against their differences,
    the sky's yaw gradient and the RGL tables' and camera height's against
    the JAX CPU yardsticks, the RGL quad at 128^2 and 16 spp (its mean and
    d(mean)/d(rgb scale), K7T's tail form, within 2e-2 of jax.grad's, every
    table's digest, its full form, within 1e-2), and fit recovering the lit
    quad's albedo within 0.06 and the sky's yaw within 1 degree, each with
    its last loss below a quarter of its first. Returns the counters of that
    run."""
    from wurblpt_tpu_torch import native
    from wurblpt_tpu_torch.materials import rgl
    from wurblpt_tpu_torch.render.bsdf import SceneStatic
    from wurblpt_tpu_torch.render.camera import CameraConfig, make_camera
    from wurblpt_tpu_torch.render.integrator import RenderParams, render_frame
    from wurblpt_tpu_torch.render.sensor import SensorRGB
    from wurblpt_tpu_torch.utils import grad_check as gc
    from wurblpt_tpu_torch.utils import scenes

    _grad_records()
    native.reset_launch_counts()
    # the pass renderer on the Cornell bench frame, 16 samples in one pass
    scene = scenes.cornell_box_ref(DEVICE)
    pose, vfov = scenes.cornell_ref_camera(DEVICE)
    cam = make_camera(pose, vfov, kc.BENCH_WIDTH, kc.BENCH_WIDTH, device=DEVICE)
    t0 = time.perf_counter()
    img, stats = render_frame(scene, SceneStatic.from_scene(scene), cam, CameraConfig(),
                              SensorRGB(), kc.BENCH_WIDTH, kc.BENCH_WIDTH, kc.BENCH_SSQRT,
                              params=RenderParams(max_path_components=kc.BENCH_DEPTH),
                              samples_per_pass=kc.BENCH_SSQRT ** 2, return_stats=True,
                              device=DEVICE)
    torch.cuda.synchronize()
    stats = [int(x) for x in stats.tolist()]
    print(f"grad: render_frame Cornell bench frame {(time.perf_counter() - t0) * 1e3:.1f} ms "
          f"(first call), mean radiance {float(img.double().mean())!r} (reference "
          f"{kc.REF_MEAN}), stats {stats} (reference {list(kc.REF_STATS)})")
    kc.check_bench_frame(img, stats)
    # the differentiable Cornell frame: emission scale and white albedo
    loss = gc.cornell_loss(DEVICE)
    value, (g_s, g_a) = _timed_step("grad: differentiable Cornell step", loss, (1.0, 0.0))
    with torch.no_grad():
        eps = 5e-3
        fd = (float(loss(torch.tensor(1.0), torch.tensor(eps)))
              - float(loss(torch.tensor(1.0), torch.tensor(-eps)))) / (2 * eps)
    print(f"grad: Cornell loss {value!r}, d/d(emission scale) {g_s!r}, d/d(white albedo) "
          f"{g_a!r} against central difference {fd!r}")
    assert abs(g_s - value) <= 1e-3 * abs(value), "emission gradient is not the loss"
    assert g_a > 0 and abs(g_a - fd) <= 5e-2 * abs(fd), "albedo gradient off its difference"
    # the sky's scale on envmap_spheres (equirect)
    loss = gc.sky_loss(DEVICE)
    value, (g_s,) = _timed_step("grad: differentiable envmap step", loss, (1.0,))
    print(f"grad: envmap loss {value!r}, d/d(sky scale) {g_s!r}")
    assert abs(g_s - value) <= 5e-2 * abs(value), "sky gradient is not the loss"
    # the camera's height over the sphere-lit floor (K3T's geometry), at
    # 128^2 and at the JAX test's 12^2 (utils/grad_check.floor_loss)
    for width, eps in ((128, gc.FLOOR_EPS), (12, 1e-3)):
        loss = gc.floor_loss(DEVICE, width)
        value, (g_y,) = _timed_step(f"grad: differentiable floor step {width}^2", loss, (0.0,))
        with torch.no_grad():
            fd = (float(loss(torch.tensor(eps))) - float(loss(torch.tensor(-eps)))) / (2 * eps)
        print(f"grad: floor {width}^2 loss {value!r}, d/d(camera height) {g_y!r} against "
              f"central difference {fd!r} (eps {eps})")
        assert abs(g_y - fd) <= 0.08 * abs(fd) + 1e-4, "camera gradient off its difference"
    # the measured material's rgb table (K7T) and one texel of an image
    # albedo (the lookup's gather backward), at tests/test_gradients_breadth.py's
    # sizes, steps and tolerances
    for what, loss, x0, eps, rtol in (("RGL rgb table scale", gc.rgl_table_loss(DEVICE), 1.0,
                                       1e-2, 3e-2),
                                      ("texel", gc.texel_loss(DEVICE), 0.5, 1.0 / 16, 8e-2)):
        value, (g_x,) = _timed_step(f"grad: differentiable {what} step", loss, (x0,))
        with torch.no_grad():
            fd = (float(loss(torch.tensor(x0 + eps))) - float(loss(torch.tensor(x0 - eps)))) / (
                2 * eps)
        print(f"grad: {what}: loss {value!r}, gradient {g_x!r} against central difference "
              f"{fd!r} (eps {eps})")
        assert abs(fd) > 1e-6 and abs(g_x - fd) <= rtol * abs(fd), (
            f"{what} gradient off its difference")
    # the sky's yaw (K8T's rotation term, the sample's backward) against the
    # JAX CPU yardstick (grad_check.SKY_YAW_REF)
    loss = gc.sky_yaw_loss(DEVICE)
    value, (g_y,) = _timed_step("grad: differentiable sky yaw step", loss, (gc.SKY_YAW,))
    ref = gc.SKY_YAW_REF
    print(f"grad: sky yaw {gc.SKY_YAW}: loss {value!r} (JAX {ref['mean']!r}), d/d(yaw) {g_y!r} "
          f"(JAX {ref['grad']!r})")
    assert abs(value - ref["mean"]) <= 1e-3 * abs(ref["mean"]), "yaw frame off its yardstick"
    assert abs(g_y - ref["grad"]) <= gc.SCALAR_REL * abs(ref["grad"]), "yaw gradient off JAX's"
    # every RGL table on the tape (K7T's full form) against the JAX digests
    # (grad_check.RGL_TABLE_REFS), and the RGL quad's camera height (the lane
    # directions: K7T's full form with K3T) against JAX and its difference
    quad = gc.rgl_quad(DEVICE)
    tabs = [getattr(quad.rgl, k) for k in rgl.GRAD_TABLES]
    value, grads = _timed_step("grad: differentiable RGL tables step", gc.rgl_tables_loss(DEVICE),
                               tabs)
    rel = gc.check_rgl_table_grads(dict(zip(rgl.GRAD_TABLES, grads)))
    print(f"grad: RGL tables: loss {value!r}, each table's digest against JAX's (largest "
          f"relative difference) {rel}")
    # the RGL quad at the grad phase's size (128^2, 16 spp in one pass):
    # d(mean)/d(rgb scale) through K7T's tail form, every table through its
    # full form, against jax.grad on the CPU (grad_check.RGL_QUAD_128_REF)
    ref = gc.RGL_QUAD_128_REF
    size = (DEVICE, gc.RGL_QUAD_WIDTH, gc.RGL_QUAD_SSQRT)
    value, (g_s,) = _timed_step("grad: differentiable RGL rgb scale step 128^2",
                                gc.rgl_table_loss(*size), (1.0,))
    print(f"grad: RGL quad 128^2 rgb scale: loss {value!r} (JAX {ref['mean']!r}), gradient "
          f"{g_s!r} (JAX {ref['grad']!r})")
    assert abs(value - ref["mean"]) <= gc.SCALAR_REL * abs(ref["mean"]), "RGL 128^2 mean off JAX's"
    assert abs(g_s - ref["grad"]) <= gc.SCALAR_REL * abs(ref["grad"]), (
        "RGL 128^2 rgb scale gradient off JAX's")
    value, grads = _timed_step("grad: differentiable RGL tables step 128^2",
                               gc.rgl_tables_loss(*size), tabs)
    got = dict(zip(rgl.GRAD_TABLES, grads))
    counts = {k: int((g.abs() > 1e-6 * g.abs().max()).sum()) for k, g in got.items()}
    print(f"grad: RGL quad 128^2 tables: entries above 1e-6 of the largest {counts} (JAX "
          f"{ {k: v[0] for k, v in ref['tables'].items()} })")
    rel = gc.check_rgl_table_grads(got, ref["tables"], count_rel=gc.TABLE_REL)
    print(f"grad: RGL quad 128^2 tables: loss {value!r} (JAX {ref['mean']!r}), each table's digest "
          f"against JAX's (largest relative difference) {rel}")
    loss = gc.rgl_camera_loss(DEVICE)
    value, (g_c,) = _timed_step("grad: differentiable RGL camera step", loss, (0.0,))
    eps = 1e-3
    with torch.no_grad():
        fd = (float(loss(torch.tensor(eps))) - float(loss(torch.tensor(-eps)))) / (2 * eps)
    ref = gc.RGL_CAMERA_REF
    print(f"grad: RGL quad camera height: loss {value!r} (JAX {ref['mean']!r}), gradient {g_c!r} "
          f"(JAX {ref['grad']!r}) against central difference {fd!r} (eps {eps})")
    assert abs(g_c - ref["grad"]) <= gc.SCALAR_REL * abs(ref["grad"]), "RGL camera gradient off JAX's"
    assert abs(g_c - fd) <= 3e-2 * abs(fd), "RGL camera gradient off its difference"
    # the animated floor over the shutter [0, 1] (K3aT, per-ray rows): its
    # vertices and a keyframe translation against central differences
    loss = gc.moving_floor_loss(gc.moving_floor(DEVICE), DEVICE, 64, 2, 3)
    value, (g_v, g_k) = _timed_step("grad: differentiable animated step", loss, (0.0, 0.0))
    eps = 1e-2
    with torch.no_grad():
        fd_v = (float(loss(torch.tensor(eps), torch.tensor(0.0)))
                - float(loss(torch.tensor(-eps), torch.tensor(0.0)))) / (2 * eps)
        fd_k = (float(loss(torch.tensor(0.0), torch.tensor(eps)))
                - float(loss(torch.tensor(0.0), torch.tensor(-eps)))) / (2 * eps)
    print(f"grad: moving floor 64^2 over [0, 1]: loss {value!r}, d/d(vertex y) {g_v!r} against "
          f"central difference {fd_v!r}, d/d(keyframe y) {g_k!r} against {fd_k!r} (eps {eps})")
    assert abs(g_v - fd_v) <= 3e-2 * abs(fd_v), "vertex gradient off its difference"
    assert abs(g_k - fd_k) <= 3e-2 * abs(fd_k), "keyframe gradient off its difference"
    # fit
    t0 = time.perf_counter()
    res = gc.fit_albedo(DEVICE)
    got = res.params["albedo"].tolist()
    print(f"grad: fit {gc.FIT_STEPS} steps in {time.perf_counter() - t0:.2f} s: albedo {got} "
          f"(target [0.7, 0.2, 0.5]), loss {res.losses[0]!r} -> {res.losses[-1]!r}")
    assert max(abs(a - b) for a, b in zip(got, (0.7, 0.2, 0.5))) <= 0.06, "fit missed"
    assert res.losses[-1] < 0.25 * res.losses[0], "fit's loss did not fall"
    # fit of the sky's yaw from 8 degrees away
    t0 = time.perf_counter()
    res = gc.fit_yaw(DEVICE)
    yaw = float(res.params["yaw"])
    print(f"grad: fit of the sky's yaw, {gc.FIT_STEPS} steps in {time.perf_counter() - t0:.2f} s: "
          f"{yaw!r} from {gc.FIT_YAW_START!r} (target {gc.SKY_YAW}, "
          f"{np.rad2deg(abs(yaw - gc.SKY_YAW)):.4f} degrees off), loss {res.losses[0]!r} -> "
          f"{res.losses[-1]!r}")
    assert abs(yaw - gc.SKY_YAW) <= np.deg2rad(1.0), "yaw fit missed"
    assert res.losses[-1] < 0.25 * res.losses[0], "yaw fit's loss did not fall"
    launches = dict(native.LAUNCHES)
    print(f"{GRAD_PATH}: launches {launches}")
    for name in ("row_scatter", "assemble_hit_bwd", "assemble_hit_anim_bwd", "env_radiance_bwd",
                 "env_radiance_bwd_rot", "env_sample_bwd", "rgl_bwd", "rgl_bwd_full",
                 "assemble_hit", "assemble_hit_anim", "row_gather", "closest_hit", "any_hit",
                 "env_radiance"):
        assert launches[name] > 0, f"kernel {name} was not launched on the {GRAD_PATH}"
    return launches


def phase_scene_api(name):
    """Phase scene_api, one path per example scene: the scene built through
    the port's Scene on the card, rendered with render_frame at the app's
    size (kernel_check.EXAMPLE_FRAMES: the generic bounce, passes of 8
    samples) with the counters at 0, held to its JAX yardstick (mean within
    1e-3 relative, each counter within 0.5 %), its hand kernels
    (SCENE_API[name]) required to launch; then frame ms (median of 5 after
    the first), the CUDA kernel launches of a pass and the device time of a
    profiled frame. Returns the counters of the first frame."""
    from wurblpt_tpu_torch import native
    from wurblpt_tpu_torch.utils import scenes

    label = f"scene_api {name}"
    t0 = time.perf_counter()
    scene = getattr(scenes, name)(device=DEVICE)
    torch.cuda.synchronize()
    tt = scene.textures
    print(f"{label}: built through Scene on the card in {time.perf_counter() - t0:.2f} s: "
          f"{scene.n_tris} triangles, {scene.n_spheres} spheres, {tt.count} textures (image "
          f"stack {list(tt.img_data.shape)} {tt.img_data.dtype}), {scene.n_lights} light prims, "
          f"sky kind {scene.env_kind}, RGL tables {scene.rgl is not None}")
    width, height, ssqrt, depth, per_pass = kc.EXAMPLE_FRAMES[name]
    render = kc.example_frame(name, DEVICE, scene)
    img, stats, launches, times = _drive(label, render, SCENE_API[name])
    mean = float(img.double().mean())
    ref_mean, ref_stats = kc.EXAMPLE_REFS[name]
    print(f"{label}: {width} x {height}, {ssqrt * ssqrt} spp, depth {depth}: mean radiance "
          f"{mean!r} (JAX yardstick {ref_mean!r}), stats {stats} (JAX {list(ref_stats)})")
    kc.check_example_frame(name, img, stats)
    digest, want = kc.frame_digest(img, stats), kc.EXAMPLE_DIGESTS.get(name)
    print(f"{label}: frame digest {digest} (image and stats; held to {want})")
    assert want is None or digest == want, f"{label}: the frame's bits moved"
    n_pass = ssqrt * ssqrt // per_pass
    dt = statistics.median(times)
    t0 = time.perf_counter()
    render(one_pass=True)
    pass_s = time.perf_counter() - t0
    kernels, copies, _, device_ms, ours, _ = _count_launches(lambda: render(one_pass=True))
    print(f"{label}: frame {dt * 1e3:.2f} ms (median of 5; all "
          f"{[round(t * 1e3, 2) for t in times]}; {n_pass} passes), "
          f"{width * height * ssqrt * ssqrt / dt:.4g} paths/s, {stats[1] / dt / 1e6:.4g} "
          f"Mrays/s; a profiled pass: {kernels} CUDA kernel launches and {copies} "
          f"copies/memsets, device time {device_ms:.3f} ms in {pass_s * 1e3:.2f} ms (busy "
          f"{device_ms / (pass_s * 1e3):.3f}) on {_nvidia_smi()}")
    print(f"{label}: hand-written kernels launched {{"
          + ", ".join(f"{k}: {v}" for k, v in sorted(launches.items()) if v) + "}, device us "
          "per launch (launches): "
          + ", ".join(f"{k} {us:.2f} ({count})" for k, (us, count) in sorted(ours.items())))
    return launches


def phase_scenes():
    from wurblpt_tpu_torch.utils import cast_steps, scenes

    out = {}
    for label, build in (("mesh", lambda: scenes.terrain_city(seed=3, device=DEVICE)),
                         ("city", lambda: scenes.city_night(seed=7, device=DEVICE)),
                         ("envmap", lambda: scenes.envmap_spheres(cube=True, device=DEVICE)),
                         ("rtiow", lambda: scenes.rtiow(device=DEVICE)),
                         ("tof", lambda: scenes.tof_box(device=DEVICE)),
                         ("cornell_animated", lambda: scenes.cornell_box_animated(DEVICE)),
                         ("cornell_animated spheres",
                          lambda: scenes.cornell_box_animated(DEVICE, spheres=True)),
                         ("sphere_field 3000", lambda: scenes.sphere_field(3000, device=DEVICE)),
                         ("sphere_field 4096", lambda: scenes.sphere_field(4096, device=DEVICE)),
                         ("tri_sphere_field", lambda: scenes.tri_sphere_field(device=DEVICE)),
                         ("tri_field 2048",
                          lambda: scenes.tri_sphere_field(2048, 0, device=DEVICE)),
                         ("tri_field 3600",
                          lambda: scenes.tri_sphere_field(3600, 40, device=DEVICE)),
                         ("rtiow_bvh", lambda: scenes.rtiow(n=kc.RTIOW_BVH_N, device=DEVICE,
                                                            use_bvh=True)),
                         ("cornell_animated_bvh", lambda: scenes.cornell_box_animated(
                             DEVICE, spheres=True, use_bvh=True)),
                         *((name, lambda n=name: kc.motion_scene(n, DEVICE))
                           for name in kc.MOTION_FRAMES)):
        t0 = time.perf_counter()
        scene = build()
        torch.cuda.synchronize()
        bvh = (f"BVH: {cast_steps.tree_summary(scene.bvh)}" if scene.has_bvh else "brute force")
        print(f"scenes: {label} scene built for the GPU in {time.perf_counter() - t0:.2f} s: "
              f"{scene.n_tris} triangles, {scene.n_spheres} spheres, {scene.n_lights} light "
              f"triangles, {bvh}, sky kind {scene.env_kind}, {scene.n_anims} animation rows")
        out[label] = scene
    return out


def _nvidia_smi():
    try:
        proc = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True, text=True,
                              timeout=60)
    except OSError as e:
        return f"nvidia-smi failed: {e}"
    return proc.stdout.strip().splitlines()[0] if proc.returncode == 0 else "nvidia-smi failed"


def main() -> int:
    global kc, np, torch

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing to check", file=sys.stderr)
        return 2
    try:
        import numpy as np

        from wurblpt_tpu_torch.utils import kernel_check as kc
    except ImportError as e:
        print(f"chip_smoke: the port is not importable here ({e})", file=sys.stderr)
        return 2
    print(f"device: {torch.cuda.get_device_name(0)} x {torch.cuda.device_count()}, "
          f"torch {torch.__version__}, CUDA {torch.version.cuda}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    out = {}
    for name, phase in (("build", phase_build), ("scenes", phase_scenes),
                        ("kernels", lambda: phase_kernels(out["scenes"])),
                        ("main path", phase_main_path),
                        ("mesh path", lambda: phase_mesh_path(out["scenes"]["mesh"])),
                        ("city path", lambda: phase_city_path(out["scenes"]["city"])),
                        ("envmap path", lambda: phase_envmap_path(out["scenes"]["envmap"])),
                        ("rtiow path", lambda: phase_rtiow_path(out["scenes"]["rtiow"])),
                        ("tof path", lambda: phase_tof_path(out["scenes"]["tof"])),
                        ("cornell_animated path",
                         lambda: phase_anim_path(out["scenes"]["cornell_animated"])),
                        ("rtiow_bvh path", lambda: phase_rtiow_bvh_path(out["scenes"]["rtiow_bvh"])),
                        ("cornell_animated_bvh path",
                         lambda: phase_anim_bvh_path(out["scenes"]["cornell_animated_bvh"])),
                        ("rtiow_dof path", lambda: phase_rtiow_dof_path(out["scenes"]["rtiow"])),
                        *((f"{n} path", lambda n=n: phase_motion_path(n, out["scenes"][n]))
                          for n in MOTION),
                        *((f"scene_api {n}", lambda n=n: phase_scene_api(n)) for n in SCENE_API),
                        (GRAD_PATH, phase_grad)):
        try:
            out[name] = phase()
        except Exception as e:  # report which phase failed, then fail the run
            traceback.print_exc()
            print(f"FAILED phase {name}: {type(e).__name__}: {e}", file=sys.stderr)
            return 1
    records = out["kernels"] + GRAD_RECORDS
    for r in records:
        _, _, counters, paths = KERNELS[r["name"]]
        r["launches"] = sum(out[path][c] for path in paths for c in counters)
        if r["name"] in INLINE:
            r["inline_in"] = [{"kernel": c, "path": path, "launches": out[path][c]}
                              for c, path in INLINE[r["name"]]]
    print(_nvidia_smi())
    print(json.dumps({"kernels": records}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
