"""Inverse rendering: fit scene or camera parameters to a target image (port of
``wurblpt_tpu/inverse.py``, the JAX package's differentiable-rendering entry
point).

`params` is a dict of tensors; the caller says how they patch into the scene
(`apply_params(scene, params) -> scene`) and, optionally, into the camera
(`apply_cam(cam, params) -> cam`). A step renders the image with the pass
renderer in differentiable mode (`render_frame`'s `accumulate_passes` with
`RenderParams(differentiable=True)`), takes the loss against the target,
back-propagates through the render (P0's, K3's and K8's backward kernels on
the card) and lets a `torch.optim` optimizer (Adam by default, in place of
optax) update the params. Each step draws its own window of the 8 x 8
stratified sample grid (`sample_offset`), as the JAX package's fit does.

    params0 = {"albedo": torch.full((3,), 0.4, device="cuda")}
    def apply_params(scene, p):
        m = scene.materials
        albedo = torch.cat([m.albedo[:1, :3] * 0 + p["albedo"], m.albedo[:1, 3:]], -1)
        return scene._replace(materials=m._replace(
            albedo=torch.cat([albedo, m.albedo[1:]], 0)))
    result = fit(scene, params0, apply_params, target, cam=cam, width=w, height=h)
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional

import torch

from .render.bsdf import SceneStatic
from .render.camera import CameraConfig, CameraParams
from .render.integrator import RenderParams, accumulate_passes
from .render.sensor import SensorRGB

STRATA_SQRT = 8   # the stratification grid every step's sample window is drawn from


@dataclass
class FitResult:
    params: Dict[str, torch.Tensor]
    losses: list
    final_image: Any


def _mse(img, target):
    return torch.mean((img - target) ** 2)


def render_loss(scene, static: SceneStatic, cam: CameraParams, target, *, width: int,
                height: int, samples_sqrt: int = 2, cam_cfg: CameraConfig = CameraConfig(),
                sensor=SensorRGB(), render_params: RenderParams = RenderParams(),
                loss_fn: Optional[Callable] = None, sample_offset=0, device="cuda"):
    """(loss, image) of one differentiable render against `target` [H, W,
    n_acc]: samples_sqrt^2 samples per pixel, drawn from the 8 x 8
    stratification grid from sample `sample_offset` on (the JAX package's
    make_train_step objective, which traces them one pass each; here they
    are one pass of spp samples: the same paths, summed in another order);
    `loss_fn(img, target)` defaults to the mean squared error."""
    spp = samples_sqrt * samples_sqrt
    params = dataclasses.replace(render_params, differentiable=True)
    acc = accumulate_passes(
        scene, static, cam, cam_cfg, sensor, width, height, STRATA_SQRT, 0.0, 0.0, params, spp,
        torch.zeros((width * height, sensor.n_acc), dtype=torch.float32,
                    device=torch.device(device)),
        0, 1, sample_offset=sample_offset, device=device)
    img = sensor.finish(acc, 1.0 / spp).reshape(height, width, sensor.n_acc)
    return (loss_fn or _mse)(img, target), img


def make_train_step(scene, apply_params: Callable[[Any, Dict], Any], target, params, *,
                    cam: CameraParams, width: int, height: int, cam_cfg: CameraConfig = CameraConfig(),
                    sensor=SensorRGB(), samples_sqrt: int = 2,
                    render_params: RenderParams = RenderParams(max_path_components=4),
                    optimizer=None, loss_fn: Optional[Callable] = None,
                    apply_cam: Optional[Callable[[CameraParams, Dict], CameraParams]] = None,
                    mesh=None, static: Optional[SceneStatic] = None, device="cuda"):
    """The training step: ``step(sample_start) -> (loss, image)`` renders with
    the current `params` (a dict of leaf tensors that require grad), takes
    the loss, back-propagates and updates `params` in place with the
    optimizer. `optimizer` is a `torch.optim.Optimizer` over the params'
    tensors, or a callable that makes one from their list (default: Adam at
    a learning rate of 2e-2). Returns (step, optimizer). A `mesh` (the JAX
    package's sharded step) is refused: multi-card training is ROADMAP
    A.11."""
    if mesh is not None:
        raise NotImplementedError("make_train_step: a sharded step over a mesh of cards "
                                  "(ROADMAP A.11) is not ported yet")
    if static is None:
        static = SceneStatic.from_scene(scene)
    leaves = list(params.values())
    if optimizer is None:
        optimizer = torch.optim.Adam(leaves, lr=2e-2)
    elif not isinstance(optimizer, torch.optim.Optimizer):
        optimizer = optimizer(leaves)

    def step(sample_start):
        optimizer.zero_grad(set_to_none=True)
        c = apply_cam(cam, params) if apply_cam is not None else cam
        loss, img = render_loss(apply_params(scene, params), static, c, target, width=width,
                                height=height, samples_sqrt=samples_sqrt, cam_cfg=cam_cfg,
                                sensor=sensor, render_params=render_params, loss_fn=loss_fn,
                                sample_offset=sample_start, device=device)
        loss.backward()
        optimizer.step()
        return loss.detach(), img.detach()

    return step, optimizer


def fit(scene, params0: Dict[str, torch.Tensor], apply_params: Callable[[Any, Dict], Any],
        target, *, cam: CameraParams, width: int, height: int,
        cam_cfg: CameraConfig = CameraConfig(), sensor=SensorRGB(), samples_sqrt: int = 2,
        render_params: RenderParams = RenderParams(max_path_components=4), optimizer=None,
        steps: int = 50, loss_fn: Optional[Callable] = None,
        apply_cam: Optional[Callable[[CameraParams, Dict], CameraParams]] = None,
        post_step: Optional[Callable[[Dict], Dict]] = None, sample_offset_per_step: bool = True,
        verbose: bool = False, mesh=None, device="cuda") -> FitResult:
    """Optimise `params0` so that the rendered image matches `target`
    (inverse.py:145-197). `apply_params(scene, params) -> scene` and
    `apply_cam(cam, params) -> cam` patch the params in; `post_step(params)
    -> params` runs after each update (e.g. clipping to valid ranges);
    `sample_offset_per_step` draws each step's samples from the next of
    the 64 // spp windows of the 8 x 8 grid (counter-based random numbers:
    each window an independent, reproducible sample set). Returns
    FitResult(params, losses, final_image)."""
    spp = samples_sqrt * samples_sqrt
    n_windows = max(64 // spp, 1)
    params = {k: v.detach().clone().requires_grad_(True) for k, v in params0.items()}
    step_fn, _ = make_train_step(scene, apply_params, target, params, cam=cam, width=width,
                                 height=height, cam_cfg=cam_cfg, sensor=sensor,
                                 samples_sqrt=samples_sqrt, render_params=render_params,
                                 optimizer=optimizer, loss_fn=loss_fn, apply_cam=apply_cam,
                                 mesh=mesh, device=device)
    losses, img = [], None
    for step in range(steps):
        win = (step % n_windows) if sample_offset_per_step else 0
        loss, img = step_fn(win * spp)
        if post_step is not None:
            with torch.no_grad():
                for k, v in post_step(params).items():
                    params[k].copy_(v)
        losses.append(float(loss))
        if verbose and (step % 10 == 0 or step == steps - 1):
            print(f"step {step:4d}  loss {float(loss):.6f}")
    return FitResult(params={k: v.detach() for k, v in params.items()}, losses=losses,
                     final_image=img)
