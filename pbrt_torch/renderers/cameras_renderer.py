"""The fork's multi-view renderer, ``Renderer "cameras"`` (port of
``pbrt_tpu/renderers/cameras_renderer.py``; reference:
src/renderers/camerasrenderer.cpp): the scene is rendered once per 4×4
camera-to-world matrix of the ``cameraTransforms`` float file, each
output named with the suffix ``_cam{i}``.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from pbrt_torch.renderers.sampler import render
from pbrt_torch.scene.paramset import read_float_file


def read_camera_file(path: str) -> list[np.ndarray]:
    """A float file of 4×4 matrices, row-major, one after another
    (camerasrenderer.cpp:196-240)."""
    vals = read_float_file(path)
    if len(vals) % 16 != 0:
        raise ValueError(f"{path}: expected a multiple of 16 floats")
    return [vals[i:i + 16].reshape(4, 4) for i in range(0, len(vals), 16)]


def render_cameras(built, spp=None, seed: int = 0, chunk_pixels: int | None = None,
                   quick: bool = False):
    """One render per camera transform, each a static camera-to-world
    matrix in place of the scene's (camerasrenderer.cpp:242-300) →
    [(film, suffix), ...]."""
    params = built.renderer_params
    cam_file = params.find_one_filename("cameraTransforms", "") if params else ""
    if not cam_file:
        raise ValueError("cameras renderer needs a cameraTransforms file")
    results = []
    for i, m in enumerate(read_camera_file(cam_file)):
        c2w = torch.as_tensor(np.asarray(m, np.float32), device=built.device)
        camera = dataclasses.replace(built.camera, cam_to_world=c2w, motion=None)
        view = dataclasses.replace(built, camera=camera)
        results.append((render(view, spp=spp, seed=seed, chunk_pixels=chunk_pixels,
                               quick=quick),
                        f"_cam{i}"))
    return results
