"""The sharded renderer on ``torch.distributed`` (port of
``pbrt_tpu/parallel/shard.py``; the reference's only parallelism is a
pthreads pool over image tiles with atomic film adds,
samplerrenderer.cpp:203-205, spectralImage.cpp:136-142).

Data parallelism over the film's pixels: every process holds the whole
scene and a whole film, renders its contiguous share of the pixel list,
and after each sample wave the films are merged as the JAX package merges
its devices' partials (shard.py:78-81): per field, ``film + all_reduce(out
− film)``, the reduction's sum in place of ``psum``. The pixel list is
padded to a multiple of the world size with duplicates of its first
pixels, weighted 0 (``sample_scale``), so padding adds exactly nothing.
A process group of ``nccl`` (on a card) or ``gloo`` (on the CPU) comes
from ``init_distributed``; without one, ``render_sharded`` is a world of
1, whose merge is still ``film + (out − film)``.
"""

from __future__ import annotations

import numpy as np
import torch

from pbrt_torch import resolve_device
from pbrt_torch.core import rng
from pbrt_torch.film import film as film_mod
from pbrt_torch.renderers.sampler import (camera_noise, integrator_draws, media_uniforms,
                                          render_wave, wave_uniforms)

#: the film's fields that the merge sums (the JAX film's splat is always 0
#: under the sampler renderer, and the port's film has none)
FILM_FIELDS = ("pixels", "weight", "depth")


def init_distributed(coordinator: str | None = None, num_processes: int | None = None,
                     process_id: int | None = None, device=None):
    """Joins the process group: ``coordinator`` "host:port" (TCP; without
    one, torch's ``env://`` variables), ``num_processes`` the world size,
    ``process_id`` this process's rank. ``nccl`` on the card (``device``
    None: the rank's card, rank mod the cards), ``gloo`` on the CPU
    (``device="cpu"``). → (rank, world)."""
    import torch.distributed as dist

    dev = resolve_device(device)
    if dev.type == "cuda" and process_id is not None:
        torch.cuda.set_device(process_id % torch.cuda.device_count())
    dist.init_process_group(
        "gloo" if dev.type == "cpu" else "nccl",
        init_method=f"tcp://{coordinator}" if coordinator else "env://",
        world_size=-1 if num_processes is None else num_processes,
        rank=-1 if process_id is None else process_id)
    return dist.get_rank(), dist.get_world_size()


def shard_pixels(cfg: film_mod.FilmConfig, world: int, rank: int):
    """This rank's contiguous share of the film's pixel list (row-major,
    padded to a multiple of ``world`` with its first pixels) → (x, y,
    weight) int64, int64, float32 numpy arrays, weight 0 on padding."""
    x0, x1, y0, y1 = cfg.pixel_bounds
    gx, gy = np.meshgrid(np.arange(x0, x1), np.arange(y0, y1))
    all_x, all_y = gx.ravel(), gy.ravel()
    pad = (-len(all_x)) % world
    scale = np.ones(len(all_x) + pad, np.float32)
    if pad:
        all_x = np.concatenate([all_x, all_x[:pad]])
        all_y = np.concatenate([all_y, all_y[:pad]])
        scale[-pad:] = 0.0
    per = len(all_x) // world
    mine = slice(rank * per, (rank + 1) * per)
    return all_x[mine], all_y[mine], scale[mine]


def render_sharded(built, spp=None, seed: int = 0, chunk_pixels: int | None = None):
    """The whole film, each process rendering its share of every wave in
    chunks of ``chunk_pixels`` lanes (default 32,768) and the films merged
    after each wave; the analogue of ``renderers/sampler.render`` without
    its checkpoints or adaptive passes. Keys are the (pixel, sample)'s, so
    a seed gives ``render``'s samples; the ray differentials take 1/√spp,
    and the pixel cone is not narrowed (shard.py:98-136)."""
    import torch.distributed as dist

    grouped = dist.is_available() and dist.is_initialized()
    rank, world = (dist.get_rank(), dist.get_world_size()) if grouped else (0, 1)
    cfg, icfg, cam, scene = built.film_config, built.integrator, built.camera, built.scene
    spp = spp if spp is not None else built.pixel_samples
    dev = built.device
    x, y, scale = (torch.as_tensor(a, device=dev) for a in shard_pixels(cfg, world, rank))
    pix = y * cfg.xres + x
    root = rng.root_key(seed)
    scrambles = rng.pixel_scrambles(root, pix)
    chunk = min(chunk_pixels or (1 << 15), len(x))
    spans = [slice(a, a + chunk) for a in range(0, len(x), chunk)]
    diff_scale = 1.0 / float(np.sqrt(max(spp, 1)))
    state = film_mod.init_film(cfg, dev)
    for s in range(spp):
        before = [getattr(state, f).clone() for f in FILM_FIELDS]
        for c in spans:
            u = wave_uniforms(icfg, root, pix[c], scrambles[c], s, built.sampler_name, spp)
            render_wave(state, scene, cam, built.filter_table, x[c], y[c], icfg, cfg, u,
                        sample_scale=scale[c], diff_scale=diff_scale,
                        noise=camera_noise(cam, root, pix[c], s),
                        media=media_uniforms(scene, icfg, root, pix[c], s),
                        draws=integrator_draws(scene, icfg, root, pix[c], s))
        for f, old in zip(FILM_FIELDS, before):
            delta = getattr(state, f) - old
            if grouped:
                dist.all_reduce(delta)
            setattr(state, f, old + delta)
    return state
