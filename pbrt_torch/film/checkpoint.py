"""Render checkpoint and resume (port of ``pbrt_tpu/film/checkpoint.py``;
the reference keeps its film in memory only).

A checkpoint is the film's sums, the next sample wave and the seed, in an
``.npz`` with the JAX package's keys and dtypes (``version``, ``pixels``,
``weight``, ``splat``, ``depth`` float32, ``next_sample``, ``seed``), so a
file written by either package resumes in the other. The port's sampler
film has no splat (only the Metropolis renderer splats, into its own
tensor): it writes zeros there and refuses a file whose splat is not
zero. Keys are structural (pixel, sample), so a resumed render equals an
uninterrupted one with the same checkpoint interval
(``renderers/sampler.py:render``).
"""

from __future__ import annotations

import os

import numpy as np
import torch

from pbrt_torch.film.film import FilmState

FORMAT_VERSION = 1


def save_checkpoint(path: str, state: FilmState, next_sample: int, seed: int,
                    meta: dict | None = None) -> str:
    """Writes ``path`` through a temporary file and a rename, so a crash
    leaves the last whole checkpoint."""
    tmp = path + ".tmp.npz"
    host = lambda t: t.detach().to("cpu", torch.float32).numpy()
    pixels = host(state.pixels)
    np.savez_compressed(tmp, version=FORMAT_VERSION, pixels=pixels, weight=host(state.weight),
                        splat=np.zeros_like(pixels), depth=host(state.depth),
                        next_sample=next_sample, seed=seed, **(meta or {}))
    os.replace(tmp, path)
    return path


def load_checkpoint(path: str, device="cpu"):
    """(FilmState on ``device``, next_sample, seed), or None where the file
    is absent or of another format version."""
    if not os.path.exists(path):
        return None
    with np.load(path) as z:
        if int(z["version"]) != FORMAT_VERSION:
            return None
        if np.any(z["splat"]):
            raise ValueError(f"{path}: the checkpoint holds splats; the port's sampler film "
                             "has none")
        dev = lambda k: torch.as_tensor(np.asarray(z[k], np.float32), device=device)
        state = FilmState(pixels=dev("pixels"), weight=dev("weight"), depth=dev("depth"))
        return state, int(z["next_sample"]), int(z["seed"])
