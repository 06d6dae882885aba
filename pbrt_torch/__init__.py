"""pbrt_torch — the spectral path tracer in PyTorch, for an NVIDIA H100.

A port of the JAX package ``pbrt_tpu`` that lives beside it and imports
nothing from it. Host-side scene handling (lexer, parser, builder, SAH BVH)
is numpy; the wavefront (camera rays, surface integrators, film) is
PyTorch on one device; the wide-BVH traversal and the keyed random numbers
are hand-written CUDA kernels (``csrc/traverse.cu``, ``csrc/rng.cu``) with
plain PyTorch versions beside them (``accel/traverse_cuda.py``,
``core/rng.py``).

Entry points take a ``device`` argument. ``None`` means CUDA and raises
when no card is present; only an explicit ``device="cpu"`` runs on the
CPU, through the kernels' plain versions.
"""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` → the current CUDA device (raises without a card); anything
    else is taken as given."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "pbrt_torch: no CUDA device is available; pass device='cpu' "
                "to run the plain PyTorch path on the CPU"
            )
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(device)
