"""Textures (port of ``pbrt_tpu/textures``)."""
