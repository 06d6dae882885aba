"""pbrt_torch.media — see the package docstring."""
