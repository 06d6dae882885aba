"""pbrt_torch.parallel — see the package docstring."""
