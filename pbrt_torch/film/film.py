"""Spectral film: filter-weighted accumulation and the ISET ``.dat`` file.

Port of ``pbrt_tpu/film/film.py`` (reference: SpectralImageFilm,
src/film/spectralImage.cpp:77-152 AddSample, :295-369 WriteImage with no
weight normalization). The scatter is ``index_add_`` on the flattened
film, in place: the film is the largest tensor of a render (512²×32 float32
is 32 MiB), and a fresh copy per chunk would double it. The reference's
AtomicAdd becomes the library scatter, whose order of additions on a card
is not fixed (so sums may differ in the last bit between runs there).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from pbrt_torch.core.filters import FILTER_TABLE_SIZE, Filter


@dataclasses.dataclass
class FilmState:
    pixels: torch.Tensor  # (H, W, S) Σ filter-weighted radiance
    weight: torch.Tensor  # (H, W) Σ filter weights
    depth: torch.Tensor  # (H, W) Σ filter-weighted first-hit distances
    #: an adaptive render's counts: pixels supersampled, pixels, waves
    adaptive: dict | None = None


@dataclasses.dataclass(frozen=True)
class FilmConfig:
    xres: int = 256
    yres: int = 256
    n_bins: int = 32
    filter: Filter = Filter()
    crop: tuple = (0.0, 1.0, 0.0, 1.0)
    filename: str = "out.dat"
    #: the scene's film name ("image", "spectralImage",
    #: "spectralImageNoCamera": the last also writes a depth EXR)
    kind: str = "image"
    #: the .dat header's lens metadata, from the camera
    focal_length: float = 0.0
    f_stop: float = 0.0
    fov: float = 0.0

    @property
    def pixel_bounds(self):
        """(x0, x1, y0, y1) integer sample window from the crop window."""
        x0 = int(np.ceil(self.xres * self.crop[0]))
        x1 = max(x0 + 1, int(np.ceil(self.xres * self.crop[1])))
        y0 = int(np.ceil(self.yres * self.crop[2]))
        y1 = max(y0 + 1, int(np.ceil(self.yres * self.crop[3])))
        return x0, x1, y0, y1


def init_film(cfg: FilmConfig, device) -> FilmState:
    H, W, S = cfg.yres, cfg.xres, cfg.n_bins
    z = lambda *s: torch.zeros(s, dtype=torch.float32, device=device)
    return FilmState(pixels=z(H, W, S), weight=z(H, W), depth=z(H, W))


def add_samples(state: FilmState, cfg: FilmConfig, px, py, L, depth, table,
                sample_scale=None, pixel_ids=None) -> FilmState:
    """Scatter samples at continuous (px, py) into the pixels within the
    filter radius, weighted from the filter table (in place).

    ``pixel_ids`` (the samples' owning integer pixels) selects the one-tap
    path for filters no wider than half a pixel, where every sample lands
    in its own pixel (film.py:85-176, the sorted path); otherwise every tap
    of the (2⌈w⌉)² neighbourhood is scattered."""
    H, W = state.weight.shape
    S = state.pixels.shape[-1]
    fx, fy = cfg.filter.xwidth, cfg.filter.ywidth
    dx = px - 0.5
    dy = py - 0.5
    nx = max(1, int(np.ceil(2.0 * fx)))
    ny = max(1, int(np.ceil(2.0 * fy)))
    ts = FILTER_TABLE_SIZE
    pix = state.pixels.view(H * W, S)
    wgt = state.weight.view(H * W)
    dep = state.depth.view(H * W)

    def tap(xi, yi, inside):
        fxo = (xi.to(px.dtype) - dx).abs()
        fyo = (yi.to(py.dtype) - dy).abs()
        in_f = inside & (fxo < fx) & (fyo < fy)
        tx = (fxo / fx * ts).to(torch.int64).clamp(0, ts - 1)
        ty = (fyo / fy * ts).to(torch.int64).clamp(0, ts - 1)
        w = torch.where(in_f, table[ty, tx], 0.0)
        if sample_scale is not None:
            w = w * sample_scale
        flat = yi.clamp(0, H - 1) * W + xi.clamp(0, W - 1)
        pix.index_add_(0, flat, w[:, None] * L)
        wgt.index_add_(0, flat, w)
        dep.index_add_(0, flat, w * depth)

    if nx == 1 and ny == 1 and pixel_ids is not None:
        xi, yi = (a.to(torch.int64) for a in pixel_ids)
        tap(xi, yi, torch.ones_like(dx, dtype=torch.bool))
        return state
    x0 = torch.ceil(dx - fx).to(torch.int64)
    y0 = torch.ceil(dy - fy).to(torch.int64)
    for oy in range(ny):
        for ox in range(nx):
            xi, yi = x0 + ox, y0 + oy
            tap(xi, yi, (xi >= 0) & (xi < W) & (yi >= 0) & (yi < H))
    return state


def write_dat(state: FilmState, cfg: FilmConfig, path: str | None = None):
    """ISET ``.dat``: header lines "xres yres nbins" and "focalLength fStop
    FOV", then float64 planes; within each plane pixel (y, x) sits at
    x*yres + y (spectralImage.cpp:332, :363)."""
    path = path or cfg.filename
    data = state.pixels.detach().to("cpu", torch.float64).numpy()
    H, W, S = data.shape
    with open(path, "wb") as f:
        f.write(f"{W} {H} {S}\n".encode())
        f.write(f"{cfg.focal_length} {cfg.f_stop} {cfg.fov}\n".encode())
        f.write(np.transpose(data, (2, 1, 0)).astype("<f8").tobytes())
    return path


def to_rgb_image(state: FilmState) -> np.ndarray:
    """The weight-normalized linear RGB preview, (H, W, 3) float32 ≥ 0
    (film/image.cpp:169-206; film.py:258-270)."""
    from pbrt_torch.core import spectrum as spec

    norm = state.pixels / torch.clamp(state.weight, min=1e-12)[..., None]
    return np.maximum(spec.to_rgb(norm).detach().cpu().numpy(), 0.0)


def write_depth_exr(state: FilmState, path: str):
    """The ``spectralImageNoCamera`` film's depth sidecar: filter-weighted
    first-hit distance over the weight, at least 0, in all three channels
    of an EXR (spectralImageNoCamera.cpp:284-302, :388-390; film.py:
    228-241)."""
    from pbrt_torch.film.imageio import write_exr

    w = state.weight.detach().to("cpu", torch.float64).numpy()
    d = state.depth.detach().to("cpu", torch.float64).numpy() / np.maximum(w, 1e-12)
    d = np.maximum(d, 0.0).astype(np.float32)
    return write_exr(path, np.repeat(d[..., None], 3, axis=-1))


def write_pfm(path: str, rgb: np.ndarray):
    """(H, W, 3) float image as little-endian PFM, bottom row first
    (core/imageio.cpp WritePFM)."""
    H, W, _ = rgb.shape
    with open(path, "wb") as f:
        f.write(f"PF\n{W} {H}\n-1.000000\n".encode())
        f.write(np.ascontiguousarray(rgb[::-1]).astype("<f4").tobytes())
    return path


def read_pfm(path: str) -> np.ndarray:
    """PFM → (H, W, 3) float32, top row first; the scale's sign gives the
    byte order (negative: little-endian)."""
    with open(path, "rb") as f:
        if f.readline().strip() != b"PF":
            raise ValueError(f"{path}: not a colour PFM file")
        W, H = map(int, f.readline().split())
        scale = float(f.readline())
        data = np.frombuffer(f.read(W * H * 3 * 4), dtype="<f4" if scale < 0 else ">f4")
    return data.reshape(H, W, 3)[::-1].astype(np.float32)


def read_dat(path: str):
    """Read a ``.dat`` back → ((H, W, S) float64 array, header dict)."""
    with open(path, "rb") as f:
        l1 = f.readline().split()
        W, H, S = int(l1[0]), int(l1[1]), int(l1[2])
        l2 = f.readline().split()
        header = {"focal_length": float(l2[0]), "f_stop": float(l2[1]),
                  "fov": float(l2[2])}
        planes = np.frombuffer(f.read(W * H * S * 8), dtype="<f8")
    return planes.reshape(S, W, H).transpose(2, 1, 0), header
