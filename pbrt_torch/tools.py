"""Offline tools (port of ``pbrt_tpu/tools.py``; reference: src/tools/).

Usage: ``python -m pbrt_torch.tools <tool> [args...]`` with tools:
  exrdiff   — compare two images with tolerance (tools/exrdiff.cpp:24-104)
  exravg    — print image mean (tools/exravg.cpp)
  exrtotiff — tone-map + gamma an EXR to PNG/TIFF (tools/exrtotiff.cpp)
  tifftoexr — convert LDR images to EXR (tools/tifftoexr.cpp)
  samplepat — best-candidate (Poisson) sample table generator
              (tools/samplepat.cpp)
  bsdftest  — MC hemisphere integration sanity tests of BxDF stacks
              (tools/bsdftest.cpp:52-270); on the card, or with --cpu
  ply2pbrt  — PLY mesh → pbrt trianglemesh (tools/ply2pbrt.c)
  datdiff   — compare two spectral .dat films (fork-native addition)

Arguments, outputs and exit codes are the JAX package's; images go through
``film/imageio.py`` and films through ``film/film.py:read_dat``. PNG is
written in numpy; Pillow is imported only where ``exrtotiff`` writes
another format (TIFF) or a reader needs it (JPEG).
"""

from __future__ import annotations

import os
import sys

import numpy as np


def exrdiff(argv):
    """exrdiff [-o diff.exr] [-t tolerance%] img1 img2"""
    from pbrt_torch.film.imageio import read_image, write_image

    out = None
    tol = 0.0
    args = []
    it = iter(argv)
    for a in it:
        if a == "-o":
            out = next(it)
        elif a == "-t":
            tol = float(next(it))
        else:
            args.append(a)
    a_img = read_image(args[0]).astype(np.float64)
    b_img = read_image(args[1]).astype(np.float64)
    if a_img.shape != b_img.shape:
        print(f"images differ in shape: {a_img.shape} vs {b_img.shape}")
        return 1
    d = a_img - b_img
    rel = np.abs(d) / (np.abs(b_img) + 1e-9) * 100.0
    n_big = int((rel > max(tol, 1e-9)).sum()) if tol > 0 else int((d != 0).sum())
    n_small = int(((d != 0) & (rel <= tol)).sum()) if tol > 0 else 0
    avg1 = a_img.mean()
    avg2 = b_img.mean()
    mse = float((d * d).mean())
    # "%%" printed as two characters by the f-string, as the JAX tool does
    print(f"images differ: {n_big} big ({100.0*n_big/d.size:.2f}%%), "
          f"{n_small} small ({100.0*n_small/d.size:.2f}%%)")
    print(f"avg 1 = {avg1:g}, avg2 = {avg2:g} (%.2f%% delta)"
          % (100.0 * abs(avg1 - avg2) / max(abs(avg2), 1e-9)))
    print(f"MSE = {mse:g}; RMS = {np.sqrt(mse):g}")
    if out:
        write_image(out, np.abs(d).astype(np.float32))
        print(f"wrote difference image {out}")
    return 0 if n_big == 0 else 1


def exravg(argv):
    from pbrt_torch.film.imageio import read_image

    for f in argv:
        print(f"{f}: avg = {read_image(f).mean():g}")
    return 0


def exrtotiff(argv):
    """exrtotiff [-scale s] [-gamma g] [-tonemap] in.exr out.{png,tiff}"""
    from pbrt_torch.film.imageio import _pillow, read_image, write_png_u8

    scale = 1.0
    gamma = 2.2
    tonemap = False
    args = []
    it = iter(argv)
    for a in it:
        if a == "-scale":
            scale = float(next(it))
        elif a == "-gamma":
            gamma = float(next(it))
        elif a == "-tonemap":
            tonemap = True
        else:
            args.append(a)
    img = read_image(args[0]) * scale
    if tonemap:
        # Reinhard's global operator, as the JAX tool (exrtotiff.cpp's is
        # contrast-based)
        img = img / (1.0 + img)
    u8 = (np.clip(img, 0.0, 1.0) ** (1.0 / gamma) * 255).astype(np.uint8)
    if os.path.splitext(args[1])[1].lower() == ".png":
        write_png_u8(args[1], u8)
    else:
        _pillow().fromarray(u8).save(args[1])
    print(f"wrote {args[1]}")
    return 0


def tifftoexr(argv):
    from pbrt_torch.film.imageio import read_image, write_exr

    write_exr(argv[1], read_image(argv[0]).astype(np.float32))
    print(f"wrote {argv[1]}")
    return 0


def samplepat(argv):
    """Best-candidate (Mitchell) 2D sample table generator
    (tools/samplepat.cpp): numpy's ``default_rng(0)``, 32 candidates a
    point, the toroidal distance; writes a text table."""
    n = int(argv[0]) if argv else 256
    out = argv[1] if len(argv) > 1 else "samplepat.txt"
    rng = np.random.default_rng(0)
    pts = [rng.uniform(0, 1, 2)]
    for _ in range(n - 1):
        cand = rng.uniform(0, 1, (32, 2))
        d = np.abs(cand[:, None, :] - np.asarray(pts)[None, :, :])
        d = np.minimum(d, 1.0 - d)
        pts.append(cand[np.argmax(np.sqrt((d**2).sum(-1)).min(axis=1))])
    np.savetxt(out, np.asarray(pts))
    print(f"wrote {n} best-candidate samples to {out}")
    return 0


def bsdftest(argv):
    """MC-integrate BxDF stacks over the hemisphere under uniform and
    cosine importance sampling; prints estimates side by side
    (tools/bsdftest.cpp). The 65,536 uniform pairs are
    ``jax.random.uniform(key(0), (n, 2))``'s (``rng.flat_uniforms``);
    ``--cpu`` runs on the CPU, else on the card."""
    import torch

    from pbrt_torch import resolve_device
    from pbrt_torch.bsdf import bxdf
    from pbrt_torch.config import DEFAULT_SPECTRAL
    from pbrt_torch.core import rng
    from pbrt_torch.core import sampling as smp

    dev = resolve_device("cpu" if "--cpu" in argv else None)
    S = DEFAULT_SPECTRAL.n_bins
    n = 1 << 16
    wo = torch.tensor([0.2, 0.1, 0.97], device=dev)
    wo = (wo / torch.linalg.vector_norm(wo)).expand(n, 3)
    full = lambda v: torch.full((n, S), v, device=dev)

    cases = {
        "lambertian(0.8)": lambda wi: bxdf.lambertian_f(full(0.8)),
        "oren-nayar(0.8, sig20)": lambda wi: bxdf.oren_nayar_f(
            full(0.8), torch.full((n,), 20.0, device=dev), wo, wi),
        "blinn(0.8, e=20)": lambda wi: bxdf.microfacet_f(
            full(0.8), bxdf.fresnel_dielectric(bxdf.cos_theta(wi), 1.0, 1.5)[..., None],
            torch.full((n,), 20.0, device=dev), wo, wi),
    }
    u = rng.flat_uniforms(rng.root_key(0), n, 2, dev)
    wi_u = smp.uniform_sample_hemisphere(u[:, 0], u[:, 1])
    wi_c = smp.cosine_sample_hemisphere(u[:, 0], u[:, 1])
    for name, f in cases.items():
        est_u = (f(wi_u).mean(-1) * bxdf.abs_cos_theta(wi_u)).mean() * 2 * np.pi
        est_c = (f(wi_c).mean(-1) * np.pi).mean()
        print(f"{name:28s} uniform: {float(est_u):.4f}  "
              f"cosine-importance: {float(est_c):.4f}")
    return 0


def ply2pbrt(argv):
    """Minimal PLY (ascii / binary_little_endian) → pbrt trianglemesh."""
    path = argv[0]
    out = argv[1] if len(argv) > 1 else None
    with open(path, "rb") as f:
        header = []
        while True:
            line = f.readline().decode("latin-1").strip()
            header.append(line)
            if line == "end_header":
                break
        fmt = next(ln.split()[1] for ln in header if ln.startswith("format"))
        n_vert = int(next(ln.split()[2] for ln in header if ln.startswith("element vertex")))
        n_face = int(next(ln.split()[2] for ln in header if ln.startswith("element face")))
        props = [ln.split()[2] for ln in header
                 if ln.startswith("property float") or ln.startswith("property double")]
        faces = []
        if fmt == "ascii":
            verts = np.loadtxt(f, max_rows=n_vert)
            for _ in range(n_face):
                row = f.readline().split()
                poly = [int(x) for x in row[1:1 + int(row[0])]]
                faces += [(poly[0], poly[t], poly[t + 1]) for t in range(1, len(poly) - 1)]
        else:
            vdt = np.dtype([(p, "<f4") for p in props])
            verts = np.frombuffer(f.read(n_vert * vdt.itemsize), vdt)
            verts = np.stack([verts[p] for p in props], -1)
            for _ in range(n_face):
                k = np.frombuffer(f.read(1), np.uint8)[0]
                poly = np.frombuffer(f.read(4 * k), "<i4")
                faces += [(poly[0], poly[t], poly[t + 1]) for t in range(1, k - 1)]
        faces = np.asarray(faces)
    pv = " ".join(f"{v:g}" for v in np.asarray(verts)[:, :3].ravel())
    iv = " ".join(str(i) for i in faces.ravel())
    text = f'Shape "trianglemesh"\n  "point P" [ {pv} ]\n  "integer indices" [ {iv} ]\n'
    if out:
        with open(out, "w") as fo:
            fo.write(text)
        print(f"wrote {out} ({n_vert} verts, {len(faces)} tris)")
    else:
        sys.stdout.write(text)
    return 0


def datdiff(argv):
    """Compare two spectral .dat films (per bin)."""
    from pbrt_torch.film.film import read_dat

    a, _ = read_dat(argv[0])
    b, _ = read_dat(argv[1])
    if a.shape != b.shape:
        print(f"shapes differ: {a.shape} vs {b.shape}")
        return 1
    d = np.abs(a - b)
    rel = d / (np.abs(b) + 1e-9)
    print(f"max abs diff {d.max():g}, mean abs {d.mean():g}, "
          f"max rel {rel.max():g}, mean rel {rel.mean():g}")
    return 0


_TOOLS = {
    "exrdiff": exrdiff,
    "exravg": exravg,
    "exrtotiff": exrtotiff,
    "tifftoexr": tifftoexr,
    "samplepat": samplepat,
    "bsdftest": bsdftest,
    "ply2pbrt": ply2pbrt,
    "datdiff": datdiff,
}


def main(argv=None):
    argv = argv if argv is not None else sys.argv[1:]
    if not argv or argv[0] not in _TOOLS:
        print(__doc__)
        return 2
    return _TOOLS[argv[0]](argv[1:])


if __name__ == "__main__":
    sys.exit(main())
