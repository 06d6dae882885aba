"""Parity of the port's texture system with the JAX package: the Perlin
permutation, the mip pyramid and the texel pool bit for bit (a
non-power-of-two and a 1×N image included), the table both builders make
from one scene's texture records, and ``eval_spectrum`` / ``eval_float``
for all 13 kinds under the uv, spherical and planar mappings, with no
footprint, an isotropic one and an anisotropic one whose eccentricity
exceeds 8 (the EWA clamp), one-level nesting included, on the same seeded
lanes; an imagemap read from a generated EXR, TGA and PFM; and the two
facts of the JAX package the port refuses (cylindrical mapping evaluated
as planar, and nesting deeper than one level read as 0).

The JAX side runs eagerly (op by op, so XLA contracts no multiply-adds).
Tolerances: texture values rtol 1e-4, atol 1e-6 on every lane, and for the
discontinuous kinds (the checkerboards and dots) on ≥ 99% of lanes, where
a lane an ulp from a cell edge may take the other side; the pyramid, the
pool and the permutation equal.
"""

import os
import struct

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pbrt_tpu.config import DEFAULT_SPECTRAL
from pbrt_tpu.scene.api import load_scene_string as jload
from pbrt_tpu.textures import texture as jtex
from pbrt_torch.film import film as tfilm
from pbrt_torch.film import imageio as tio
from pbrt_torch.scene.api import load_scene_string as tload
from pbrt_torch.textures import texture as ttex

TOL = dict(rtol=1e-4, atol=1e-6)
LANES_PER_ROW = 48
DISCONTINUOUS = (jtex.T_CHECKER2D, jtex.T_CHECKER3D, jtex.T_DOTS)
_FIELDS = ("kind", "mapping", "uv_xform", "world_to_tex", "c1", "c2", "f1", "f2", "ref1",
           "ref2", "img_offset", "img_w", "img_h", "img_level_off", "img_n_levels",
           "pool_rgb", "perm")
#: every class, each written under the three mappings (3D kinds ignore it)
_CLASSES = (
    ('"constant"', '"rgb value" [.2 .5 .7]'),
    ('"scale"', '"rgb tex1" [.9 .4 .2] "rgb tex2" [.5 .8 1.2]'),
    ('"mix"', '"rgb tex1" [.9 .1 .1] "rgb tex2" [.1 .2 .9] "float amount" [.3]'),
    ('"bilerp"', '"rgb tex1" [.8 .7 .1] "rgb tex2" [.1 .3 .9]'),
    ('"imagemap"', '"string filename" ["@DIR@/lines.exr"] "float scale" [1.5]'),
    ('"uv"', ''),
    ('"checkerboard"', '"rgb tex1" [1 .2 .1] "rgb tex2" [.1 .3 1]'),
    ('"checkerboard"', '"integer dimension" [3] "rgb tex1" [.9 .9 .2] "rgb tex2" [.1 .1 .3]'),
    ('"dots"', '"rgb tex1" [.9 .2 .6] "rgb tex2" [.2 .7 .3]'),
    ('"fbm"', ''),
    ('"wrinkled"', ''),
    ('"marble"', '"rgb tex1" [.8 .8 .7] "rgb tex2" [.2 .1 .1] "float variation" [.7]'),
    ('"windy"', ''),
)
#: one-level references: an imagemap scaled, a checkerboard of two rows, a
#: mix of noise and an image, dots of a bilerp
_NESTED = """
Texture "n-scale" "spectrum" "scale" "texture tex1" "t4-0" "rgb tex2" [.5 .6 .7]
Texture "n-check" "spectrum" "checkerboard" "texture tex1" "t4-1" "texture tex2" "t9-0"
  "float uscale" [3] "float vscale" [5]
Texture "n-mix" "spectrum" "mix" "texture tex1" "t10-0" "texture tex2" "t4-2" "float amount" [.6]
Texture "n-dots" "spectrum" "dots" "texture tex1" "t3-0" "rgb tex2" [.3 .3 .3]
  "float uscale" [4] "float vscale" [4]
Texture "n-float" "float" "scale" "texture tex1" "t11-1" "float tex2" [-.25]
"""


def write_lines(directory, H=37, W=53, name="lines.exr"):
    """A line pattern at a size that is not a power of two (so the Lanczos
    resample runs), with colour along both axes."""
    yy, xx = np.mgrid[0:H, 0:W]
    stripes = 0.5 + 0.5 * np.sin(xx * 0.9) * np.cos(yy * 0.35)
    img = np.stack([stripes, 0.3 + 0.4 * yy / H, 1.0 - stripes * xx / W], -1)
    tio.write_exr(os.path.join(directory, name), img.astype(np.float32), half=False)


def kinds_scene(directory):
    """Scene text declaring every class under every mapping, with a
    texture-space transform on every other row, and the nested rows; one
    material binds a texture so both builders see the whole environment."""
    lines = ["WorldBegin"]
    for ci, (cls, params) in enumerate(_CLASSES):
        for mi, mapping in enumerate(("uv", "spherical", "planar")):
            xf = (f'"float uscale" [{1.5 + mi}] "float vscale" [{2.5 - mi}] '
                  f'"float udelta" [{.1 * mi}] "float vdelta" [-.2]')
            lines += ["TransformBegin", f"Rotate {20 * ci + 7 * mi} 1 1 0",
                      f"Scale {1 + .2 * mi} .8 1.3" if (ci + mi) % 2 else "",
                      f'Texture "t{ci}-{mi}" "spectrum" {cls} "string mapping" ["{mapping}"] '
                      f"{xf} {params.replace('@DIR@', directory)}", "TransformEnd"]
    lines += [_NESTED, 'Material "matte" "texture Kd" "t0-0"', 'Shape "sphere"', "WorldEnd"]
    return "\n".join(lines)


def texture_records(desc):
    """The texture environment of the scene's material, as the JAX builder
    gathers it (float records, then spectrum records over them)."""
    m = desc.shapes[0].material
    return {**m.float_textures, **m.spectrum_textures}


def build_both(text):
    jt, jidx = jtex.build_texture_table(texture_records(jload(text)), DEFAULT_SPECTRAL)
    tt, tidx = ttex.build_texture_table(texture_records(tload(text)), DEFAULT_SPECTRAL, "cpu")
    return jt, jidx, tt, tidx


@pytest.fixture(scope="module")
def tables(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("textures"))
    write_lines(d)
    return build_both(kinds_scene(d))


def _lanes(K, seed):
    rng = np.random.default_rng(seed)
    R = K * LANES_PER_ROW
    tid = np.repeat(np.arange(K), LANES_PER_ROW).astype(np.int32)
    tid[::17] = -1  # lanes with no texture get zeros
    uv = rng.uniform(-2.0, 3.0, (R, 2)).astype(np.float32)
    p = rng.uniform(-3.0, 3.0, (R, 3)).astype(np.float32)
    sigma = np.exp(rng.uniform(np.log(1e-4), np.log(0.2), R)).astype(np.float32)
    ang = rng.uniform(0, 2 * np.pi, R)
    stretch = rng.uniform(1.0, 20.0, R)  # eccentricity beyond the clamp of 8
    major = (np.stack([np.cos(ang), np.sin(ang)], -1) * (sigma * stretch)[:, None])
    return tid, uv, p, sigma, major.astype(np.float32)


def _eval(tbl, fn, tid, uv, p, sigma, major, footprint, torch_side):
    fp = {"none": (None, None), "iso": (sigma, None), "aniso": (sigma, major)}[footprint]
    if torch_side:
        a = [None if x is None else torch.as_tensor(x) for x in (tid, uv, p) + fp]
        a[0] = a[0].long()
        return getattr(ttex, fn)(tbl, *a).numpy()
    a = [None if x is None else jnp.asarray(x) for x in (tid, uv, p) + fp]
    return np.asarray(getattr(jtex, fn)(tbl, *a))


def test_permutation_and_pyramid_bit_equal():
    np.testing.assert_array_equal(ttex.perlin_permutation(),
                                  np.concatenate([np.random.default_rng(1234).permutation(256)] * 2))
    rng = np.random.default_rng(3)
    for shape in ((37, 53, 3), (1, 19, 3), (16, 1, 3), (64, 64, 3), (5, 3, 3)):
        img = rng.random(shape).astype(np.float32) * 3
        jl, tl = jtex._build_pyramid(img), ttex._build_pyramid(img)
        assert len(jl) == len(tl) and tl[0].shape[:2] == tuple(
            ttex._next_pow2(n) for n in shape[:2])
        for a, b in zip(jl, tl):
            assert b.dtype == np.float32
            np.testing.assert_array_equal(b, a)


def test_tables_equal(tables):
    jt, jidx, tt, tidx = tables
    assert tidx == jidx and tt.count == jt.count == 3 * len(_CLASSES) + 5
    for f in _FIELDS:
        a, b = np.asarray(getattr(jt, f)), getattr(tt, f).numpy()
        if f in ("pool_rgb", "perm", "img_level_off", "kind", "ref1", "ref2"):
            np.testing.assert_array_equal(b, a, err_msg=f)
        else:
            np.testing.assert_allclose(b, a, rtol=1e-6, atol=1e-7, err_msg=f)
    assert set(tt.kinds) == set(range(13))
    # three 37×53 images, each resampled to 64×64 with 7 levels down to 1×1
    assert tt.pool_rgb.shape[0] == 1 + 3 * sum(4 ** k for k in range(7))


@pytest.mark.parametrize("footprint", ["none", "iso", "aniso"])
def test_eval_spectrum_matches_jax(tables, footprint):
    jt, _, tt, _ = tables
    tid, uv, p, sigma, major = _lanes(tt.count, seed=7)
    a = _eval(jt, "eval_spectrum", tid, uv, p, sigma, major, footprint, False)
    b = _eval(tt, "eval_spectrum", tid, uv, p, sigma, major, footprint, True)
    assert b.shape == a.shape == (len(tid), 32) and np.isfinite(b).all()
    close = np.isclose(b, a, **TOL).all(-1)
    kind = np.asarray(jt.kind)[np.maximum(tid, 0)]
    for k in range(13):
        lanes = (kind == k) & (tid >= 0)
        share = close[lanes].mean()
        assert share >= (0.99 if k in DISCONTINUOUS else 1.0), (k, share)
    assert (b[tid < 0] == 0).all()
    if footprint == "aniso":
        ecc = np.linalg.norm(major, axis=-1) / sigma
        assert (ecc > ttex.MAX_ANISOTROPY).mean() > 0.5


def test_eval_float_and_row_subsets_match_jax(tables):
    """``eval_float`` on the float row and on a mix of rows, and the port's
    ``rows`` argument: evaluating only the kinds of the rows named gives
    those rows' values."""
    jt, jidx, tt, _ = tables
    tid, uv, p, sigma, major = _lanes(tt.count, seed=8)
    a = _eval(jt, "eval_float", tid, uv, p, sigma, major, "aniso", False)
    b = _eval(tt, "eval_float", tid, uv, p, sigma, major, "aniso", True)
    kind = np.asarray(jt.kind)[np.maximum(tid, 0)]
    cont = ~np.isin(kind, DISCONTINUOUS)
    np.testing.assert_allclose(b[cont], a[cont], **TOL)
    rows = (jidx[("float", "n-float")], jidx[("spectrum", "t4-1")])
    sel = np.isin(tid, rows)
    args = [torch.as_tensor(x) for x in (tid[sel], uv[sel], p[sel], sigma[sel], major[sel])]
    args[0] = args[0].long()
    sub = ttex.eval_float(tt, *args, rows=rows).numpy()
    np.testing.assert_array_equal(sub, b[sel])


@pytest.mark.parametrize("fmt", ["exr", "tga", "pfm"])
def test_imagemap_from_each_format(tmp_path, fmt):
    rng = np.random.default_rng(11)
    img = rng.random((24, 40, 3)).astype(np.float32)
    path = os.path.join(tmp_path, f"map.{fmt}")
    if fmt == "exr":
        tio.write_exr(path, img, half=False)
    elif fmt == "pfm":
        tfilm.write_pfm(path, img)
    else:
        H, W, _ = img.shape
        with open(path, "wb") as f:
            f.write(struct.pack("<BBBHHBHHHHBB", 0, 0, 2, 0, 0, 0, 0, 0, W, H, 24, 0))
            f.write((img * 255).astype(np.uint8)[::-1, :, ::-1].tobytes())
    text = (f'WorldBegin\nTexture "m" "spectrum" "imagemap" "string filename" ["{path}"] '
            f'"float uscale" [3] "bool gamma" ["{"true" if fmt == "pfm" else "false"}"]\n'
            'Material "matte" "texture Kd" "m"\nShape "sphere"\nWorldEnd')
    jt, _, tt, _ = build_both(text)
    assert int(tt.img_n_levels[0]) == 7 and tt.pool_rgb.shape[0] > 1
    np.testing.assert_array_equal(tt.pool_rgb.numpy(), np.asarray(jt.pool_rgb))
    tid, uv, p, sigma, major = _lanes(1, seed=12)
    tid[:] = 0
    for fp in ("none", "iso", "aniso"):
        a = _eval(jt, "eval_spectrum", tid, uv, p, sigma, major, fp, False)
        b = _eval(tt, "eval_spectrum", tid, uv, p, sigma, major, fp, True)
        np.testing.assert_allclose(b, a, **TOL)


def test_missing_image_is_black_with_a_warning(tmp_path):
    text = (f'WorldBegin\nTexture "m" "spectrum" "imagemap" "string filename" '
            f'["{tmp_path}/absent.exr"]\nMaterial "matte" "texture Kd" "m"\nShape "sphere"\n'
            "WorldEnd")
    with pytest.warns(UserWarning, match="black texture"):
        tt, _ = ttex.build_texture_table(texture_records(tload(text)), DEFAULT_SPECTRAL, "cpu")
    assert tt.pool_rgb.shape[0] == 1 and int(tt.img_offset[0]) == -1
    out = ttex.eval_spectrum(tt, torch.zeros(4, dtype=torch.long), torch.rand(4, 2),
                             torch.rand(4, 3))
    assert (out == 0).all()


def test_cylindrical_mapping_is_refused_and_jax_evaluates_it_as_planar(tmp_path):
    """Fact 9: the JAX package accepts cylindrical mapping and evaluates it
    with the planar formula; the port refuses it."""
    def scene(mapping):
        return (f'WorldBegin\nTexture "c" "spectrum" "uv" "string mapping" ["{mapping}"] '
                '"float uscale" [2]\nMaterial "matte" "texture Kd" "c"\nShape "sphere"\n'
                "WorldEnd")
    with pytest.raises(NotImplementedError, match="cylindrical"):
        ttex.build_texture_table(texture_records(tload(scene("cylindrical"))),
                                 DEFAULT_SPECTRAL, "cpu")
    rng = np.random.default_rng(2)
    uv = jnp.asarray(rng.random((64, 2), dtype=np.float32))
    p = jnp.asarray(rng.uniform(-2, 2, (64, 3)).astype(np.float32))
    tid = jnp.zeros(64, jnp.int32)
    out = {}
    for m in ("cylindrical", "planar"):
        jt, _ = jtex.build_texture_table(texture_records(jload(scene(m))), DEFAULT_SPECTRAL)
        out[m] = np.asarray(jtex.eval_spectrum(jt, tid, uv, p))
    np.testing.assert_array_equal(out["cylindrical"], out["planar"])


def test_deeper_nesting_is_refused_and_jax_reads_it_as_zero(tmp_path):
    """Fact 10: scale(scale(imagemap, 2), .5) renders black in the JAX
    package (the inner reference is evaluated with a zero ``prev``); the
    port refuses nesting deeper than one level."""
    write_lines(str(tmp_path))
    text = (f'WorldBegin\nTexture "img" "spectrum" "imagemap" "string filename" '
            f'["{tmp_path}/lines.exr"]\n'
            'Texture "s2" "spectrum" "scale" "texture tex1" "img" "rgb tex2" [2 2 2]\n'
            'Texture "s" "spectrum" "scale" "texture tex1" "s2" "rgb tex2" [.5 .5 .5]\n'
            'Material "matte" "texture Kd" "s"\nShape "sphere"\nWorldEnd')
    jt, jidx = jtex.build_texture_table(texture_records(jload(text)), DEFAULT_SPECTRAL)
    rng = np.random.default_rng(5)
    uv = jnp.asarray(rng.random((64, 2), dtype=np.float32))
    p = jnp.zeros((64, 3))
    outer = np.asarray(jtex.eval_spectrum(jt, jnp.full(64, jidx[("spectrum", "s")]), uv, p))
    inner = np.asarray(jtex.eval_spectrum(jt, jnp.full(64, jidx[("spectrum", "s2")]), uv, p))
    assert (outer == 0).all() and (inner > 0).any()
    with pytest.raises(NotImplementedError, match="nested"):
        ttex.build_texture_table(texture_records(tload(text)), DEFAULT_SPECTRAL, "cpu")
