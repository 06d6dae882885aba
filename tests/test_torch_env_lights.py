"""Parity of the port's environment and map lights with the JAX package:
``Distribution1D`` and ``Distribution2D`` (built and sampled), the light
table of a scene with a mapped and a constant infinite light, a
projection and a goniometric light (field by field against the JAX
builder's), ``sample_li``, ``pdf_li`` and ``le_escaped`` on the same
arrays (``interop`` carries the JAX package's own env CDFs across, so
buckets compare bit for bit), and the image readers: EXR (half and
float), TGA (raw and RLE) and PFM, read by both packages.

Tolerances: built CDFs rtol 3e-5, about n·ε for float32 prefix sums over
n = 512 entries, which XLA and numpy associate differently; CDF buckets
equal; (u, v) and pdfs from the
same CDFs rtol 1e-6; sample_li's wi, L, pdf and dist rtol / atol 1e-5
(tests/test_torch_lights.py's, XLA contracting multiply-adds) on every
lane; images equal.
"""

import os
import struct

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from pbrt_tpu.core import sampling as jsmp
from pbrt_tpu.film import imageio as jio
from pbrt_tpu.lights import table as jlt
from pbrt_tpu.scene.api import load_scene_string as jload
from pbrt_tpu.scene.builder import build as jbuild
from pbrt_torch.core import sampling as tsmp
from pbrt_torch.film import film as tfilm
from pbrt_torch.film import imageio as tio
from pbrt_torch.interop import scene_from_numpy
from pbrt_torch.lights import table as tlt
from pbrt_torch.scene.api import load_scene_string as tload
from pbrt_torch.scene.builder import build as tbuild
from torch_parity_util import jax_scene_arrays, tiny_scene_text

R = 4000
#: lanes of sample_li. Its JAX side runs under ``jit``: run eagerly, the
#: vmapped ``lax.switch`` over light types broadcasts the arrays it closes
#: over to every lane (the 16.8 MB env map: 4.3 GB at 256 lanes)
R_LI = 2000
TOL = dict(rtol=1e-5, atol=1e-5)
CDF_TOL = dict(rtol=3e-5, atol=1e-7)
LIGHTS = """
LightSource "infinite" "rgb L" [.4 .5 .6]
AttributeBegin
Rotate -90 1 0 0
LightSource "infinite" "rgb L" [1 .9 .8] "string mapname" ["@DIR@/env.exr"]
AttributeEnd
AttributeBegin
Translate 0 3 0
Rotate 90 1 0 0
LightSource "projection" "rgb I" [20 20 20] "float fov" [35] "string mapname" ["@DIR@/projection.exr"]
AttributeEnd
AttributeBegin
Translate 1 2 -1
Rotate 30 0 0 1
LightSource "goniometric" "rgb I" [8 8 8] "string mapname" ["@DIR@/gonio.exr"]
AttributeEnd
"""
FIELDS = ("type", "emit", "l2w", "w2l", "env_id", "env_map", "lmap_id", "lmap", "proj_screen",
          "proj_invtan")
ENV_DIST = ("func", "cond_cdf", "cond_int", "marg_func", "marg_cdf", "marg_int")


@pytest.fixture(scope="module")
def scenes(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("envlights"))
    chip_smoke.write_material_data(d)
    text = tiny_scene_text().replace("WorldBegin", "WorldBegin\n" + LIGHTS.replace("@DIR@", d), 1)
    jb = jbuild(jload(text))
    scene, _, _ = scene_from_numpy(jax_scene_arrays(jb), "cpu")
    return jb, scene, tbuild(tload(text), device="cpu")


@pytest.mark.parametrize("shape", [(37,), (5, 64), (256, 512)], ids=str)
def test_distributions_build_like_jax(shape):
    """Distribution1D (a row per leading index) and Distribution2D from the
    same values, one row all zero (the uniform CDF)."""
    rng = np.random.default_rng(len(shape))
    f = (rng.random(shape) ** 4 * 50).astype(np.float32)
    if len(shape) == 2:
        f[1] = 0.0
        j2, t2 = jsmp.Distribution2D.build(jnp.asarray(f)), tsmp.Distribution2D.build(f)
        for k in ENV_DIST:
            np.testing.assert_allclose(getattr(t2, k).numpy(), np.asarray(getattr(j2, k)),
                                       **CDF_TOL, err_msg=k)
        return
    j1, t1 = jsmp.Distribution1D.build(jnp.asarray(f)), tsmp.Distribution1D.build(f)
    for k in ("func", "cdf", "func_int"):
        np.testing.assert_allclose(getattr(t1, k).numpy(), np.asarray(getattr(j1, k)),
                                   **CDF_TOL, err_msg=k)


def test_distribution1d_sampling_matches_jax():
    """From the JAX package's CDF: equal buckets for u on and beside every
    CDF entry, (x, pdf) rtol 1e-6, the discrete pmf."""
    rng = np.random.default_rng(3)
    f = (rng.random(50) ** 3).astype(np.float32)
    f[7] = 0.0
    j = jsmp.Distribution1D.build(jnp.asarray(f))
    t = tsmp.Distribution1D(*(torch.as_tensor(np.asarray(x)) for x in (j.func, j.cdf, j.func_int)))
    cdf = np.asarray(j.cdf)
    u = np.concatenate([rng.random(R), cdf, np.nextafter(cdf, 0), np.nextafter(cdf, 2)])
    u = np.clip(u, 0, np.float32(1 - 2**-24)).astype(np.float32)
    xj, pj, oj = (np.asarray(a) for a in j.sample_continuous(jnp.asarray(u)))
    xt, pt, ot = t.sample_continuous(torch.as_tensor(u))
    np.testing.assert_array_equal(ot.numpy(), oj)
    # atol: XLA flushes the denormal x of a u on a zero-width bucket to 0
    np.testing.assert_allclose(xt.numpy(), xj, rtol=1e-6, atol=1e-30)
    np.testing.assert_allclose(pt.numpy(), pj, rtol=1e-6)
    (dj, mj), (dt, mt) = j.sample_discrete(jnp.asarray(u)), t.sample_discrete(torch.as_tensor(u))
    np.testing.assert_array_equal(dt.numpy(), np.asarray(dj))
    np.testing.assert_allclose(mt.numpy(), np.asarray(mj), rtol=1e-6)
    assert not (ot.numpy() == 7).any()  # a zero bucket is never picked


def test_light_table_matches_jax_builder(scenes):
    jb, scene, tb = scenes
    jl, tl = jb.scene.lights, tb.scene.lights
    for k in FIELDS:
        a, b = np.asarray(getattr(jl, k)), getattr(tl, k).numpy()
        if a.dtype.kind == "f":
            np.testing.assert_allclose(b, a, rtol=1e-5, atol=1e-7, err_msg=k)
        else:
            np.testing.assert_array_equal(b, a, err_msg=k)
    for k in ENV_DIST:
        np.testing.assert_allclose(getattr(tl.env_dist, k).numpy(),
                                   np.asarray(getattr(jl.env_dist, k)), **CDF_TOL, err_msg=k)
    assert tl.type.tolist() == [tlt.INFINITE, tlt.INFINITE, tlt.PROJECTION, tlt.GONIO, tlt.AREA]
    assert tl.env_id.tolist() == [-1, 0, -1, -1, -1] and tl.lmap_id.tolist() == [-1, -1, 0, 1, -1]
    assert tl.infinite_rows == (0, 1) and tl.infinite_mapped == (False, True)
    # the RGB roundtrip of a constant L: a spectrum, not the L given
    assert tuple(tl.env_map.shape) == (256, 512, 32) and tuple(tl.lmap.shape) == (2, 64, 64, 32)


def _points(rng, n=R):
    return rng.uniform([-2.5, -0.9, -2.5], [2.5, 2.0, 2.5], (n, 3)).astype(np.float32)


@pytest.mark.parametrize("row,name", [(0, "constant infinite"), (1, "mapped infinite"),
                                      (2, "projection"), (3, "goniometric"), (-1, "mixed")])
def test_sample_li_matches_jax(scenes, row, name):
    jb, scene, _ = scenes
    rng = np.random.default_rng(row + 10)
    li = rng.integers(0, 5, R_LI) if row < 0 else np.full(R_LI, row)
    p, u1, u2 = (_points(rng, R_LI), rng.random(R_LI, dtype=np.float32),
                 rng.random(R_LI, dtype=np.float32))
    lj = jax.jit(jlt.sample_li)(jb.scene.lights, jb.scene.geometry, jnp.asarray(li, jnp.int32),
                                jnp.asarray(p), jnp.asarray(u1), jnp.asarray(u2))
    lt = tlt.sample_li(scene.lights, scene.geometry, torch.as_tensor(li), torch.as_tensor(p),
                       torch.as_tensor(u1), torch.as_tensor(u2))
    for k in ("wi", "L", "pdf", "dist"):
        np.testing.assert_allclose(getattr(lt, k).numpy(), np.asarray(getattr(lj, k)), **TOL,
                                   err_msg=k)
    np.testing.assert_array_equal(lt.is_delta.numpy(), np.asarray(lj.is_delta))
    lit = (lt.L > 0).any(-1).float().mean()
    assert lit > 0.05, name
    if name == "projection":  # points outside its screen get nothing
        assert lit < 0.9


def test_pdf_li_and_le_escaped_match_jax(scenes):
    """The infinite lights' solid-angle pdf (the mapped one's from its
    Distribution2D) and the summed radiance of escaped rays."""
    jb, scene, _ = scenes
    rng = np.random.default_rng(5)
    w = rng.normal(size=(R, 3)).astype(np.float32)
    w /= np.linalg.norm(w, axis=1, keepdims=True)
    p = _points(rng)
    for row in (0, 1, 2):
        li = np.full(R, row)
        pj = jlt.pdf_li(jb.scene.lights, jb.scene.geometry, jnp.asarray(li, jnp.int32),
                        jnp.asarray(p), jnp.asarray(w))
        pt = tlt.pdf_li(scene.lights, torch.as_tensor(li), torch.as_tensor(w))
        np.testing.assert_allclose(pt.numpy(), np.asarray(pj), **TOL)
    lj = jlt.le_escaped(jb.scene.lights, jnp.asarray(w))
    lt = tlt.le_escaped(scene.lights, torch.as_tensor(w))
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), **TOL)
    assert lt.numpy().max() > 50 * np.median(lt.numpy())  # the sun patch


def test_missing_map_falls_back_to_constant(tmp_path):
    """A map that does not load warns, and the light is constant in both
    packages."""
    text = tiny_scene_text().replace("WorldBegin", 'WorldBegin\nLightSource "infinite" '
                                     f'"string mapname" ["{tmp_path}/none.exr"]', 1)
    jl = jbuild(jload(text)).scene.lights
    tl = tbuild(tload(text), device="cpu").scene.lights
    assert tl.env_id.tolist()[0] == -1 and tuple(tl.env_map.shape) == (1, 1, 32)
    np.testing.assert_allclose(tl.emit.numpy(), np.asarray(jl.emit), rtol=1e-5)


def _write_tga(path, rgb8, rle):
    """A 24-bit TGA, bottom-up; RLE as one run packet per row pair."""
    H, W, _ = rgb8.shape
    hdr = struct.pack("<BBBHHBHHHHBB", 0, 0, 10 if rle else 2, 0, 0, 0, 0, 0, W, H, 24, 0)
    bgr = rgb8[::-1, :, ::-1]
    with open(path, "wb") as f:
        f.write(hdr)
        if not rle:
            f.write(bgr.tobytes())
            return
        for px in bgr.reshape(-1, 3):  # one raw packet of one pixel each, then a run
            f.write(bytes([0]) + px.tobytes())


@pytest.mark.parametrize("kind", ["exr-half", "exr-float", "tga", "tga-rle", "pfm"])
def test_images_read_like_jax(tmp_path, kind):
    rng = np.random.default_rng(4)
    img = (rng.random((13, 21, 3)) * 4).astype(np.float32)
    path = os.path.join(tmp_path, "img." + kind.split("-")[0])
    if kind.startswith("exr"):
        tio.write_exr(path, img, half=kind == "exr-half")
    elif kind.startswith("tga"):
        _write_tga(path, (img * 60).astype(np.uint8), kind == "tga-rle")
    else:
        tfilm.write_pfm(path, img)
    a, b = jio.read_image(path), tio.read_image(path)
    np.testing.assert_array_equal(b, a)
    assert b.dtype == np.float32 and b.shape == (13, 21, 3)
    if kind != "exr-half" and not kind.startswith("tga"):
        np.testing.assert_array_equal(b, img)
