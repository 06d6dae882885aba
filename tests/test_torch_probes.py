"""The port's radiance probes (``pbrt_torch/renderers/probes.py``,
``integrators/irradiance.py:useprobes_li``) against the JAX package's
(``pbrt_tpu/renderers/probes.py``, ``integrators/irradiance.py:168-224``),
on ``torch_parity_util.prt_scene_text`` under ``directlighting`` depth 1
at 16×16: a 2 × 2 × 2 grid of lmax-2 probes, 32 directions each (256
lanes, as many as the film's pixels, so the JAX pieces compile for one
lane count).

The JAX side runs eagerly with its per-step pieces compiled once each
(``torch_parity_util.jax_integrator_pieces``, entered once for the
module), reading a hit area light's row as the port does
(``jax_area_rows_like_port``).

Tolerances: the coefficients rtol 1e-4, atol 1e-6 on ≥ 99% of (probe,
term) rows (each a 32-direction sum of directlighting traces); the file's
text equal byte for byte when both write the same coefficients (the
bound's float32s as numpy prints them, ``%g``), and the port's own file's
numbers within the coefficients' tolerance; what the two readers return
equal; the per-lane radiance rtol 1e-4, atol 1e-6 on ≥ 99% of lanes;
``render(seed)`` pixels rtol 1e-4, atol 1e-6 on ≥ 99%, per-bin sums rtol
1e-4.
"""

import dataclasses
import inspect
from unittest import mock

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pbrt_tpu.integrators.irradiance as jirr
import pbrt_tpu.integrators.path as jpath
import pbrt_tpu.renderers.dispatch as jdispatch
import pbrt_tpu.renderers.probes as jprobes
from pbrt_tpu.core import rng as jrng
from pbrt_tpu.renderers.sampler import render as j_render
from pbrt_tpu.scene.api import load_scene_string as jload
from pbrt_tpu.scene.builder import build as jbuild
from pbrt_tpu.utils import error as jerr
from pbrt_torch.core import geometry as geom
from pbrt_torch.core import rng
from pbrt_torch.integrators import irradiance as tirr
from pbrt_torch.integrators.path import trace_radiance
from pbrt_torch.interop import integrator_from_numpy, scene_from_numpy
from pbrt_torch.renderers import dispatch, probes
from pbrt_torch.renderers.sampler import key_uniforms, render
from pbrt_torch.scene.api import load_scene_string as tload
from pbrt_torch.scene.builder import build as tbuild
from pbrt_torch.utils import error as terr
from torch_parity_util import (jax_area_rows_like_port, jax_integrator_pieces, jax_scene_arrays,
                               prt_scene_text)

N = 16
DIRECT = '"directlighting" "integer maxdepth" [1]'
TOL = dict(rtol=1e-4, atol=1e-6)
SAMPLE = 2
GRID = (2, 2, 2)


def useprobes(path: str) -> str:
    return f'"useprobes" "integer maxdepth" [1] "string filename" ["{path}"]'


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """The JAX package's probes and file, its useprobes build reading the
    file, and shared rays and keys; its pieces stay compiled and patched
    for every test of the module."""
    d = tmp_path_factory.mktemp("probes")
    with jax_integrator_pieces(), jax_area_rows_like_port():
        jb = jbuild(jload(prt_scene_text(DIRECT, N, N)))
        jpath_ = str(d / "jax.probes")
        centers_j, cj = jprobes.create_probes(jb, lmax=2, nprobes=GRID, nindir=32,
                                              filename=jpath_, verbose=False)
        text = prt_scene_text(useprobes(jpath_), N, N)
        jbu = jbuild(jload(text))
        arrays = jax_scene_arrays(jbu)
        scene, _, _ = scene_from_numpy(arrays, "cpu")
        rs = np.random.default_rng(8)
        u = rs.random((N * N, 5), dtype=np.float32)
        ys, xs = np.divmod(np.arange(N * N), N)
        jr = jbu.camera.generate_rays(jnp.asarray((xs + u[:, 0]).astype(np.float32)),
                                      jnp.asarray((ys + u[:, 1]).astype(np.float32)),
                                      *(jnp.asarray(u[:, k]) for k in (2, 3, 4)))
        pix = np.arange(N * N, dtype=np.int64)
        keys = jrng.pixel_sample_key(jrng.root_key(4), jnp.asarray(pix.astype(np.uint32)),
                                     jnp.uint32(SAMPLE))
        rays = geom.Ray.make(*(torch.as_tensor(np.array(a)) for a in (jr.origin, jr.direction)))
        yield dict(dir=d, jb=jb, cj=np.asarray(cj), centers=centers_j, jfile=jpath_, text=text,
                   jbu=jbu, scene=scene, icfg=integrator_from_numpy(arrays), jr=jr, keys=keys, rays=rays,
                   pix=torch.as_tensor(pix))


def _both_useprobes(s, jscene=None, scene=None):
    """useprobes per lane, both packages, on the same rays and keys."""
    jscene = jscene or s["jbu"].scene
    Lj, tj = jirr.useprobes_li(jscene, s["jr"], s["keys"], s["jbu"].integrator, jscene.probes)
    u = key_uniforms(s["icfg"], rng.root_key(4), s["pix"], SAMPLE)
    L, t = tirr.useprobes_li(scene or s["scene"], s["rays"], s["icfg"], u)
    return np.asarray(Lj), np.asarray(tj), L.numpy(), t.numpy()


def test_create_probes_matches_jax_and_its_file(setup):
    """The port's own build's probes against the JAX package's; its writer
    gives the JAX file byte for byte from the JAX coefficients; its own
    file holds its coefficients as %g."""
    s = setup
    tb = tbuild(tload(prt_scene_text(DIRECT, N, N)), device="cpu")
    tpath_ = str(s["dir"] / "port.probes")
    centers, ct = probes.create_probes(tb, lmax=2, nprobes=GRID, nindir=32, filename=tpath_)
    assert ct.shape == (8, 9, 32) and np.isfinite(ct).all() and ct[:, 0].min() > 0
    np.testing.assert_array_equal(centers, s["centers"])
    assert np.isclose(ct, s["cj"], **TOL).all(-1).mean() >= 0.99
    g = tb.scene.geometry
    again = probes.write_probe_file(str(s["dir"] / "again.probes"), 2, g.world_lo.numpy(),
                                    g.world_hi.numpy(), GRID, s["cj"])
    with open(again, "rb") as a, open(s["jfile"], "rb") as b:
        assert a.read() == b.read()
    own = probes.read_probe_file(tpath_, 32)[4]
    np.testing.assert_allclose(own, ct, rtol=1e-5, atol=1e-12)


def test_read_probe_file_matches_jax(setup):
    t = probes.read_probe_file(setup["jfile"], 32)
    j = jprobes.read_probe_file(setup["jfile"], 32)
    assert t[0] == j[0] == 2 and t[3] == j[3] == GRID
    for a, b in zip(t[1:3] + t[4:], j[1:3] + j[4:]):
        np.testing.assert_array_equal(a, b)
    probes_ = setup["scene"].probes
    assert probes_.coeffs.shape == (2, 2, 2, 9, 32) and probes_.lmax == 2
    np.testing.assert_array_equal(probes_.coeffs.numpy().reshape(8, 9, 32), t[4])


def test_useprobes_li_matches_jax(setup):
    """Per lane: directlighting plus the trilinear probes' irradiance."""
    Lj, tj, L, t = _both_useprobes(setup)
    assert np.isfinite(L).all() and L.sum() > 0
    assert np.isclose(L, Lj, **TOL).all(-1).mean() >= 0.99
    np.testing.assert_allclose(t, tj, rtol=1e-5)
    # the probes add light where the hit is diffuse
    u = key_uniforms(setup["icfg"], rng.root_key(4), setup["pix"], SAMPLE)
    direct, _ = trace_radiance(setup["scene"], setup["rays"], dataclasses.replace(
        setup["icfg"], kind="directlighting"), u)
    assert (L.sum(-1) > direct.numpy().sum(-1) + 1e-6).mean() > 0.5


def test_render_seed_matches_jax(setup):
    """``render`` of the 16×16 scene under useprobes (1 spp, seed 3), each
    package from its own build reading the JAX file; and the JAX package's
    ProbeGrid through interop renders as the port's own read."""
    js = j_render(setup["jbu"], spp=1, seed=3, verbose=False)
    tb = tbuild(tload(setup["text"]), device="cpu")
    pt = render(tb, spp=1, seed=3).pixels.numpy()
    pj = np.asarray(js.pixels)
    assert pt.shape == (N, N, 32) and np.isfinite(pt).all() and pt.sum() > 0
    assert np.isclose(pt, pj, **TOL).all(-1).mean() >= 0.99
    np.testing.assert_allclose(pt.sum((0, 1)), pj.sum((0, 1)), rtol=1e-4)
    fed = dataclasses.replace(tb, scene=dataclasses.replace(tb.scene,
                                                            probes=setup["scene"].probes))
    np.testing.assert_array_equal(render(fed, spp=1, seed=3).pixels.numpy(), pt)


def test_fact_only_bands_up_to_2_reach_the_irradiance(setup):
    """Fact: Â_l is zero above l = 2 (irradiance.py:185-190): bands 3–4 of
    lmax-4 probes change nothing, in both packages."""
    s = setup
    rs = np.random.default_rng(2)
    c = np.asarray(s["jbu"].scene.probes.coeffs)
    c4 = np.concatenate([c, np.zeros(c.shape[:3] + (16, 32), np.float32)], axis=3)
    c4b = c4.copy()
    c4b[..., 9:, :] = rs.random(c4b[..., 9:, :].shape).astype(np.float32)
    out = []
    for coeffs in (c4, c4b):
        jp = jirr.ProbeGrid(lo=s["jbu"].scene.probes.lo, hi=s["jbu"].scene.probes.hi,
                            coeffs=jnp.asarray(coeffs), lmax=4)
        tp = tirr.ProbeGrid(lo=s["scene"].probes.lo, hi=s["scene"].probes.hi,
                            coeffs=torch.as_tensor(coeffs), lmax=4)
        Lj, _, L, _ = _both_useprobes(s, dataclasses.replace(s["jbu"].scene, probes=jp),
                                      dataclasses.replace(s["scene"], probes=tp))
        out.append((Lj, L))
    np.testing.assert_array_equal(out[0][0], out[1][0])
    np.testing.assert_array_equal(out[0][1], out[1][1])
    Lj, _, L, _ = _both_useprobes(s)
    np.testing.assert_allclose(out[0][1], L, rtol=1e-6, atol=1e-7)


def test_fact_useprobes_reads_no_texture_and_refuses_a_mix(setup, capfd):
    """Facts: at the probe hit useprobes takes the table's kd and no
    texture (irradiance.py:176-178): in the port a checkerboard floor adds
    the same indirect light as an untextured matte of the table's default
    kd, and the JAX package's hit is a ``surface_interaction`` with no
    spread and no ``apply_textures``; on a mix floor the JAX package fails
    (a mix lane has no kd; its directlighting trace stubbed here) and the
    port refuses it; without ``filename`` both warn and render as
    irradiancecache."""
    s = setup
    u = key_uniforms(s["icfg"], rng.root_key(4), s["pix"], SAMPLE)
    dl = dataclasses.replace(s["icfg"], kind="directlighting")
    ind = []
    for floor in ("textured", "default"):
        text = prt_scene_text(useprobes(s["jfile"]), N, N, floor=floor)
        scene = tbuild(tload(text), device="cpu").scene
        L, _ = tirr.useprobes_li(scene, s["rays"], s["icfg"], u)
        direct, _ = trace_radiance(scene, s["rays"], dl, u)
        ind.append((L - direct).numpy())
    np.testing.assert_allclose(ind[0], ind[1], rtol=1e-6, atol=1e-7)
    assert ind[0].sum() > 0
    calls = []
    real = jirr.surface_interaction
    with mock.patch.object(jirr, "surface_interaction",
                           lambda *a, **kw: calls.append(kw) or real(*a, **kw)):
        _both_useprobes(s)
    assert calls == [{}] and "apply_textures" not in inspect.getsource(jirr.useprobes_li)
    text = prt_scene_text(useprobes(s["jfile"]), N, N, floor="mix")
    jbm = jbuild(jload(text))
    stub = lambda scene, rays, keys, cfg, **kw: (jnp.zeros((N * N, 32)), jnp.zeros(N * N))
    with mock.patch.object(jpath, "trace_radiance", stub), pytest.raises(AttributeError):
        jirr.useprobes_li(jbm.scene, s["jr"], s["keys"], jbm.integrator, jbm.scene.probes)
    tbm = tbuild(tload(text), device="cpu")
    with pytest.raises(NotImplementedError, match="mix"):
        render(tbm, spp=1)
    # another test in this worker may have left either package quiet (a CLI
    # run with --quiet) or the message counted past its repeats
    for e in (jerr, terr):
        e.set_options()
        e.reset()
    capfd.readouterr()
    bare = prt_scene_text('"useprobes" "integer maxdepth" [1]', N, N)
    assert jbuild(jload(bare)).integrator.kind == "irradiancecache"
    assert "useprobes without a probe file" in capfd.readouterr().err
    assert tbuild(tload(bare), device="cpu").integrator.kind == "irradiancecache"
    assert "useprobes without a probe file" in capfd.readouterr().err


def test_fact_createprobes_grid_and_header(setup, tmp_path):
    """Facts: ``Renderer "createprobes"`` takes ⌈extent / samplespacing⌉
    probes per axis (default spacing 1) and ``indirectsamples`` clamped to
    [16, 256] (dispatch.py:50-58), as the JAX package's dispatch; at the
    default spacing a large scene's lanes overflow 32 bits and the port
    says so; the header's two flags are never read."""
    asked = []
    grab = lambda built, **kw: asked.append(kw) or (None, None)
    for extra, grid, nindir in (('"float samplespacing" [3] "integer indirectsamples" [8]',
                                 (3, 2, 3), 16),
                                ('"float samplespacing" [2.5] "integer indirectsamples" [999]',
                                 (4, 2, 4), 256)):
        path = str(tmp_path / "grid.probes")
        text = prt_scene_text(DIRECT, N, N).replace(
            "WorldBegin", f'Renderer "createprobes" {extra} "string filename" ["{path}"]\n'
            'WorldBegin', 1)
        asked.clear()
        with mock.patch.object(jprobes, "create_probes", grab):
            assert jdispatch.render_scene(jbuild(jload(text)), verbose=False) == [path]
        assert asked[0]["nprobes"] == grid and asked[0]["nindir"] == nindir
        with mock.patch.object(probes, "create_probes", grab):
            assert dispatch.render_scene(tbuild(tload(text), device="cpu")) == [path]
        assert asked[1]["nprobes"] == grid and asked[1]["nindir"] == nindir
    text = prt_scene_text(DIRECT, N, N).replace(
        "WorldBegin", 'Renderer "createprobes" "float samplespacing" [.001]\nWorldBegin', 1)
    with pytest.raises(ValueError, match="32-bit lane index"):
        dispatch.render_scene(tbuild(tload(text), device="cpu"))
    lines = open(setup["jfile"]).read().split("\n", 1)
    flags = str(tmp_path / "flags.probes")
    with open(flags, "w") as f:
        f.write(lines[0].replace("2 1 1", "2 0 7") + "\n" + lines[1])
    for reader in (probes.read_probe_file, jprobes.read_probe_file):
        a, b = reader(setup["jfile"], 32), reader(flags, 32)
        np.testing.assert_array_equal(a[4], b[4])
        assert a[:1] + a[3:4] == b[:1] + b[3:4]
