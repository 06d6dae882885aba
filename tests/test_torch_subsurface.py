"""The port's dipole subsurface integrator and surface-points renderer
(``pbrt_torch/integrators/dipole.py``, ``renderers/surface_points.py``)
against the JAX package's (``pbrt_tpu/integrators/dipole.py``,
``renderers/surface_points.py``), on the tiny scene with a ``subsurface``
and a ``kdsubsurface`` box (``torch_parity_util.subsurface_scene_text``).

The JAX side runs eagerly with its per-step pieces compiled once each
(``torch_parity_util.jax_integrator_pieces``): its own tests of these
integrators are marked slow, so this file carries the comparison.

Tolerances: the point sets, the thinning and the points file equal (host
numpy on both sides); Rd rtol 1e-5 (XLA contracts its multiply-adds);
the irradiance at the points rtol 1e-4, atol 1e-6 on ≥ 99.5% of the
points (a shadow ray that grazes an edge may see the light in one package
and not in the other); Mo rtol 1e-3, atol 1e-7: both packages expand
|p − q|² as |p|² − 2 p·q + |q|², which cancels (|p|² ≈ 4 here, up to
600 on ss-envmap's scale, against dipole depths z² ≈ 0.1), and XLA takes
p·q in a matmul and the einsum over a chunk's points in its own order;
``render(seed)`` as ``tests/test_torch_film.py``'s (pixels rtol 1e-4, atol
1e-6 on ≥ 99%, per-bin sums rtol 1e-5).
"""

import dataclasses
from unittest import mock

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pbrt_tpu.integrators.dipole as jdip
from pbrt_tpu.renderers import surface_points as jsp
from pbrt_tpu.renderers.sampler import render as j_render
from pbrt_tpu.scene.api import load_scene_string as jload
from pbrt_tpu.scene.builder import build as jbuild
from pbrt_torch.integrators import dipole as tdip
from pbrt_torch.interop import scene_from_numpy
from pbrt_torch.lights import table as tlt
from pbrt_torch.renderers import surface_points as tsp
from pbrt_torch.renderers.dispatch import render_scene
from pbrt_torch.renderers.sampler import render
from pbrt_torch.scene.api import load_scene_string as tload
from pbrt_torch.scene.builder import build as tbuild
from torch_parity_util import jax_integrator_pieces, jax_scene_arrays, subsurface_scene_text

DIPOLE = '"dipolesubsurface" "integer maxdepth" [2]'
TOL = dict(rtol=1e-4, atol=1e-6)


@pytest.fixture(scope="module")
def pieces():
    with jax_integrator_pieces():
        yield


@pytest.fixture(scope="module")
def pair(pieces):
    """(JAX build, the port's scene from its arrays, the port's own build)."""
    text = subsurface_scene_text(DIPOLE)
    jb = jbuild(jload(text))
    scene, _, _ = scene_from_numpy(jax_scene_arrays(jb), "cpu")
    return jb, scene, tbuild(tload(text), device="cpu")


def test_diffusion_rd_matches_jax():
    rs = np.random.default_rng(1)
    d2 = (rs.random(500) ** 2 * 4).astype(np.float32)
    sa = (rs.random((500, 32)) * 0.5 + 0.01).astype(np.float32)
    sps = (rs.random((500, 32)) * 4 + 0.1).astype(np.float32)
    eta = (1.0 + rs.random((500, 1)) * 0.8).astype(np.float32)
    ref = np.asarray(jdip.diffusion_rd(*(jnp.asarray(x) for x in (d2, sa, sps, eta))))
    out = tdip.diffusion_rd(*(torch.as_tensor(x) for x in (d2, sa, sps, eta))).numpy()
    assert ref.max() > 0.01 and (ref > 0).mean() > 0.9
    np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-9)


def test_surface_points_match_jax(pair):
    """The area-weighted points on the two boxes (seed 0, 4,096 of them),
    their normals, areas and material rows, equal; both rows present."""
    jb, _, tb = pair
    ref = jdip.sample_surface_points(jb)
    out = tdip.sample_surface_points(tb)
    for a, b in zip(out, ref):
        np.testing.assert_array_equal(a, b)
    kinds = tb.scene.materials.kind.numpy()[out[3]]
    assert set(kinds.tolist()) == {tdip.SUBSURFACE, tdip.KDSUBSURFACE}
    ss = tb.scene.subsurface
    np.testing.assert_array_equal(ss.points.numpy(), ref[0])
    np.testing.assert_array_equal(ss.material.numpy(), ref[3])


def test_compute_irradiance_matches_jax(pair):
    """E at the points: the JAX builder's preprocess against the port's, on
    the JAX package's arrays and in the port's own build."""
    jb, scene, tb = pair
    ref = np.asarray(jb.scene.subsurface.E)
    pts, nrm = np.asarray(jb.scene.subsurface.points), np.asarray(jb.scene.subsurface.normals)
    out = tdip.compute_irradiance(scene, pts, nrm).numpy()
    assert ref.max() > 0.1 and (ref.sum(-1) > 0).mean() > 0.3 and (ref.sum(-1) == 0).any()
    for e in (out, tb.scene.subsurface.E.numpy()):
        assert np.isclose(e, ref, **TOL).all(-1).mean() >= 0.995


def test_mo_gather_matches_jax(pair):
    """Mo at 64 lanes around the cloud (both materials' rows), the port's
    plain version against the JAX package's chunked einsum, from the same
    point cloud; inactive lanes 0."""
    jb, scene, _ = pair
    ss = scene.subsurface
    rs = np.random.default_rng(2)
    pick = rs.integers(0, ss.points.shape[0], 64)
    p = (ss.points.numpy()[pick] + rs.normal(0, 0.05, (64, 3))).astype(np.float32)
    mat = ss.material.numpy()[pick]
    ref = np.asarray(jdip.mo_gather(jb.scene.subsurface, jb.scene.materials, jnp.asarray(p),
                                    jnp.asarray(mat.astype(np.int32))))
    active = torch.as_tensor(np.arange(64) % 5 != 0)
    out = tdip.mo_gather(ss, scene.materials, torch.as_tensor(p), torch.as_tensor(mat), active)
    assert ref.min() > 0
    np.testing.assert_allclose(out.numpy()[active.numpy()], ref[active.numpy()], rtol=1e-3,
                               atol=1e-7)
    assert not out.numpy()[~active.numpy()].any()
    # the plain version's tiles and tree against one dense sum
    d2 = ((p[:, None, :] - ss.points.numpy()[None]) ** 2).sum(-1)
    prm = tdip._lane_params(scene.materials, torch.as_tensor(mat))
    dense = (tdip._rd(torch.as_tensor(d2)[:, :, None], [x[:, None] for x in prm])
             * (ss.E * ss.areas[:, None])).sum(1).numpy()
    np.testing.assert_allclose(out.numpy()[active.numpy()], dense[active.numpy()], rtol=1e-3)


def test_mo_gather_plain_lanes_stand_alone(pair):
    """What the kernel's lane list relies on: ``mo_gather_plain`` on
    permuted lanes returns the permuted result bit for bit, and a lane's
    value does not depend on which other lanes are active (nor on how many
    lanes the call has); the grouped order against a float64 dense sum at
    ``test_mo_gather_matches_jax``'s tolerance."""
    _, _, tb = pair
    ss, mt = tb.scene.subsurface, tb.scene.materials
    rs = np.random.default_rng(3)
    n = 48
    pick = rs.integers(0, ss.points.shape[0], n)
    p = torch.as_tensor((ss.points.numpy()[pick] + rs.normal(0, 0.05, (n, 3))).astype(np.float32))
    mat = ss.material[pick]
    active = torch.as_tensor(rs.random(n) < 0.6)
    bits = lambda x: x.view(torch.int32)
    out = tdip.mo_gather_plain(ss, mt, p, mat, active)
    assert out[active].min() > 0 and not out[~active].any()
    perm = torch.as_tensor(rs.permutation(n))
    moved = tdip.mo_gather_plain(ss, mt, p[perm], mat[perm], active[perm])
    assert torch.equal(bits(moved), bits(out[perm]))
    other = torch.as_tensor(rs.random(n) < 0.3)
    both = active & other
    assert both.any()
    assert torch.equal(bits(tdip.mo_gather_plain(ss, mt, p, mat, other)[both]), bits(out[both]))
    r = int(torch.nonzero(active)[0])
    alone = tdip.mo_gather_plain(ss, mt, p[r:r + 1], mat[r:r + 1])
    assert torch.equal(bits(alone[0]), bits(out[r]))
    d2 = ((p.double()[:, None, :] - ss.points.double()[None]) ** 2).sum(-1)
    prm = [x.double()[:, None] for x in tdip._lane_params(mt, mat)]
    dense = (tdip._rd(d2[:, :, None], prm) * (ss.E * ss.areas[:, None]).double()).sum(1)
    np.testing.assert_allclose(out[active].numpy(), dense[active].numpy(), rtol=1e-3, atol=1e-7)


def test_mo_gather_kernel_constants_match_plain_order():
    """``csrc/dipole.cu``'s tile and pairwise group are the plain version's
    ``TILE`` and ``GROUP`` (read from the source's text)."""
    import pathlib
    import re

    src = (pathlib.Path(tdip.__file__).parent.parent / "csrc" / "dipole.cu").read_text()
    consts = dict(re.findall(r"constexpr int (kTile|kGroup) = (\d+);", src))
    assert consts == {"kTile": str(tdip.TILE), "kGroup": str(tdip.GROUP)}
    assert tdip.TILE % tdip.GROUP == 0 and tdip.GROUP == 8


def test_mo_gather_one_build_and_cpu_path(pair):
    """``csrc/dipole.cu`` has one build: it reads no macro, so the only
    other build of it (``scripts/mo_lab.py``'s) is the FMA-contracted one,
    a flag of ``native.kernel_lib``; ``launch_with`` (a given build, no
    launch counted) takes only CUDA tensors, and ``mo_gather`` on CPU
    tensors runs the plain version and counts no launch."""
    import inspect
    import pathlib

    from pbrt_torch.utils import native

    src = (pathlib.Path(tdip.__file__).parent.parent / "csrc" / "dipole.cu").read_text()
    assert "#if" not in src and "fmad" in inspect.signature(native.kernel_lib).parameters
    _, _, tb = pair
    ss, mt = tb.scene.subsurface, tb.scene.materials
    p, mat = ss.points[:3], ss.material[:3]
    prm = torch.stack(tdip._lane_params(mt, mat))
    with pytest.raises(ValueError, match="unsupported device"):
        tdip.launch_with(None, prm, p, torch.ones(3, dtype=torch.uint8), tdip._point_table(ss))
    tdip.reset_launches()
    out = tdip.mo_gather(ss, mt, p, mat, torch.tensor([True, False, True]))
    assert not any(tdip.launches.values()) and out[1].eq(0).all() and out[0].gt(0).all()


def test_render_seed_matches_jax(pair):
    """``render`` of the 8×8 scene under dipolesubsurface (depth 2, 1 spp,
    seed 3), each package from its own build."""
    jb, _, tb = pair
    js = j_render(jb, spp=1, seed=3, verbose=False)
    ts = render(tb, spp=1, seed=3)
    pj, pt = np.asarray(js.pixels), ts.pixels.numpy()
    assert pt.shape == (8, 8, 32) and np.isfinite(pt).all() and pt.sum() > 0
    assert np.isclose(pt, pj, **TOL).all(-1).mean() >= 0.99
    np.testing.assert_allclose(pt.sum((0, 1)), pj.sum((0, 1)), rtol=1e-5)
    # the diffusion term is in the image: without it the boxes are darker
    off = render(tb.__class__(**{**tb.__dict__, "scene": tb.scene.__class__(
        **{**tb.scene.__dict__, "has_subsurface": False})}), spp=1, seed=3).pixels.numpy()
    assert pt.sum() > off.sum() * 1.001


def test_poisson_thin_matches_jax():
    rs = np.random.default_rng(5)
    pts = rs.random((3000, 3)).astype(np.float32) * 2
    for d in (0.0, 0.05, 0.2):
        ref, out = jsp.poisson_thin(pts, d), tsp.poisson_thin(pts, d)
        np.testing.assert_array_equal(out, ref)
    keep = tsp.poisson_thin(pts, 0.2)
    q = pts[keep]
    d2 = ((q[:, None] - q[None]) ** 2).sum(-1) + np.eye(len(q)) * 10
    assert len(keep) < 1000 and d2.min() >= 0.2 ** 2 * (1 - 1e-6)


def test_surfacepoints_renderer_and_file_round_trip(pair, tmp_path):
    """``Renderer "surfacepoints"`` through the port's dispatch writes the
    JAX package's file, line for line; it reads back."""
    jb, _, _ = pair
    text = subsurface_scene_text(DIPOLE).replace(
        "WorldBegin", f'Renderer "surfacepoints" "float minsampledistance" [.15] '
        f'"string filename" ["{tmp_path}/port.pts"]\nWorldBegin', 1)
    tb = tbuild(tload(text), device="cpu")
    assert render_scene(tb) == [f"{tmp_path}/port.pts"]
    ref = jsp.generate_surface_points(jb, 0.15)
    jsp.write_points_file(str(tmp_path / "jax.pts"), *ref)
    assert (tmp_path / "port.pts").read_text() == (tmp_path / "jax.pts").read_text()
    pts, nrm, area, eps = tsp.read_points_file(str(tmp_path / "port.pts"))
    assert len(pts) == len(ref[0]) > 50 and area.shape == eps.shape == (len(pts),)
    np.testing.assert_allclose(pts, ref[0], rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(nrm, ref[1], atol=1e-5)
    assert np.allclose(eps, 1.5e-5)


def test_fact_points_file_and_spacing_are_not_read(pair, tmp_path):
    """Fact: the integrator never reads a points file and never reads
    ``minsampledistance`` or ``maxerror``: it always samples 4,096 points
    by area with seed 0 (the builder calls ``prepare_subsurface`` without
    one, pbrt_tpu/scene/builder.py:815-823). A points file read back gets
    material row 0 (dipole.py:164), in both packages."""
    jb, _, tb = pair
    pts_file = tmp_path / "given.pts"
    tsp.write_points_file(str(pts_file), *tsp.generate_surface_points(tb, 0.3))
    text = subsurface_scene_text(
        '"dipolesubsurface" "integer maxdepth" [2] "float minsampledistance" [.9] '
        f'"float maxerror" [.5] "string pointsfile" ["{pts_file}"]')
    tb2 = tbuild(tload(text), device="cpu")
    for a, b in ((tb2.scene.subsurface, tb.scene.subsurface),):
        for k in ("points", "areas", "material", "E"):
            assert torch.equal(getattr(a, k), getattr(b, k)), k
    jb2 = jbuild(jload(text))
    np.testing.assert_array_equal(np.asarray(jb2.scene.subsurface.points),
                                  np.asarray(jb.scene.subsurface.points))
    jss = jdip.prepare_subsurface(jb, pointsfile=str(pts_file))
    tss = tdip.prepare_subsurface(tb, pointsfile=str(pts_file))
    n = len(tsp.read_points_file(str(pts_file))[0])
    assert tss.points.shape[0] == n == jss.points.shape[0] != tdip.MAX_POINTS
    assert not tss.material.any() and not np.asarray(jss.material).any()


def test_fact_irradiance_takes_abs_cos_and_a_uniform_pick(pieces):
    """Fact: the irradiance at a point takes |cos θ| (a flipped normal gives
    the same E, bit for bit, in both packages) and picks its light
    uniformly, ⌊u·n⌋, whatever the lights' powers (dipole.py:127-141): the
    scene adds a point light 40 times the sphere light's power."""
    text = subsurface_scene_text(DIPOLE).replace(
        "WorldBegin", 'WorldBegin\nLightSource "point" "rgb I" [480 480 480] '
        '"point from" [0 3 -2]', 1)
    jb = jbuild(jload(text))
    scene, _, _ = scene_from_numpy(jax_scene_arrays(jb), "cpu")
    ss = scene.subsurface
    pts, nrm = ss.points.numpy()[:512], ss.normals.numpy()[:512]
    for fn, sc in ((jdip.compute_irradiance, jb), (tdip.compute_irradiance, scene)):
        a, b = (np.asarray(fn(sc, pts, n)) for n in (nrm, -nrm))
        np.testing.assert_array_equal(a, b)
    picks = []
    real = tlt.sample_li

    def spy(lt, g, li, *a):
        picks.append(li.clone())
        return real(lt, g, li, *a)

    with mock.patch.object(tlt, "sample_li", spy):
        tdip.compute_irradiance(scene, pts, nrm)
    u = tdip.rng.chain_uniforms(tdip.rng.root_key(31), torch.arange(512), 0,
                                chain=[(tdip.rng.LIGHT_SAMPLE, 4)], n=3)
    power = scene.lights.power_dist.func.numpy()
    assert len(power) == 2 and power.max() > 20 * power.min()
    for s, li in enumerate(picks):
        assert torch.equal(li, torch.clamp((u[:, 3 * s] * 2).long(), max=1))
    assert 0.4 < float(torch.cat(picks).float().mean()) < 0.6


def test_jax_point_cloud_through_interop_renders_as_the_ports_own(pair):
    """The JAX builder's point cloud, carried across by ``interop`` (the
    ``ss_*`` arrays), renders as the port's own preprocess at the same
    seed."""
    jb, scene, tb = pair
    assert scene.has_subsurface and scene.subsurface.E.shape == (tdip.MAX_POINTS, 32)
    np.testing.assert_array_equal(scene.subsurface.E.numpy(), np.asarray(jb.scene.subsurface.E))
    films = [render(b, spp=1, seed=2).pixels.numpy()
             for b in (tb, dataclasses.replace(tb, scene=scene))]
    assert films[0].sum() > 0
    assert np.isclose(films[1], films[0], **TOL).all(-1).mean() >= 0.99
    np.testing.assert_allclose(films[1].sum((0, 1)), films[0].sum((0, 1)), rtol=1e-5)
