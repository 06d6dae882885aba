"""Parity of the port's front end and builder with the JAX package: the
SceneDescription of the tiny built-in scene field by field, and the built
tables — wide rows bit for bit, wide_stack, materials, lights, camera —
for that scene and for a generated mesh of about 2k triangles."""

import numpy as np
import pytest
import torch

from pbrt_tpu.scene.api import load_scene_string as jload
from pbrt_tpu.scene.builder import build as jbuild
from pbrt_torch.scene.api import load_scene_string as tload
from pbrt_torch.scene.builder import build as tbuild
from torch_parity_util import tiny_scene_text


def _mesh_scene_text(n_side=32):
    """A seeded, bumpy height-field grid of 2·(n_side−1)² triangles under
    the tiny scene's camera and light."""
    rng = np.random.default_rng(9)
    xs = np.linspace(-3, 3, n_side)
    gx, gy = np.meshgrid(xs, xs)
    gz = rng.uniform(-0.3, 0.3, gx.shape)
    P = np.stack([gx, gz, gy], -1).reshape(-1, 3)
    idx = []
    for i in range(n_side - 1):
        for j in range(n_side - 1):
            a = i * n_side + j
            idx += [a, a + 1, a + n_side, a + 1, a + n_side + 1, a + n_side]
    mesh = ('Shape "trianglemesh" "point P" [' + " ".join(f"{v:.5f}" for v in P.ravel())
            + '] "integer indices" [' + " ".join(map(str, idx)) + "]")
    text = tiny_scene_text()
    return text.replace("WorldEnd", f"AttributeBegin\n Material \"matte\" "
                        f"\"color Kd\" [.3 .5 .2]\n {mesh}\nAttributeEnd\nWorldEnd")


@pytest.fixture(scope="module")
def scenes():
    out = {}
    for name, text in (("tiny", tiny_scene_text()), ("mesh", _mesh_scene_text())):
        out[name] = (text, jbuild(jload(text)), tbuild(tload(text), device="cpu"))
    return out


def _params_equal(a, b):
    assert set(a.entries) == set(b.entries)
    for k in a.entries:
        ta, va = a.entries[k]
        tb, vb = b.entries[k]
        assert ta == tb, k
        assert list(va) == list(vb), k


def test_scene_description_fields():
    """Every record of the tiny scene's SceneDescription, field by field."""
    text = tiny_scene_text()
    j, t = jload(text), tload(text)
    assert len(j.shapes) == len(t.shapes) == 4
    for a, b in zip(j.shapes, t.shapes):
        assert a.shape_type == b.shape_type
        _params_equal(a.params, b.params)
        for ma, mb in zip(a.object_to_world.m, b.object_to_world.m):
            np.testing.assert_array_equal(ma, mb)
        assert a.transform_times == b.transform_times
        assert a.reverse_orientation == b.reverse_orientation
        assert a.primitive_id == b.primitive_id
        assert a.material.mat_type == b.material.mat_type
        assert a.material.material_id == b.material.material_id
        _params_equal(a.material.params, b.material.params)
        assert (a.area_light is None) == (b.area_light is None)
        if a.area_light is not None:
            assert a.area_light[0] == b.area_light[0]
            _params_equal(a.area_light[1], b.area_light[1])
    for f in ("film", "sampler", "filter", "renderer", "surface_integrator",
              "volume_integrator", "accelerator"):
        ra, rb = getattr(j, f), getattr(t, f)
        assert ra[0] == rb[0], f
        _params_equal(ra[1], rb[1])
    assert j.camera[0] == t.camera[0]
    _params_equal(j.camera[1], t.camera[1])
    for ma, mb in zip(j.camera[2].m, t.camera[2].m):
        np.testing.assert_array_equal(ma, mb)
    assert j.camera[3] == t.camera[3]
    assert j.material_names == t.material_names
    assert j.mesh_names == t.mesh_names
    assert (j.lights, j.volumes, j.instances, j.objects) == ([], [], [], {})
    assert (t.lights, t.volumes, t.instances, t.objects) == ([], [], [], {})


def test_param_spectra_match():
    """ParamSet spectra (RGB → 32 bins) resolve the same; rtol 1e-6."""
    text = tiny_scene_text()
    for a, b in zip(jload(text).shapes, tload(text).shapes):
        for name in ("Kd", "Ks", "Kr"):
            if name in a.material.params.entries:
                np.testing.assert_allclose(
                    b.material.params.find_one_spectrum(name, 0.0),
                    a.material.params.find_one_spectrum(name, 0.0), rtol=1e-6)


@pytest.mark.parametrize("name", ["tiny", "mesh"])
def test_wide_rows_bit_for_bit(scenes, name):
    _, jb, tb = scenes[name]
    jr = np.asarray(jb.scene.geometry.wide_rows)
    tr = tb.scene.geometry.wide_rows.numpy()
    assert tr.shape == jr.shape
    np.testing.assert_array_equal(tr.view(np.int32), jr.view(np.int32))
    assert tb.scene.geometry.wide_stack == jb.scene.geometry.wide_stack
    if name == "mesh":
        assert tb.scene.geometry.num_triangles > 1900


@pytest.mark.parametrize("name", ["tiny", "mesh"])
def test_built_tables_match(scenes, name):
    """Triangle and sphere tables equal; spectra rtol 1e-6."""
    _, jb, tb = scenes[name]
    jg, tg = jb.scene.geometry, tb.scene.geometry
    for k in ("tri_v0", "tri_e1", "tri_e2", "tri_n0", "tri_uv1", "quad_o2w",
              "quad_params"):
        np.testing.assert_array_equal(getattr(tg, k).numpy(), np.asarray(getattr(jg, k)))
    np.testing.assert_allclose(tg.quad_w2o.numpy(), np.asarray(jg.quad_w2o), rtol=1e-6,
                               atol=1e-7)
    for k in ("tri_material", "tri_area_light", "tri_mesh_id", "quad_material",
              "quad_area_light", "quad_mesh_id"):
        np.testing.assert_array_equal(getattr(tg, k).numpy(), np.asarray(getattr(jg, k)))
    np.testing.assert_array_equal(tg.quad_reverse.numpy(), np.asarray(jg.quad_reverse))
    jm, tm = jb.scene.materials, tb.scene.materials
    for k in ("kd", "ks", "kr", "exp_u", "eta"):
        np.testing.assert_allclose(getattr(tm, k).numpy(), np.asarray(getattr(jm, k)),
                                   rtol=1e-6)
    codes = np.asarray(jm.active_lobes)[np.clip(np.asarray(jm.lobe_type), 0, None)]
    codes = np.where(np.asarray(jm.lobe_type) >= 0, codes, -1)
    np.testing.assert_array_equal(tm.lobe_type.numpy(), codes)
    np.testing.assert_array_equal(tm.n_lobes.numpy(), np.asarray(jm.n_lobes))
    jl, tl = jb.scene.lights, tb.scene.lights
    np.testing.assert_allclose(tl.emit.numpy(), np.asarray(jl.emit), rtol=1e-6)
    np.testing.assert_array_equal(tl.quad_idx.numpy(), np.asarray(jl.quad_idx))
    np.testing.assert_allclose(tb.camera.raster_to_camera.numpy(),
                               np.asarray(jb.camera.raster_to_camera), rtol=1e-6)
    np.testing.assert_allclose(tb.camera.cam_to_world.numpy(),
                               np.asarray(jb.camera.cam_to_world.m_start), rtol=1e-6)
    np.testing.assert_array_equal(tb.filter_table.numpy(), jb.filter_table)
    assert tb.film_config.xres == jb.film_config.xres
    assert tb.integrator.max_depth == jb.integrator.max_depth


def test_build_needs_a_device_or_cpu():
    """device=None means CUDA: without a card it raises; only an explicit
    device='cpu' runs on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the no-card path is not reachable")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tbuild(tload(tiny_scene_text()))


def test_unported_features_raise():
    """The decided refusals raise; names the JAX package does not know fall
    back as there (tests/test_torch_fallbacks.py holds each against it)."""
    # a texture under cylindrical mapping (the JAX package evaluates it as
    # planar) and a mix of mixes (the JAX package renders the inner mix black)
    textured = ('Texture "checks" "spectrum" "checkerboard" "string mapping" ["cylindrical"]\n'
                'Material "matte" "texture Kd" "checks"')
    nested = ('MakeNamedMaterial "a" "string type" ["matte"]\n'
              'MakeNamedMaterial "b" "string type" ["glass"]\n'
              'MakeNamedMaterial "ab" "string type" ["mix"] "string namedmaterial1" ["a"] '
              '"string namedmaterial2" ["b"]\n'
              'Material "mix" "string namedmaterial1" ["ab"] "string namedmaterial2" ["a"]')
    for extra in (textured, nested):
        text = tiny_scene_text().replace("WorldBegin",
                                         f'WorldBegin\n{extra}\nShape "sphere" "float radius" [.3]',
                                         1)
        with pytest.raises(NotImplementedError):
            tbuild(tload(text), device="cpu")
    plain = tbuild(tload(tiny_scene_text()), device="cpu")
    # a surface integrator the JAX package does not know renders path
    text = tiny_scene_text().replace('SurfaceIntegrator "path"',
                                     'SurfaceIntegrator "bidirectional"')
    assert tbuild(tload(text), device="cpu").integrator == plain.integrator
    # a shape it does not know is skipped with its warning, and an
    # accelerator or split it does not know builds the SAH BVH
    unknown_shape = 'Shape "bilinearpatch" "point P" [0 0 0 1 0 0 0 1 0 1 1 0]'
    for head, body in (("", unknown_shape), ('Accelerator "qbvh"', ""),
                       ('Accelerator "bvh" "string splitmethod" "hlbvh"', "")):
        text = tiny_scene_text().replace("WorldBegin", f"{head}\nWorldBegin\n{body}", 1)
        g = tbuild(tload(text), device="cpu").scene.geometry
        assert g.accel_kind == "bvh" and g.num_quadrics == plain.scene.geometry.num_quadrics
        np.testing.assert_array_equal(g.wide_rows.numpy(), plain.scene.geometry.wide_rows.numpy())
