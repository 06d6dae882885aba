"""The port's emission sampling (``pbrt_torch/lights/table.py``:
``sample_le``, ``area_sample_point``, and the light table's
``world_center``, ``world_radius`` and ``power_dist``) against the JAX
package's (``pbrt_tpu/lights/table.py:385-555``, builder.py:874-875 and
:1052), on every light type: point, spot, distant, area lights on a sphere
and on a triangle mesh (the lights-and-quadrics scene), infinite (mapped
and constant), projection and goniometric (the environment scene).

The JAX side runs ``sample_le`` under ``jit`` (eagerly, its vmapped
``lax.switch`` broadcasts the env map per lane). The port's side takes the
JAX package's arrays (``interop``, so the light rows and CDFs are the
same) and, for the table's fields, its own builder.

Tolerances: the world bound equal (the same float32 from the same
float64 scene bound); the powers and their CDF rtol 1e-6 (a constant
infinite light's spectrum, whose mean is its power, comes from XLA in one
package and numpy in the other, an ulp apart); sample_le's d, n and pdf
rtol / atol 1e-5, Le rtol 1e-4 (a spot light's falloff divides cos θ −
cos θ_total, which cancels near the cone's edge), its origin p atol 1e-5
· the world radius (a point on the world disk: XLA contracts the disk's
multiply-adds into FMAs); the light pick by power equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from pbrt_tpu.lights import table as jlt
from pbrt_tpu.scene.api import load_scene_string as jload
from pbrt_tpu.scene.builder import build as jbuild
from pbrt_torch.interop import scene_from_numpy
from pbrt_torch.lights import table as tlt
from pbrt_torch.scene.api import load_scene_string as tload
from pbrt_torch.scene.builder import build as tbuild
from torch_parity_util import jax_scene_arrays, lights_scene_text, tiny_scene_text

R = 2000
TOL = dict(rtol=1e-5, atol=1e-5)
ENV_LIGHTS = """
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


@pytest.fixture(scope="module")
def scenes(tmp_path_factory):
    """{name: (JAX built scene, the port's scene from its arrays, the
    port's own build)} for the two scenes."""
    d = str(tmp_path_factory.mktemp("emission"))
    chip_smoke.write_material_data(d)
    texts = {"lights": lights_scene_text(),
             "env": tiny_scene_text().replace("WorldBegin", "WorldBegin\n"
                                              + ENV_LIGHTS.replace("@DIR@", d), 1)}
    out = {}
    for name, text in texts.items():
        jb = jbuild(jload(text))
        scene, _, _ = scene_from_numpy(jax_scene_arrays(jb), "cpu")
        out[name] = (jb, scene, tbuild(tload(text), device="cpu"))
    return out


def test_scenes_hold_every_light_type(scenes):
    types = set()
    for _, scene, _ in scenes.values():
        types |= set(scene.lights.type.tolist())
    assert types == set(range(7))
    lt = scenes["lights"][1].lights
    assert lt.area_shapes == {tlt.SHAPE_SPHERE, tlt.SHAPE_MESH}
    assert scenes["env"][1].lights.infinite_mapped == (False, True)


@pytest.mark.parametrize("name", ["lights", "env"])
def test_emission_fields_match_jax_builder(scenes, name):
    """The port's builder gives the JAX builder's world bound and light
    powers: max(mean(emit), 1e-6) per row, and their CDF."""
    jb, _, tb = scenes[name]
    jl, tl = jb.scene.lights, tb.scene.lights
    np.testing.assert_array_equal(tl.world_center.numpy(), np.asarray(jl.world_center))
    np.testing.assert_array_equal(tl.world_radius.numpy(), np.asarray(jl.world_radius))
    for k in ("func", "cdf", "func_int"):
        np.testing.assert_allclose(getattr(tl.power_dist, k).numpy(),
                                   np.asarray(getattr(jl.power_dist, k)), rtol=1e-6, err_msg=k)
    assert float(tl.world_radius) > 10.0


@pytest.mark.parametrize("name", ["lights", "env"])
def test_sample_le_matches_jax(scenes, name):
    """Each row of the table on R lanes, from the same uniforms: the
    emitted ray's origin, direction, normal, radiance and pdf."""
    jb, scene, _ = scenes[name]
    jl, jg = jb.scene.lights, jb.scene.geometry
    lt = scene.lights
    rs = np.random.default_rng(9)
    u = rs.random((4, R), dtype=np.float32)
    li = np.repeat(np.arange(lt.count), -(-R // lt.count))[:R].astype(np.int32)
    ej = jax.jit(jlt.sample_le)(jl, jg, jnp.asarray(li), *(jnp.asarray(x) for x in u))
    et = tlt.sample_le(lt, scene.geometry, torch.as_tensor(li.astype(np.int64)),
                       *(torch.as_tensor(x) for x in u))
    wr = float(lt.world_radius)
    np.testing.assert_allclose(et.p.numpy(), np.asarray(ej.p), rtol=0, atol=1e-5 * wr)
    for k in ("d", "n", "pdf"):
        np.testing.assert_allclose(getattr(et, k).numpy(), np.asarray(getattr(ej, k)), **TOL,
                                   err_msg=k)
    np.testing.assert_allclose(et.Le.numpy(), np.asarray(ej.Le), rtol=1e-4, atol=1e-5)
    pdf = et.pdf.numpy()
    assert np.isfinite(pdf).all() and (pdf > 0).mean() > 0.9
    assert np.abs(np.linalg.norm(et.d.numpy(), axis=-1) - 1).max() < 1e-5


def test_area_sample_point_matches_jax(scenes):
    """Points by area on the sphere and mesh area lights: point, normal
    and area pdf."""
    jb, scene, _ = scenes["lights"]
    lt = scene.lights
    rows = [i for i in range(lt.count) if int(lt.type[i]) == tlt.AREA]
    li = np.repeat(rows, R // len(rows)).astype(np.int32)
    u1, u2 = np.random.default_rng(3).random((2, li.size), dtype=np.float32)
    fn = jax.jit(jax.vmap(lambda i, a, b: jlt._area_sample_point(
        jb.scene.lights, jb.scene.geometry, i, a, b)))
    ref = fn(jnp.asarray(li), jnp.asarray(u1), jnp.asarray(u2))
    out = tlt.area_sample_point(lt, scene.geometry, torch.as_tensor(li.astype(np.int64)),
                                torch.as_tensor(u1), torch.as_tensor(u2))
    for a, b in zip(out, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)


def test_power_pick_matches_jax(scenes):
    """The emitting light picked by power, as photon shooting and VPL
    generation pick it (photonmap.py:62): index and pmf."""
    jb, scene, _ = scenes["lights"]
    u = np.random.default_rng(4).random(R, dtype=np.float32)
    ij, pj = jb.scene.lights.power_dist.sample_discrete(jnp.asarray(u))
    it, pt = scene.lights.power_dist.sample_discrete(torch.as_tensor(u))
    np.testing.assert_array_equal(it.numpy(), np.asarray(ij))
    np.testing.assert_allclose(pt.numpy(), np.asarray(pj), rtol=1e-6)
    assert len(set(it.tolist())) == scene.lights.count
