"""Parity of the port's material table (``pbrt_torch/materials/table.py``)
with the JAX package's on one scene holding every material kind: the
builders' tables field by field (lobe codes mapped through the JAX
table's ``active_lobes``), then ``bsdf_f``, ``bsdf_pdf``, ``bsdf_sample``
and ``has_delta_only`` on lanes spread over every row, mix rows included,
from the JAX table carried across by ``interop`` (so both sides read the
same measured pools).

Tolerances: table spectra rtol 1e-6, the rest equal; f and pdf
``allclose`` rtol 1e-4, atol 1e-6 on every lane; a sampled direction atol
1e-6 and its f and pdf as f's on ≥ 99.5% of lanes (XLA's transcendentals
round differently from libm's by an ulp, and a sampled half vector
carries that on; tests/test_torch_bxdf.py), directions within 1e-5 and
the delta flags equal on every lane. The JAX functions run under ``jit``,
where XLA contracts multiply-adds into FMA.

The last two tests show fact 5 of ROADMAP.md's Queue 3: the JAX package
renders a mix nested in a mix as a black Lambertian (its row's own
placeholder lobe), and the port refuses it.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from pbrt_tpu.materials import table as jmt
from pbrt_tpu.scene.api import load_scene_string as jload
from pbrt_tpu.scene.builder import build as jbuild
from pbrt_torch.interop import scene_from_numpy
from pbrt_torch.materials import table as tmt
from pbrt_torch.scene.api import load_scene_string as tload
from pbrt_torch.scene.builder import build as tbuild
from torch_parity_util import jax_scene_arrays, tiny_scene_text

R = 3000
F_TOL = dict(rtol=1e-4, atol=1e-6)

#: one sphere per material; every kind of the JAX package, both measured
#: formats and a measured file that does not load, two mixes and an
#: unknown type (matte 0.5)
MATERIALS = (
    'Material "matte" "color Kd" [.5 .4 .3]',
    'Material "matte" "color Kd" [.6 .6 .5] "float sigma" [25]',
    'Material "plastic" "color Kd" [.3 .2 .1] "color Ks" [.4 .4 .4] "float roughness" [.05]',
    'Material "glass" "float index" [1.45]',
    'Material "mirror" "color Kr" [.8 .8 .7]',
    'Material "metal"',
    'Material "shinymetal" "color Ks" [.8 .6 .3] "color Kr" [.5 .5 .5] "float roughness" [.08]',
    'Material "substrate" "color Kd" [.5 .5 .8] "color Ks" [.5 .5 .5] '
    '"float uroughness" [.05] "float vroughness" [.2]',
    'Material "uber" "color Kd" [.3 .3 .3] "color Ks" [.2 .2 .2] "color Kr" [.2 .2 .2] '
    '"color Kt" [.3 .3 .3] "float roughness" [.05] "float index" [1.4]',
    'Material "translucent" "color Kd" [.5 .6 .4] "color Ks" [.3 .3 .3] '
    '"color reflect" [.5 .5 .5] "color transmit" [.4 .4 .4] "float roughness" [.1]',
    'Material "anisoward" "color Kd" [.2 .3 .5] "color Ks" [.4 .4 .4] "float alphaU" [.08] '
    '"float alphaV" [.3]',
    'Material "subsurface" "string name" ["Skin1"] "float scale" [2]',
    'Material "kdsubsurface" "color Kd" [.6 .5 .4] "float meanfreepath" [.5]',
    'Material "measured" "string filename" ["@DIR@/generated.brdf"]',
    'Material "measured" "string filename" ["@DIR@/generated.merl"]',
    'Material "measured" "string filename" ["@DIR@/missing.merl"]',
    'Material "mix" "string namedmaterial1" ["red plastic"] '
    '"string namedmaterial2" ["clear glass"] "float amount" [.3]',
    'Material "mix" "string namedmaterial1" ["red plastic"] '
    '"string namedmaterial2" ["rough metal"] "color amount" [.2 .5 .8]',
    'Material "velvet" "color Kd" [.4 .4 .4]',
)
NAMED = """
MakeNamedMaterial "red plastic" "string type" ["plastic"] "color Kd" [.6 .1 .1]
    "color Ks" [.3 .3 .3] "float roughness" [.1]
MakeNamedMaterial "clear glass" "string type" ["glass"] "float index" [1.5]
MakeNamedMaterial "rough metal" "string type" ["metal"] "float roughness" [.05]
"""
TABLE_FIELDS = ("kind", "n_lobes", "kd", "ks", "kr", "kt", "sigma", "exp_u", "exp_v", "eta",
                "eta_spec", "k_spec", "irreg_offset", "irreg_count", "merl_offset",
                "irreg_points", "irreg_spectra", "merl_rgb", "ss_sigma_a", "ss_sigma_s",
                "ss_scale", "mix_m1", "mix_m2", "mix_amt")


def _scene_text(directory, materials=MATERIALS, named=NAMED):
    shapes = "".join(
        f"AttributeBegin\n{m.replace('@DIR@', directory)}\n"
        f"Translate {-3 + 0.4 * i} 0 3\nShape \"sphere\" \"float radius\" [.15]\nAttributeEnd\n"
        for i, m in enumerate(materials))
    return tiny_scene_text().replace("WorldBegin", "WorldBegin\n" + named + shapes, 1)


@pytest.fixture(scope="module")
def tables(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("materials"))
    chip_smoke.write_material_data(d)
    text = _scene_text(d)
    with pytest.warns(UserWarning, match="missing.merl"):
        jb = jbuild(jload(text))
    with pytest.warns(UserWarning, match="missing.merl"):
        tb = tbuild(tload(text), device="cpu")
    scene, _, _ = scene_from_numpy(jax_scene_arrays(jb), "cpu")
    return jb.scene.materials, tb.scene.materials, scene.materials


def test_material_table_matches_jax_builder(tables):
    jt, tt, it = tables
    codes = np.asarray(jt.active_lobes)[np.clip(np.asarray(jt.lobe_type), 0, None)]
    codes = np.where(np.asarray(jt.lobe_type) >= 0, codes, -1)
    for t in (tt, it):
        np.testing.assert_array_equal(t.lobe_type.numpy(), codes)
        for k in TABLE_FIELDS:
            a, b = np.asarray(getattr(jt, k)), getattr(t, k).numpy()
            if a.dtype.kind == "f":
                np.testing.assert_allclose(b, a, rtol=1e-6, err_msg=k)
            else:
                np.testing.assert_array_equal(b, a, err_msg=k)
        assert t.active_lobes == tuple(jt.active_lobes) == tuple(range(14))
        assert t.has_mix and t.max_lobes == jt.max_lobes == 4
    kinds = set(tt.kind.tolist())
    assert kinds == set(range(14)), kinds
    # the missing file's row is matte 0.5; the unknown type's matte
    assert (tt.irreg_count > 0).sum() == 1 and (tt.merl_offset > 0).sum() == 1


@pytest.fixture(scope="module")
def lanes(tables):
    """R lanes over every row (mix rows and their sub-rows included), with
    directions on both sides, a geometric normal tilted off the shading
    normal, and uniforms."""
    jt, _, it = tables
    rng = np.random.default_rng(30)
    M = it.count
    idx = np.concatenate([np.arange(M), rng.integers(0, M, R - M)])
    wo = rng.normal(size=(R, 3)).astype(np.float32)
    wi = rng.normal(size=(R, 3)).astype(np.float32)
    wo[: R // 2, 2] = np.abs(wo[: R // 2, 2])  # half the wo above the surface
    ng = np.array([0.0, 0.0, 1.0]) + 0.15 * rng.normal(size=(R, 3))
    unit = lambda a: (a / np.linalg.norm(a, axis=1, keepdims=True)).astype(np.float32)
    u = rng.random((R, 3), dtype=np.float32)
    return dict(idx=idx, wo=unit(wo), wi=unit(wi), ng=unit(ng), u=u)


def _jax_calls(jt, L):
    pools = jmt.pools_of(jt)
    lm = jmt.gather_lane(jt, jnp.asarray(L["idx"], jnp.int32))
    wo, wi, ng = (jnp.asarray(L[k]) for k in ("wo", "wi", "ng"))
    u = jnp.asarray(L["u"])
    f = jax.jit(lambda lm, a, b, n: jmt.bsdf_f(lm, a, b, pools, n))(lm, wo, wi, ng)
    pdf = jax.jit(jmt.bsdf_pdf)(lm, wo, wi)
    samp = jax.jit(lambda lm, a, u, n: jmt.bsdf_sample(lm, a, u[:, 0], u[:, 1], u[:, 2],
                                                        pools, n))(lm, wo, u, ng)
    return [np.asarray(x) for x in (f, pdf, *samp, jmt.has_delta_only(lm))]


def _port_calls(it, L):
    lm = tmt.gather_lane(it, torch.as_tensor(L["idx"]))
    wo, wi, ng, u = (torch.as_tensor(L[k]) for k in ("wo", "wi", "ng", "u"))
    f = tmt.bsdf_f(lm, wo, wi, ng)
    pdf = tmt.bsdf_pdf(lm, wo, wi)
    samp = tmt.bsdf_sample(lm, wo, u[:, 0], u[:, 1], u[:, 2], ng)
    return [x.numpy() for x in (f, pdf, *samp, tmt.has_delta_only(lm))]


def test_bsdf_matches_jax_on_every_kind(tables, lanes):
    """f and pdf at given directions, then sampling, on lanes of every row."""
    jt, _, it = tables
    fj, pj, wj, sfj, spj, dj, hj = _jax_calls(jt, lanes)
    ft, pt, wt, sft, spt, dt, ht = _port_calls(it, lanes)
    np.testing.assert_allclose(ft, fj, **F_TOL)
    np.testing.assert_allclose(pt, pj, **F_TOL)
    assert (ft > 0).any(-1).mean() > 0.3 and np.isfinite(ft).all()
    np.testing.assert_array_equal(dt, dj)
    np.testing.assert_array_equal(ht, hj)
    ok = (np.isclose(wt, wj, rtol=0.0, atol=1e-6).all(-1)
          & np.isclose(sft, sfj, **F_TOL).all(-1) & np.isclose(spt, spj, **F_TOL))
    assert ok.mean() >= 0.995, np.nonzero(~ok)[0]
    np.testing.assert_allclose(wt, wj, rtol=0.0, atol=1e-5)
    # every row's lanes: delta-only rows (glass, mirror, subsurface's
    # specular lobe) and the mixes' delta samples are present
    kind = it.kind.numpy()[lanes["idx"]]
    assert ht[kind == tmt.GLASS].all() and not ht[kind == tmt.PLASTIC].any()
    assert dt[kind == tmt.MIXMAT].any() and not dt[kind == tmt.MIXMAT].all()


NESTED = """
MakeNamedMaterial "white" "string type" ["matte"] "color Kd" [.8 .8 .8]
MakeNamedMaterial "grey" "string type" ["matte"] "color Kd" [.3 .3 .3]
MakeNamedMaterial "inner" "string type" ["mix"] "string namedmaterial1" ["white"]
    "string namedmaterial2" ["grey"] "float amount" [.5]
"""
OUTER = ('Material "mix" "string namedmaterial1" ["inner"] "string namedmaterial2" ["grey"] '
         '"float amount" [.5]')


def test_jax_renders_a_nested_mix_black():
    """Fact 5: the outer mix's first sub-lane is the inner mix's own row,
    whose placeholder lobe is a Lambertian of Kd 0, so f = ½·0 + ½·f(grey)
    where pbrt's recursive MixMaterial gives ½·f(inner) + ½·f(grey)."""
    jb = jbuild(jload(_scene_text("", (OUTER,), NESTED)))
    jt = jb.scene.materials
    kind = np.asarray(jt.kind)
    outer = int(np.nonzero((kind == jmt.MIXMAT) & (np.asarray(jt.mix_m1) != np.arange(len(kind))))[0][0])
    inner, grey = int(np.asarray(jt.mix_m1)[outer]), int(np.asarray(jt.mix_m2)[outer])
    assert kind[inner] == jmt.MIXMAT
    lm = jmt.gather_lane(jt, jnp.asarray([outer], jnp.int32))
    assert float(jnp.abs(lm.lm1.kd).max()) == 0.0
    up = jnp.asarray([[0.0, 0.0, 1.0]])
    f = np.asarray(jmt.bsdf_f(lm, up, up, jmt.pools_of(jt)))[0]
    f_grey = np.asarray(jt.kd)[grey] / np.pi
    np.testing.assert_allclose(f, 0.5 * f_grey, rtol=1e-6)
    f_recursive = 0.5 * (0.5 * (np.asarray(jt.kd)[grey] + 0.8 * 0.94) / np.pi) + 0.5 * f_grey
    assert (f < 0.7 * f_recursive).all()


def test_port_refuses_a_nested_mix():
    with pytest.raises(NotImplementedError, match="mix of mixes"):
        tbuild(tload(_scene_text("", (OUTER,), NESTED)), device="cpu")
