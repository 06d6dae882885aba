"""Shared helpers for the port's parity tests (tests/test_torch_*.py): the
JAX package's built scene as the plain arrays ``pbrt_torch.interop``
takes, the tiny built-in scene's text at a chosen size, the tiny scene
with every ported light and quadric added, and the tiny scene made a
materials-and-environment scene."""

from __future__ import annotations

import re

import numpy as np
import torch

# The tier runs these tests in several pytest-xdist workers on one
# machine, and every worker imports this module while it collects. With
# torch's default of one intra-op thread per core in every worker, the
# threads oversubscribe the cores and each parallel op waits for threads
# that are not running: beside five busy workers, one Metropolis test took
# 68 s with the default and 2.2 s with one thread. One thread per worker.
torch.set_num_threads(1)

_GEOMETRY = ("tri_v0", "tri_e1", "tri_e2", "tri_n0", "tri_n1", "tri_n2",
             "tri_uv0", "tri_uv1", "tri_uv2", "tri_material",
             "tri_area_light", "tri_mesh_id", "quad_type", "quad_o2w",
             "quad_w2o", "quad_params", "quad_material", "quad_area_light",
             "quad_mesh_id", "quad_reverse")
#: the world table (None where every triangle is instanced), the motion
#: and instancing fields, None in a scene without them
_GEOMETRY_OPTIONAL = ("wide_rows", "tri_motion", "tri_n_motion", "motion_time", "wide_motion",
                      "inst_rows", "inst_o2w", "inst_w2o", "inst_root", "inst_lo",
                      "inst_hi", "inst_mesh_id")
_LIGHTS = ("type", "emit", "pos", "dirw", "cos_total", "cos_falloff", "shape_kind",
           "quad_idx", "tri_start", "tri_count", "cdf_offset", "total_area", "tri_cdf",
           "l2w", "w2l", "env_id", "env_map", "lmap_id", "lmap", "proj_screen",
           "proj_invtan")
_MATERIALS = ("kind", "n_lobes", "lobe_type", "kd", "ks", "kr", "kt", "sigma", "exp_u",
              "exp_v", "eta", "eta_spec", "k_spec", "irreg_offset", "irreg_count",
              "merl_offset", "irreg_points", "irreg_spectra", "merl_rgb", "ss_sigma_a",
              "ss_sigma_s", "ss_scale", "mix_m1", "mix_m2", "mix_amt", "kd_tex", "ks_tex",
              "sigma_tex", "bump_tex", "normal_tex")
_TEXTURES = ("kind", "mapping", "uv_xform", "world_to_tex", "c1", "c2", "f1", "f2", "ref1",
             "ref2", "img_offset", "img_w", "img_h", "img_level_off", "img_n_levels",
             "pool_rgb", "perm")
_ENV_DIST = ("func", "cond_cdf", "cond_int", "marg_func", "marg_cdf", "marg_int")
_VOLUMES = ("kind", "w2v", "lo", "hi", "sigma_a", "sigma_s", "le", "g", "exp_a", "exp_b",
            "updir", "grid_offset", "grid_n", "pool")
_INTEGRATOR = ("kind", "max_depth", "strategy", "rr_depth", "ao_nsamples", "ao_maxdist",
               "metadata_channel", "volume_kind", "n_bins", "ic_minweight", "ic_minspacing",
               "ic_maxspacing", "ic_maxangle", "ic_stride", "prt_nsamples")
#: the preprocess products' fields, by scene field and array prefix
_PREPROCESS = {"subsurface": ("ss", ("points", "normals", "areas", "E", "material")),
               "photons": ("ph", ("p", "wi", "alpha", "is_caustic", "valid", "radius")),
               "vpls": ("vpl", ("p", "n", "contrib", "valid")),
               "prt": ("prt", ("c_in", "lmax")),
               "probes": ("probe", ("lo", "hi", "coeffs", "lmax"))}


def tiny_scene_text(xres=16, yres=16, spp=2, max_depth=4) -> str:
    """``__graft_entry__._tiny_builtin_scene``'s text at the given size."""
    import __graft_entry__

    src = open(__graft_entry__.__file__).read()
    text = re.search(r'text = f"""(.*?)"""', src, re.S).group(1)
    text = (text.replace("{xres}", str(xres)).replace("{yres}", str(yres))
            .replace("{spp}", str(spp)))
    return text.replace('"integer maxdepth" [4]',
                        f'"integer maxdepth" [{max_depth}]')


def jax_scene_arrays(built) -> dict:
    """A ``pbrt_tpu.scene.builder.BuiltScene`` → the dict of
    ``pbrt_torch.interop.scene_from_numpy``."""
    g, mt = built.scene.geometry, built.scene.materials
    lt, cam, fc = built.scene.lights, built.camera, built.film_config
    a = np.asarray
    out = {k: a(getattr(g, k)) for k in _GEOMETRY}
    out["wide_stack"] = g.wide_stack
    out.update({k: None if getattr(g, k) is None else a(getattr(g, k))
                for k in _GEOMETRY_OPTIONAL})
    out["inst_stack"] = g.inst_stack if g.inst_rows is not None else None
    c2w = cam.cam_to_world
    out.update(jax_camera_arrays(cam))
    out.update(film_kind=fc.kind, film_focal_length=fc.focal_length, film_f_stop=fc.f_stop,
               renderer_name=built.renderer_name,
               renderer_params=dict(built.renderer_params.entries),
               renderer_search_dir=built.renderer_params.search_dir)
    if not c2w.is_static:
        out.update(cam_T=a(c2w.T), cam_R=a(c2w.R), cam_S=a(c2w.S), cam_times=a(c2w.times),
                   cam_to_world_end=a(c2w.m_end))
    out.update(
        mat_active_lobes=np.asarray(mt.active_lobes),
        **{f"mat_{k}": a(getattr(mt, k)) for k in _MATERIALS},
        **{f"light_{k}": a(getattr(lt, k)) for k in _LIGHTS},
        **{f"light_env_{k}": a(getattr(lt.env_dist, k)) for k in _ENV_DIST},
        light_world_center=a(lt.world_center), light_world_radius=a(lt.world_radius),
        **{f"light_power_{k}": a(getattr(lt.power_dist, k)) for k in ("func", "cdf", "func_int")},
        **{f"tex_{k}": a(getattr(built.scene.textures, k)) for k in _TEXTURES},
        has_textures=built.scene.has_textures, pixel_spread=built.scene.pixel_spread,
        film_xres=fc.xres, film_yres=fc.yres, film_n_bins=fc.n_bins,
        filter_kind=fc.filter.kind, filter_xwidth=fc.filter.xwidth,
        filter_ywidth=fc.filter.ywidth,
        **{f"icfg_{k}": getattr(built.integrator, k) for k in _INTEGRATOR},
    )
    for field, (prefix, names) in _PREPROCESS.items():
        obj = getattr(built.scene, field)
        if obj is not None:
            out.update({f"{prefix}_{k}": a(getattr(obj, k)) for k in names})
    vt = built.scene.volumes
    if built.scene.has_volumes:
        out.update({f"vol_{k}": a(getattr(vt, k)) for k in _VOLUMES})
    return out


def jax_camera_arrays(cam) -> dict:
    """Any JAX camera → ``cam_class`` and ``cam_<field>`` for each of its
    fields (``pbrt_torch.interop.camera_from_numpy``), ``cam_to_world``
    its shutter-open keyframe."""
    import dataclasses

    from pbrt_torch.interop import camera_key

    out = {"cam_class": type(cam).__name__}
    for f in dataclasses.fields(cam):
        v = getattr(cam, f.name)
        out[camera_key(f.name)] = np.asarray(v.m_start if f.name == "cam_to_world" else v)
    return out


#: what ``lights_scene_text`` adds to the tiny scene: a point, a spot and a
#: distant light, an emissive two-triangle quad facing down (besides the
#: tiny scene's sphere light) and a disk, cylinder, cone, paraboloid and
#: hyperboloid
LIGHTS_AND_QUADRICS = """
LightSource "point" "rgb I" [3 3 3] "point from" [1.5 2 -2]
AttributeBegin
  Translate 0 0.5 0
  LightSource "spot" "rgb I" [12 12 12] "point from" [-1 2.5 -1] "point to" [0 -1 0]
    "float coneangle" [25] "float conedeltaangle" [8]
AttributeEnd
LightSource "distant" "rgb L" [.6 .5 .4] "point from" [1 2 -1] "point to" [0 0 0]
AttributeBegin
  AreaLightSource "area" "rgb L" [5 5 5]
  Material "matte" "color Kd" [0 0 0]
  Shape "trianglemesh" "point P" [-3 2.5 -1  -1 2.5 -1  -1 2.5 1  -3 2.5 1]
    "integer indices" [0 1 2 0 2 3]
AttributeEnd
AttributeBegin
  Material "matte" "color Kd" [.2 .5 .3]
  AttributeBegin
    Translate -2.2 -0.4 0.6
    Rotate -70 1 0 0
    Shape "disk" "float radius" [.6] "float innerradius" [.15] "float height" [.1]
  AttributeEnd
  AttributeBegin
    Translate -1.3 -1 2
    Rotate -90 1 0 0
    Shape "cylinder" "float radius" [.35] "float zmin" [0] "float zmax" [1.2]
      "float phimax" [300]
  AttributeEnd
  AttributeBegin
    Translate 1.4 -1 2.2
    Rotate -90 1 0 0
    Shape "cone" "float radius" [.5] "float height" [1.3]
  AttributeEnd
  AttributeBegin
    Translate 0.2 -1 2.6
    Rotate -90 1 0 0
    Shape "paraboloid" "float radius" [.5] "float zmin" [0] "float zmax" [1]
  AttributeEnd
  AttributeBegin
    Translate -0.6 0.2 -1.6
    Rotate -90 1 0 0
    Scale .25 .25 .25
    Shape "hyperboloid" "float zmin" [-1.5] "float zmax" [1.5]
  AttributeEnd
AttributeEnd
"""


def lights_scene_text(xres=16, yres=16, spp=1, max_depth=4, integrator="path") -> str:
    """The tiny scene with ``LIGHTS_AND_QUADRICS`` added and the given
    surface integrator."""
    text = tiny_scene_text(xres, yres, spp, max_depth)
    text = text.replace('SurfaceIntegrator "path"', f'SurfaceIntegrator "{integrator}"')
    return text.replace("WorldBegin", "WorldBegin\n" + LIGHTS_AND_QUADRICS, 1)


#: what ``materials_scene_text`` adds to the tiny scene: the infinite,
#: projection and goniometric lights of ``chip_smoke.MATERIALS_AND_ENV``
#: (the same generated maps), an uber back wall, two rows of small spheres
#: in shinymetal, anisoward, Oren–Nayar matte, translucent, a mix of a
#: named plastic and a named glass and both measured formats, and the
#: generated blob (2,880 triangles) in metal at roughness .001
MATERIALS_AND_ENV = """
AttributeBegin
  Rotate -90 1 0 0
  LightSource "infinite" "rgb L" [1 1 1] "string mapname" ["@DIR@/env.exr"]
AttributeEnd
AttributeBegin
  Translate -.5 3 -1.5
  Rotate 90 1 0 0
  LightSource "projection" "rgb I" [40 40 40] "float fov" [30]
    "string mapname" ["@DIR@/projection.exr"]
AttributeEnd
AttributeBegin
  Translate 1.2 1.5 -2.5
  LightSource "goniometric" "rgb I" [5 5 5] "string mapname" ["@DIR@/gonio.exr"]
AttributeEnd
MakeNamedMaterial "red plastic" "string type" ["plastic"] "color Kd" [.6 .1 .1]
  "color Ks" [.3 .3 .3] "float roughness" [.02]
MakeNamedMaterial "clear glass" "string type" ["glass"] "float index" [1.5]
AttributeBegin
  Material "uber" "color Kd" [.3 .3 .3] "color Ks" [.2 .2 .2] "color Kr" [.2 .2 .2]
    "color Kt" [.3 .3 .3] "float roughness" [.05] "float index" [1.5]
  Shape "trianglemesh" "point P" [-8 -1 4  8 -1 4  8 5 4  -8 5 4] "integer indices" [0 2 1 0 3 2]
AttributeEnd
@SPHERES@
AttributeBegin
  Material "metal" "float roughness" [.001]
  Translate -1.6 -1 .8
  Rotate -90 1 0 0
  Scale .012 .012 .012
  @BLOB@
AttributeEnd
"""
_SPHERE_MATERIALS = (
    'Material "shinymetal" "color Ks" [.8 .6 .3] "color Kr" [.5 .5 .5] "float roughness" [.05]',
    'Material "anisoward" "color Kd" [.2 .3 .5] "color Ks" [.4 .4 .4] "float alphaU" [.05] '
    '"float alphaV" [.3]',
    'Material "matte" "color Kd" [.7 .7 .5] "float sigma" [20]',
    'Material "translucent" "color Kd" [.5 .6 .4] "color Ks" [.3 .3 .3] '
    '"color reflect" [.5 .5 .5] "color transmit" [.5 .5 .5] "float roughness" [.1]',
    'Material "mix" "string namedmaterial1" ["red plastic"] '
    '"string namedmaterial2" ["clear glass"] "float amount" [.3]',
    'Material "measured" "string filename" ["@DIR@/generated.brdf"]',
    'Material "measured" "string filename" ["@DIR@/generated.merl"]',
)
#: the spheres' centres, radius .45 on the floor (y = −1), in two rows: as
#: large as the frame allows, since a sphere's normal carries the hit
#: point's rounding times t/r, and a glossy lobe carries that times its
#: exponent
_SPHERE_AT = ((-.95, -2.0), (0, -2.0), (.95, -2.0), (-1.5, -.6), (-.5, -.6), (.5, -.6),
              (1.5, -.6))


def materials_scene_text(directory: str, xres=16, yres=16, max_depth=3,
                         integrator="path") -> str:
    """The tiny scene with ``MATERIALS_AND_ENV`` added (the generated files
    in ``directory``), its floor in substrate and its plastic sphere in
    glass, moved back behind the spheres; the mirror sphere stays."""
    import chip_smoke

    P, idx = chip_smoke.blob_mesh(chip_smoke.SMALL_BLOB_FREQ)
    blob = ('Shape "trianglemesh" "point P" [' + " ".join(f"{v:.6g}" for v in P.ravel())
            + '] "integer indices" [' + " ".join(map(str, idx.ravel())) + "]")
    spheres = "".join(f"AttributeBegin\n  {m}\n  Translate {x} -.55 {z}\n"
                      f"  Shape \"sphere\" \"float radius\" [.45]\nAttributeEnd\n"
                      for m, (x, z) in zip(_SPHERE_MATERIALS, _SPHERE_AT))
    extra = MATERIALS_AND_ENV.replace("@SPHERES@", spheres).replace("@BLOB@", blob)
    text = tiny_scene_text(xres, yres, 1, max_depth)
    text = text.replace('SurfaceIntegrator "path"', f'SurfaceIntegrator "{integrator}"')
    text = text.replace('Material "matte" "color Kd" [.6 .6 .6]',
                        'Material "substrate" "color Kd" [.5 .5 .8] "color Ks" [.5 .5 .5] '
                        '"float uroughness" [.05] "float vroughness" [.05]')
    text = text.replace('Material "plastic" "color Kd" [.4 .2 .2] "color Ks" [.5 .5 .5]\n'
                        '        "float roughness" [.05]',
                        'Material "glass" "float index" [1.5]\n      Translate 0 0 1.6')
    text = text.replace("WorldBegin", "WorldBegin\n" + extra, 1)
    return text.replace("@DIR@", directory)


#: what ``texture_scene_text`` adds to the tiny scene: goldens/metal.pbrt's
#: floor textures at the tiny scale (an imagemap Kd, a scaled imagemap bump
#: map), a checkerboard, a normal map and dots; a quad with the normal map
#: and one in a mix of a named matte with dotted Kd and a named plastic
#: with checkered Ks (images under @DIR@/textures, from
#: ``chip_smoke.write_texture_data``). Quads, not spheres: a float32 sphere
#: hit rounds differently under XLA's contracted multiply-adds, and near a
#: silhouette a normal map carries that past the stated tolerance
TEXTURES = """
Texture "tmap" "color" "imagemap" "string filename" ["@DIR@/textures/lines.exr"]
  "float uscale" [6] "float vscale" [6]
Texture "tbump-tex" "float" "imagemap" "string filename" ["@DIR@/textures/lines.exr"]
  "float uscale" [6] "float vscale" [6]
Texture "sbump" "float" "scale" "texture tex1" "tbump-tex" "float tex2" [-.02]
Texture "checks" "color" "checkerboard" "float uscale" [8] "float vscale" [4]
  "rgb tex1" [.8 .2 .1] "rgb tex2" [.1 .2 .7]
Texture "nmap" "color" "imagemap" "string filename" ["@DIR@/textures/normal.exr"]
  "float uscale" [2] "float vscale" [2]
Texture "dots" "color" "dots" "float uscale" [6] "float vscale" [6] "rgb tex1" [.9 .8 .2]
  "rgb tex2" [.2 .4 .6]
MakeNamedMaterial "dotted" "string type" ["matte"] "texture Kd" "dots"
MakeNamedMaterial "checked" "string type" ["plastic"] "color Kd" [.1 .1 .1]
  "texture Ks" "checks" "float roughness" [.08]
AttributeBegin
  Material "matte" "color Kd" [.6 .6 .6] "texture normalmap" "nmap"
  Shape "trianglemesh" "point P" [-3.4 -1 .6  -1.3 -1 -.4  -1.3 1.2 -.4  -3.4 1.2 .6]
    "integer indices" [0 1 2 0 2 3] "float uv" [0 0 1 0 1 1 0 1]
AttributeEnd
AttributeBegin
  Material "mix" "string namedmaterial1" ["dotted"] "string namedmaterial2" ["checked"]
    "float amount" [.4]
  Shape "trianglemesh" "point P" [-1.3 -1 -2.1  -.2 -1 -2.5  -.2 .1 -2.5  -1.3 .1 -2.1]
    "integer indices" [0 1 2 0 2 3] "float uv" [0 0 1 0 1 1 0 1]
AttributeEnd
"""


def texture_scene_text(directory: str, xres=16, yres=16, max_depth=3,
                       integrator="path") -> str:
    """The tiny scene with ``TEXTURES`` added, its floor in substrate with
    the imagemap Kd and the bump map (and uv over it), its plastic sphere in
    the checkerboard."""
    text = tiny_scene_text(xres, yres, 1, max_depth)
    text = text.replace('SurfaceIntegrator "path"', f'SurfaceIntegrator "{integrator}"')
    text = text.replace('Material "matte" "color Kd" [.6 .6 .6]',
                        'Material "substrate" "texture Kd" "tmap" "color Ks" [.5 .5 .5]\n'
                        '  "float uroughness" [.05] "float vroughness" [.05] '
                        '"texture bumpmap" "sbump"')
    text = text.replace('"integer indices" [0 1 2 2 3 0]',
                        '"integer indices" [0 1 2 2 3 0] "float uv" [0 0 1 0 1 1 0 1]', 1)
    text = text.replace('Material "plastic" "color Kd" [.4 .2 .2]',
                        'Material "plastic" "texture Kd" "checks"')
    text = text.replace("WorldBegin", "WorldBegin\n" + TEXTURES, 1)
    return text.replace("@DIR@", directory)


def write_absorption_curve(path) -> str:
    """A smooth two-column water absorption curve over 395–715 nm (λ, 1/m
    scaled to scene units), the stand-in for the fork's data file."""
    lam = np.linspace(395.0, 715.0, 33)
    sigma = 0.02 + 0.3 / (1.0 + np.exp(-(lam - 600.0) / 25.0))
    np.savetxt(path, np.stack([lam, sigma], -1), fmt="%.6f")
    return str(path)


def fog_scene_text(volume_integrator="emission", xres=8, yres=8, spp=1, sampler="lowdiscrepancy",
                   volume=None, renderer="") -> str:
    """A camera in a fog box looking at a lit matte quad: a point light,
    ``directlighting`` depth 1, a homogeneous region that absorbs,
    scatters (g 0.3) and emits, under ``volume_integrator``; ``volume``
    replaces the region's line."""
    volume = volume or ('Volume "homogeneous" "point p0" [-5 -5 -5] "point p1" [5 5 5] '
                        '"spectrum sigma_a" [395 .2 715 .3] "spectrum sigma_s" [395 .25 715 .1] '
                        '"spectrum Le" [395 .05 715 .02] "float g" [.3]')
    return f"""
LookAt 0 0 -3  0 0 0  0 1 0
Camera "perspective" "float fov" [40]
Film "image" "integer xresolution" [{xres}] "integer yresolution" [{yres}]
Sampler "{sampler}" "integer pixelsamples" [{spp}]
{renderer}
SurfaceIntegrator "directlighting" "integer maxdepth" [1]
VolumeIntegrator "{volume_integrator}"
WorldBegin
LightSource "point" "rgb I" [6 6 6] "point from" [0.5 1 -1]
{volume}
Material "matte" "spectrum Kd" [395 .8 715 .8]
Shape "trianglemesh" "point P" [-10 -10 2  10 -10 2  10 10 2  -10 10 2]
  "integer indices" [0 1 2 2 3 0]
WorldEnd
"""


def subsurface_scene_text(integrator: str, xres=8, yres=8, spp=1, max_depth=2,
                          room: bool = False) -> str:
    """The tiny scene with ``chip_smoke.SUBSURFACE_BOXES`` (and its
    ``SUBSURFACE_ROOM``) under ``integrator`` (the directive's name and
    parameters after ``SurfaceIntegrator``)."""
    from chip_smoke import SUBSURFACE_BOXES, SUBSURFACE_ROOM

    text = tiny_scene_text(xres, yres, spp, max_depth)
    text = re.sub(r'SurfaceIntegrator "path" "integer maxdepth" \[\d+\]',
                  f"SurfaceIntegrator {integrator}", text)
    return text.replace("WorldEnd", SUBSURFACE_BOXES + (SUBSURFACE_ROOM if room else "")
                        + "WorldEnd")


def scan_loop(film_state, scene, camera, filter_table, xs_stack, ys_stack, mask_stack,
              sample_base, root_key, icfg, sampler_name, spp, film_cfg, n_waves,
              diff_scale=None):
    """The JAX sampler's ``_render_scan_jit``: its ``lax.scan`` over (wave,
    chunk) steps as the loop it runs, each ``render_wave`` run eagerly."""
    from pbrt_tpu.renderers import sampler as jsampler

    C = xs_stack.shape[0]
    for step in range(n_waves * C):
        ci = step % C
        film_state = jsampler.render_wave(
            film_state, scene, camera, filter_table, xs_stack[ci], ys_stack[ci],
            sample_base + step // C, root_key, icfg, sampler_name, spp, film_cfg,
            sample_scale=mask_stack[ci], sorted_pixels=True, diff_scale=diff_scale)
    return film_state


def jax_integrator_pieces():
    """A context in which the JAX package's integrators run eagerly with
    their per-step pieces compiled once each (traversal, surface
    interaction, lanes' materials and their BSDF, light sampling, the
    shadow rays, the dipole's, photons' and VPLs' gathers, keys' uniforms)
    and its sampler's scan as a loop: compiled whole, each integrator takes
    XLA tens of seconds per scene."""
    import contextlib
    from unittest import mock

    import jax

    import pbrt_tpu.integrators.dipole as jdip
    import pbrt_tpu.integrators.igi as jigi
    import pbrt_tpu.integrators.irradiance as jirr
    import pbrt_tpu.integrators.path as jpath
    import pbrt_tpu.integrators.photonmap as jpm
    import pbrt_tpu.lights.table as jlt
    import pbrt_tpu.materials.table as jmt
    from pbrt_tpu.accel import intersect as jisect
    from pbrt_tpu.core import interaction as jinter
    from pbrt_tpu.core import rng as jrng
    from pbrt_tpu.renderers import sampler as jsampler

    isect = jax.jit(jisect.intersect, static_argnames=("any_hit",))
    si = jax.jit(jinter.surface_interaction, static_argnames=("spread",))
    patches = [(m, "intersect", isect) for m in (jpath, jpm, jigi, jirr)]
    patches += [(m, "surface_interaction", si) for m in (jpath, jpm, jigi, jirr)]
    patches += [(jmt, k, jax.jit(getattr(jmt, k)))
                for k in ("gather_lane", "bsdf_sample", "bsdf_f", "bsdf_pdf", "has_delta_only")]
    patches += [(jlt, k, jax.jit(getattr(jlt, k)))
                for k in ("sample_li", "sample_le", "emitted_radiance", "pdf_li_hit",
                          "le_escaped", "pdf_li")]
    patches += [(jpath, "_shadow_unoccluded", jax.jit(jpath._shadow_unoccluded)),
                (jdip, "mo_gather", jax.jit(jdip.mo_gather)),
                (jpm, "radiance_estimate", jax.jit(jpm.radiance_estimate,
                                                   static_argnames=("caustic_only",))),
                (jigi, "vpl_lighting", jax.jit(jigi.vpl_lighting,
                                               static_argnames=("n_vpl_samples", "g_limit"))),
                (jrng, "uniform_per", jax.jit(jrng.uniform_per, static_argnums=1)),
                (jsampler, "_render_scan_jit", scan_loop)]
    stack = contextlib.ExitStack()
    for mod, name, fn in patches:
        stack.enter_context(mock.patch.object(mod, name, fn))
    return stack


#: a matte floor under a constant sky and a small sphere light, a dark
#: blocker above it, a plastic and a mirror sphere (``prt_scene_text``)
PRT_SCENE = """
LookAt 0 3 -6  0 0 0  0 1 0
Camera "perspective" "float fov" [40]
Film "image" "integer xresolution" [{xres}] "integer yresolution" [{yres}]
Sampler "lowdiscrepancy" "integer pixelsamples" [{spp}]
SurfaceIntegrator {integrator}
{renderer}
WorldBegin
LightSource "infinite" "rgb L" [.6 .7 .8]
{lights}
AttributeBegin
  Translate 1.5 3 -1
  AreaLightSource "area" "rgb L" [8 8 8]
  Material "matte" "color Kd" [0 0 0]
  Shape "sphere" "float radius" [.4]
AttributeEnd
{floor}
Shape "trianglemesh" "point P" [-4 0 -4  4 0 -4  4 0 4  -4 0 4]
  "integer indices" [0 1 2 2 3 0]
AttributeBegin
  Material "matte" "color Kd" [.1 .1 .1]
  Translate 0 .8 0
  Shape "trianglemesh" "point P" [-1 0 -1  1 0 -1  1 0 1  -1 0 1]
    "integer indices" [0 1 2 2 3 0]
AttributeEnd
AttributeBegin
  Material "plastic" "color Kd" [.4 .2 .2] "color Ks" [.4 .4 .4] "float roughness" [.1]
  Translate -1.6 .5 .5
  Shape "sphere" "float radius" [.5]
AttributeEnd
AttributeBegin
  Material "mirror" "color Kr" [.8 .8 .8]
  Translate 1.4 .45 1
  Shape "sphere" "float radius" [.45]
AttributeEnd
WorldEnd
"""
#: the floor's material: plain, a mix of two mattes, a textured matte, or a
#: matte of the default kd
PRT_FLOORS = {
    "matte": 'Material "matte" "color Kd" [.6 .6 .6]',
    "mix": ('MakeNamedMaterial "bright" "string type" ["matte"] "color Kd" [.6 .6 .6]\n'
            'MakeNamedMaterial "dim" "string type" ["matte"] "color Kd" [.2 .3 .1]\n'
            'Material "mix" "string namedmaterial1" ["bright"] '
            '"string namedmaterial2" ["dim"] "color amount" [.5 .5 .5]'),
    "textured": ('Texture "checks" "spectrum" "checkerboard" "float uscale" [4] '
                 '"float vscale" [4] "color tex1" [.9 .9 .9] "color tex2" [.1 .1 .1]\n'
                 'Material "matte" "texture Kd" "checks"'),
    "default": 'Material "matte"',
}


def prt_scene_text(integrator: str, xres=8, yres=8, spp=1, floor="matte", lights="",
                   renderer="") -> str:
    """``PRT_SCENE`` under ``integrator`` (the directive's name and
    parameters), its floor one of ``PRT_FLOORS``, ``lights`` more light
    lines, ``renderer`` a ``Renderer`` line."""
    return PRT_SCENE.format(xres=xres, yres=yres, spp=spp, integrator=integrator,
                            renderer=renderer, lights=lights, floor=PRT_FLOORS[floor])


def jax_area_rows_like_port():
    """A context in which the JAX package reads a hit area light's emission
    and MIS pdf from row ``area_row0 + area_light`` of its light table, as
    the port does (it reads row ``area_light``, whose rows start with the
    ``LightSource`` lights: test_torch_lights.py shows it), so scenes with
    both kinds compare; the lookups it wraps are the ones in place when it
    is entered. Nothing in the JAX package changes."""
    import contextlib
    from unittest import mock

    import jax.numpy as jnp

    import pbrt_tpu.lights.table as jlt

    emit, pdf = jlt.emitted_radiance, jlt.pdf_li_hit

    def shift(lt, idx):
        types = np.asarray(lt.type)
        row0 = int(np.argmax(types == jlt.AREA)) if (types == jlt.AREA).any() else len(types)
        return jnp.where(idx >= 0, idx + row0, idx)

    stack = contextlib.ExitStack()
    stack.enter_context(mock.patch.object(
        jlt, "emitted_radiance", lambda lt, idx, *a: emit(lt, shift(lt, idx), *a)))
    stack.enter_context(mock.patch.object(
        jlt, "pdf_li_hit", lambda lt, g, idx, *a: pdf(lt, g, shift(lt, idx), *a)))
    return stack
