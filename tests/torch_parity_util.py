"""Shared helpers for the port's parity tests (tests/test_torch_*.py): the
JAX package's built scene as the plain arrays ``pbrt_torch.interop``
takes, the tiny built-in scene's text at a chosen size, and the tiny
scene with every ported light and quadric added."""

from __future__ import annotations

import re

import numpy as np

_GEOMETRY = ("tri_v0", "tri_e1", "tri_e2", "tri_n0", "tri_n1", "tri_n2",
             "tri_uv0", "tri_uv1", "tri_uv2", "tri_material",
             "tri_area_light", "tri_mesh_id", "quad_type", "quad_o2w",
             "quad_w2o", "quad_params", "quad_material", "quad_area_light",
             "quad_mesh_id", "quad_reverse", "wide_rows")
_LIGHTS = ("type", "emit", "pos", "dirw", "cos_total", "cos_falloff", "shape_kind",
           "quad_idx", "tri_start", "tri_count", "cdf_offset", "total_area", "tri_cdf")


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
    out.update(
        mat_n_lobes=a(mt.n_lobes), mat_lobe_type=a(mt.lobe_type),
        mat_active_lobes=np.asarray(mt.active_lobes), mat_kd=a(mt.kd),
        mat_ks=a(mt.ks), mat_kr=a(mt.kr), mat_exp_u=a(mt.exp_u),
        mat_eta=a(mt.eta),
        **{f"light_{k}": a(getattr(lt, k)) for k in _LIGHTS},
        cam_raster_to_camera=a(cam.raster_to_camera),
        cam_to_world=a(cam.cam_to_world.m_start),
        cam_lens_radius=a(cam.lens_radius),
        cam_focal_distance=a(cam.focal_distance),
        cam_shutter_open=a(cam.shutter_open),
        cam_shutter_close=a(cam.shutter_close), cam_fov=cam.fov_deg,
        film_xres=fc.xres, film_yres=fc.yres, film_n_bins=fc.n_bins,
        filter_kind=fc.filter.kind, filter_xwidth=fc.filter.xwidth,
        filter_ywidth=fc.filter.ywidth,
    )
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
