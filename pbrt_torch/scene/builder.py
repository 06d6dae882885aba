"""Scene flattener: SceneDescription → device-ready ``BuiltScene``.

Port of the slices' part of ``pbrt_tpu/scene/builder.py:150`` (reference:
RenderOptions::MakeScene / MakeRenderer, api.cpp:1309-1440): triangle
meshes become one world-space triangle soup, quadrics a quadric table, the
triangles get the native SAH tree collapsed into 8-wide rows, materials
and lights become tables, and the camera, film, filter, sampler and
integrator are configured.

What the slices cover: ``trianglemesh``, the refined shapes
(``heightfield``, ``loopsubdiv`` and ``nurbs``, triangulated on the host
as the JAX package does, builder.py:66-78) and the six quadrics (sphere,
cylinder, disk, cone, paraboloid, hyperboloid); every material of the JAX
package, ``mix`` of two named materials included, with Kd, Ks, bump and
normal maps bound to textures; the texture records visible to every
material, as one texture table (every kind under the uv, spherical and
planar mappings); point, spot, distant, infinite (constant or lat-long
mapped), projection and goniometric lights; diffuse area lights on every
shape (a quadric's sampled as a sphere of its radius, as the JAX package
does, builder.py:1004-1006); every camera (perspective, orthographic, pinhole,
environment, and the fork's realistic, ideal-diffraction and eye lens
cameras), static or animated, with the lens metadata of the film header;
the ``Renderer`` directive, recorded for ``renderers/dispatch.py``;
every filter; the ``lowdiscrepancy``, ``halton``, ``bestcandidate``,
``random``, ``stratified`` and ``adaptive`` samplers (their parameters kept
for the renderer); the ``path``, ``directlighting``, ``whitted``,
``ambientocclusion``, ``metadata``, ``dipolesubsurface``, ``igi``,
``photonmap`` (and ``exphotonmap``), ``irradiancecache``, ``useprobes``,
``diffuseprt`` and ``glossyprt`` integrators, the preprocess of the
dipole, igi, photonmap and the PRT kinds (and useprobes' probe file) run
at the end of the build (``preprocess``); the homogeneous,
exponential, volumegrid and water volumes as one volume table, under the
``emission`` or ``single`` volume integrator (any other name renders as
``emission``, as in the JAX package, builder.py:732-733); the
accelerators: the BVH with SAH, ``middle`` or ``equal`` splits (one wide
table over the triangles, quadrics tested densely), and the ``kdtree``
(``kdtreeaccel``) and ``grid`` built over every primitive's bounds,
quadrics included, with no wide table (builder.py:520-582).

Motion blur and instancing as the JAX package builds them (builder.py:
154-518): an animated mesh keeps its start triangles plus their
shutter-end deltas (one motion interval per scene, the last animated
shape's), an animated quadric warns and keeps its start transform, and
the world table is built over the union of both keyframes' bounds. An
object used by at least two static ``ObjectInstance``s, with no quadric
and no area light, keeps one object-space copy and its own table (the
instance table has a row and a fresh mesh id per use) under the BVH;
every other use, and every use under a kd-tree or grid, is flattened into
world shapes. Names the JAX package does not know fall back as there
(ROADMAP fact 53): an accelerator to the BVH and a split method to SAH,
a surface integrator to ``path``, without a word; a shape (an instanced
object's without a word) and a ``LightSource`` are skipped with the JAX
package's warning; an area light is one whatever its name. An unknown
shape takes no area-light id, where the JAX package gives it one and
builds no row for it (fact 54, repaired). Four cases raise
``NotImplementedError`` instead of rendering something different: a mix
whose sub-material is a mix (the JAX package renders the inner mix
black), cylindrical texture mapping (evaluated as planar there), texture
references nested deeper than one level (read as 0 there), and photonmap
or useprobes on a mix lane. A light map that fails to load warns and the light is
constant, and an image texture that fails to load warns and is black, as
in the JAX package.
"""

from __future__ import annotations

import collections
import dataclasses
import struct
import zlib

import numpy as np
import torch

from pbrt_torch import resolve_device
from pbrt_torch.accel import bvh as bvh_mod
from pbrt_torch.accel.grid import build_grid
from pbrt_torch.accel.kdtree import build_kdtree
from pbrt_torch.accel.intersect import (CONE, CYLINDER, DISK, HYPERBOLOID,
                                        PARABOLOID, SPHERE, SceneGeometry)
from pbrt_torch.accel.wide import LEAF_TRIS, build_wide_bvh
from pbrt_torch.cameras.cameras import make_camera
from pbrt_torch.core import sampling as smp
from pbrt_torch.core import spectrum as spec
from pbrt_torch.core import transform as xf
from pbrt_torch.core.filters import make_filter
from pbrt_torch.film.film import FilmConfig
from pbrt_torch.film.imageio import read_image
from pbrt_torch.integrators import dipole, igi, photonmap
from pbrt_torch.integrators import prt as prt_mod
from pbrt_torch.integrators.irradiance import ProbeGrid
from pbrt_torch.integrators.path import KINDS, IntegratorConfig, RenderScene
from pbrt_torch.lights import table as lt_mod
from pbrt_torch.materials.table import build_material_table
from pbrt_torch.media.volumes import build_volume_table
from pbrt_torch.renderers.probes import read_probe_file
from pbrt_torch.scene.api import SceneDescription
from pbrt_torch.scene.paramset import ParamSet
from pbrt_torch.shapes.loopsubdiv import refine_loopsubdiv
from pbrt_torch.shapes.mesh import make_heightfield, make_mesh
from pbrt_torch.shapes.nurbs import refine_nurbs
from pbrt_torch.textures.texture import build_texture_table
from pbrt_torch.utils import error as err


@dataclasses.dataclass
class BuiltScene:
    scene: RenderScene
    camera: object
    film_config: FilmConfig
    filter_table: torch.Tensor  # (16, 16) on the device
    sampler_name: str
    pixel_samples: int
    integrator: IntegratorConfig
    device: torch.device
    description: SceneDescription
    #: the scene's ``Renderer`` directive (api.cpp:1333-1420)
    renderer_name: str = "sampler"
    renderer_params: ParamSet | None = None
    #: the ``Sampler`` directive's parameters (adaptive's counts and method)
    sampler_params: ParamSet = dataclasses.field(default_factory=ParamSet)


#: the shapes refined into triangle meshes on the host (builder.py:66-78)
MESH_SHAPES = {"trianglemesh": make_mesh, "loopsubdiv": refine_loopsubdiv,
               "heightfield": make_heightfield, "nurbs": refine_nurbs}
#: the accelerators (builder.py:172): the wide BVH, or a kd-tree or grid
KD_NAMES = ("kdtree", "kdtreeaccel")
ACCELERATORS = ("bvh",) + KD_NAMES + ("grid",)


def _mesh_triangles(rec, o2w):
    """A mesh-shaped record (``MESH_SHAPES``) at ``o2w`` → (v0, e1, e2,
    (n0, n1, n2), (uv0, uv1, uv2)) per triangle, in the mesh's float32,
    with face normals where it has none (builder.py:235-276)."""
    mesh = MESH_SHAPES[rec.shape_type](rec.params, o2w, rec.reverse_orientation)
    idx, p = mesh.indices, mesh.positions
    v0 = p[idx[:, 0]]
    e1 = p[idx[:, 1]] - v0
    e2 = p[idx[:, 2]] - v0
    if mesh.normals is not None:
        ns = tuple(mesh.normals[idx[:, k]] for k in range(3))
    else:
        fn = np.cross(e1, e2)
        fn /= np.maximum(np.linalg.norm(fn, axis=-1, keepdims=True), 1e-20)
        if rec.reverse_orientation:
            fn = -fn
        ns = (fn, fn, fn)
    if mesh.uvs is not None:
        uvs = tuple(mesh.uvs[idx[:, k]] for k in range(3))
    else:
        z = np.zeros((len(idx), 2), np.float32)
        uvs = (z, z + [1.0, 0.0], z + [1.0, 1.0])
    return v0, e1, e2, ns, uvs


def _expand_instances(desc, accel_is_bvh: bool = True):
    """Shape records with both keyframe transforms, and the static uses
    that keep a shared object (builder.py:154-201): under the BVH an object
    qualifies when it has ≥ 2 static uses, only meshes, no animated record
    and no area light; every other use is flattened (instance × object
    transform at each keyframe). → ([(rec, o2w_start, o2w_end)],
    [(name, o2w)])."""
    records = [(rec, rec.object_to_world.m[0], rec.object_to_world.m[1])
               for rec in desc.shapes]
    uses = collections.Counter(i.name for i in desc.instances)

    def shared(name):
        recs = desc.objects.get(name, [])
        return bool(recs) and uses[name] >= 2 and accel_is_bvh and all(
            rec.shape_type not in _QUADRIC_TYPES and rec.area_light is None
            and np.allclose(rec.object_to_world.m[0], rec.object_to_world.m[1], atol=1e-12)
            for rec in recs)

    tlas_uses = []
    for inst in desc.instances:
        m0, m1 = inst.instance_to_world.m
        if np.allclose(m0, m1, atol=1e-12) and shared(inst.name):
            tlas_uses.append((inst.name, m0))
            continue
        for rec in desc.objects.get(inst.name, []):
            records.append((rec, m0 @ rec.object_to_world.m[0], m1 @ rec.object_to_world.m[1]))
    return records, tlas_uses


def _instance_tables(desc, tlas_uses, T, mat_id_for, tri):
    """Each shared object's object-space triangles appended to ``tri``
    after the T world ones, its table built at its row offset with ids from
    T on, and the instance table (builder.py:372-499). → the geometry's
    ``inst_*`` fields, as numpy arrays of their dtypes."""
    obj_info, blas_rows, row_off = {}, [], 0
    for name in dict.fromkeys(n for n, _ in tlas_uses):
        ov0, oe1, oe2 = [], [], []
        for rec in desc.objects[name]:
            if rec.shape_type not in MESH_SHAPES:
                continue  # skipped without a word, as builder.py:391-393 skips it
            v0, e1, e2, ns, uvs = _mesh_triangles(rec, rec.object_to_world.m[0])
            cnt = len(v0)
            for k, a in (("v0", v0), ("e1", e1), ("e2", e2), ("n0", ns[0]), ("n1", ns[1]),
                         ("n2", ns[2]), ("uv0", uvs[0]), ("uv1", uvs[1]), ("uv2", uvs[2])):
                tri[k].append(np.asarray(a, np.float32))
            tri["mat"].append(np.full(cnt, mat_id_for(rec.material), np.int64))
            tri["al"].append(np.full(cnt, -1, np.int64))
            tri["mid"].append(np.full(cnt, rec.primitive_id, np.int64))
            tri["dv"].append(np.zeros((cnt, 9), np.float32))
            tri["dn"].append(np.zeros((cnt, 9), np.float32))
            ov0.append(v0.astype(np.float32))
            oe1.append(e1.astype(np.float32))
            oe2.append(e2.astype(np.float32))
        o_v0, o_e1, o_e2 = np.concatenate(ov0), np.concatenate(oe1), np.concatenate(oe2)
        lo_o = np.minimum(np.minimum(o_v0, o_v0 + o_e1), o_v0 + o_e2)
        hi_o = np.maximum(np.maximum(o_v0, o_v0 + o_e1), o_v0 + o_e2)
        tree = bvh_mod.build_bvh(lo_o, hi_o, max_prims_in_node=LEAF_TRIS)
        wide = build_wide_bvh(tree, o_v0, o_e1, o_e2, row_base=row_off, pid_base=T)
        obj_info[name] = dict(root=row_off, stack=wide.max_stack,
                              lo=lo_o.min(axis=0), hi=hi_o.max(axis=0))
        blas_rows.append(wide.rows)
        row_off += len(wide.rows)
        T += len(o_v0)
    # each use its own mesh id (TransformedPrimitive's primitiveId)
    mid_base = 1 + max([int(r.primitive_id) for r in desc.shapes]
                       + [int(r.primitive_id) for rs in desc.objects.values() for r in rs]
                       + [0])
    boxes = [xf.apply_bbox(m, obj_info[n]["lo"], obj_info[n]["hi"]) for n, m in tlas_uses]
    # child refs and triangle ids are offset values kept in f32: guard the
    # concatenated totals
    assert row_off < (1 << 24), "instance BLAS row offset exceeds f32"
    assert T < (1 << 24), "instanced triangle id exceeds exact-f32"
    return dict(
        inst_rows=np.concatenate(blas_rows),
        inst_o2w=np.stack([m.astype(np.float32) for _, m in tlas_uses]),
        inst_w2o=np.stack([np.linalg.inv(m).astype(np.float32) for _, m in tlas_uses]),
        inst_root=np.asarray([obj_info[n]["root"] for n, _ in tlas_uses], np.int32),
        inst_lo=np.stack([lo.astype(np.float32) for lo, _ in boxes]),
        inst_hi=np.stack([hi.astype(np.float32) for _, hi in boxes]),
        inst_mesh_id=np.arange(mid_base, mid_base + len(tlas_uses), dtype=np.int64),
        inst_stack=max([info["stack"] for info in obj_info.values()] + [8]),
    )


_QUADRIC_TYPES = {"sphere": SPHERE, "cylinder": CYLINDER, "disk": DISK,
                  "cone": CONE, "paraboloid": PARABOLOID, "hyperboloid": HYPERBOLOID}


def _quadric_params(rec) -> np.ndarray:
    """(8,) radius, zmin, zmax, phimax, height, inner radius, hyperboloid a
    and c, as the JAX package's ``_quadric_params`` (builder.py:81-119)."""
    p = rec.params
    prm = np.zeros(8, np.float32)
    st = rec.shape_type
    phimax = np.deg2rad(p.find_one_float("phimax", 360.0))
    if st == "sphere":
        r = p.find_one_float("radius", 1.0)
        prm[0] = r
        prm[1] = p.find_one_float("zmin", -r)
        prm[2] = p.find_one_float("zmax", r)
        prm[3] = phimax
    elif st == "cylinder":
        prm[0] = p.find_one_float("radius", 1.0)
        prm[1] = p.find_one_float("zmin", -1.0)
        prm[2] = p.find_one_float("zmax", 1.0)
        prm[3] = phimax
    elif st == "disk":
        prm[0] = p.find_one_float("radius", 1.0)
        prm[3] = phimax
        prm[4] = p.find_one_float("height", 0.0)
        prm[5] = p.find_one_float("innerradius", 0.0)
    elif st == "cone":
        prm[0] = p.find_one_float("radius", 1.0)
        prm[3] = phimax
        prm[4] = p.find_one_float("height", 1.0)
        prm[1], prm[2] = 0.0, prm[4]
    elif st == "paraboloid":
        prm[0] = p.find_one_float("radius", 1.0)
        prm[1] = p.find_one_float("zmin", 0.0)
        prm[2] = p.find_one_float("zmax", 1.0)
        prm[3] = phimax
        prm[4] = prm[2]
    else:  # hyperboloid: the JAX package's canonical x² + y² − z² = 1
        prm[0] = 1.0
        prm[1] = p.find_one_float("zmin", -1.0)
        prm[2] = p.find_one_float("zmax", 1.0)
        prm[3] = phimax
        prm[6], prm[7] = 1.0, 1.0
    return prm


def _quadric_bounds(qtype: int, prm: np.ndarray, o2w: np.ndarray):
    """A quadric's world bounds: its object box by its transform
    (builder.py:122-143)."""
    r = float(prm[0])
    if qtype in (SPHERE, CYLINDER):
        lo, hi = np.array([-r, -r, prm[1]]), np.array([r, r, prm[2]])
    elif qtype == DISK:
        lo, hi = np.array([-r, -r, prm[4] - 1e-4]), np.array([r, r, prm[4] + 1e-4])
    elif qtype == CONE:
        lo, hi = np.array([-r, -r, 0.0]), np.array([r, r, prm[4]])
    elif qtype == PARABOLOID:
        lo = np.array([-r, -r, min(prm[1], prm[2])])
        hi = np.array([r, r, max(prm[1], prm[2])])
    else:
        m = max(r, abs(prm[1]), abs(prm[2])) * 2.0
        lo, hi = np.array([-m, -m, prm[1]]), np.array([m, m, prm[2]])
    return xf.apply_bbox(o2w, lo, hi)


def _read_light_map(path: str, what: str):
    """The map's (H, W, C) linear RGB, or None with a warning where it does
    not load (the JAX package then keeps the light constant)."""
    try:
        return read_image(path)
    except (OSError, ValueError, KeyError, IndexError, struct.error, zlib.error) as e:
        err.warning(f"{what} {path!r}: {e}; using constant")
        return None


def _light_source_row(rec, cfg) -> dict:
    """One ``LightSource`` as a light-table row (builder.py:878-992)."""
    p = rec.params
    l2w = rec.light_to_world
    t = rec.light_type
    if t in ("point", "spot"):
        I = p.find_one_spectrum("I", 1.0, "illuminant") * p.find_one_float("scale", 1.0)
        frm = p.find_one_point("from", (0.0, 0.0, 0.0))
        pos = frm @ l2w[:3, :3].T + l2w[:3, 3]
        if t == "point":
            return dict(type=lt_mod.POINT, emit=I, pos=pos, l2w=l2w)
        tow = p.find_one_point("to", (0.0, 0.0, 1.0)) @ l2w[:3, :3].T + l2w[:3, 3]
        d = tow - pos
        d = d / max(np.linalg.norm(d), 1e-12)
        cone = p.find_one_float("coneangle", 30.0)
        delta = p.find_one_float("conedeltaangle", 5.0)
        return dict(type=lt_mod.SPOT, emit=I, pos=pos, dirw=d, l2w=l2w,
                    cos_total=np.cos(np.deg2rad(cone)),
                    cos_falloff=np.cos(np.deg2rad(cone - delta)))
    if t == "distant":
        L = p.find_one_spectrum("L", 1.0, "illuminant") * p.find_one_float("scale", 1.0)
        frm = p.find_one_point("from", (0.0, 0.0, 0.0))
        to = p.find_one_point("to", (0.0, 0.0, 1.0))
        d = (to - frm) @ l2w[:3, :3].T
        return dict(type=lt_mod.DISTANT, emit=L, dirw=d / max(np.linalg.norm(d), 1e-12),
                    l2w=l2w)
    if t == "infinite":
        L = p.find_one_spectrum("L", 1.0, "illuminant") * p.find_one_float("scale", 1.0)
        # infinite.cpp:60-77: the map's texels are scaled by L.ToRGB() and
        # read back as illuminant spectra, and a constant light's L takes
        # the same RGB roundtrip (a white L becomes RGB (1.202, .947, .905))
        L_rgb = spec.to_rgb(torch.as_tensor(np.asarray(L, np.float32)), cfg).numpy()
        mapname = p.find_one_filename("mapname", "")
        img = _read_light_map(mapname, "infinite light map") if mapname else None
        if img is not None:
            try:
                img = img * L_rgb[None, None, :]
            except ValueError as e:  # a 2- or 4-channel map
                err.warning(f"infinite light map {mapname!r}: {e}; using constant")
                img = None
        if img is not None:
            env = spec.from_rgb(img, "illuminant", cfg)
            return dict(type=lt_mod.INFINITE, emit=np.ones(cfg.n_bins, np.float32),
                        l2w=l2w, env=env)
        # float32, as the JAX package keeps it: the light's power is its mean
        emit = np.asarray(spec.from_rgb(np.maximum(L_rgb, 0.0).astype(np.float32), "illuminant",
                                        cfg), np.float32)
        return dict(type=lt_mod.INFINITE, emit=emit, l2w=l2w)
    if t in ("projection", "goniometric"):
        I = p.find_one_spectrum("I", 1.0, "illuminant") * p.find_one_float("scale", 1.0)
        mapname = p.find_one_filename("mapname", "")
        rgb = _read_light_map(mapname, "light map") if mapname else None
        img = (spec.from_rgb(rgb, "illuminant", cfg) if rgb is not None
               else np.ones((1, 1, cfg.n_bins), np.float32))
        row = dict(emit=I, pos=l2w[:3, 3], l2w=l2w, lmap=img)
        if t == "goniometric":
            return dict(row, type=lt_mod.GONIO)
        # the perspective screen window (projection.cpp constructor)
        fov = p.find_one_float("fov", 45.0)
        aspect = img.shape[1] / img.shape[0]
        screen = ((-aspect, aspect, -1.0, 1.0) if aspect > 1.0
                  else (-1.0, 1.0, -1.0 / aspect, 1.0 / aspect))
        return dict(row, type=lt_mod.PROJECTION, proj_screen=screen,
                    proj_invtan=1.0 / np.tan(0.5 * np.deg2rad(fov)))
    err.warning(f"light {t!r} not supported yet; skipped")
    return None


def _stack_maps(lmaps, S):
    """Projection / goniometric maps stacked at their common (largest)
    size, each resized by host bilinear interpolation (builder.py:843)."""
    if not lmaps:
        return np.ones((1, 1, 1, S), np.float32)
    Hm = max(m.shape[0] for m in lmaps)
    Wm = max(m.shape[1] for m in lmaps)
    out = []
    for m in lmaps:
        if m.shape[:2] != (Hm, Wm):
            ys = np.clip((np.arange(Hm) + 0.5) * m.shape[0] / Hm - 0.5, 0, m.shape[0] - 1)
            xs = np.clip((np.arange(Wm) + 0.5) * m.shape[1] / Wm - 0.5, 0, m.shape[1] - 1)
            y0 = np.floor(ys).astype(int)
            y1 = np.minimum(y0 + 1, m.shape[0] - 1)
            x0 = np.floor(xs).astype(int)
            x1 = np.minimum(x0 + 1, m.shape[1] - 1)
            fy = (ys - y0)[:, None, None]
            fx = (xs - x0)[None, :, None]
            m = (m[y0][:, x0] * (1 - fy) * (1 - fx) + m[y0][:, x1] * (1 - fy) * fx
                 + m[y1][:, x0] * fy * (1 - fx) + m[y1][:, x1] * fy * fx)
        out.append(m.astype(np.float32))
    return np.stack(out)


def _light_table(rows: list, n_bins: int, dev, world_lo, world_hi) -> lt_mod.LightTable:
    """Light-table rows (``LightSource`` rows first, then area lights) →
    the device table, laid out as the JAX package's ``_build_lights``
    (builder.py:1014-1113), with the scene's bounding sphere and the
    light-power distribution (builder.py:874-875, :1052). A scene without
    lights gets an empty table (and a power distribution of one row)."""
    L = len(rows)
    typ = np.zeros(L, np.int64)
    l2w = np.tile(np.eye(4, dtype=np.float32), (L, 1, 1))
    emit = np.zeros((L, n_bins), np.float32)
    pos = np.zeros((L, 3), np.float32)
    dirw = np.tile(np.asarray([0, 0, 1], np.float32), (L, 1))
    cos_total = np.full(L, -1.0, np.float32)
    cos_falloff = np.full(L, -1.0, np.float32)
    shape_kind, quad_idx, tri_start, tri_count, cdf_offset = (
        np.zeros(L, np.int64) for _ in range(5))
    total_area = np.ones(L, np.float32)
    env_id = np.full(L, -1, np.int64)
    lmap_id = np.full(L, -1, np.int64)
    proj_screen = np.tile(np.asarray([-1.0, 1.0, -1.0, 1.0], np.float32), (L, 1))
    proj_invtan = np.ones(L, np.float32)
    cdfs, lmaps, env_map = [], [], None
    power = np.ones(max(L, 1), np.float32)
    for i, r in enumerate(rows):
        typ[i] = r["type"]
        power[i] = max(float(np.mean(r["emit"])), 1e-6)
        l2w[i] = r.get("l2w", np.eye(4))
        emit[i] = r["emit"]
        pos[i] = r.get("pos", (0, 0, 0))
        dirw[i] = r.get("dirw", (0, 0, 1))
        cos_total[i] = r.get("cos_total", -1.0)
        cos_falloff[i] = r.get("cos_falloff", -1.0)
        shape_kind[i] = r.get("shape_kind", 0)
        quad_idx[i] = r.get("quad_idx", 0)
        if r.get("shape_kind") == lt_mod.SHAPE_MESH:
            tri_start[i] = r["tri_start"]
            tri_count[i] = r["tri_count"]
            cdf_offset[i] = sum(len(c) for c in cdfs)
            areas = r["areas"]
            total_area[i] = float(areas.sum())
            cdfs.append(np.cumsum(areas) / max(areas.sum(), 1e-20))
        # one env map per table: a later mapped light stays at its L of
        # ones, unmapped (the JAX package's rule)
        if r.get("env") is not None and env_map is None:
            env_map = r["env"]
            env_id[i] = 0
        if r.get("lmap") is not None:
            lmap_id[i] = len(lmaps)
            lmaps.append(r["lmap"])
            proj_screen[i] = r.get("proj_screen", (-1.0, 1.0, -1.0, 1.0))
            proj_invtan[i] = r.get("proj_invtan", 1.0)
    tri_cdf = np.concatenate(cdfs).astype(np.float32) if cdfs else np.zeros(1, np.float32)
    if env_map is None:
        env_map = np.ones((1, 1, n_bins), np.float32)
        env_lum = np.ones((1, 1), np.float32)
    else:
        env_lum = env_map.mean(axis=-1) + 1e-6
    t = lambda a, dt=torch.float32: torch.as_tensor(np.asarray(a), dtype=dt, device=dev)
    i64 = torch.int64
    return lt_mod.LightTable(
        type=t(typ, i64), emit=t(emit), pos=t(pos), dirw=t(dirw),
        cos_total=t(cos_total), cos_falloff=t(cos_falloff),
        shape_kind=t(shape_kind, i64), quad_idx=t(quad_idx, i64),
        tri_start=t(tri_start, i64), tri_count=t(tri_count, i64),
        cdf_offset=t(cdf_offset, i64), total_area=t(total_area), tri_cdf=t(tri_cdf),
        l2w=t(l2w), w2l=t(np.linalg.inv(l2w)), env_id=t(env_id, i64), env_map=t(env_map),
        env_dist=smp.Distribution2D.build(env_lum, dev), lmap_id=t(lmap_id, i64),
        lmap=t(_stack_maps(lmaps, n_bins)), proj_screen=t(proj_screen),
        proj_invtan=t(proj_invtan), world_center=t(0.5 * (world_lo + world_hi)),
        world_radius=t(np.float32(np.linalg.norm(world_hi - world_lo) * 0.5 + 1e-6)),
        power_dist=smp.Distribution1D.build(power, dev),
    )


def _mix_rows(mat_records, mat_id_for, named) -> dict:
    """{row of a ``mix`` record: (row of namedmaterial1, of namedmaterial2)}
    (builder.py:631-652): sub-materials used by no shape get rows of their
    own; a name that is not found warns and takes the mix's own row, as in
    the JAX package. A sub-material that is itself a mix is refused."""
    rows = {}
    for i, m in enumerate(list(mat_records)):
        if m.mat_type != "mix":
            continue
        pair = []
        for pname in ("namedmaterial1", "namedmaterial2"):
            nm = m.params.find_one_string(pname, "")
            sub = named.get(nm)
            if sub is None or sub is m:
                err.warning(f"mix material: named material {nm!r} not found")
                pair.append(i)
            elif sub.mat_type == "mix":
                raise NotImplementedError(f"a mix of mixes ({nm!r} in {m.name!r}) is not "
                                          "ported (the JAX package renders the inner mix "
                                          "black)")
            else:
                pair.append(mat_id_for(sub))
        rows[i] = tuple(pair)
    return rows


#: the ``SurfaceIntegrator`` names and the kinds they render
#: (builder.py:716-730): ``exphotonmap`` is ``photonmap``
INTEGRATOR_NAMES = {**{k: k for k in KINDS}, "exphotonmap": "photonmap"}


#: the precomputed-transfer kinds, and their cap on samples per hit and on
#: the projection's rays (builder.py:743-747, :760-764)
PRT_KINDS = ("diffuseprt", "glossyprt")
PRT_MAX_PER_HIT = 64
PRT_MAX_PROJECTION = 4096


def _integrator_config(name: str, params, n_bins: int,
                       volume_name: str = "emission") -> IntegratorConfig:
    """The ``SurfaceIntegrator`` as an ``IntegratorConfig`` (builder.py:
    716-750): ``nsamples`` is ambient occlusion's sample count and the
    irradiance cache's gather count, ``maxdist`` ambient occlusion's, the
    metadata channel is read from ``strategy`` as the JAX package reads it,
    the irradiance cache reads ``minweight``, ``minpixelspacing``,
    ``maxpixelspacing`` and ``maxangledifference``, ``diffuseprt`` and
    ``glossyprt`` take min(``nsamples``, 64) samples per hit (default
    4,096), and any ``VolumeIntegrator`` but ``single`` is ``emission``."""
    kind = INTEGRATOR_NAMES.get(name, "path")  # any other name renders path (:717-731)
    prt_kind = kind in PRT_KINDS
    return IntegratorConfig(
        kind=kind, max_depth=params.find_one_int("maxdepth", 5),
        strategy=params.find_one_string("strategy", "all"),
        ao_nsamples=params.find_one_int("nsamples", 4),
        ao_maxdist=params.find_one_float("maxdist", 1e30),
        metadata_channel=params.find_one_string("strategy", "depth"),
        volume_kind="single" if volume_name == "single" else "emission",
        n_bins=n_bins,
        prt_nsamples=min(params.find_one_int("nsamples", 4096), PRT_MAX_PER_HIT) if prt_kind
        else 32,
        ic_minweight=params.find_one_float("minweight", 0.5),
        ic_minspacing=params.find_one_float("minpixelspacing", 2.5),
        ic_maxspacing=params.find_one_float("maxpixelspacing", 15.0),
        ic_maxangle=params.find_one_float("maxangledifference", 10.0),
    )


def preprocess(built: "BuiltScene", params) -> "BuiltScene":
    """The preprocess of ``igi``, ``photonmap``, ``dipolesubsurface``,
    ``diffuseprt`` / ``glossyprt`` and ``useprobes`` on the built scene's
    device (builder.py:755-827), with the JAX package's parameters:
    ``nlights`` (paths max(4·nlights, 256)) and ``maxdepth``;
    ``indirectphotons`` (paths min(max(n / 16, 1024), 8192)) and
    ``maxphotondepth``; the dipole's 4,096 points of seed 0, with no
    points file (``minsampledistance`` and ``maxerror`` are not read); the
    PRT projection's lmax (default 4) and max(min(``nsamples``, 4,096), 16)
    rays of seed 0; the probe file ``filename`` (without one, useprobes
    warns and renders as ``irradiancecache``)."""
    kind = built.integrator.kind
    scene = built.scene
    if kind in PRT_KINDS:
        scene = dataclasses.replace(scene, prt=prt_mod.project_incident_radiance(
            scene, built.integrator, lmax=params.find_one_int("lmax", 4),
            nsamples=min(params.find_one_int("nsamples", 4096), PRT_MAX_PROJECTION)))
    elif kind == "useprobes":
        path = params.find_one_filename("filename", "")
        if not path:
            err.warning("useprobes without a probe file; falling back to irradiancecache "
                        "behavior")
            return dataclasses.replace(built, integrator=dataclasses.replace(
                built.integrator, kind="irradiancecache"))
        lmax, lo, hi, dims, coeffs = read_probe_file(path, built.film_config.n_bins)
        f32 = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=built.device)
        scene = dataclasses.replace(scene, probes=ProbeGrid(
            lo=f32(lo), hi=f32(hi), coeffs=f32(coeffs.reshape(dims + coeffs.shape[1:])),
            lmax=lmax))
    elif kind == "igi":
        vpls = igi.generate_vpls(scene, n_paths=max(params.find_one_int("nlights", 64) * 4, 256),
                                 max_depth=params.find_one_int("maxdepth", 5))
        scene = dataclasses.replace(scene, vpls=vpls, has_vpls=True)
    elif kind == "photonmap":
        n_ind = params.find_one_int("indirectphotons", 100000)
        photons = photonmap.shoot_photons(scene, n_paths=min(max(n_ind // 16, 1024), 8192),
                                          max_depth=params.find_one_int("maxphotondepth", 5))
        scene = dataclasses.replace(scene, photons=photons, has_photons=True)
    elif kind == "dipolesubsurface":
        ss = dipole.prepare_subsurface(built)
        if ss is not None:
            scene = dataclasses.replace(scene, subsurface=ss, has_subsurface=True)
    return dataclasses.replace(built, scene=scene)


def build(desc: SceneDescription, device=None) -> BuiltScene:
    """Flatten ``desc`` onto ``device`` (None → the CUDA device; raises
    without one)."""
    dev = resolve_device(device)
    cfg = desc.spectral_config
    S = cfg.n_bins
    accel_name, accel_params = desc.accelerator
    if accel_name not in ACCELERATORS:
        accel_name = "bvh"  # pbrt's MakeScene falls back to its BVH (builder.py:525-545)
    accel_is_bvh = accel_name == "bvh"
    split = accel_params.find_one_string("splitmethod", "sah")
    if split not in bvh_mod.SPLIT_METHODS:
        split = "sah"  # builder.py:527-529

    mat_records, mat_index = [], {}

    def mat_id_for(m):
        if id(m) not in mat_index:
            mat_index[id(m)] = len(mat_records)
            mat_records.append(m)
        return mat_index[id(m)]

    shape_records, tlas_uses = _expand_instances(desc, accel_is_bvh)
    tri = {k: [] for k in ("v0", "e1", "e2", "n0", "n1", "n2", "uv0", "uv1",
                           "uv2", "mat", "al", "mid", "dv", "dn")}
    quads, area_lights = [], []
    n_tris = 0
    any_motion, motion_times = False, (0.0, 1.0)
    for rec, o2w, o2w_end in shape_records:
        animated = not np.allclose(o2w, o2w_end, atol=1e-12)
        mat_i = mat_id_for(rec.material)
        known = rec.shape_type in MESH_SHAPES or rec.shape_type in _QUADRIC_TYPES
        # the area light's name is never read (builder.py:233-234); an
        # unknown shape takes no area-light id (ROADMAP fact 54)
        al_id = len(area_lights) if rec.area_light is not None and known else -1
        if rec.shape_type in MESH_SHAPES:
            v0, e1, e2, (n0, n1, n2), uvs = _mesh_triangles(rec, o2w)
            count = len(v0)
            for k, a in (("v0", v0), ("e1", e1), ("e2", e2), ("n0", n0),
                         ("n1", n1), ("n2", n2), ("uv0", uvs[0]), ("uv1", uvs[1]),
                         ("uv2", uvs[2])):
                tri[k].append(np.asarray(a, np.float32))
            tri["mat"].append(np.full(count, mat_i, np.int64))
            tri["al"].append(np.full(count, al_id, np.int64))
            tri["mid"].append(np.full(count, rec.primitive_id, np.int64))
            if animated:
                # shutter-end deltas of [v0, e1, e2] and of the normals
                # (builder.py:278-308); the interval is this shape's
                any_motion, motion_times = True, tuple(rec.transform_times[:2])
                v0e, e1e, e2e, (n0e, n1e, n2e), _ = _mesh_triangles(rec, o2w_end)
                tri["dv"].append(np.concatenate([v0e - v0, e1e - e1, e2e - e2],
                                                axis=1).astype(np.float32))
                tri["dn"].append(np.concatenate([n0e - n0, n1e - n1, n2e - n2],
                                                axis=1).astype(np.float32))
            else:
                tri["dv"].append(np.zeros((count, 9), np.float32))
                tri["dn"].append(np.zeros((count, 9), np.float32))
            if al_id >= 0:
                area_lights.append(dict(
                    rec=rec, shape_kind=lt_mod.SHAPE_MESH, tri_start=n_tris,
                    tri_count=count,
                    areas=0.5 * np.linalg.norm(np.cross(e1, e2), axis=-1)))
            n_tris += count
        elif rec.shape_type in _QUADRIC_TYPES:
            if animated:
                err.warning(f"animated quadric {rec.shape_type!r}: motion blur is "
                            "supported for meshes only; using the start transform")
            qtype = _QUADRIC_TYPES[rec.shape_type]
            quads.append(dict(
                type=qtype, o2w=o2w.astype(np.float64), params=_quadric_params(rec),
                mat=mat_i, al=al_id, mid=rec.primitive_id,
                reverse=rec.reverse_orientation ^ xf.swaps_handedness(o2w),
            ))
            if al_id >= 0:
                # every quadric's light is sampled as a sphere of its radius
                # (builder.py:1004-1006; ROADMAP Queue 3, fact 2)
                area_lights.append(dict(rec=rec, shape_kind=lt_mod.SHAPE_SPHERE,
                                        quad_idx=len(quads) - 1))
        else:
            err.warning(f"shape {rec.shape_type!r} not supported yet; skipped")

    T_world, Q = n_tris, len(quads)
    inst = {}
    if tlas_uses:
        inst = _instance_tables(desc, tlas_uses, T_world, mat_id_for, tri)

    def cat(k, width, dtype=np.float32):
        if tri[k]:
            return np.concatenate(tri[k]).astype(dtype)
        return np.zeros((0,) + width, dtype)

    v0, e1, e2 = cat("v0", (3,)), cat("e1", (3,)), cat("e2", (3,))
    dv = cat("dv", (9,))
    # every primitive's world bounds (builder.py:500-524): the world
    # triangles, on the union of the shutter's start and end bounds in a
    # motion scene, then the quadrics
    w_v0, w_e1, w_e2 = v0[:T_world], e1[:T_world], e2[:T_world]
    lo_t = np.minimum(np.minimum(w_v0, w_v0 + w_e1), w_v0 + w_e2)
    hi_t = np.maximum(np.maximum(w_v0, w_v0 + w_e1), w_v0 + w_e2)
    if any_motion and T_world:
        w_dv = dv[:T_world]
        v0e, e1e, e2e = w_v0 + w_dv[:, 0:3], w_e1 + w_dv[:, 3:6], w_e2 + w_dv[:, 6:9]
        lo_t = np.minimum(lo_t, np.minimum(np.minimum(v0e, v0e + e1e), v0e + e2e))
        hi_t = np.maximum(hi_t, np.maximum(np.maximum(v0e, v0e + e1e), v0e + e2e))
    lo_q, hi_q = np.zeros((Q, 3)), np.zeros((Q, 3))
    for i, q in enumerate(quads):
        lo_q[i], hi_q[i] = _quadric_bounds(q["type"], q["params"], q["o2w"])
    lo, hi = np.concatenate([lo_t, lo_q]), np.concatenate([hi_t, hi_q])
    wide_rows = wide_motion = wide_tbox = None
    wide_stack = 8
    accel = {}
    if accel_is_bvh and T_world:
        # the wide table over the world triangles [0, T_world)
        tree = bvh_mod.build_bvh(lo_t, hi_t, max_prims_in_node=LEAF_TRIS, method=split)
        wide = build_wide_bvh(tree, w_v0, w_e1, w_e2,
                              tri_motion=w_dv if any_motion else None)
        wide_rows, wide_motion, wide_stack = wide.rows, wide.motion_rows, wide.max_stack
        wide_tbox = wide.time_boxes
    elif not accel_is_bvh and len(lo):
        i32 = lambda a: torch.as_tensor(np.asarray(a, np.int32), device=dev)
        if accel_name in KD_NAMES:
            kd = build_kdtree(lo, hi,
                              isect_cost=accel_params.find_one_float("intersectcost", 80.0),
                              trav_cost=accel_params.find_one_float("traversalcost", 1.0),
                              empty_bonus=accel_params.find_one_float("emptybonus", 0.5),
                              max_prims=accel_params.find_one_int("maxprims", 8))
            accel = dict(accel_kind="kdtree",
                         kd_split=torch.as_tensor(kd.node_split, device=dev),
                         kd_axis=i32(kd.node_axis), kd_above=i32(kd.node_above),
                         kd_prim_off=i32(kd.node_prim_off), kd_prim_cnt=i32(kd.node_prim_cnt),
                         kd_prim_ids=i32(kd.prim_ids))
        else:
            gr = build_grid(lo, hi)
            accel = dict(accel_kind="grid", grid_dims=tuple(int(n) for n in gr.dims),
                         grid_off=i32(gr.voxel_off), grid_cnt=i32(gr.voxel_cnt),
                         grid_ids=i32(gr.prim_ids))
    # the scene's bound (builder.py:578-582): the kd-tree's and grid's clip
    # box, and aggregatetest's
    world_lo = lo.min(axis=0) if len(lo) else np.zeros(3)
    world_hi = hi.max(axis=0) if len(hi) else np.ones(3)
    if inst:
        world_lo = np.minimum(world_lo, inst["inst_lo"].min(axis=0))
        world_hi = np.maximum(world_hi, inst["inst_hi"].max(axis=0))

    t = lambda a, dt=torch.float32: torch.as_tensor(np.asarray(a), dtype=dt, device=dev)
    opt = lambda a, dt=torch.float32: None if a is None else t(a, dt)
    i64 = torch.int64
    o2ws = np.asarray([q["o2w"] for q in quads]).reshape(Q, 4, 4)
    geometry = SceneGeometry(
        tri_v0=t(v0), tri_e1=t(e1), tri_e2=t(e2),
        tri_n0=t(cat("n0", (3,))), tri_n1=t(cat("n1", (3,))),
        tri_n2=t(cat("n2", (3,))), tri_uv0=t(cat("uv0", (2,))),
        tri_uv1=t(cat("uv1", (2,))), tri_uv2=t(cat("uv2", (2,))),
        tri_material=t(cat("mat", (), np.int64), i64),
        tri_area_light=t(cat("al", (), np.int64), i64),
        tri_mesh_id=t(cat("mid", (), np.int64), i64),
        quad_type=t([q["type"] for q in quads], i64),
        quad_o2w=t(o2ws.astype(np.float32)),
        quad_w2o=t(np.linalg.inv(o2ws).astype(np.float32) if Q
                   else np.zeros((0, 4, 4), np.float32)),
        quad_params=t(np.asarray([q["params"] for q in quads],
                                 np.float32).reshape(Q, 8)),
        quad_material=t([q["mat"] for q in quads], i64),
        quad_area_light=t([q["al"] for q in quads], i64),
        quad_mesh_id=t([q["mid"] for q in quads], i64),
        quad_reverse=t([bool(q["reverse"]) for q in quads], torch.bool),
        wide_rows=opt(wide_rows), wide_stack=int(wide_stack),
        tri_motion=t(dv) if any_motion else None,
        tri_n_motion=t(cat("dn", (9,))) if any_motion else None,
        motion_time=t(np.asarray(motion_times, np.float32)) if any_motion else None,
        wide_motion=opt(wide_motion), wide_tbox=opt(wide_tbox),
        **{k: v if k == "inst_stack" else torch.as_tensor(v, device=dev)
           for k, v in inst.items()},
        world_lo=t(world_lo.astype(np.float32)), world_hi=t(world_hi.astype(np.float32)),
        **accel,
    )

    # the LightSource rows after the shapes, as the JAX package warns
    light_rows = [row for row in (_light_source_row(rec, cfg) for rec in desc.lights)
                  if row is not None]
    for al in area_lights:
        lp = al["rec"].area_light[1]
        light_rows.append(dict(
            al, type=lt_mod.AREA,
            emit=lp.find_one_spectrum("L", 1.0, "illuminant") * lp.find_one_float("scale", 1.0)))
    lights = _light_table(light_rows, S, dev, world_lo, world_hi)
    mix_rows = _mix_rows(mat_records, mat_id_for, desc.named_materials)
    # every material's texture environment, float records first, a
    # spectrum texture of the same name over it (builder.py:654-659)
    tex_records = {}
    for m in mat_records:
        tex_records.update(m.float_textures)
        tex_records.update(m.spectrum_textures)
    textures, tex_index = build_texture_table(tex_records, cfg, dev)
    materials = build_material_table(mat_records, cfg, dev, mix_rows, tex_index)
    volumes = build_volume_table(desc.volumes, cfg, dev) if desc.volumes else None
    scene = RenderScene(geometry=geometry, materials=materials, lights=lights,
                        textures=textures, volumes=volumes,
                        has_textures=bool(tex_records), has_volumes=bool(desc.volumes))

    film_name, film_params = desc.film
    filt = make_filter(
        desc.filter[0],
        {k: v[1][0] for k, v in desc.filter[1].entries.items() if v[1]},
    )
    crop = film_params.find_floats("cropwindow")
    film_cfg = FilmConfig(
        xres=film_params.find_one_int("xresolution", 640),
        yres=film_params.find_one_int("yresolution", 480),
        n_bins=S, filter=filt,
        crop=tuple(crop) if crop is not None else (0.0, 1.0, 0.0, 1.0),
        filename=film_params.find_one_string("filename", "pbrt.dat"),
        kind=film_name,
    )
    cam_name, cam_params, cam2world_ts, times = desc.camera
    c2w = xf.AnimatedTransform.from_matrices(cam2world_ts.m[0], cam2world_ts.m[1],
                                             times[0], times[1])
    camera = make_camera(cam_name, cam_params, c2w, film_cfg.xres,
                         film_cfg.yres, dev)
    # the film header's lens metadata, from the camera (builder.py:690-703)
    film_cfg = dataclasses.replace(film_cfg, fov=camera.fov_deg,
                                   focal_length=camera.focal_length_mm,
                                   f_stop=camera.f_stop)
    if 0.0 < camera.fov_deg < 360.0 and scene.has_textures:
        # the pixel cone over the shorter image axis (builder.py:704-711)
        res_short = max(min(film_cfg.xres, film_cfg.yres), 1)
        scene.pixel_spread = float(2.0 * np.tan(np.deg2rad(camera.fov_deg) / 2.0) / res_short)

    sampler_name, sampler_params = desc.sampler
    integrator = _integrator_config(*desc.surface_integrator, S, desc.volume_integrator[0])
    built = BuiltScene(
        scene=scene, camera=camera, film_config=film_cfg,
        filter_table=t(filt.table()), sampler_name=sampler_name,
        pixel_samples=sampler_params.find_one_int("pixelsamples", 4),
        integrator=integrator, device=dev, description=desc,
        renderer_name=desc.renderer[0], renderer_params=desc.renderer[1],
        sampler_params=sampler_params,
    )
    return preprocess(built, desc.surface_integrator[1])
