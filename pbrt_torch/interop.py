"""Carry a built scene and random keys across as plain arrays.

``key_from_numpy`` takes a threefry key's data — two uint32 words, as
``jax.random.key_data`` gives them, (2,) or (R, 2) — and returns the
port's key tensor (int64 words, ``pbrt_torch.core.rng``), so both packages
can be handed the same keys.

``scene_from_numpy`` takes a scene already flattened elsewhere — in the
tests, by the JAX package's builder — as numpy arrays keyed by field name,
and puts it on a device as the port's ``RenderScene``, camera and film
configuration. The integrator and the traversal can then be compared on
the very same arrays, independent of the port's own builder.

Keys (shapes as in the JAX package's tables):

- geometry: ``tri_v0 tri_e1 tri_e2 tri_n0 tri_n1 tri_n2`` (T, 3),
  ``tri_uv0 tri_uv1 tri_uv2`` (T, 2), ``tri_material tri_area_light
  tri_mesh_id`` (T,), ``quad_type quad_material quad_area_light
  quad_mesh_id quad_reverse`` (Q,), ``quad_o2w quad_w2o`` (Q, 4, 4),
  ``quad_params`` (Q, 8), ``wide_rows`` (M, 80, None where every
  triangle is instanced), ``wide_stack`` ();
  optionally, for motion blur, ``tri_motion tri_n_motion`` (T, 9),
  ``motion_time`` (2,), ``wide_motion`` (M, 80) (the port's time boxes,
  ``wide.time_boxes``, are built from the rows), and for instancing
  ``inst_rows`` (Mi, 80), ``inst_o2w inst_w2o`` (I, 4, 4), ``inst_root
  inst_mesh_id`` (I,), ``inst_lo inst_hi`` (I, 3), ``inst_stack`` ()
  (absent or None where the scene has none);
- materials: ``mat_kind mat_n_lobes`` (M,), ``mat_lobe_type`` (M, 4) as
  indices into ``mat_active_lobes`` (the JAX table's compact codes, -1
  pad), ``mat_kd mat_ks mat_kr mat_kt mat_eta_spec mat_k_spec
  mat_ss_sigma_a mat_ss_sigma_s mat_mix_amt`` (M, S), ``mat_sigma
  mat_exp_u mat_exp_v mat_eta mat_ss_scale mat_irreg_offset
  mat_irreg_count mat_merl_offset mat_mix_m1 mat_mix_m2`` (M,), the
  measured pools ``mat_irreg_points`` (P, 3), ``mat_irreg_spectra`` (P, S),
  ``mat_merl_rgb`` (Q, 3), the texture rows ``mat_kd_tex mat_ks_tex
  mat_sigma_tex mat_bump_tex mat_normal_tex`` (M,);
- textures: the texture table's fields as ``tex_<field>`` (the JAX
  package's ``TextureTable`` names: ``tex_kind tex_mapping tex_ref1
  tex_ref2 tex_f1 tex_f2 tex_img_offset tex_img_w tex_img_h
  tex_img_n_levels`` (K,), ``tex_uv_xform`` (K, 4), ``tex_world_to_tex``
  (K, 4, 4), ``tex_c1 tex_c2`` (K, S), ``tex_img_level_off`` (K, 14),
  ``tex_pool_rgb`` (P, 3), ``tex_perm`` (512,)), ``has_textures`` and
  ``pixel_spread`` ();
- lights: ``light_type light_shape_kind light_quad_idx light_tri_start
  light_tri_count light_cdf_offset light_env_id light_lmap_id`` (L,),
  ``light_cos_total light_cos_falloff light_total_area light_proj_invtan``
  (L,), ``light_pos light_dirw`` (L, 3), ``light_emit`` (L, S),
  ``light_l2w light_w2l`` (L, 4, 4), ``light_proj_screen`` (L, 4),
  ``light_tri_cdf`` (K,), ``light_env_map`` (H, W, S), ``light_lmap`` (P,
  Hm, Wm, S) and the env map's distribution as the JAX package built it,
  ``light_env_func`` (H, W), ``light_env_cond_cdf`` (H, W+1),
  ``light_env_cond_int light_env_marg_func`` (H,), ``light_env_marg_cdf``
  (H+1,), ``light_env_marg_int`` (); optionally the emission side,
  ``light_world_center`` (3,), ``light_world_radius`` () and the power
  distribution ``light_power_func`` (L,), ``light_power_cdf`` (L+1,),
  ``light_power_func_int`` (); rows in the JAX package's order:
  ``LightSource`` rows, then the area lights, a quadric's of shape kind
  ``SHAPE_SPHERE`` whatever its type (the JAX package's fact 2);
- camera: ``cam_class``, the JAX package's class name
  (``ProjectiveCamera``, ``PinholeCamera``, ``EnvironmentCamera``,
  ``RealisticDiffractionCamera``, ``IdealDiffractionCamera``,
  ``RealisticEyeCamera``), and each of its fields under ``camera_key``'s
  name (``cam_<field>``; ``cam_to_world`` the shutter-open keyframe,
  (4, 4)): for a projective camera ``cam_raster_to_camera`` (4, 4),
  ``cam_lens_radius cam_focal_distance cam_shutter_open
  cam_shutter_close cam_fov_deg`` () and ``cam_kind``; for the lens
  cameras the elements' (E,) arrays, the eye's ``ior_spectra`` (6, S),
  the offsets and the statics; for an animated camera also its keyframes
  decomposed, ``cam_T`` (2, 3), ``cam_R`` (2, 4), ``cam_S`` (2, 3, 3),
  ``cam_times`` (2,), and ``cam_to_world_end`` (4, 4);
- film: ``film_xres film_yres film_n_bins`` (), ``filter_kind`` (str),
  ``filter_xwidth filter_ywidth`` (), optionally ``film_kind`` (str) and
  the header's ``film_focal_length film_f_stop`` ();
- volumes, optionally (absent, None or with no region where the scene has
  none): the JAX package's ``VolumeTable`` fields as ``vol_<field>``,
  ``vol_kind`` (V,), ``vol_w2v`` (V, 4, 4), ``vol_lo vol_hi vol_updir``
  (V, 3), ``vol_sigma_a vol_sigma_s vol_le`` (V, S), ``vol_g vol_exp_a
  vol_exp_b vol_grid_offset`` (V,), ``vol_grid_n`` (V, 3), ``vol_pool``
  (P,).

- preprocess products, optionally (absent or None where the scene has
  none), as the JAX package's dataclasses hold them: the dipole's
  ``ss_points ss_normals`` (N, 3), ``ss_areas`` (N,), ``ss_E`` (N, S),
  ``ss_material`` (N,); the photon maps' ``ph_p ph_wi`` (N, 3),
  ``ph_alpha`` (N, S), ``ph_is_caustic ph_valid`` (N,), ``ph_radius`` ();
  the VPLs' ``vpl_p vpl_n`` (N, 3), ``vpl_contrib`` (N, S), ``vpl_valid``
  (N,); the PRT projection's ``prt_c_in`` (terms, S) and ``prt_lmax`` ();
  the probe grid's ``probe_lo probe_hi`` (3,), ``probe_coeffs`` (nx, ny,
  nz, terms, S) and ``probe_lmax`` ().

``integrator_from_numpy`` takes the JAX package's ``IntegratorConfig``
fields the port has, as ``icfg_<field>`` (``icfg_volume_kind`` among
them), and returns the port's.

``renderer_from_numpy`` takes ``renderer_name`` (str) and
``renderer_params`` (the ``Renderer`` directive's entries, name → (type,
values)) with ``renderer_search_dir`` and returns the port's pair.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from pbrt_torch.accel import wide
from pbrt_torch.accel.intersect import SceneGeometry
from pbrt_torch.cameras import cameras as cam_mod
from pbrt_torch.cameras.eye import RealisticEyeCamera
from pbrt_torch.cameras.realistic import IdealDiffractionCamera, RealisticDiffractionCamera
from pbrt_torch.core.sampling import Distribution1D, Distribution2D
from pbrt_torch.core.transform import AnimatedTransform
from pbrt_torch.core.filters import Filter
from pbrt_torch.film.film import FilmConfig
from pbrt_torch.integrators.dipole import SubsurfaceData
from pbrt_torch.integrators.igi import VPLSet
from pbrt_torch.integrators.irradiance import ProbeGrid
from pbrt_torch.integrators.path import IntegratorConfig, RenderScene
from pbrt_torch.integrators.photonmap import PhotonMaps
from pbrt_torch.integrators.prt import PRTData
from pbrt_torch.lights import table as lt_mod
from pbrt_torch.materials.table import MIXMAT, TEXTURE_COLUMNS, MaterialTable
from pbrt_torch.media.volumes import VolumeTable
from pbrt_torch.scene.paramset import ParamSet
from pbrt_torch.textures.texture import table_from_numpy

_GEOMETRY_F32 = ("tri_v0", "tri_e1", "tri_e2", "tri_n0", "tri_n1", "tri_n2",
                 "tri_uv0", "tri_uv1", "tri_uv2", "quad_o2w", "quad_w2o",
                 "quad_params")
_GEOMETRY_I64 = ("tri_material", "tri_area_light", "tri_mesh_id",
                 "quad_type", "quad_material", "quad_area_light",
                 "quad_mesh_id")
#: the world table (None where every triangle is instanced), then the
#: motion and instancing keys, each absent (or None) in a scene without
_GEOMETRY_OPTIONAL = {"wide_rows": np.float32, "tri_motion": np.float32, "tri_n_motion": np.float32,
                      "motion_time": np.float32, "wide_motion": np.float32,
                      "inst_rows": np.float32, "inst_o2w": np.float32,
                      "inst_w2o": np.float32, "inst_lo": np.float32,
                      "inst_hi": np.float32, "inst_root": np.int32,
                      "inst_mesh_id": np.int64, "world_lo": np.float32,
                      "world_hi": np.float32, "kd_split": np.float32, "kd_axis": np.int32,
                      "kd_above": np.int32, "kd_prim_off": np.int32, "kd_prim_cnt": np.int32,
                      "kd_prim_ids": np.int32, "grid_off": np.int32, "grid_cnt": np.int32,
                      "grid_ids": np.int32}
_MATERIAL_F32 = ("kd", "ks", "kr", "kt", "sigma", "exp_u", "exp_v", "eta", "eta_spec",
                 "k_spec", "irreg_points", "irreg_spectra", "merl_rgb", "ss_sigma_a",
                 "ss_sigma_s", "ss_scale", "mix_amt")
_MATERIAL_I64 = ("kind", "irreg_offset", "irreg_count", "merl_offset", "mix_m1", "mix_m2")
_LIGHT_F32 = ("emit", "pos", "dirw", "cos_total", "cos_falloff", "total_area", "tri_cdf",
              "l2w", "w2l", "env_map", "lmap", "proj_screen", "proj_invtan")
_LIGHT_I64 = ("tri_start", "tri_count", "cdf_offset", "env_id", "lmap_id")
_ENV_DIST = ("func", "cond_cdf", "cond_int", "marg_func", "marg_cdf", "marg_int")


CAMERA_CLASSES = {c.__name__: c for c in (
    cam_mod.ProjectiveCamera, cam_mod.PinholeCamera, cam_mod.EnvironmentCamera,
    RealisticDiffractionCamera, IdealDiffractionCamera, RealisticEyeCamera)}
#: camera fields that live on the device
_CAMERA_TENSORS = ("raster_to_camera", "cam_to_world", "ior_spectra")


def camera_key(field: str) -> str:
    """The array key of a camera field: ``cam_<field>``, and
    ``cam_to_world`` for the transform's shutter-open keyframe."""
    return field if field == "cam_to_world" else f"cam_{field}"


def _camera_field(name: str, value, dev):
    """One ``cam_<name>`` array → the port camera's field value: device
    tensors, host float32 (int32 for media) element arrays, tuples of
    numbers, or Python numbers."""
    a = np.asarray(value)
    if name in _CAMERA_TENSORS:
        return torch.as_tensor(a.astype(np.float32), device=dev)
    if name.startswith("el_"):
        return a.astype(np.int32 if name == "el_medium" else np.float32)
    if a.dtype.kind in "US":
        return str(a)
    if a.ndim:
        return tuple(v.item() for v in a)
    return a.item()


def camera_from_numpy(arrays: dict, device):
    """The port's camera from the ``cam_*`` arrays (see the module
    docstring), on ``device``."""
    dev = torch.device(device)
    cls = CAMERA_CLASSES[str(arrays["cam_class"])]
    camera = cls(**{f.name: _camera_field(f.name, arrays[camera_key(f.name)], dev)
                    for f in dataclasses.fields(cls) if camera_key(f.name) in arrays})
    if arrays.get("cam_T") is not None:
        m0, m1 = (np.asarray(arrays[k], np.float32) for k in ("cam_to_world", "cam_to_world_end"))
        motion = AnimatedTransform(
            **{k: np.asarray(arrays[f"cam_{k}"], np.float32) for k in ("T", "R", "S", "times")},
            m_start=m0, m_end=m1, is_static=bool(np.array_equal(m0, m1)))
        camera.motion = None if motion.is_static else motion
    return camera


def renderer_from_numpy(arrays: dict):
    """→ (renderer name, its ``ParamSet``)."""
    return (str(arrays.get("renderer_name", "sampler")),
            ParamSet(dict(arrays.get("renderer_params") or {}),
                     search_dir=str(arrays.get("renderer_search_dir", "."))))


def key_from_numpy(data, device="cpu") -> torch.Tensor:
    """(..., 2) uint32 key words → the port's (..., 2) int64 key tensor."""
    a = np.asarray(data)
    if a.shape[-1:] != (2,) or a.dtype != np.uint32:
        raise ValueError(f"key data: {a.dtype} {a.shape}, expected uint32 (..., 2)")
    return torch.as_tensor(a.astype(np.int64), device=device)


def _lights_from_numpy(arrays, f32, i64) -> lt_mod.LightTable:
    ltype = np.asarray(arrays["light_type"], np.int64)
    kind = np.asarray(arrays["light_shape_kind"], np.int64)
    # an area row's shape_kind is 1 (a quadric, sampled as a sphere) or 2
    # (a triangle range): the JAX builder emits no other (builder.py:1004-1008)
    qidx = np.asarray(arrays["light_quad_idx"], np.int64)
    # the JAX package's own env CDFs, so sampling compares bit for bit
    env_dist = Distribution2D(**{k: f32(arrays[f"light_env_{k}"]) for k in _ENV_DIST})
    emission = {}
    if arrays.get("light_world_center") is not None:
        emission = dict(
            world_center=f32(arrays["light_world_center"]),
            world_radius=f32(arrays["light_world_radius"]),
            power_dist=Distribution1D(**{k: f32(arrays[f"light_power_{k}"])
                                         for k in ("func", "cdf", "func_int")}))
    return lt_mod.LightTable(
        type=i64(ltype), shape_kind=i64(kind), quad_idx=i64(qidx), env_dist=env_dist,
        **emission,
        **{k: f32(arrays[f"light_{k}"]) for k in _LIGHT_F32},
        **{k: i64(arrays[f"light_{k}"]) for k in _LIGHT_I64},
    )


_VOLUME_F32 = ("w2v", "lo", "hi", "sigma_a", "sigma_s", "le", "g", "exp_a", "exp_b", "updir",
               "pool")
_VOLUME_I64 = ("grid_offset", "grid_n")


def volumes_from_numpy(arrays: dict, device) -> VolumeTable | None:
    """The ``vol_*`` arrays → the port's ``VolumeTable``, or None where the
    scene has no region."""
    kind = arrays.get("vol_kind")
    if kind is None or len(kind) == 0:
        return None
    dev = torch.device(device)
    return VolumeTable(
        kinds=tuple(int(k) for k in np.asarray(kind)),
        **{k: torch.as_tensor(np.array(arrays[f"vol_{k}"], np.float32), device=dev)
           for k in _VOLUME_F32},
        **{k: torch.as_tensor(np.array(arrays[f"vol_{k}"], np.int64), device=dev)
           for k in _VOLUME_I64})


def preprocess_from_numpy(arrays: dict, device) -> dict:
    """The ``ss_*``, ``ph_*``, ``vpl_*``, ``prt_*`` and ``probe_*`` arrays →
    the ``RenderScene`` fields they fill (``subsurface``, ``photons``,
    ``vpls`` and their ``has_*`` flags, ``prt``, ``probes``), those given."""
    dev = torch.device(device)
    t = lambda k, dt=np.float32: torch.as_tensor(np.array(arrays[k], dt), device=dev)
    out = {}
    if arrays.get("ss_points") is not None:
        out.update(has_subsurface=True, subsurface=SubsurfaceData(
            points=t("ss_points"), normals=t("ss_normals"), areas=t("ss_areas"), E=t("ss_E"),
            material=t("ss_material", np.int64)))
    if arrays.get("ph_p") is not None:
        out.update(has_photons=True, photons=PhotonMaps(
            p=t("ph_p"), wi=t("ph_wi"), alpha=t("ph_alpha"), is_caustic=t("ph_is_caustic", bool),
            valid=t("ph_valid", bool), radius=t("ph_radius")))
    if arrays.get("vpl_p") is not None:
        out.update(has_vpls=True, vpls=VPLSet(p=t("vpl_p"), n=t("vpl_n"),
                                              contrib=t("vpl_contrib"), valid=t("vpl_valid", bool)))
    if arrays.get("prt_c_in") is not None:
        out["prt"] = PRTData(c_in=t("prt_c_in"), lmax=int(arrays["prt_lmax"]))
    if arrays.get("probe_coeffs") is not None:
        out["probes"] = ProbeGrid(lo=t("probe_lo"), hi=t("probe_hi"), coeffs=t("probe_coeffs"),
                                  lmax=int(arrays["probe_lmax"]))
    return out


def integrator_from_numpy(arrays: dict) -> IntegratorConfig:
    """The ``icfg_*`` values → the port's ``IntegratorConfig`` (fields not
    given keep their defaults)."""
    return IntegratorConfig(**{f.name: type(f.default)(arrays[f"icfg_{f.name}"])
                               for f in dataclasses.fields(IntegratorConfig)
                               if f"icfg_{f.name}" in arrays})


def scene_from_numpy(arrays: dict, device):
    """→ (RenderScene, camera, FilmConfig) on ``device``."""
    dev = torch.device(device)
    f32 = lambda a: torch.as_tensor(np.array(a, np.float32), device=dev)
    i64 = lambda a: torch.as_tensor(np.array(a, np.int64), device=dev)

    geo = {k: f32(arrays[k]) for k in _GEOMETRY_F32}
    geo.update({k: i64(arrays[k]) for k in _GEOMETRY_I64})
    geo.update({k: torch.as_tensor(np.array(arrays[k], dt), device=dev)
                for k, dt in _GEOMETRY_OPTIONAL.items() if arrays.get(k) is not None})
    if arrays.get("wide_motion") is not None and arrays.get("wide_rows") is not None:
        # the motion kernels' time boxes, the port's own table, from the rows
        geo["wide_tbox"] = f32(wide.time_boxes(np.asarray(arrays["wide_rows"], np.float32),
                                               np.asarray(arrays["wide_motion"], np.float32)))
    if arrays.get("inst_stack") is not None:
        geo["inst_stack"] = int(arrays["inst_stack"])
    if arrays.get("accel_kind", "bvh") != "bvh":
        geo["accel_kind"] = str(arrays["accel_kind"])
        if arrays.get("grid_dims") is not None:
            geo["grid_dims"] = tuple(int(n) for n in np.asarray(arrays["grid_dims"]))
    geometry = SceneGeometry(
        **{"wide_rows": None, **geo},
        quad_reverse=torch.as_tensor(np.array(arrays["quad_reverse"], bool),
                                     device=dev),
        wide_stack=int(arrays["wide_stack"]),
    )

    active = [int(c) for c in np.asarray(arrays["mat_active_lobes"]).ravel()]
    compact = np.asarray(arrays["mat_lobe_type"], np.int64)
    codes = np.where(compact >= 0,
                     np.asarray(active, np.int64)[np.clip(compact, 0, None)], -1)
    n_lobes = np.asarray(arrays["mat_n_lobes"], np.int64)
    mat_kind = np.asarray(arrays["mat_kind"], np.int64)
    materials = MaterialTable(
        n_lobes=i64(n_lobes), lobe_type=i64(codes),
        **{k: f32(arrays[f"mat_{k}"]) for k in _MATERIAL_F32},
        **{k: i64(arrays[f"mat_{k}"]) for k in _MATERIAL_I64 + TEXTURE_COLUMNS},
        active_lobes=tuple(sorted(set(active))),
        max_lobes=int(max(n_lobes.max(), 1)), has_mix=bool((mat_kind == MIXMAT).any()),
    )

    lights = _lights_from_numpy(arrays, f32, i64)
    camera = camera_from_numpy(arrays, dev)
    film = FilmConfig(
        xres=int(arrays["film_xres"]), yres=int(arrays["film_yres"]),
        n_bins=int(arrays["film_n_bins"]),
        filter=Filter(kind=str(arrays["filter_kind"]),
                      xwidth=float(arrays["filter_xwidth"]),
                      ywidth=float(arrays["filter_ywidth"])),
        fov=float(arrays["cam_fov_deg"]),
        kind=str(arrays.get("film_kind", "image")),
        focal_length=float(arrays.get("film_focal_length", 0.0)),
        f_stop=float(arrays.get("film_f_stop", 0.0)),
    )
    textures = table_from_numpy(
        {k[len("tex_"):]: v for k, v in arrays.items() if k.startswith("tex_")}, dev)
    volumes = volumes_from_numpy(arrays, dev)
    scene = RenderScene(geometry=geometry, materials=materials, lights=lights,
                        textures=textures, volumes=volumes,
                        has_textures=bool(arrays["has_textures"]),
                        has_volumes=volumes is not None,
                        pixel_spread=float(arrays["pixel_spread"]),
                        **preprocess_from_numpy(arrays, dev))
    return scene, camera, film
