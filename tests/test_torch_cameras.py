"""The port's cameras against the JAX package's: ``generate_rays`` of every
camera on the same 4,096 lanes (film points, lens and time uniforms from a
numpy seed; the lens cameras' keyed normals from the same (pixel, sample)
keys), compared as origins, directions, times, wavelengths and the alive
mask (a dead lens lane has direction 0). The JAX side runs eagerly.

Tolerances, from float32 arithmetic in another order (XLA's CPU backend
also fuses multiply-adds; the keyed normals differ by ≤ 3 ulps):

- projective, pinhole, environment, ideal cameras: origins and directions
  within 1e-5 · max(1, |o|) and 1e-5;
- the lens stacks and the eye, on lanes alive in both: 99.9% of the lanes
  within 1e-4 · max(1, |o|) (origins, mm in camera space, ~40 mm plus
  the camera's translation) and 1e-4 (directions), every lane within
  5e-3 and 5e-3 (a lane that grazes an element's rim meets it at a
  shallow angle, which magnifies the ulps);
- alive masks agree on ≥ 99.9% of the lanes, and a lane whose mask differs
  must sit at a decision (an aperture rim, total internal reflection): the
  port's own mask for it changes when its film point moves by 1e-3 pixel.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from pbrt_tpu.cameras import cameras as jcams
from pbrt_tpu.core import rng as jrng
from pbrt_tpu.core.transform import AnimatedTransform as JAT
from pbrt_tpu.film.film import FilmConfig as JFC
from pbrt_tpu.scene.paramset import ParamSet as JPS

from pbrt_torch.cameras import cameras as tcams
from pbrt_torch.cameras.eye import RealisticEyeCamera
from pbrt_torch.cameras.realistic import RealisticDiffractionCamera, lens_rows
from pbrt_torch.core import rng as trng
from pbrt_torch.core.transform import AnimatedTransform as TAT
from pbrt_torch.core.transform import look_at
from pbrt_torch.scene.paramset import ParamSet as TPS

import chip_smoke

N = 4096
XRES, YRES = 64, 48
SEED, SAMPLE = 3, 1
#: a placed camera: the lens traces in camera space, then this applies
C2W = np.linalg.inv(look_at((2.0, 3.0, -40.0), (0.0, 0.5, 0.0), (0.0, 1.0, 0.0)))

#: a symmetric biconvex lens, f = 50 mm (tests/test_cameras.py:60-70)
BICONVEX = "# focal length\n50\n# radius separation n aperture\n50 2 1.5 20\n-50 0 1 20\n"
#: the D-Gauss F/2 at 50 mm and the schematic eye (Zemax signs, read with
#: flipLensRadius) with its media spectra, as chip_smoke.py renders them
DGAUSS, EYE = chip_smoke.DGAUSS_50MM, chip_smoke.SCHEMATIC_EYE
EYE_IORS = {k: list(v) for k, v in chip_smoke.EYE_MEDIA.items()}


def _params(entries):
    return (JPS(dict(entries), search_dir="/"), TPS(dict(entries), search_dir="/"))


def _lens(tmp_path, text, name="lens.dat"):
    path = tmp_path / name
    path.write_text(text)
    return {"specfile": ("string", [str(path)])}


def _f(v):
    return ("float", [float(v)])


def _b(v):
    return ("bool", ["true" if v else "false"])


def _dgauss(tmp_path, **extra):
    return {**_lens(tmp_path, DGAUSS), "filmdistance": _f(70), "aperture_diameter": _f(17.1),
            **extra}


def _eye(tmp_path, **extra):
    return {**_lens(tmp_path, EYE, "eye.dat"), "flipLensRadius": _b(True),
            "retinaDistance": _f(16.32), "retinaRadius": _f(12.0),
            "retinaSemiDiam": _f(6.0), "pupilDiameter": _f(4.0), "filmdiag": _f(12.0),
            "lensDecenterX": _f(0.3), "lensDecenterY": _f(-0.2), "lensTiltX": _f(2.0),
            "lensTiltY": _f(1.0),
            **{k: ("spectrum", v) for k, v in EYE_IORS.items()}, **extra}


#: (id, camera, parameters(tmp_path), wavelengths: None for the default)
CASES = [
    ("perspective", "perspective", lambda t: {"fov": _f(50), "lensradius": _f(.3),
                                              "focaldistance": _f(30)}, [None]),
    ("orthographic", "orthographic", lambda t: {"lensradius": _f(.2),
                                                "focaldistance": _f(20)}, [None, 520.0]),
    ("pinhole", "pinhole", lambda t: {"filmdistance": _f(1.5)}, [None]),
    ("environment", "environment", lambda t: {}, [None, 610.0]),
    ("ideal", "idealDiffraction", lambda t: {"focal_length": _f(50), "filmdistance": _f(70),
                                             "aperture_diameter": _f(4)}, [None, 450.0]),
    ("ideal-no-diffraction", "idealDiffraction",
     lambda t: {"focal_length": _f(50), "filmdistance": _f(50),
                "aperture_diameter": _f(4), "diffractionEnabled": _f(0)}, [None]),
    ("biconvex", "realisticDiffraction",
     lambda t: {**_lens(t, BICONVEX), "filmdistance": _f(50), "aperture_diameter": _f(8)},
     [None]),
    ("dgauss", "realisticDiffraction", lambda t: _dgauss(t), [None, 420.0]),
    ("dgauss-chromatic", "realisticDiffraction",
     lambda t: _dgauss(t, chromaticAberrationEnabled=_b(True)), [420.0, 550.0, 690.0]),
    ("dgauss-no-diffraction", "realisticDiffraction",
     lambda t: _dgauss(t, diffractionEnabled=_b(False), x_aperture_offset=_f(.4),
                       y_aperture_offset=_f(-.3), film_center_x=_f(.5),
                       film_center_y=_f(.2)), [None]),
    ("dgauss-eye-ior", "realisticDiffraction",
     lambda t: _dgauss(t, IORforEyeEnabled=_b(True)), [650.0]),
    ("dgauss-curved", "realisticDiffraction",
     lambda t: _dgauss(t, curveRadius=_f(60), chromaticAberrationEnabled=_b(True)), [500.0]),
    ("pinhole-array", "realisticDiffraction",
     lambda t: _dgauss(t, num_pinholes_w=_f(8), num_pinholes_h=_f(6)), [None]),
    ("microlens", "realisticDiffraction",
     lambda t: _dgauss(t, num_pinholes_w=_f(8), num_pinholes_h=_f(6),
                       microlens_enabled=_f(1)), [None]),
    ("pinhole-exit", "realisticDiffraction",
     lambda t: _dgauss(t, pinhole_exit_x=_f(.5), pinhole_exit_y=_f(-.3),
                       pinhole_exit_z=_f(1.0)), [None]),
    ("eye", "realisticEye", lambda t: _eye(t), [None, 450.0, 550.0, 650.0]),
    ("eye-flat-retina", "realisticEye", lambda t: _eye(t, retinaRadius=_f(0)), [520.0]),
]
LENS_CAMERAS = ("realisticDiffraction", "realisticEye")


def _cameras(name, entries):
    jp, tp = _params(entries)
    jc = jcams.make_camera(name, jp, JAT.from_matrices(C2W, C2W, 0.0, 1.0),
                           JFC(xres=XRES, yres=YRES))
    tc = tcams.make_camera(name, tp, TAT.from_matrices(C2W, C2W, 0.0, 1.0), XRES, YRES, "cpu")
    return jc, tc


def _inputs(seed=0):
    rs = np.random.default_rng(seed)
    px = rs.uniform(0, XRES, N).astype(np.float32)
    py = rs.uniform(0, YRES, N).astype(np.float32)
    u = rs.uniform(0, 1, (3, N)).astype(np.float32)
    return px, py, u


def _port_rays(tc, px, py, u, lam):
    tags = tc.noise_tags
    noise = (trng.camera_normals(trng.root_key(SEED), torch.arange(N), SAMPLE, tags.start,
                                 len(tags)) if len(tags) else None)
    return tc.generate_rays(*(torch.as_tensor(a) for a in (px, py, u[0], u[1], u[2])),
                            wavelength=lam, noise=noise)


def _alive(d):
    return np.linalg.norm(np.asarray(d), axis=-1) > 0.5


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_camera_rays_match_jax(case, tmp_path):
    _, name, make, lams = case
    jc, tc = _cameras(name, make(tmp_path))
    px, py, u = _inputs()
    keys = jrng.pixel_sample_key(jrng.root_key(SEED), jnp.arange(N), jnp.int32(SAMPLE))
    lens = name in LENS_CAMERAS
    for lam in lams:
        jl = None if lam is None else jnp.full((N,), lam, jnp.float32)
        jr = jc.generate_rays(*(jnp.asarray(a) for a in (px, py, u[0], u[1], u[2])),
                              wavelength=jl, keys=keys)
        tr = _port_rays(tc, px, py, u, lam)
        jo, jd = np.asarray(jr.origin), np.asarray(jr.direction)
        to, td = tr.origin.numpy(), tr.direction.numpy()
        np.testing.assert_allclose(tr.time.numpy(), np.asarray(jr.time), rtol=1e-6, atol=1e-7)
        tw = tr.wavelength.numpy() if torch.is_tensor(tr.wavelength) else tr.wavelength
        np.testing.assert_array_equal(np.broadcast_to(tw, (N,)), np.asarray(jr.wavelength))
        ja, ta = _alive(jd), _alive(td)
        assert (ja == ta).mean() >= 0.999, f"{lam}: alive masks differ on {(ja != ta).sum()}"
        if (ja != ta).any():
            flips = np.nonzero(ja != ta)[0]
            assert np.all(_at_a_decision(tc, px, py, u, lam)[flips]), (lam, flips)
        both = ja & ta
        assert both.mean() > (0.05 if lens else 0.999)
        scale = np.maximum(1.0, np.abs(jo[both]))
        eo = (np.abs(to[both] - jo[both]) / scale).max(-1)
        ed = np.abs(td[both] - jd[both]).max(-1)
        if lens:
            assert np.quantile(eo, 0.999) <= 1e-4 and np.quantile(ed, 0.999) <= 1e-4, (lam,)
            assert eo.max() <= 5e-3 and ed.max() <= 5e-3, (lam, eo.max(), ed.max())
        else:
            assert eo.max() <= 1e-5 and ed.max() <= 1e-5, (lam, eo.max(), ed.max())
        # dead lanes have direction exactly 0 on both sides
        assert np.all(td[~ta] == 0.0) and np.all(jd[~ja] == 0.0)


def _at_a_decision(tc, px, py, u, lam, step=1e-3, base=None):
    """Lanes whose alive flag the port changes when the film point moves by
    ``step`` pixel along x or y (``base``: the unmoved lanes' flags, if
    already traced)."""
    if base is None:
        base = _alive(_port_rays(tc, px, py, u, lam).direction)
    moved = np.zeros(N, bool)
    for dx, dy in ((step, 0), (-step, 0), (0, step), (0, -step)):
        a = _alive(_port_rays(tc, (px + dx).astype(np.float32), (py + dy).astype(np.float32),
                              u, lam).direction)
        moved |= a != base
    return moved


def test_decision_lanes_are_few(tmp_path):
    """The test of a flipped lane is not vacuous: on the D-Gauss stack the
    detector finds rim lanes when the film point moves by 0.1 pixel, and
    at most 1% of the lanes at 1e-3 pixel. Port only: the camera is the
    port's own, and the unmoved lanes are traced once for both steps."""
    _, tp = _params(_dgauss(tmp_path))
    tc = tcams.make_camera("realisticDiffraction", tp, TAT.from_matrices(C2W, C2W, 0.0, 1.0),
                           XRES, YRES, "cpu")
    px, py, u = _inputs()
    base = _alive(_port_rays(tc, px, py, u, 550.0).direction)
    assert _at_a_decision(tc, px, py, u, 550.0, step=0.1, base=base).mean() > 0.0
    assert _at_a_decision(tc, px, py, u, 550.0, base=base).mean() <= 0.01


def test_lens_rows_follow_the_jax_factory(tmp_path):
    """Trace order, stop rows sized by aperture_diameter, the next medium
    skipping stops, and the header's metadata, against the JAX camera."""
    jc, tc = _cameras("realisticDiffraction", _dgauss(tmp_path, curveRadius=_f(60)))
    for f in ("el_radius", "el_sep", "el_n", "el_aperture", "el_next_n"):
        np.testing.assert_array_equal(getattr(tc, f), np.asarray(getattr(jc, f)), err_msg=f)
    assert tc.el_aperture[5] == np.float32(17.1) and tc.el_radius[5] == 0.0
    for f in ("focal_length_mm", "f_stop", "fov_deg", "sensor_width", "curve_radius",
              "film_distance"):
        assert getattr(tc, f) == pytest.approx(float(getattr(jc, f)), rel=1e-7), f
    assert list(tc.noise_tags) == list(range(1000, 1011))
    vals = np.asarray([50, 1, 2, 1.5, 4, 0, 1, 0, 3], np.float64)
    radius, _, n, ap, next_n = lens_rows(vals, 2.5)
    assert list(radius) == [0, 1] and list(ap) == [2.5, 4] and list(n) == [1, 1.5]
    assert list(next_n) == [1.5, 1.0]


def test_eye_factory_matches_jax(tmp_path):
    """Flip, the stop's pupil, the semi-diameter clamp, the media spectra,
    the inert decenter and tilt, and the metadata."""
    entries = _eye(tmp_path)
    entries["specfile"] = _lens(tmp_path, EYE.replace("-7.72 -7.72 0.55 1 5.0",
                                                      "-7.72 -7.72 0.55 1 9.0"), "eye2.dat")[
        "specfile"]
    jc, tc = _cameras("realisticEye", entries)
    assert isinstance(tc, RealisticEyeCamera)
    for f in ("el_rx", "el_ry", "el_thickness", "el_medium", "el_semidiam", "el_cx", "el_cy"):
        np.testing.assert_array_equal(getattr(tc, f), np.asarray(getattr(jc, f)), err_msg=f)
    assert tc.el_semidiam[-1] < 9.0  # clamped: the conic cannot reach 9 mm
    np.testing.assert_array_equal(tc.ior_spectra.numpy(), np.asarray(jc.ior_spectra))
    np.testing.assert_array_equal(tc.lens_decenter, np.asarray(jc.lens_decenter))
    np.testing.assert_array_equal(tc.lens_tilt, np.asarray(jc.lens_tilt))
    assert tc.lens_tilt == (2.0, 1.0)
    assert (tc.focal_length_mm, tc.f_stop) == (jc.focal_length_mm, jc.f_stop)
    assert len(tc.noise_tags) == 0


def test_eye_flip_reads_the_other_convention(tmp_path):
    """The flipped Zemax file read with flipLensRadius traces as the same
    eye written in pbrt's convention without it."""
    rows = [ln.split() for ln in EYE.splitlines()]
    plain = "\n".join([rows[0][0]] + [" ".join(
        f"{-float(w):g}" if i in (0, 1, 5, 6) else w for i, w in enumerate(r)) for r in rows[1:]])
    _, a = _cameras("realisticEye", _eye(tmp_path))
    _, b = _cameras("realisticEye", {**_eye(tmp_path), **_lens(tmp_path, plain, "plain.dat"),
                                     "flipLensRadius": _b(False)})
    for f in ("el_rx", "el_ry", "el_cx", "el_cy", "el_semidiam"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f), err_msg=f)


def test_camera_kinds_and_metadata(tmp_path):
    """make_camera's classes and the film header's numbers per camera, as
    the JAX package's (focal length, f-stop, fov)."""
    for _, name, make, _ in CASES:
        jc, tc = _cameras(name, make(tmp_path))
        for f in ("focal_length_mm", "f_stop", "fov_deg"):
            assert getattr(tc, f) == pytest.approx(float(getattr(jc, f, 0.0))), (name, f)
    _, tc = _cameras("realisticDiffraction", _dgauss(tmp_path))
    assert isinstance(tc, RealisticDiffractionCamera)
    assert not hasattr(tc, "ray_differentials")
    with pytest.raises(ValueError, match="specfile"):
        _cameras("realisticDiffraction", {})
    with pytest.raises(ValueError, match="unknown camera"):
        _cameras("fisheye", {})


def test_orthographic_differentials_match_jax(tmp_path):
    """The orthographic camera's one-pixel differentials shift the origin
    (orthographic.cpp:63-76)."""
    jc, tc = _cameras("orthographic", {})
    px, py, u = _inputs(1)
    z = np.zeros(N, np.float32)
    jr = jc.generate_rays(*(jnp.asarray(a) for a in (px, py, z, z, z)))
    tr = tc.generate_rays(*(torch.as_tensor(a) for a in (px, py, z, z, z)))
    jd = jc.ray_differentials(jnp.asarray(px), jnp.asarray(py), jr)
    td = tc.ray_differentials(torch.as_tensor(px), torch.as_tensor(py), tr)
    for a, b in zip(jd, td):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-5, atol=1e-5)
    assert not torch.equal(td[0], tr.origin) and torch.equal(td[1], tr.direction)


def test_animated_lens_camera_interpolates(tmp_path):
    """A lens camera under an animated transform: rays at each lane's
    shutter time, as the JAX camera's."""
    m1 = C2W.copy()
    m1[:3, 3] += [1.0, -0.5, 2.0]
    jp, tp = _params(_dgauss(tmp_path, diffractionEnabled=_b(False)))
    jc = jcams.make_camera("realisticDiffraction", jp, JAT.from_matrices(C2W, m1, 0.0, 1.0),
                           JFC(xres=XRES, yres=YRES))
    tc = tcams.make_camera("realisticDiffraction", tp, TAT.from_matrices(C2W, m1, 0.0, 1.0),
                           XRES, YRES, "cpu")
    assert tc.motion is not None
    px, py, u = _inputs(2)
    jr = jc.generate_rays(*(jnp.asarray(a) for a in (px, py, u[0], u[1], u[2])))
    tr = tc.generate_rays(*(torch.as_tensor(a) for a in (px, py, u[0], u[1], u[2])))
    both = _alive(jr.direction) & _alive(tr.direction)
    assert both.mean() > 0.5
    np.testing.assert_allclose(tr.origin.numpy()[both], np.asarray(jr.origin)[both],
                               rtol=1e-4, atol=1e-3)


def test_ideal_camera_chromatic_flag_is_inert(tmp_path):
    """Queue 3 fact: idealDiffraction reads no chromaticAberrationEnabled
    (realistic.py:458-478; the reference parses it and never applies it):
    without diffraction its rays are the same at every wavelength, in both
    packages."""
    entries = {"focal_length": _f(50), "filmdistance": _f(70), "aperture_diameter": _f(4),
               "diffractionEnabled": _f(0), "chromaticAberrationEnabled": _b(True)}
    jc, tc = _cameras("idealDiffraction", entries)
    px, py, u = _inputs(3)
    out = []
    for lam in (420.0, 680.0):
        jr = jc.generate_rays(*(jnp.asarray(a) for a in (px, py, u[0], u[1], u[2])),
                              wavelength=jnp.full((N,), lam, jnp.float32))
        tr = tc.generate_rays(*(torch.as_tensor(a) for a in (px, py, u[0], u[1], u[2])),
                              wavelength=lam)
        out.append((np.asarray(jr.direction), tr.direction.numpy()))
    np.testing.assert_array_equal(out[0][0], out[1][0])
    np.testing.assert_array_equal(out[0][1], out[1][1])


def test_dead_lens_lanes_meet_a_sphere_far_away():
    """Queue 3 fact: a dead lens lane (direction 0) meets the light sphere
    at t ~5e24 in both packages (the sphere's solve with a zero quadratic
    term): it adds no radiance, but the film's depth channel takes that
    distance."""
    from pbrt_tpu.accel.intersect import intersect as j_intersect
    from pbrt_tpu.core.geometry import Ray as JRay
    from pbrt_tpu.scene.api import load_scene_string as jload
    from pbrt_tpu.scene.builder import build as jbuild
    from pbrt_torch.accel.intersect import intersect as t_intersect
    from pbrt_torch.core.geometry import Ray as TRay
    from pbrt_torch.integrators.path import trace_radiance
    from pbrt_torch.scene.api import load_scene_string as tload
    from pbrt_torch.scene.builder import build as tbuild

    text, _ = chip_smoke.real_scene_text(6, res=16)
    jb, tb = jbuild(jload(text)), tbuild(tload(text), device="cpu")
    o = np.array([[370.3493, 65.9514, 22.164], [370.1745, 44.4954, 21.5369],
                  [400.0, 20.0, 30.0]], np.float32)
    d = np.zeros_like(o)
    jh = j_intersect(jb.scene.geometry, JRay.make(jnp.asarray(o), jnp.asarray(d)))
    ray = TRay.make(torch.as_tensor(o), torch.as_tensor(d))
    th = t_intersect(tb.scene.geometry, ray)
    np.testing.assert_array_equal(th.prim.numpy(), np.asarray(jh.prim))
    np.testing.assert_allclose(th.t.numpy(), np.asarray(jh.t), rtol=1e-6)
    sphere = tb.scene.geometry.num_triangles
    assert th.prim.tolist() == [sphere, sphere, -1] and float(th.t[0]) > 1e24
    u = trng.primary_uniforms_plain(trng.root_key(0), torch.arange(3),
                                    trng.pixel_scrambles_plain(trng.root_key(0), torch.arange(3)),
                                    0, tb.integrator.max_depth)
    L, first_t = trace_radiance(tb.scene, ray, tb.integrator, u)
    assert float(L.abs().max()) == 0.0 and float(first_t[0]) > 1e24


def test_eye_decenter_and_tilt_are_inert(tmp_path):
    """Queue 3 fact: realisticEye reads lensDecenterX/Y and lensTiltX/Y
    (eye.py:319-325) and its trace never applies them: the rays equal the
    centred, untilted eye's, in both packages."""
    px, py, u = _inputs(4)
    rays = []
    for extra in ({}, {"lensDecenterX": _f(0), "lensDecenterY": _f(0), "lensTiltX": _f(0),
                       "lensTiltY": _f(0)}):
        jc, tc = _cameras("realisticEye", _eye(tmp_path, **extra))
        jr = jc.generate_rays(*(jnp.asarray(a) for a in (px, py, u[0], u[1], u[2])))
        tr = tc.generate_rays(*(torch.as_tensor(a) for a in (px, py, u[0], u[1], u[2])))
        rays.append((np.asarray(jr.direction), tr.direction.numpy()))
    np.testing.assert_array_equal(rays[0][0], rays[1][0])
    np.testing.assert_array_equal(rays[0][1], rays[1][1])
    assert _alive(rays[0][1]).mean() > 0.05
