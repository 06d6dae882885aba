"""The port's per-wavelength renderer, multi-view renderer, output dispatch
and command line against the JAX package's.

``render_spectral(seed)`` renders the 8×8 tiny scene (path, depth 2)
through the D-Gauss lens with chromatic aberration and diffraction on,
with both sampling methods and 4 and 32 bands, in both packages. The lens
rays agree within ulps (tests/test_torch_cameras.py), so a hit can move
by an ulp: the films are compared as the sampler's are
(tests/test_torch_film.py), pixels within rtol 1e-3, atol 1e-6 on ≥ 99%,
per-bin sums within 1e-3 of the largest, weights and depths rtol 1e-4.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pbrt_tpu.core import spectrum as jspec
from pbrt_tpu.film import film as jfilm
from pbrt_tpu.renderers import dispatch as jdispatch
from pbrt_tpu.renderers.spectral import render_spectral as j_render_spectral
from pbrt_tpu.scene.api import load_scene_string as jload
from pbrt_tpu.scene.builder import build as jbuild

from pbrt_torch import cli
from pbrt_torch.config import DEFAULT_SPECTRAL, SpectralConfig
from pbrt_torch.core import spectrum as tspec
from pbrt_torch.film import film as tfilm
from pbrt_torch.film.imageio import read_exr
from pbrt_torch.interop import renderer_from_numpy, scene_from_numpy
from pbrt_torch.renderers import dispatch
from pbrt_torch.renderers.cameras_renderer import read_camera_file, render_cameras
from pbrt_torch.renderers.sampler import render
from pbrt_torch.renderers.spectral import band_wavelength, render_spectral
from pbrt_torch.scene.api import load_scene_string as tload
from pbrt_torch.scene.builder import build as tbuild
from chip_smoke import DGAUSS_50MM as DGAUSS
from torch_parity_util import jax_scene_arrays, tiny_scene_text


def lens_scene(directory, bands=4, method="singleDirection", xres=8, film="image",
               camera=None, renderer=None, spp=2, named=True):
    """The tiny scene seen through the D-Gauss lens from 60 units back (the
    lens traces in camera-space millimetres: its front element sits ~37
    units ahead of the camera); ``named``: the film's file in
    ``directory`` (unnamed, the JAX package's compiled wave is reused)."""
    lens = os.path.join(directory, "dgauss.dat")
    with open(lens, "w") as f:
        f.write(DGAUSS)
    camera = camera or (f'Camera "realisticDiffraction" "string specfile" ["{lens}"] '
                        '"float filmdistance" [70] "float aperture_diameter" [17.1] '
                        '"bool chromaticAberrationEnabled" ["true"]')
    renderer = renderer or (f'Renderer "spectral" "integer nWaveBands" [{bands}] '
                            f'"string samplingMethod" ["{method}"]')
    text = tiny_scene_text(xres, xres, spp=spp, max_depth=2)
    text = text.replace("LookAt 0 1.5 -5", "LookAt 0 6 -60")
    text = text.replace('Camera "perspective" "float fov" [45]', f"{camera}\n{renderer}")
    name = f' "string filename" ["{os.path.join(directory, "out.dat")}"]' if named else ""
    return text.replace('Film "image"', f'Film "{film}"{name}')


def _films_agree(tf, jf):
    pt, pj = tf.pixels.numpy(), np.asarray(jf.pixels)
    assert np.isfinite(pt).all() and pt.sum() > 0
    assert np.isclose(pt, pj, rtol=1e-3, atol=1e-6).all(-1).mean() >= 0.99
    st, sj = pt.sum((0, 1)), pj.sum((0, 1))
    assert np.abs(st - sj).max() <= 1e-3 * np.abs(sj).max()
    np.testing.assert_allclose(tf.weight.numpy(), np.asarray(jf.weight), rtol=1e-4)
    np.testing.assert_allclose(tf.depth.numpy(), np.asarray(jf.depth), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("bands", [4, 32])
@pytest.mark.parametrize("method", ["singleDirection", "samplerDirection"])
def test_render_spectral_matches_jax(method, bands, tmp_path):
    text = lens_scene(str(tmp_path), bands, method, named=False)
    jf = j_render_spectral(jbuild(jload(text)), spp=2, seed=3, verbose=False)
    tf = render_spectral(tbuild(tload(text), device="cpu"), spp=2, seed=3, chunk_pixels=40)
    _films_agree(tf, jf)
    pt = tf.pixels.numpy()
    width = 32 // bands
    lit = (np.abs(pt).sum((0, 1)) > 0).reshape(bands, width)
    # every bin of a traced band holds the band's value; samplerDirection at
    # 2 spp traces bands 0 and 1 only
    traced = bands if method == "singleDirection" else 2
    assert lit[:traced].all() and not lit[traced:].any()
    assert np.all(pt.reshape(8, 8, bands, width) == pt.reshape(8, 8, bands, width)[..., :1])


def test_spectral_weights_count_every_band(tmp_path):
    """singleDirection adds each sample's filter weight once per band (the
    JAX package's and the reference's film: AddSample per band)."""
    b = tbuild(tload(lens_scene(str(tmp_path), 4)), device="cpu")
    f = render_spectral(b, spp=1, seed=0, chunk_pixels=64)
    np.testing.assert_allclose(f.weight.numpy(), 4.0)


def test_spectral_refuses_bands_that_do_not_divide(tmp_path):
    b = tbuild(tload(lens_scene(str(tmp_path), 5)), device="cpu")
    with pytest.raises(ValueError, match="nWaveBands=5 must divide 32"):
        render_spectral(b, spp=1)
    with pytest.raises(ValueError, match="must divide"):
        j_render_spectral(jbuild(jload(lens_scene(str(tmp_path), 5))), spp=1, verbose=False)


@pytest.mark.parametrize("n_bands", [1, 4, 8, 32])
def test_band_wavelengths_match_jax(n_bands):
    """The band centres in float32, as the JAX wave computes them."""
    cfg = DEFAULT_SPECTRAL
    dw = (cfg.lambda_end - cfg.lambda_start) / n_bands
    for b in range(n_bands):
        ref = np.float32(cfg.lambda_start + dw * jnp.float32(b) + dw * 0.5)
        assert band_wavelength(b, n_bands, cfg) == float(ref)


def test_value_at_wavelength_matches_jax():
    """Per-lane wavelengths across the range and past both ends, the last
    bin clamped (spectrum.py:267-285): within rtol 3e-7 of the JAX package's."""
    rs = np.random.default_rng(2)
    s = rs.uniform(0, 3, (4000, 32)).astype(np.float32)
    lam = np.concatenate([rs.uniform(380, 730, 3990), [395, 400, 705, 710, 714.9, 715, 720,
                                                       390, 405, 560]]).astype(np.float32)
    ref = np.asarray(jspec.value_at_wavelength(jnp.asarray(s), jnp.asarray(lam)))
    out = tspec.value_at_wavelength(torch.as_tensor(s), torch.as_tensor(lam)).numpy()
    np.testing.assert_allclose(out, ref, rtol=3e-7, atol=1e-7)
    cfg = SpectralConfig(n_bins=8)
    s8 = s[:, :8]
    ref8 = np.asarray(jspec.value_at_wavelength(jnp.asarray(s8), jnp.asarray(lam), cfg))
    np.testing.assert_allclose(tspec.value_at_wavelength(torch.as_tensor(s8),
                                                         torch.as_tensor(lam), cfg).numpy(),
                               ref8, rtol=3e-7, atol=1e-7)


def test_write_outputs_headers_and_sidecar_match_jax(tmp_path):
    """The .dat header (size, focal length, f-stop, fov) equals the JAX
    package's byte for byte, for the lens camera and a perspective one; the
    spectralImageNoCamera film also writes its depth EXR, equal to the JAX
    package's sidecar of the same film."""
    for camera in (None, 'Camera "perspective" "float fov" [37]'):
        text = lens_scene(str(tmp_path), 4, film="spectralImageNoCamera", camera=camera)
        jb, tb = jbuild(jload(text)), tbuild(tload(text), device="cpu")
        assert tb.film_config.kind == jb.film_config.kind == "spectralImageNoCamera"
        assert (tb.renderer_name, tb.renderer_params.find_one_int("nWaveBands", 0)) == \
            ("spectral", 4)
        film = render_spectral(tb, spp=1, seed=0)
        jdir, tdir = tmp_path / "j", tmp_path / "t"
        jdir.mkdir(exist_ok=True)
        tdir.mkdir(exist_ok=True)
        tout = dispatch.write_outputs(tb, film, str(tdir / "img.dat"))
        jstate = jfilm.FilmState(pixels=jnp.asarray(film.pixels.numpy()),
                                 weight=jnp.asarray(film.weight.numpy()),
                                 splat=jnp.zeros_like(jnp.asarray(film.pixels.numpy())),
                                 depth=jnp.asarray(film.depth.numpy()))
        jout = jdispatch.write_outputs(jb, jstate, str(jdir / "img.dat"))
        assert [os.path.basename(p) for p in tout] == [os.path.basename(p) for p in jout] == \
            ["img.dat", "img.exr", "img_depth.exr"]
        tdat, jdat = (open(p, "rb").read() for p in (tout[0], jout[0]))
        assert tdat.split(b"\n", 2)[:2] == jdat.split(b"\n", 2)[:2]
        assert tdat == jdat  # the same film: planes equal too
        hdr = tfilm.read_dat(tout[0])[1]
        if camera is None:
            assert hdr == {"focal_length": 50.0, "f_stop": 50.0 / 17.1, "fov": 0.0}
        else:
            assert hdr == {"focal_length": 0.0, "f_stop": 0.0, "fov": 37.0}
        np.testing.assert_array_equal(read_exr(tout[2]), read_exr(jout[2]))
        np.testing.assert_allclose(read_exr(tout[1]), read_exr(jout[1]), rtol=1e-3, atol=1e-4)


def test_write_outputs_other_formats(tmp_path):
    """.exr writes the preview and the planes, .pfm, .png and .jpg (through
    Pillow) the preview; an extension without a writer raises."""
    tb = tbuild(tload(lens_scene(str(tmp_path), 4, renderer=" ")), device="cpu")
    film = render(tb, spp=1, seed=0)
    out = dispatch.write_outputs(tb, film, str(tmp_path / "a.exr"))
    assert [os.path.basename(p) for p in out] == ["a.exr", "a.dat"]
    assert os.path.basename(dispatch.write_outputs(tb, film, str(tmp_path / "b.pfm"))[0]) == "b.pfm"
    png = dispatch.write_outputs(tb, film, str(tmp_path / "c.png"))[0]
    assert open(png, "rb").read(8) == b"\x89PNG\r\n\x1a\n"
    jpg = dispatch.write_outputs(tb, film, str(tmp_path / "d.jpg"))[0]
    assert open(jpg, "rb").read(2) == b"\xff\xd8"
    with pytest.raises(ValueError, match="unsupported image format"):
        dispatch.write_outputs(tb, film, str(tmp_path / "e.gif"))


def test_cameras_renderer_suffixes_and_views(tmp_path):
    """One render per 4×4 of cameraTransforms, each output suffixed _cam{i},
    each film the sampler's render with that matrix as the camera (a
    perspective camera here); the JAX package writes the same .dat names
    and reads the same matrices."""
    mats = [np.eye(4), np.eye(4)]
    mats[0][:3, 3] = [0.0, 1.5, -5.0]
    mats[1][:3, 3] = [1.0, 1.0, -6.0]
    cam_file = tmp_path / "cams.txt"
    cam_file.write_text("\n".join(" ".join(f"{v:g}" for v in m.ravel()) for m in mats))
    text = lens_scene(str(tmp_path), camera='Camera "perspective" "float fov" [45]',
                      renderer=f'Renderer "cameras" "string cameraTransforms" ["{cam_file}"]')
    tb = tbuild(tload(text), device="cpu")
    assert [m.tolist() for m in read_camera_file(str(cam_file))] == [m.tolist() for m in mats]
    views = render_cameras(tb, spp=1, seed=2)
    assert [s for _, s in views] == ["_cam0", "_cam1"]
    import dataclasses

    for (film, _), m in zip(views, mats):
        cam = dataclasses.replace(tb.camera, cam_to_world=torch.as_tensor(m, dtype=torch.float32))
        ref = render(dataclasses.replace(tb, camera=cam), spp=1, seed=2)
        assert torch.equal(film.pixels, ref.pixels)
    assert not torch.equal(views[0][0].pixels, views[1][0].pixels)
    outs = dispatch.render_scene(tb, spp=1, seed=2, outfile=str(tmp_path / "v.dat"))
    assert [os.path.basename(p) for p in outs] == ["v_cam0.dat", "v_cam0.exr",
                                                  "v_cam1.dat", "v_cam1.exr"]
    jb = jbuild(jload(text))
    jouts = []
    for i in range(2):
        jouts += jdispatch.write_outputs(jb, jfilm.init_film(jb.film_config),
                                         str(tmp_path / "w.dat"), suffix=f"_cam{i}")
    assert [os.path.basename(p) for p in jouts] == ["w_cam0.dat", "w_cam0.exr",
                                                   "w_cam1.dat", "w_cam1.exr"]


def test_jax_exr_outfile_drops_the_camera_suffix(tmp_path):
    """Queue 3 fact: with an .exr (or .pfm, .png) output the JAX package
    writes every view of the cameras renderer to the same file name (its
    suffix reaches only the .dat); the port suffixes every file."""
    text = lens_scene(str(tmp_path), camera='Camera "perspective" "float fov" [45]',
                      renderer=" ")
    jb, tb = jbuild(jload(text)), tbuild(tload(text), device="cpu")
    jout = jdispatch.write_outputs(jb, jfilm.init_film(jb.film_config),
                                   str(tmp_path / "j.exr"), suffix="_cam1")
    assert [os.path.basename(p) for p in jout] == ["j.exr", "j_cam1.dat"]
    film = render(tb, spp=1)
    tout = dispatch.write_outputs(tb, film, str(tmp_path / "t.exr"), suffix="_cam1")
    assert [os.path.basename(p) for p in tout] == ["t_cam1.exr", "t_cam1.dat"]


def test_unknown_renderer_renders_as_the_sampler(tmp_path):
    """Every renderer of the JAX package is ported, and a name it does not
    know renders as ``sampler`` there (dispatch.py:76-79) and in the port:
    the same ``.dat``, byte for byte."""
    files = []
    for name in ("bogus", "sampler"):
        tb = tbuild(tload(lens_scene(str(tmp_path), camera='Camera "perspective"',
                                     renderer=f'Renderer "{name}"')), device="cpu")
        assert tb.renderer_name == name
        out = dispatch.render_scene(tb, spp=1, outfile=str(tmp_path / f"{name}.dat"))
        files.append(open(out[0], "rb").read())
    assert files[0] == files[1] and len(files[0]) > 100


def test_interop_carries_cameras_and_renderer(tmp_path):
    """The JAX build's lens camera and renderer, carried as arrays, give the
    port's own build's camera fields and renderer parameters."""
    text = lens_scene(str(tmp_path), 8, "samplerDirection")
    arrays = jax_scene_arrays(jbuild(jload(text)))
    _, cam, film = scene_from_numpy(arrays, "cpu")
    tb = tbuild(tload(text), device="cpu")
    for f in ("el_radius", "el_sep", "el_n", "el_aperture", "el_next_n"):
        np.testing.assert_array_equal(getattr(cam, f), getattr(tb.camera, f), err_msg=f)
    for f in ("film_distance", "chromatic", "diffraction", "num_pinholes", "pinhole_exit",
              "focal_length_mm", "f_stop", "xres", "yres"):
        assert getattr(cam, f) == getattr(tb.camera, f), f
    assert torch.equal(cam.cam_to_world, tb.camera.cam_to_world)
    assert (film.focal_length, film.f_stop) == (tb.film_config.focal_length,
                                                tb.film_config.f_stop)
    name, params = renderer_from_numpy(arrays)
    assert name == "spectral" and params.find_one_int("nWaveBands", 0) == 8
    assert params.find_one_string("samplingMethod", "") == "samplerDirection"


def test_cli_renders_on_the_cpu(tmp_path, capsys):
    """python -m pbrt_torch.cli scene --cpu: the lens spectral scene end to
    end, its .dat header the lens's; --quick renders 1 spp."""
    scene = tmp_path / "scene.pbrt"
    scene.write_text(lens_scene(str(tmp_path), 4, film="spectralImageNoCamera"))
    out = tmp_path / "cli.dat"
    assert cli.main([str(scene), "--cpu", "--quick", "--seed", "4", "--outfile", str(out)]) == 0
    printed = capsys.readouterr().out
    assert "RealisticDiffractionCamera" in printed and "wrote" in printed
    data, hdr = tfilm.read_dat(str(out))
    assert data.shape == (8, 8, 32) and np.isfinite(data).all() and data.sum() > 0
    assert hdr == {"focal_length": 50.0, "f_stop": 50.0 / 17.1, "fov": 0.0}
    assert (tmp_path / "cli_depth.exr").exists() and (tmp_path / "cli.exr").exists()
    tb = tbuild(tload(scene.read_text()), device="cpu")
    np.testing.assert_array_equal(data, render_spectral(tb, spp=1, seed=4).pixels.double()
                                  .numpy())


def test_cli_refuses_what_is_not_ported(tmp_path, monkeypatch):
    """Every flag is ported since the sharded renderer was: ``--distributed``
    without a coordinator reads torch's ``env://`` variables and fails
    without them, ``--ndevices`` is parsed and never read (as the JAX CLI
    does); without a card the default device raises."""
    scene = tmp_path / "scene.pbrt"
    scene.write_text(lens_scene(str(tmp_path)))
    for var in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(var, raising=False)
    with pytest.raises(ValueError, match="RANK"):
        cli.main([str(scene), "--cpu", "--distributed"])
    if not torch.cuda.is_available():
        for flags in ([], ["--ndevices", "2"]):
            with pytest.raises(RuntimeError, match="no CUDA device"):
                cli.main([str(scene), "--quiet", *flags])
