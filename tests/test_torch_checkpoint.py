"""The port's checkpoint and resume (``pbrt_torch/film/checkpoint.py``,
``renderers/sampler.py:render(checkpoint_path=…)``) and its statistics
module (``pbrt_torch/utils/stats.py``), against the JAX package's.

Scene: ``tests/test_checkpoint.py``'s (a matte sphere under a constant
sky, 8×8, lowdiscrepancy at 4 spp, path depth 5) with the camera moved
out of the sphere (``LookAt``): from the origin it sees the sphere's
inside, where no light comes, and every film is 0. Tolerances: a resumed
render equals an uninterrupted one with the same ``checkpoint_every`` bit
for bit, and one without a checkpoint within atol 1e-6 (the JAX test's
rule). A checkpoint written by the JAX package, resumed by the port, gives
the JAX package's uninterrupted film within the render tolerance of
``test_torch_film.py::test_render_seed_matches_jax``: pixels rtol 1e-4 /
atol 1e-6 on ≥ 99% of pixels, per-bin sums within 1e-3 relative, weights
rtol 1e-5. The files' keys and dtypes are equal, and each package reads
the other's. Statistics: counters, call counts and the report's lines
equal, timers to the same format.
"""

import os
import re

import numpy as np
import pytest
import torch

from pbrt_tpu.film import checkpoint as jck
from pbrt_tpu.renderers.sampler import render as jrender
from pbrt_tpu.scene.api import load_scene_string as jload
from pbrt_tpu.scene.builder import build as jbuild
from pbrt_tpu.utils import stats as jstats
from pbrt_torch.film import checkpoint as tck
from pbrt_torch.film import film as film_mod
from pbrt_torch.renderers.sampler import render
from pbrt_torch.scene.api import load_scene_string
from pbrt_torch.scene.builder import build
from pbrt_torch.utils import stats as tstats
from torch_parity_util import jax_integrator_pieces

_SRC = open(__file__.replace("test_torch_checkpoint.py", "test_checkpoint.py")).read()
SCENE = "LookAt 0 0 -4  0 0 0  0 1 0\n" + _SRC.split('SCENE = """')[1].split('"""')[0]
FIELDS = ("pixels", "weight", "depth")


@pytest.fixture(scope="module")
def built():
    return build(load_scene_string(SCENE), device="cpu")


def test_resume_bit_identical(built, tmp_path):
    """Two waves into a checkpoint, then resumed to four: equal bit for bit
    to four waves with the same interval, and within atol 1e-6 of a render
    without a checkpoint."""
    full = render(built, checkpoint_path=str(tmp_path / "full.npz"), checkpoint_every=2)
    ck = str(tmp_path / "ck.npz")
    render(built, spp=2, checkpoint_path=ck, checkpoint_every=2)
    assert tck.load_checkpoint(ck)[1:] == (2, 0)
    resumed = render(built, spp=4, checkpoint_path=ck, checkpoint_every=2)
    assert tck.load_checkpoint(ck)[1:] == (4, 0)
    for k in FIELDS:
        assert torch.equal(getattr(full, k), getattr(resumed, k)), k
    plain = render(built)
    assert float(plain.pixels.sum()) > 0
    np.testing.assert_allclose(resumed.pixels.numpy(), plain.pixels.numpy(), atol=1e-6)
    np.testing.assert_allclose(resumed.weight.numpy(), 4.0)


def test_checkpoint_of_another_seed_is_not_resumed(built, tmp_path):
    ck = str(tmp_path / "ck.npz")
    render(built, spp=2, seed=1, checkpoint_path=ck, checkpoint_every=2)
    out = render(built, spp=2, seed=0, checkpoint_path=ck, checkpoint_every=2)
    assert torch.equal(out.pixels, render(built, spp=2, seed=0).pixels)
    assert tck.load_checkpoint(ck)[2] == 0


def test_jax_checkpoint_resumes_in_the_port(built, tmp_path):
    """The JAX package renders two waves into a checkpoint; the port resumes
    it to four; against the JAX package's uninterrupted four. The port's own
    checkpoint loads in the JAX package, keys and dtypes equal."""
    jb = jbuild(jload(SCENE))
    ck = str(tmp_path / "jax.npz")
    with jax_integrator_pieces():
        jrender(jb, spp=2, verbose=False, checkpoint_path=ck, checkpoint_every=2)
        jfull = jrender(jb, spp=4, verbose=False)
    resumed = render(built, spp=4, checkpoint_path=ck, checkpoint_every=2)
    pj, pt = np.asarray(jfull.pixels), resumed.pixels.numpy()
    assert np.isfinite(pt).all() and pt.sum() > 0
    assert np.isclose(pt, pj, rtol=1e-4, atol=1e-6).all(-1).mean() >= 0.99
    sj, st = pj.sum((0, 1)), pt.sum((0, 1))
    assert np.abs(st - sj).max() <= 1e-3 * np.abs(sj).max()
    np.testing.assert_allclose(resumed.weight.numpy(), np.asarray(jfull.weight), rtol=1e-5)
    np.testing.assert_allclose(resumed.depth.numpy(), np.asarray(jfull.depth), rtol=1e-5)
    # the port's file: the JAX package's keys and dtypes, read by it
    ours = str(tmp_path / "port.npz")
    tck.save_checkpoint(ours, resumed, 4, 0)
    with np.load(ck) as a, np.load(ours) as b:
        assert sorted(a.files) == sorted(b.files)
        assert all(a[k].dtype == b[k].dtype and a[k].shape == b[k].shape for k in a.files)
    state, nxt, seed = jck.load_checkpoint(ours)
    assert (nxt, seed) == (4, 0)
    for k in FIELDS:
        np.testing.assert_array_equal(np.asarray(getattr(state, k)), getattr(resumed, k).numpy())
    assert not np.asarray(state.splat).any()


def test_version_check(built, tmp_path):
    """An absent file or another version gives None; a file with splats is
    refused (the sampler film has none)."""
    assert tck.load_checkpoint(str(tmp_path / "absent.npz")) is None
    st = film_mod.init_film(built.film_config, "cpu")
    path = str(tmp_path / "v.npz")
    tck.save_checkpoint(path, st, 3, 7, meta={"note": np.asarray(1)})
    assert tck.load_checkpoint(path)[1:] == (3, 7)
    assert not os.path.exists(path + ".tmp.npz")
    with np.load(path) as z:
        fields = dict(z)
    np.savez(path, **{**fields, "version": tck.FORMAT_VERSION + 1})
    assert tck.load_checkpoint(path) is None
    assert jck.load_checkpoint(path) is None
    np.savez(path, **{**fields, "splat": np.ones_like(fields["splat"])})
    with pytest.raises(ValueError, match="splat"):
        tck.load_checkpoint(path)


def _lines(mod, tag):
    return [ln for ln in mod.report().splitlines() if tag in ln]


def test_stats_match_jax(capsys, tmp_path):
    """Counters (with counting switched off between), timers and the report
    of both modules after the same calls; the progress bar's output alike;
    ``device_trace`` writes a trace of a torch op."""
    tag = "t15"
    for m in (jstats, tstats):
        m.incr(f"{tag}/counter", 3)
        m.incr(f"{tag}/counter")
        m.set_enabled(False)
        m.incr(f"{tag}/counter", 100)
        m.set_enabled(True)
        for _ in range(2):
            with m.timed(f"{tag}/phase"):
                pass
    assert jstats.report().splitlines()[0] == "pbrt_tpu statistics:"
    assert tstats.report().splitlines()[0] == "pbrt_torch statistics:"
    jl, tl = _lines(jstats, tag), _lines(tstats, tag)
    assert len(jl) == len(tl) == 2 and jl[0] == tl[0] and "4" in tl[0]
    seconds = lambda s: re.sub(r"\d+\.\d{3}s", "#s", s)
    assert seconds(jl[1]) == seconds(tl[1]) and "(2 calls)" in tl[1]
    capsys.readouterr()
    outs = []
    for m in (jstats, tstats):
        p = m.ProgressReporter(4, title="t")
        p.update(2)
        p.finish()
        outs.append(re.sub(r"\d+\.\d", "#", capsys.readouterr().out))
    assert outs[0] == outs[1] and "[" + "+" * 20 in outs[1]
    with tstats.device_trace(str(tmp_path / "trace")) as d:
        torch.ones(8).add_(1)
    assert d == str(tmp_path / "trace") and os.listdir(d)
