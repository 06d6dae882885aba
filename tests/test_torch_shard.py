"""The port's sharded renderer on ``torch.distributed``
(``pbrt_torch/parallel/shard.py``) and the CLI's ``--distributed``, on
the CPU under ``gloo``.

- A world of 1 (no process group, and a ``gloo`` group of one) against
  the JAX package's ``render_sharded`` on a 1-device mesh: the tiny scene
  at 8×8, 2 spp, path depth 1; the render tolerance of
  ``test_torch_film.py::test_render_seed_matches_jax`` (pixels rtol 1e-4 /
  atol 1e-6 on ≥ 99% of pixels, per-bin sums within 1e-3 relative,
  weights and depths rtol 1e-5). With a group of one and without one the
  films are equal bit for bit.
- Two processes under ``gloo`` (a subprocess pair, as
  ``tests/test_distributed.py``) against the world of 1 on a 9×7 film (63
  pixels: one padding lane): weights and pixels equal bit for bit (box
  filter: each pixel's samples come from one rank, and the other rank's
  delta is exactly 0).
- Padding lanes (weight 0) add exactly nothing; the shares cover every
  pixel once.
- The CLI with ``--distributed … --num-processes 1 --process-id 0``
  renders the whole image in the process, as without it, and ignores
  ``--ndevices``, as the JAX CLI does (fact 47).
"""

import inspect
import os
import socket
import subprocess
import sys

import numpy as np
import torch

import pbrt_tpu.cli as jcli
from pbrt_tpu.parallel import shard as jshard
from pbrt_tpu.scene.api import load_scene_string as jload
from pbrt_tpu.scene.builder import build as jbuild
from pbrt_torch.film import film as film_mod
from pbrt_torch.parallel import shard
from pbrt_torch.renderers.sampler import render_wave
from pbrt_torch.scene.api import load_scene_string
from pbrt_torch.scene.builder import build
from torch_parity_util import tiny_scene_text

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TEXT = tiny_scene_text(8, 8, spp=2, max_depth=1)
FIELDS = ("pixels", "weight", "depth")


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_world_of_one_matches_jax():
    """No group, and a ``gloo`` group of one: the same film bit for bit,
    the JAX package's ``render_sharded`` on a 1-device mesh within the
    render tolerance."""
    import torch.distributed as dist

    b = build(load_scene_string(TEXT), device="cpu")
    alone = shard.render_sharded(b, spp=2, seed=0)
    rank, world = shard.init_distributed(f"127.0.0.1:{_free_port()}", 1, 0, "cpu")
    try:
        assert (rank, world) == (0, 1) and dist.get_backend() == "gloo"
        grouped = shard.render_sharded(b, spp=2, seed=0)
    finally:
        dist.destroy_process_group()
    for k in FIELDS:
        assert torch.equal(getattr(alone, k), getattr(grouped, k)), k
    jf = jshard.render_sharded(jbuild(jload(TEXT)), mesh=jshard.make_mesh(1), spp=2, seed=0)
    pj, pt = np.asarray(jf.pixels), grouped.pixels.numpy()
    assert np.isfinite(pt).all() and pt.sum() > 0
    assert np.isclose(pt, pj, rtol=1e-4, atol=1e-6).all(-1).mean() >= 0.99
    sj, st = pj.sum((0, 1)), pt.sum((0, 1))
    assert np.abs(st - sj).max() <= 1e-3 * np.abs(sj).max()
    np.testing.assert_allclose(grouped.weight.numpy(), np.asarray(jf.weight), rtol=1e-5)
    np.testing.assert_allclose(grouped.depth.numpy(), np.asarray(jf.depth), rtol=1e-5)
    assert not np.asarray(jf.splat).any()


WORKER = r"""
import sys
import numpy as np
import torch
sys.path.insert(0, {repo!r})
sys.path.insert(0, {tests!r})
torch.set_num_threads(1)
from pbrt_torch.parallel import shard
from pbrt_torch.scene.api import load_scene_string
from pbrt_torch.scene.builder import build
from torch_parity_util import tiny_scene_text
rank = int(sys.argv[1])
r, w = shard.init_distributed(sys.argv[2], 2, rank, "cpu")
assert (r, w) == (rank, 2), (r, w)
b = build(load_scene_string(tiny_scene_text(9, 7, spp=2, max_depth=2)), device="cpu")
f = shard.render_sharded(b, spp=2, seed=5, chunk_pixels=16)
torch.distributed.destroy_process_group()
if rank == 0:
    np.savez(sys.argv[3], pixels=f.pixels.numpy(), weight=f.weight.numpy(), depth=f.depth.numpy())
print(f"RANK{{rank}} OK")
"""


def test_two_processes_match_world_of_one(tmp_path):
    out = str(tmp_path / "film.npz")
    code = WORKER.format(repo=REPO, tests=os.path.join(REPO, "tests"))
    coord = f"127.0.0.1:{_free_port()}"
    procs = [subprocess.Popen([sys.executable, "-c", code, str(r), coord, out], cwd=REPO,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for r in range(2)]
    outs = []
    for p in procs:
        try:
            outs.append((p.returncode,) + p.communicate(timeout=300))
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
    for r, (_, so, se) in enumerate(outs):
        assert f"RANK{r} OK" in so, f"rank {r}:\n{so[-2000:]}\n{se[-3000:]}"
    b = build(load_scene_string(tiny_scene_text(9, 7, spp=2, max_depth=2)), device="cpu")
    one = shard.render_sharded(b, spp=2, seed=5, chunk_pixels=16)
    with np.load(out) as z:
        assert float(z["pixels"].sum()) > 0
        for k in FIELDS:
            np.testing.assert_array_equal(z[k], getattr(one, k).numpy(), err_msg=k)
    np.testing.assert_array_equal(one.weight.numpy(), 2.0)


def test_padding_adds_nothing():
    """Five shares of a 63-pixel film cover every pixel once at weight 1
    and pad with 2 duplicates at weight 0; a wave of the padding lanes
    alone leaves the film exactly 0."""
    b = build(load_scene_string(tiny_scene_text(9, 7, spp=1, max_depth=2)), device="cpu")
    shares = [shard.shard_pixels(b.film_config, 5, r) for r in range(5)]
    x, y, w = (np.concatenate(a) for a in zip(*shares))
    assert len(x) == 63 + 2 and all(len(s[0]) == 13 for s in shares)
    real = w == 1.0
    assert sorted(zip(y[real], x[real])) == [(j, i) for j in range(7) for i in range(9)]
    assert (w[~real] == 0.0).all() and list(zip(x[~real], y[~real])) == [(0, 0), (1, 0)]
    st = film_mod.init_film(b.film_config, "cpu")
    px, py = (torch.as_tensor(a[~real]) for a in (x, y))
    u = torch.full((2, 5 + 7 * 2), 0.5)
    render_wave(st, b.scene, b.camera, b.filter_table, px, py, b.integrator, b.film_config, u,
                sample_scale=torch.zeros(2))
    for k in FIELDS:
        assert torch.equal(getattr(st, k), torch.zeros_like(getattr(st, k))), k


def test_cli_distributed_renders_the_whole_image(tmp_path):
    """``--distributed 127.0.0.1:<port> --num-processes 1 --process-id 0
    --ndevices 4`` joins a group of one and writes the same .dat as a
    render without the flags (the whole image: fact 47); the JAX CLI parses
    ``--ndevices`` and never reads it, and its renderer does not shard."""
    scene = tmp_path / "tiny.pbrt"
    scene.write_text(tiny_scene_text(8, 8, spp=1, max_depth=1))
    runs = {}
    for label, extra in (("plain", []), ("distributed", [
            "--distributed", f"127.0.0.1:{_free_port()}", "--num-processes", "1",
            "--process-id", "0", "--ndevices", "4"])):
        out = str(tmp_path / f"{label}.dat")
        p = subprocess.run([sys.executable, "-m", "pbrt_torch.cli", str(scene), "--cpu",
                            "--outfile", out, *extra], cwd=REPO, capture_output=True,
                           text=True, timeout=300)
        assert p.returncode == 0, p.stderr[-3000:]
        runs[label] = (p.stdout, open(out, "rb").read())
    assert "distributed: process 0/1" in runs["distributed"][0]
    assert "distributed: process" not in runs["plain"][0]
    assert runs["plain"][1] == runs["distributed"][1]
    src = inspect.getsource(jcli)
    assert '"--ndevices"' in src and "args.ndevices" not in src
    assert "shard" not in inspect.getsource(jcli.main).split("render_scene(", 1)[1]
