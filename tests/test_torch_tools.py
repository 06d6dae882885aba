"""The port's offline tools (``python -m pbrt_torch.tools``) against the
JAX package's (``pbrt_tpu/tools.py``) on the same inputs, made in
``tmp_path`` from a numpy seed: each tool's exit code and printed lines
equal (output file names swapped), and its output files equal: images
decoded pixel for pixel (the port writes PNG in numpy, the JAX tool
through Pillow), text byte for byte. ``bsdftest``'s estimates (printed to
4 decimals) within 1e-3; they are drawn from the same threefry uniforms.
"""

import struct

import numpy as np
import pytest
from PIL import Image as PIL

from pbrt_tpu import tools as jtools
from pbrt_torch import tools as ttools
from pbrt_torch.film.imageio import read_exr, write_exr, write_png_u8


@pytest.fixture
def inputs(tmp_path):
    rng = np.random.default_rng(15)
    a = rng.uniform(0.0, 2.0, (5, 6, 3)).astype(np.float32)
    b = a.copy()
    b[1, 2] *= 1.3  # 30% off: big under -t 10, small under -t 50
    b[3, 4, 0] += 0.01
    paths = {k: str(tmp_path / f"{k}.exr") for k in ("a", "b")}
    write_exr(paths["a"], a, half=False)
    write_exr(paths["b"], b, half=False)
    u8 = rng.integers(0, 256, (4, 7, 3), dtype=np.uint8)
    paths["png"] = write_png_u8(str(tmp_path / "ldr.png"), u8)
    for k, d in (("dat1", 0.0), ("dat2", 0.05)):
        data = rng.uniform(0, 1, (32, 6, 5)) + d
        with open(tmp_path / f"{k}.dat", "wb") as f:
            f.write(b"6 5 32\n50 4 30\n")
            f.write(data.astype("<f8").tobytes())
        paths[k] = str(tmp_path / f"{k}.dat")
    verts = rng.uniform(-1, 1, (6, 3)).astype(np.float32)
    faces = [(0, 1, 2), (2, 3, 4, 5), (1, 3, 5, 0, 4)]
    head = ["ply", "", "element vertex 6", "property float x", "property float y",
            "property float z", "element face 3", "property list uchar int vertex_indices",
            "end_header"]
    for fmt in ("ascii", "binary_little_endian"):
        head[1] = f"format {fmt} 1.0"
        with open(tmp_path / f"{fmt}.ply", "wb") as f:
            f.write(("\n".join(head) + "\n").encode())
            if fmt == "ascii":
                f.write("".join(" ".join(f"{v:g}" for v in r) + "\n" for r in verts).encode())
                f.write("".join(f"{len(p)} " + " ".join(map(str, p)) + "\n"
                                for p in faces).encode())
            else:
                f.write(verts.astype("<f4").tobytes())
                for p in faces:
                    f.write(struct.pack("<B", len(p)) + np.asarray(p, "<i4").tobytes())
        paths[fmt] = str(tmp_path / f"{fmt}.ply")
    return paths


def _both(capsys, tool, args_j, args_t=None):
    """(rc, stdout) of the JAX tool, then the port's."""
    capsys.readouterr()
    rj = jtools.main([tool, *args_j])
    oj = capsys.readouterr().out
    rt = ttools.main([tool, *(args_j if args_t is None else args_t)])
    ot = capsys.readouterr().out
    return (rj, oj), (rt, ot)


@pytest.mark.parametrize("case", ["same", "differ", "tolerance", "loose"])
def test_exrdiff(inputs, capsys, tmp_path, case):
    a, b = inputs["a"], inputs["b"]
    args = {"same": [a, a], "differ": [a, b], "tolerance": ["-t", "10", a, b],
            "loose": ["-t", "50", a, b]}[case]
    dj, dt = str(tmp_path / "dj.exr"), str(tmp_path / "dt.exr")
    j, t = _both(capsys, "exrdiff", ["-o", dj, *args], ["-o", dt, *args])
    assert j[0] == t[0] == (0 if case in ("same", "loose") else 1)
    assert j[1].replace(dj, dt) == t[1]
    np.testing.assert_array_equal(read_exr(dt), read_exr(dj))


def test_exravg(inputs, capsys):
    j, t = _both(capsys, "exravg", [inputs["a"], inputs["b"]])
    assert j == t and t[1].count("avg = ") == 2


@pytest.mark.parametrize("ext", [".png", ".tiff"])
def test_exrtotiff(inputs, capsys, tmp_path, ext):
    oj, ot = str(tmp_path / f"j{ext}"), str(tmp_path / f"t{ext}")
    for flags in ([], ["-scale", "2", "-gamma", "1.8", "-tonemap"]):
        j, t = _both(capsys, "exrtotiff", [*flags, inputs["a"], oj], [*flags, inputs["a"], ot])
        assert j[0] == t[0] == 0 and j[1].replace(oj, ot) == t[1]
        with PIL.open(oj) as ij, PIL.open(ot) as it:
            np.testing.assert_array_equal(np.asarray(it), np.asarray(ij))


def test_tifftoexr(inputs, capsys, tmp_path):
    oj, ot = str(tmp_path / "j.exr"), str(tmp_path / "t.exr")
    j, t = _both(capsys, "tifftoexr", [inputs["png"], oj], [inputs["png"], ot])
    assert j[0] == t[0] == 0 and j[1].replace(oj, ot) == t[1]
    np.testing.assert_array_equal(read_exr(ot), read_exr(oj))


def test_samplepat(capsys, tmp_path):
    oj, ot = str(tmp_path / "j.txt"), str(tmp_path / "t.txt")
    j, t = _both(capsys, "samplepat", ["24", oj], ["24", ot])
    assert j[0] == t[0] == 0 and j[1].replace(oj, ot) == t[1]
    assert open(oj).read() == open(ot).read()


def test_bsdftest(capsys):
    j, t = _both(capsys, "bsdftest", [], ["--cpu"])
    assert j[0] == t[0] == 0
    lj, lt = j[1].splitlines(), t[1].splitlines()
    assert len(lj) == len(lt) == 3
    for a, b in zip(lj, lt):
        assert a[:28] == b[:28]
        nums = lambda s: [float(x) for x in s.split() if x.replace(".", "").isdigit()]
        np.testing.assert_allclose(nums(b), nums(a), atol=1e-3)
    assert abs(float(lt[0].split()[-1]) - 0.8) < 1e-3


@pytest.mark.parametrize("fmt", ["ascii", "binary_little_endian"])
def test_ply2pbrt(inputs, capsys, tmp_path, fmt):
    j, t = _both(capsys, "ply2pbrt", [inputs[fmt]])
    assert j == t and t[0] == 0 and '"integer indices"' in t[1]
    oj, ot = str(tmp_path / "j.pbrt"), str(tmp_path / "t.pbrt")
    j, t = _both(capsys, "ply2pbrt", [inputs[fmt], oj], [inputs[fmt], ot])
    assert j[1].replace(oj, ot) == t[1] and "(6 verts, 6 tris)" in t[1]
    assert open(oj).read() == open(ot).read()


def test_datdiff(inputs, capsys):
    j, t = _both(capsys, "datdiff", [inputs["dat1"], inputs["dat2"]])
    assert j == t and t[0] == 0 and "max abs diff" in t[1]


def test_unknown_tool_prints_usage(capsys):
    j, t = _both(capsys, "nosuchtool", [])
    assert j[0] == t[0] == 2 and "exrdiff" in t[1]
    assert ttools.main([]) == 2
