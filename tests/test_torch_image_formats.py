"""The port's PNG, BMP and JPEG readers against the JAX package's
(``pbrt_tpu/film/imageio.py:241-244``, which reads them through Pillow's
``Image.open(path).convert("RGB")``): texels equal bit for bit, on files
written by Pillow and on PNGs written here row filter by row filter.

The port decodes PNG and BMP itself (numpy and zlib: the card's machine
has no Pillow) and reads and writes JPEG through Pillow, imported where a
file is read; without Pillow that raises ``ImportError`` naming it.
"""

import builtins
import os
import struct
import zlib

import numpy as np
import pytest
from PIL import Image

from pbrt_tpu.film import imageio as jio
from pbrt_tpu.scene.api import load_scene_string as jload
from pbrt_tpu.scene.builder import build as jbuild
from pbrt_torch.film import imageio as tio
from pbrt_torch.scene.api import load_scene_string as tload
from pbrt_torch.scene.builder import build as tbuild
from tests.torch_parity_util import tiny_scene_text


def _both(path):
    a, b = tio.read_image(path), jio.read_image(path)
    np.testing.assert_array_equal(a, b)
    assert a.dtype == b.dtype == np.float32 and a.shape == b.shape
    return a


def _pixels(mode, shape, seed):
    return Image.fromarray(np.random.default_rng(seed).integers(0, 256, shape, dtype=np.uint8),
                           mode)


@pytest.mark.parametrize("mode,shape", [("RGB", (17, 23, 3)), ("RGBA", (9, 31, 4)),
                                        ("L", (13, 7)), ("LA", (5, 6, 2))])
@pytest.mark.parametrize("optimize", [False, True])
def test_png_modes_equal_jax(tmp_path, mode, shape, optimize):
    """Pillow's PNGs of each colour type (with its adaptive row filters when
    optimizing)."""
    path = str(tmp_path / f"{mode}.png")
    _pixels(mode, shape, len(mode)).save(path, optimize=optimize)
    img = _both(path)
    assert img.shape == shape[:2] + (3,)


@pytest.mark.parametrize("bits", [1, 2, 4, 8])
def test_palette_png_equal_jax(tmp_path, bits):
    path = str(tmp_path / f"p{bits}.png")
    _pixels("RGB", (11, 13, 3), bits).quantize(2 ** bits).save(path, bits=bits)
    _both(path)


def test_one_bit_gray_png_equal_jax(tmp_path):
    path = str(tmp_path / "g1.png")
    _pixels("L", (9, 14), 5).convert("1").save(path)
    img = _both(path)
    assert set(np.unique(img).tolist()) == {0.0, 1.0}


def _write_png(path, px, filters):
    """An RGB PNG with row y filtered by ``filters[y % len(filters)]``."""
    H, W, C = px.shape
    raw = px.astype(np.int64).reshape(H, W * C)
    out = []
    prev = np.zeros(W * C, np.int64)
    for y in range(H):
        f = filters[y % len(filters)]
        row = raw[y]
        left = np.concatenate([np.zeros(C, np.int64), row[:-C]])
        upleft = np.concatenate([np.zeros(C, np.int64), prev[:-C]])
        if f == 0:
            enc = row
        elif f == 1:
            enc = row - left
        elif f == 2:
            enc = row - prev
        elif f == 3:
            enc = row - (left + prev) // 2
        else:
            p = left + prev - upleft
            pa, pb, pc = np.abs(p - left), np.abs(p - prev), np.abs(p - upleft)
            enc = row - np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, prev, upleft))
        out.append(bytes([f]) + (enc % 256).astype(np.uint8).tobytes())
        prev = row

    def chunk(tag, data):
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))

    with open(path, "wb") as fh:
        fh.write(b"\x89PNG\r\n\x1a\n")
        fh.write(chunk(b"IHDR", struct.pack(">IIBBBBB", W, H, 8, 2, 0, 0, 0)))
        fh.write(chunk(b"IDAT", zlib.compress(b"".join(out))))
        fh.write(chunk(b"IEND", b""))


@pytest.mark.parametrize("filters", [(0,), (1,), (2,), (3,), (4,), (4, 3, 2, 1, 0)])
def test_png_row_filters_equal_jax(tmp_path, filters):
    """Each of the five row filters (and all in turn), written here; the
    texels are the image's, as Pillow decodes them too."""
    px = np.random.default_rng(sum(filters) + len(filters)).integers(0, 256, (12, 19, 3))
    path = str(tmp_path / "f.png")
    _write_png(path, px, filters)
    img = _both(path)
    np.testing.assert_array_equal(img, (px.astype(np.float32) / 255.0) ** 2.2)


@pytest.mark.parametrize("mode,shape", [("RGB", (17, 23, 3)), ("RGB", (4, 5, 3)),
                                        ("RGBA", (9, 31, 4))])
def test_bmp_equal_jax(tmp_path, mode, shape):
    """24-bit (rows padded to 4 bytes) and 32-bit BMPs from Pillow."""
    path = str(tmp_path / "b.bmp")
    _pixels(mode, shape, shape[0]).save(path)
    _both(path)


def test_top_down_bmp(tmp_path):
    """A negative height stores the rows top down."""
    path = str(tmp_path / "b.bmp")
    _pixels("RGB", (6, 5, 3), 3).save(path)
    data = bytearray(open(path, "rb").read())
    H = struct.unpack_from("<i", data, 22)[0]
    off = struct.unpack_from("<I", data, 10)[0]
    stride = (24 * 5 + 31) // 32 * 4
    rows = [bytes(data[off + r * stride: off + (r + 1) * stride]) for r in range(H)]
    data[off:off + H * stride] = b"".join(rows[::-1])
    struct.pack_into("<i", data, 22, -H)
    flipped = str(tmp_path / "t.bmp")
    open(flipped, "wb").write(bytes(data))
    np.testing.assert_array_equal(tio.read_image(flipped), tio.read_image(path))


@pytest.mark.parametrize("mode,shape", [("RGB", (16, 24, 3)), ("L", (8, 8))])
def test_jpeg_through_pillow_equal_jax(tmp_path, mode, shape):
    path = str(tmp_path / "j.jpg")
    _pixels(mode, shape, 1).save(path, quality=90)
    _both(path)
    jpeg = str(tmp_path / "j.jpeg")
    os.replace(path, jpeg)
    _both(jpeg)


def test_jpeg_without_pillow_names_it(tmp_path, monkeypatch):
    """Where Pillow is missing, reading or writing a JPEG raises
    ImportError naming it; PNG and BMP need nothing."""
    path = str(tmp_path / "j.jpg")
    _pixels("RGB", (8, 8, 3), 2).save(path)
    png = str(tmp_path / "p.png")
    _pixels("RGB", (8, 8, 3), 2).save(png)
    real_import = builtins.__import__

    def no_pil(name, *args, **kwargs):
        if name == "PIL" or name.startswith("PIL."):
            raise ModuleNotFoundError("No module named 'PIL'")
        return real_import(name, *args, **kwargs)

    monkeypatch.setattr(builtins, "__import__", no_pil)
    with pytest.raises(ImportError, match="Pillow"):
        tio.read_image(path)
    with pytest.raises(ImportError, match="Pillow"):
        tio.write_image(str(tmp_path / "o.jpg"), np.zeros((2, 2, 3), np.float32))
    assert tio.read_image(png).shape == (8, 8, 3)


def test_unsupported_png_and_bmp_raise(tmp_path):
    """16-bit PNGs and 8-bit BMPs are refused with a ValueError (a texture
    that fails to load warns and is black, as in the JAX package)."""
    p16 = str(tmp_path / "d.png")
    Image.fromarray(np.zeros((4, 4), np.uint16) + 300).save(p16)
    with pytest.raises(ValueError, match="bit depth 16"):
        tio.read_image(p16)
    b8 = str(tmp_path / "g.bmp")
    _pixels("L", (4, 4), 1).save(b8)
    with pytest.raises(ValueError, match="8 bits per pixel"):
        tio.read_image(b8)
    bad = str(tmp_path / "x.png")
    open(bad, "wb").write(b"not a png")
    with pytest.raises(ValueError, match="not a PNG"):
        tio.read_image(bad)


def test_jpeg_written_through_pillow(tmp_path):
    img = np.random.default_rng(0).uniform(0, 1, (6, 9, 3)).astype(np.float32)
    a, b = str(tmp_path / "t.jpg"), str(tmp_path / "j.jpg")
    tio.write_image(a, img)
    jio.write_image(b, img)
    assert open(a, "rb").read() == open(b, "rb").read()


@pytest.mark.parametrize("ext", [".png", ".bmp", ".jpg"])
def test_imagemap_texture_from_each_format(tmp_path, ext):
    """An imagemap texture from each format: both builders' texel pools are
    equal bit for bit."""
    path = str(tmp_path / f"tex{ext}")
    _pixels("RGB", (8, 16, 3), 9).save(path)
    text = tiny_scene_text(4, 4).replace(
        'Material "matte" "color Kd" [.6 .6 .6]',
        f'Texture "img" "spectrum" "imagemap" "string filename" "{path}"\n'
        'Material "matte" "texture Kd" "img"', 1)
    assert '"imagemap"' in text
    jb, tb = jbuild(jload(text)), tbuild(tload(text), device="cpu")
    jt, tt = jb.scene.textures, tb.scene.textures
    np.testing.assert_array_equal(tt.pool_rgb.numpy(), np.asarray(jt.pool_rgb))
    assert tt.pool_rgb.shape[0] > 16 * 8
