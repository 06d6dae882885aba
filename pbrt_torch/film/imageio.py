"""Image I/O: EXR (scanline NONE/ZIP/ZIPS, HALF/FLOAT/UINT), TGA, PFM,
PNG, BMP and JPEG.

Port of ``pbrt_tpu/film/imageio.py`` (reference: src/core/imageio.{h,cpp},
ReadImage dispatching on the extension): a minimal OpenEXR 2.0 scanline
codec in numpy (zlib and the EXR byte predictor / deinterleave), the TGA
reader with its sRGB decode, and PFM through ``film/film.py``; for output
also 8-bit PNG and TGA writers. Host-side and numpy only, but for JPEG.

PNG (8-bit gray, gray + alpha, RGB, RGBA and palette, 1-, 2- and 4-bit
gray and palette, zlib and the five row filters, not interlaced) and BMP (24- and 32-bit uncompressed) are
decoded here; JPEG goes through Pillow, imported where a file is read or
written, as the JAX package reads all three (imageio.py:241-244, writes
:257-260): without Pillow it raises ``ImportError``, naming the package.
Like ``Image.open(path).convert("RGB")`` there, a reader keeps RGB (gray
repeated, the palette looked up, alpha dropped) and returns
``(x / 255) ** 2.2``, bit for bit the JAX reader's.
"""

from __future__ import annotations

import os
import struct
import zlib

import numpy as np

_EXR_MAGIC = 0x01312F76
_PT_UINT, _PT_HALF, _PT_FLOAT = 0, 1, 2
_DTYPES = {_PT_UINT: np.uint32, _PT_HALF: np.float16, _PT_FLOAT: np.float32}


def _read_cstr(buf, i):
    e = buf.index(b"\0", i)
    return buf[i:e].decode("latin-1"), e + 1


def _parse_channels(val: bytes):
    chans = []
    i = 0
    while i < len(val) and val[i] != 0:
        name, i = _read_cstr(val, i)
        ptype, _, x_samp, y_samp = struct.unpack_from("<iiii", val, i)
        i += 16
        chans.append((name, ptype))
    return chans


def _predictor_undo(data: bytes) -> bytes:
    """EXR byte predictor decode: out[0]=raw[0]; out[i]=out[i-1]+raw[i]-128."""
    raw = np.frombuffer(bytes(data), np.uint8).astype(np.int64)
    deltas = raw.copy()
    deltas[1:] -= 128
    out = np.cumsum(deltas) % 256
    return out.astype(np.uint8).tobytes()


def _deinterleave(data: bytes) -> bytes:
    n = len(data)
    half = (n + 1) // 2
    out = np.empty(n, np.uint8)
    a = np.frombuffer(data, np.uint8)
    out[0::2] = a[:half]
    out[1::2] = a[half : half + n // 2]
    return out.tobytes()


def _interleave(data: bytes) -> bytes:
    a = np.frombuffer(data, np.uint8)
    n = len(a)
    half = (n + 1) // 2
    out = np.empty(n, np.uint8)
    out[:half] = a[0::2]
    out[half:] = a[1::2]
    return out.tobytes()


def _predictor_apply(data: bytes) -> bytes:
    a = np.frombuffer(data, np.uint8).astype(np.int64)
    d = np.empty_like(a)
    d[0] = a[0]
    d[1:] = (a[1:] - a[:-1] + 128) % 256
    return d.astype(np.uint8).tobytes()


def read_exr(path: str) -> np.ndarray:
    """Read a scanline EXR → (H, W, C) float32 with channels ordered
    R, G, B[, A] when present (else alphabetical)."""
    with open(path, "rb") as f:
        buf = f.read()
    magic, version = struct.unpack_from("<ii", buf, 0)
    if magic != _EXR_MAGIC:
        raise ValueError(f"{path}: not an EXR file")
    if version & 0x200:
        raise ValueError(f"{path}: tiled EXR not supported")
    i = 8
    attrs = {}
    while True:
        name, i = _read_cstr(buf, i)
        if not name:
            break
        typ, i = _read_cstr(buf, i)
        size = struct.unpack_from("<i", buf, i)[0]
        i += 4
        attrs[name] = (typ, buf[i : i + size])
        i += size
    chans = _parse_channels(attrs["channels"][1])
    comp = attrs["compression"][1][0]
    x0, y0, x1, y1 = struct.unpack("<4i", attrs["dataWindow"][1])
    W = x1 - x0 + 1
    H = y1 - y0 + 1
    if comp == 0:
        lines_per_chunk = 1
    elif comp == 2:  # ZIPS
        lines_per_chunk = 1
    elif comp == 3:  # ZIP
        lines_per_chunk = 16
    else:
        raise ValueError(f"{path}: compression {comp} not supported (NONE/ZIP only)")
    n_chunks = (H + lines_per_chunk - 1) // lines_per_chunk
    offsets = struct.unpack_from(f"<{n_chunks}q", buf, i)
    bytes_per_px = sum(np.dtype(_DTYPES[pt]).itemsize for _, pt in chans)
    out = {name: np.empty((H, W), _DTYPES[pt]) for name, pt in chans}
    for ci, off in enumerate(offsets):
        y, nbytes = struct.unpack_from("<ii", buf, off)
        data = buf[off + 8 : off + 8 + nbytes]
        ny = min(lines_per_chunk, y1 - y + 1)
        raw_size = W * bytes_per_px * ny
        if comp in (2, 3):
            if nbytes < raw_size:
                data = zlib.decompress(data)
                data = _deinterleave(_predictor_undo(bytearray(data)))
        # scanline layout: per line, per channel (file order), W values
        pos = 0
        for line in range(ny):
            for name, pt in chans:
                dt = np.dtype(_DTYPES[pt]).newbyteorder("<")
                n = W * dt.itemsize
                out[name][y - y0 + line] = np.frombuffer(data[pos : pos + n], dt)
                pos += n
    names = [c[0] for c in chans]
    order = [n for n in ("R", "G", "B", "A", "Y") if n in names]
    order += [n for n in sorted(names) if n not in order]
    planes = [out[n].astype(np.float32) for n in order]
    return np.stack(planes, axis=-1)


def write_exr(path: str, img: np.ndarray, half: bool = True):
    """Write (H, W, C) as an uncompressed scanline EXR (C ∈ {1, 3, 4})."""
    img = np.asarray(img, np.float32)
    if img.ndim == 2:
        img = img[..., None]
    H, W, C = img.shape
    names = {1: ["Y"], 3: ["B", "G", "R"], 4: ["A", "B", "G", "R"]}[C]
    src_idx = {1: [0], 3: [2, 1, 0], 4: [3, 2, 1, 0]}[C]
    pt = _PT_HALF if half else _PT_FLOAT
    dt = np.dtype(_DTYPES[pt]).newbyteorder("<")

    def attr(name, typ, val):
        return (
            name.encode() + b"\0" + typ.encode() + b"\0"
            + struct.pack("<i", len(val)) + val
        )

    chlist = b""
    for n in names:
        chlist += n.encode() + b"\0" + struct.pack("<iiii", pt, 0, 1, 1)
    chlist += b"\0"
    header = struct.pack("<ii", _EXR_MAGIC, 2)
    header += attr("channels", "chlist", chlist)
    header += attr("compression", "compression", b"\0")
    box = struct.pack("<4i", 0, 0, W - 1, H - 1)
    header += attr("dataWindow", "box2i", box)
    header += attr("displayWindow", "box2i", box)
    header += attr("lineOrder", "lineOrder", b"\0")
    header += attr("pixelAspectRatio", "float", struct.pack("<f", 1.0))
    header += attr("screenWindowCenter", "v2f", struct.pack("<2f", 0, 0))
    header += attr("screenWindowWidth", "float", struct.pack("<f", 1.0))
    header += b"\0"
    line_bytes = W * dt.itemsize * len(names)
    table_start = len(header)
    data_start = table_start + 8 * H
    offsets = [data_start + y * (8 + line_bytes) for y in range(H)]
    with open(path, "wb") as f:
        f.write(header)
        f.write(struct.pack(f"<{H}q", *offsets))
        for y in range(H):
            f.write(struct.pack("<ii", y, line_bytes))
            for si in src_idx:
                f.write(img[y, :, si].astype(dt).tobytes())
    return path


def read_tga(path: str) -> np.ndarray:
    """Minimal TGA reader (types 2/10, 24/32bpp) → (H, W, 3|4) float32 with
    sRGB→linear decode (reference: imageio.cpp TGA gamma handling)."""
    with open(path, "rb") as f:
        hdr = f.read(18)
        idlen, cmap_type, img_type = hdr[0], hdr[1], hdr[2]
        W = struct.unpack_from("<H", hdr, 12)[0]
        H = struct.unpack_from("<H", hdr, 14)[0]
        bpp = hdr[16]
        desc = hdr[17]
        f.read(idlen)
        nch = bpp // 8
        if img_type == 2:
            data = np.frombuffer(f.read(W * H * nch), np.uint8).reshape(H, W, nch)
        elif img_type == 10:  # RLE
            out = np.empty((H * W, nch), np.uint8)
            raw = f.read()
            pos = 0
            px = 0
            while px < H * W:
                pkt = raw[pos]
                pos += 1
                cnt = (pkt & 0x7F) + 1
                if pkt & 0x80:
                    val = np.frombuffer(raw[pos : pos + nch], np.uint8)
                    pos += nch
                    out[px : px + cnt] = val
                else:
                    out[px : px + cnt] = np.frombuffer(
                        raw[pos : pos + cnt * nch], np.uint8
                    ).reshape(cnt, nch)
                    pos += cnt * nch
                px += cnt
            data = out.reshape(H, W, nch)
        else:
            raise ValueError(f"{path}: TGA type {img_type} unsupported")
    if not (desc & 0x20):  # bottom-up origin
        data = data[::-1]
    # BGR(A) → RGB(A)
    if nch >= 3:
        data = data[..., [2, 1, 0] + ([3] if nch == 4 else [])]
    lin = (data.astype(np.float32) / 255.0) ** 2.2
    return lin


def to_8bit(img: np.ndarray) -> np.ndarray:
    """Linear (H, W, 3) → 8-bit with the 1/2.2 gamma (imageio.py:260)."""
    return np.clip(np.asarray(img) ** (1 / 2.2) * 255.0, 0, 255).astype(np.uint8)


def write_tga(path: str, img: np.ndarray):
    """(H, W, 3) linear → uncompressed 24-bit TGA, top row first."""
    u8 = to_8bit(img)
    H, W, _ = u8.shape
    with open(path, "wb") as f:
        # no id, no colour map, type 2 (true colour), 24 bits, origin top left
        f.write(struct.pack("<BBBHHBHHHHBB", 0, 0, 2, 0, 0, 0, 0, 0, W, H, 24, 0x20))
        f.write(np.ascontiguousarray(u8[..., ::-1]).tobytes())  # BGR
    return path


def write_png(path: str, img: np.ndarray):
    """(H, W, 3) linear → 8-bit RGB PNG (zlib, no filter)."""
    return write_png_u8(path, to_8bit(img))


def write_png_u8(path: str, u8: np.ndarray):
    """(H, W, 3) uint8 → RGB PNG (zlib, no filter)."""
    H, W, _ = u8.shape

    def chunk(tag: bytes, data: bytes) -> bytes:
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))

    rows = np.concatenate([np.zeros((H, 1), np.uint8), u8.reshape(H, W * 3)], axis=1)
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n")
        f.write(chunk(b"IHDR", struct.pack(">IIBBBBB", W, H, 8, 2, 0, 0, 0)))
        f.write(chunk(b"IDAT", zlib.compress(rows.tobytes())))
        f.write(chunk(b"IEND", b""))
    return path


def write_image(path: str, img: np.ndarray):
    """(H, W, 3) linear RGB by extension (imageio.py:249-263): EXR and PFM
    as floats, PNG, TGA and JPEG (through Pillow) as 8 bits with the 1/2.2
    gamma."""
    ext = os.path.splitext(path)[1].lower()
    if ext == ".exr":
        return write_exr(path, img)
    if ext == ".pfm":
        from pbrt_torch.film.film import write_pfm

        return write_pfm(path, np.asarray(img, np.float32))
    if ext == ".png":
        return write_png(path, img)
    if ext == ".tga":
        return write_tga(path, img)
    if ext == ".jpg":
        _pillow().fromarray(to_8bit(img)).save(path)
        return path
    raise ValueError(f"unsupported image format {ext!r}")


_PNG_MAGIC = b"\x89PNG\r\n\x1a\n"
#: channels of each PNG colour type: gray, RGB, palette, gray + alpha, RGBA
_PNG_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}


def _unfilter_png(raw: bytes, H: int, stride: int, bpp: int) -> np.ndarray:
    """Undoes the per-row filters (none, sub, up, average, Paeth) of a PNG
    image's inflated bytes → (H, stride) uint8."""
    rows = np.frombuffer(raw, np.uint8)
    if rows.size != H * (stride + 1):
        raise ValueError(f"PNG: {rows.size} bytes of image data, expected {H * (stride + 1)}")
    rows = rows.reshape(H, stride + 1)
    out = np.zeros((H + 1, stride + bpp), np.int64)  # a zero row above, zero pixel left
    for y in range(H):
        kind, line = rows[y, 0], rows[y, 1:].astype(np.int64)
        up = out[y, bpp:]
        if kind == 0:
            cur = line
        elif kind == 1:  # sub: running sums along each channel
            cur = np.cumsum(line.reshape(-1, bpp), axis=0).reshape(-1) % 256
        elif kind == 2:
            cur = (line + up) % 256
        elif kind in (3, 4):
            row = out[y + 1]
            for x in range(0, stride, bpp):
                a = row[x:x + bpp]  # the pixel to the left (bytes x - bpp .. x)
                b = up[x:x + bpp]
                if kind == 3:
                    pred = (a + b) // 2
                else:
                    c = out[y, x:x + bpp]
                    p = a + b - c
                    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
                    pred = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
                row[x + bpp:x + 2 * bpp] = (line[x:x + bpp] + pred) % 256
            continue
        else:
            raise ValueError(f"PNG: unknown row filter {kind}")
        out[y + 1, bpp:] = cur
    return out[1:, bpp:].astype(np.uint8)


def read_png_rgb8(path: str) -> np.ndarray:
    """A PNG → (H, W, 3) uint8 RGB, as Pillow's ``convert("RGB")`` gives
    it."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:8] != _PNG_MAGIC:
        raise ValueError(f"{path}: not a PNG file")
    i, idat, palette, hdr = 8, [], None, None
    while i + 8 <= len(data):
        n, tag = struct.unpack_from(">I4s", data, i)
        body = data[i + 8:i + 8 + n]
        i += 12 + n
        if tag == b"IHDR":
            hdr = struct.unpack(">IIBBBBB", body)
        elif tag == b"PLTE":
            palette = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif tag == b"IDAT":
            idat.append(body)
        elif tag == b"IEND":
            break
    if hdr is None:
        raise ValueError(f"{path}: PNG without IHDR")
    W, H, depth, ctype, _, _, interlace = hdr
    low = depth in (1, 2, 4) and ctype in (0, 3)  # packed gray or palette indices
    if (depth != 8 and not low) or ctype not in _PNG_CHANNELS or interlace != 0:
        raise ValueError(f"{path}: PNG with bit depth {depth}, colour type {ctype}, "
                         f"interlace {interlace}: only 8-bit (1-, 2- or 4-bit gray or "
                         "palette), non-interlaced is read")
    nch = _PNG_CHANNELS[ctype]
    stride = (W * nch * depth + 7) // 8
    raw = _unfilter_png(zlib.decompress(b"".join(idat)), H, stride, max(1, nch * depth // 8))
    if low:
        per = 8 // depth
        shifts = (8 - depth) - depth * np.arange(per, dtype=np.uint8)
        px = ((raw[..., None] >> shifts) & ((1 << depth) - 1)).reshape(H, -1)[:, :W, None]
        if ctype == 0:  # gray stretched to 0..255, as Pillow's L;1/L;2/L;4
            px = px * (255 // ((1 << depth) - 1))
        px = px.astype(np.uint8)
    else:
        px = raw.reshape(H, W, nch)
    if ctype == 3:
        if palette is None:
            raise ValueError(f"{path}: palette PNG without PLTE")
        full = np.zeros((256, 3), np.uint8)
        full[:len(palette)] = palette
        return full[px[..., 0]]
    if ctype in (0, 4):
        return np.repeat(px[..., :1], 3, axis=-1)
    return np.ascontiguousarray(px[..., :3])


def read_bmp_rgb8(path: str) -> np.ndarray:
    """A 24- or 32-bit uncompressed BMP (bottom-up or top-down) → (H, W, 3)
    uint8 RGB."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:2] != b"BM":
        raise ValueError(f"{path}: not a BMP file")
    off = struct.unpack_from("<I", data, 10)[0]
    W, H, _, bpp, comp = struct.unpack_from("<iiHHI", data, 18)
    if bpp not in (24, 32) or comp not in (0, 3):
        raise ValueError(f"{path}: BMP with {bpp} bits per pixel, compression {comp}: "
                         "only 24- and 32-bit uncompressed is read")
    nb = bpp // 8
    stride = (bpp * W + 31) // 32 * 4
    rows = np.frombuffer(data, np.uint8, count=stride * abs(H), offset=off)
    px = rows.reshape(abs(H), stride)[:, :W * nb].reshape(abs(H), W, nb)
    if H > 0:  # bottom-up
        px = px[::-1]
    return np.ascontiguousarray(px[..., 2::-1])  # BGR(X) → RGB


def _pillow():
    """Pillow's ``Image``, imported where a JPEG is read or written."""
    try:
        from PIL import Image
    except ImportError as e:
        raise ImportError("JPEG images need Pillow (the PIL package), which is not "
                          "installed") from e
    return Image


def read_image(path: str) -> np.ndarray:
    """(H, W, C) float32 linear, by extension (imageio.cpp:31-60)."""
    ext = os.path.splitext(path)[1].lower()
    if ext == ".exr":
        return read_exr(path)
    if ext == ".tga":
        return read_tga(path)
    if ext == ".pfm":
        from pbrt_torch.film.film import read_pfm

        return read_pfm(path)
    if ext in (".png", ".jpg", ".jpeg", ".bmp"):
        if ext == ".png":
            rgb = read_png_rgb8(path)
        elif ext == ".bmp":
            rgb = read_bmp_rgb8(path)
        else:
            with _pillow().open(path) as im:
                rgb = np.asarray(im.convert("RGB"))
        return (rgb.astype(np.float32) / 255.0) ** 2.2
    raise ValueError(f"unsupported image format {ext!r}")
