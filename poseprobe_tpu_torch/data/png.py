"""A PNG reader on zlib and numpy, and the image reader the loaders use.

`read_png` decodes the PNGs that the datasets hold: bit depth 8 or 16; grey,
grey + alpha, RGB or RGBA; not interlaced; any of the five row filters. It
returns what `imageio.imread` returns for them: uint8 or uint16 pixels,
[H, W] for grey and [H, W, C] otherwise. `imread` reads a PNG through it on
every machine, and any other format (the JPEGs of the custom and Replica
layouts) through imageio or PIL where one is installed.
"""
from __future__ import annotations

import struct
import zlib

import numpy as np

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}        # colour type -> channels


def read_png(path: str) -> np.ndarray:
    """The pixels of the PNG file at `path`."""
    with open(path, "rb") as f:
        return decode_png(f.read(), str(path))


def decode_png(data: bytes, name: str = "<bytes>") -> np.ndarray:
    if data[:8] != _SIGNATURE:
        raise ValueError(f"{name}: not a PNG file")
    header, idat, pos = None, [], 8
    while pos + 8 <= len(data):
        length, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + length]
        pos += 12 + length                              # length, type, body, CRC
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    if header is None:
        raise ValueError(f"{name}: no IHDR chunk")
    W, H, depth, colour, _, _, interlace = header
    if colour not in _CHANNELS or depth not in (8, 16):
        raise ValueError(f"{name}: colour type {colour} at bit depth {depth} is not read "
                         "(grey, grey-alpha, RGB and RGBA at 8 or 16 bits are)")
    if interlace:
        raise ValueError(f"{name}: interlaced PNGs are not read")
    C = _CHANNELS[colour]
    bpp = C * depth // 8                                # bytes per pixel
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    if raw.size < H * (W * bpp + 1):
        raise ValueError(f"{name}: truncated image data")
    raw = raw[:H * (W * bpp + 1)].reshape(H, W * bpp + 1)
    ftype = raw[:, 0]
    if (ftype > 4).any():
        raise ValueError(f"{name}: unknown row filter {int(ftype.max())}")
    px = _unfilter(ftype, raw[:, 1:].reshape(H, W, bpp))
    if depth == 16:
        px = px.reshape(H, W * C * 2).view(">u2").astype(np.uint16)
    px = px.reshape(H, W, C)
    return px[..., 0] if C == 1 else px


def _unfilter(ftype: np.ndarray, rows: np.ndarray) -> np.ndarray:
    """Undo the row filters of [H, W, bpp] filtered bytes. A pixel depends on
    its left, upper and upper-left neighbours, so with Average or Paeth rows
    the pixels of one anti-diagonal are undone together."""
    H, W, _ = rows.shape
    if not np.isin(ftype, (3, 4)).any():                # None, Sub, Up: row by row
        out = np.empty_like(rows)
        prev = np.zeros_like(rows[0])
        for r in range(H):
            f = ftype[r]
            out[r] = (rows[r] if f == 0 else np.cumsum(rows[r], axis=0, dtype=np.uint8) if f == 1
                      else rows[r] + prev)
            prev = out[r]
        return out
    pad = np.zeros((H + 1, W + 1, rows.shape[2]), np.int16)   # pad[r + 1, i + 1] = pixel (r, i)
    x = rows.astype(np.int16)
    for d in range(H + W - 1):
        r = np.arange(max(0, d - W + 1), min(H - 1, d) + 1)
        i = d - r
        a, b, c = pad[r + 1, i], pad[r, i + 1], pad[r, i]
        p = a + b - c
        pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
        paeth = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
        f = ftype[r][:, None]
        pred = np.where(f == 1, a, np.where(f == 2, b, np.where(f == 3, (a + b) >> 1,
                                                                np.where(f == 4, paeth, 0))))
        pad[r + 1, i + 1] = (x[r, i] + pred) & 255
    return pad[1:, 1:].astype(np.uint8)


def imread(path: str) -> np.ndarray:
    """The pixels of an image file: a PNG through `read_png`, any other
    format through imageio or PIL."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:8] == _SIGNATURE:
        return decode_png(data, str(path))
    try:
        import imageio.v2 as imageio
        return np.asarray(imageio.imread(path))
    except ImportError:
        pass
    try:
        from PIL import Image
    except ImportError:
        raise ImportError(f"{path}: reading a file that is not a PNG needs imageio or PIL, "
                          "and neither is installed") from None
    with Image.open(path) as im:
        return np.asarray(im)
