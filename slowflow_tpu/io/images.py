"""Image I/O: PNG and PBM/PGM/PPM (8- and 16-bit) in numpy, other formats
through Pillow when it is installed.

Replaces the reference's OpenCV `imread(..., CV_LOAD_IMAGE_UNCHANGED)` usage
(slow_flow.cpp:470) and libpng/libjpeg loaders (epic_flow_extended/io.c:192-403).
PNG (gray, RGB, RGBA, gray+alpha and palette; 1-16 bit; non-interlaced) and
the netpbm formats are decoded here with `zlib`/`struct`, so the pipeline's
own formats need nothing beyond numpy; the PNG scanline unfilter runs in the
package's C++ helper (native/png.cpp). Images are returned as float32 arrays:
  grayscale/raw -> [H, W]
  color         -> [H, W, 3] RGB (alpha dropped)
"""
from __future__ import annotations

import os
import struct
import zlib

import numpy as np

from ..native import png_unfilter

_PNG_SIG = b"\x89PNG\r\n\x1a\n"
_PNM_MAGIC = (b"P1", b"P2", b"P3", b"P4", b"P5", b"P6")
_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}      # PNG colour type -> samples


# --------------------------------------------------------------------- PNG
def _unfilter(raw: bytes, h: int, stride: int, bpp: int) -> np.ndarray:
    """Undo the per-scanline PNG filters (spec §9.2). Returns [h, stride]
    uint8. Runs in the package's C++ helper; without a C++ toolchain,
    None/Sub/Up rows are vectorised here and Average/Paeth rows walk the
    row in Python (seconds per 1080p frame)."""
    out = png_unfilter(raw, h, stride, bpp)
    if out is not None:
        return out
    rows = np.frombuffer(raw, np.uint8)[:h * (stride + 1)].reshape(
        h, stride + 1)
    out = np.zeros((h, stride), np.uint8)
    prior = np.zeros(stride, np.uint8)
    for y in range(h):
        ftype, line = rows[y, 0], rows[y, 1:]
        if ftype == 0:
            cur = line.copy()
        elif ftype == 1:
            pad = (-stride) % bpp
            cur = np.cumsum(np.pad(line, (0, pad)).reshape(-1, bpp), axis=0,
                            dtype=np.uint8).reshape(-1)[:stride]
        elif ftype == 2:
            cur = line + prior
        elif ftype in (3, 4):
            cur = bytearray(line.tobytes())
            up = prior.tobytes()
            for i in range(stride):
                a = cur[i - bpp] if i >= bpp else 0
                b = up[i]
                if ftype == 3:
                    cur[i] = (cur[i] + ((a + b) >> 1)) & 0xFF
                else:
                    c = up[i - bpp] if i >= bpp else 0
                    p = a + b - c
                    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
                    pred = a if (pa <= pb and pa <= pc) else (
                        b if pb <= pc else c)
                    cur[i] = (cur[i] + pred) & 0xFF
            cur = np.frombuffer(bytes(cur), np.uint8)
        else:
            raise ValueError(f"bad PNG filter type {ftype}")
        out[y] = cur
        prior = out[y]
    return out


def _read_png(data: bytes) -> np.ndarray:
    """Decode a PNG. Returns uint8/uint16 [H, W] (gray) or [H, W, C]."""
    pos = 8
    idat = []
    palette = None
    while pos < len(data):
        n, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + n]
        pos += 12 + n
        if kind == b"IHDR":
            w, h, depth, ctype, _, _, interlace = struct.unpack(">IIBBBBB",
                                                                body)
        elif kind == b"PLTE":
            palette = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    if interlace:
        raise ValueError("interlaced PNG is not supported")
    ch = _CHANNELS[ctype]
    bits = depth * ch
    stride = (w * bits + 7) // 8
    rows = _unfilter(zlib.decompress(b"".join(idat)), h, stride,
                     max(1, bits // 8))
    if depth == 16:
        img = rows.view(">u2").astype(np.uint16).reshape(h, w, ch)
    elif depth == 8:
        img = rows.reshape(h, w, ch)
    else:                                          # 1/2/4-bit samples
        img = np.unpackbits(rows, axis=1).reshape(h, -1, depth)
        img = (img * (1 << np.arange(depth - 1, -1, -1))).sum(-1)
        img = img[:, :w].astype(np.uint8)[..., None]
        if ctype == 0:
            img = img * np.uint8(255 // ((1 << depth) - 1))
    if ctype == 3:
        return palette[img[..., 0]]
    if ch in (1, 2):                               # gray (+ alpha)
        return img[..., 0]
    return img[..., :3]


def _write_png(path, arr: np.ndarray) -> None:
    """Encode uint8/uint16 [H, W] or [H, W, 3] as PNG (filter 0)."""
    h, w = arr.shape[:2]
    ctype = 2 if arr.ndim == 3 else 0
    depth = 16 if arr.dtype == np.uint16 else 8
    rows = arr.astype(">u2" if depth == 16 else np.uint8).reshape(h, -1)
    rows = rows.view(np.uint8).reshape(h, -1)
    raw = np.concatenate([np.zeros((h, 1), np.uint8), rows], 1).tobytes()

    def chunk(kind, body):
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF))

    with open(path, "wb") as fh:
        fh.write(_PNG_SIG
                 + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, ctype,
                                              0, 0, 0))
                 + chunk(b"IDAT", zlib.compress(raw, 6))
                 + chunk(b"IEND", b""))


# --------------------------------------------------------------- PBM/PGM/PPM
def _read_pnm(data: bytes) -> np.ndarray:
    """Decode P1-P6. Bitmaps come back as bool (True = white, the PBM 0 bit);
    PGM/PPM as uint8 or uint16 by maxval."""
    magic = data[:2]
    tokens = []
    pos = 2
    need = 2 if magic in (b"P1", b"P4") else 3
    while len(tokens) < need:
        while data[pos:pos + 1].isspace():
            pos += 1
        if data[pos:pos + 1] == b"#":
            pos = data.index(b"\n", pos)
            continue
        start = pos
        while not data[pos:pos + 1].isspace():
            pos += 1
        tokens.append(int(data[start:pos]))
    w, h = tokens[0], tokens[1]
    maxval = tokens[2] if need == 3 else 1
    ch = 3 if magic in (b"P3", b"P6") else 1
    if magic in (b"P1", b"P2", b"P3"):
        body = data[pos:]
        if magic == b"P1":
            vals = [int(c) for c in body.decode("ascii") if c in "01"]
        else:
            vals = [int(t) for t in body.split()]
        img = np.asarray(vals[:w * h * ch], np.uint16 if maxval > 255
                         else np.uint8)
    else:
        body = data[pos + 1:]
        if magic == b"P4":
            stride = (w + 7) // 8
            img = np.unpackbits(np.frombuffer(body[:stride * h], np.uint8)
                                .reshape(h, stride), axis=1)[:, :w]
        elif maxval > 255:
            img = np.frombuffer(body[:2 * w * h * ch], ">u2").astype(np.uint16)
        else:
            img = np.frombuffer(body[:w * h * ch], np.uint8)
    if magic in (b"P1", b"P4"):
        return np.asarray(img).reshape(h, w) == 0
    return img.reshape((h, w, 3) if ch == 3 else (h, w))


def _pillow(path):
    try:
        from PIL import Image
    except ImportError as e:
        raise ImportError(
            f"{os.fspath(path)}: only PNG and PBM/PGM/PPM are decoded "
            "without Pillow; install Pillow to read other formats") from e
    return Image


def _decode(path) -> np.ndarray:
    with open(path, "rb") as fh:
        data = fh.read()
    if data.startswith(_PNG_SIG) and data[28] == 0:     # non-interlaced
        return _read_png(data)
    if data[:2] in _PNM_MAGIC:
        return _read_pnm(data)
    img = _pillow(path).open(path)
    if img.mode == "P":
        img = img.convert("RGB")
    arr = np.asarray(img)
    if arr.ndim == 3 and arr.shape[2] == 4:
        arr = arr[:, :, :3]
    return arr


def read_image(path) -> np.ndarray:
    """Read an image file unchanged (8/16-bit preserved) as float32.

    16-bit single channel images (the raw Bayer teasers) come back as [H, W]
    with values in 0..65535; 8-bit color as [H, W, 3] in 0..255.
    """
    return _decode(path).astype(np.float32)


def is_16bit(path) -> bool:
    return _decode(path).dtype == np.uint16


def write_image(path, arr: np.ndarray, bit16: bool = False) -> None:
    """Write a PNG. arr is [H, W] or [H, W, 3]; clipped to the dtype range."""
    arr = np.asarray(arr)
    if bit16:
        _write_png(path, np.clip(arr, 0, 65535).astype(np.uint16))
    else:
        _write_png(path, np.clip(arr, 0, 255).astype(np.uint8))


def read_pbm(path) -> np.ndarray:
    """Read a PBM/PGM/PNG binary mask as uint8 {0, 255} array [H, W].

    The reference stores occlusion maps as binary PBM via OpenCV
    (slow_flow.cpp:899-904) and reads them back with imread
    (dense_tracking.cpp:1169).
    """
    arr = _decode(path)
    if arr.dtype == bool:
        arr = arr.astype(np.uint8) * 255
    if arr.ndim == 3:
        arr = arr[..., 0]
    return arr.astype(np.uint8)


def write_pbm(path, arr: np.ndarray) -> None:
    """Write a {0, 255}-valued mask as binary PBM (pixel >= 128 -> white,
    stored as the PBM 0 bit)."""
    white = np.asarray(arr) >= 128
    h, w = white.shape
    with open(path, "wb") as fh:
        fh.write(b"P4\n%d %d\n" % (w, h))
        fh.write(np.packbits(~white, axis=1).tobytes())
