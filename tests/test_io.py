import numpy as np
import pytest

from slowflow_tpu.io import (
    read_flo, write_flo, read_edges, write_edges, read_matches, write_matches,
    read_pbm, write_pbm, read_image, write_image,
)


def test_flo_roundtrip(tmp_path, rng):
    flow = rng.normal(size=(7, 5, 2)).astype(np.float32)
    p = tmp_path / "a.flo"
    write_flo(p, flow)
    out = read_flo(p)
    np.testing.assert_array_equal(out, flow)


def test_flo_binary_layout(tmp_path):
    """Byte-level check against the reference writer (io.c:78-96)."""
    flow = np.zeros((2, 3, 2), np.float32)
    flow[0, 1] = (1.5, -2.5)
    p = tmp_path / "b.flo"
    write_flo(p, flow)
    raw = p.read_bytes()
    assert np.frombuffer(raw[:4], np.float32)[0] == np.float32(202021.25)
    assert np.frombuffer(raw[4:12], np.int32).tolist() == [3, 2]
    vals = np.frombuffer(raw[12:], np.float32).reshape(2, 3, 2)
    assert vals[0, 1, 0] == 1.5 and vals[0, 1, 1] == -2.5


def test_flo_bad_magic(tmp_path):
    p = tmp_path / "bad.flo"
    p.write_bytes(b"\x00" * 16)
    with pytest.raises(ValueError):
        read_flo(p)


def test_edges_roundtrip(tmp_path, rng):
    e = rng.random((6, 9)).astype(np.float32)
    p = tmp_path / "edges.dat"
    write_edges(p, e)
    np.testing.assert_array_equal(read_edges(p, 9, 6), e)


def test_matches_roundtrip(tmp_path):
    p = tmp_path / "m.txt"
    p.write_text("1 2 3 4 extra stuff 9\n5.5 6 7 8\n# junk\n")
    m = read_matches(p)
    assert m.shape == (2, 4)
    np.testing.assert_allclose(m[0], [1, 2, 3, 4])
    np.testing.assert_allclose(m[1], [5.5, 6, 7, 8])
    p2 = tmp_path / "m2.txt"
    write_matches(p2, m)
    np.testing.assert_allclose(read_matches(p2), m)


def test_pbm_roundtrip(tmp_path):
    mask = np.zeros((5, 8), np.uint8)
    mask[1, 2] = 255
    mask[4, 7] = 255
    p = tmp_path / "o.pbm"
    write_pbm(p, mask)
    out = read_pbm(p)
    np.testing.assert_array_equal(out, mask)


def test_image_roundtrip_8bit(tmp_path, rng):
    img = (rng.random((4, 6, 3)) * 255).astype(np.uint8)
    p = tmp_path / "img.png"
    write_image(p, img.astype(np.float32))
    out = read_image(p)
    np.testing.assert_array_equal(out, img.astype(np.float32))


def test_image_roundtrip_16bit(tmp_path, rng):
    img = (rng.random((4, 6)) * 65535).astype(np.uint16)
    p = tmp_path / "img16.png"
    write_image(p, img.astype(np.float32), bit16=True)
    out = read_image(p)
    np.testing.assert_array_equal(out, img.astype(np.float32))


def test_flo_error_paths(tmp_path):
    """Corrupt/truncated .flo files fail loudly with the file named
    (io.c:78-96 magic check semantics)."""
    import pytest
    from slowflow_tpu.io import read_flo, write_flo

    bad = tmp_path / "bad.flo"
    bad.write_bytes(b"\x00\x01\x02\x03" + b"\x00" * 32)
    with pytest.raises(ValueError, match="not a .flo"):
        read_flo(bad)

    trunc = tmp_path / "trunc.flo"
    write_flo(trunc, np.zeros((8, 10, 2), np.float32))
    data = trunc.read_bytes()
    trunc.write_bytes(data[: len(data) // 2])
    with pytest.raises(ValueError, match="truncated"):
        read_flo(trunc)

    with pytest.raises(FileNotFoundError):
        read_flo(tmp_path / "missing.flo")


@pytest.mark.parametrize("shape,bit16", [((5, 9), False), ((5, 9, 3), False),
                                         ((5, 9), True), ((5, 9, 3), True)])
def test_png_roundtrip_gray_rgb_8_16bit(tmp_path, rng, shape, bit16):
    top = 65535 if bit16 else 255
    img = np.floor(rng.random(shape) * (top + 1)).astype(np.float32)
    p = tmp_path / "rt.png"
    write_image(p, img, bit16=bit16)
    assert p.read_bytes()[:8] == b"\x89PNG\r\n\x1a\n"
    np.testing.assert_array_equal(read_image(p), img)


def test_pbm_binary_layout(tmp_path):
    """P4 with the PBM convention: bit 1 = black, rows padded to bytes."""
    mask = np.zeros((2, 10), np.uint8)
    mask[0, 0] = 255                      # white -> bit 0
    mask[1, 9] = 255
    p = tmp_path / "m.pbm"
    write_pbm(p, mask)
    raw = p.read_bytes()
    assert raw.startswith(b"P4\n10 2\n")
    body = np.frombuffer(raw[len(b"P4\n10 2\n"):], np.uint8)
    assert body.tolist() == [0b01111111, 0b11000000, 0b11111111, 0b10000000]
    np.testing.assert_array_equal(read_pbm(p), mask)


def test_pnm_ascii_and_binary(tmp_path):
    p = tmp_path / "a.pgm"
    p.write_bytes(b"P2\n# comment\n3 2\n255\n0 10 20\n30 40 255\n")
    np.testing.assert_array_equal(read_image(p),
                                  [[0, 10, 20], [30, 40, 255]])
    q = tmp_path / "b.ppm"
    q.write_bytes(b"P6 2 1 65535\n" + np.array(
        [1, 2, 3, 60000, 5, 6], ">u2").tobytes())
    np.testing.assert_array_equal(read_image(q),
                                  [[[1, 2, 3], [60000, 5, 6]]])
    r = tmp_path / "c.pbm"
    r.write_bytes(b"P1\n3 2\n1 0 1\n0 1 0\n")
    np.testing.assert_array_equal(read_pbm(r), [[0, 255, 0], [255, 0, 255]])


def test_png_decode_matches_pillow():
    """The parity frame (written by another encoder, with its own filter
    choices) decodes to the same pixels as Pillow."""
    import os

    Image = pytest.importorskip("PIL.Image")
    path = os.path.join(os.path.dirname(__file__), "parity", "im1.png")
    want = np.asarray(Image.open(path)).astype(np.float32)
    got = read_image(path)
    assert got.shape == (96, 128, 3)
    np.testing.assert_array_equal(got, want)


def test_png_palette_and_alpha(tmp_path):
    """Palette and RGBA PNGs written by hand: palette indices expand to RGB,
    alpha is dropped; every filter type (None/Sub/Up/Average/Paeth)."""
    import struct
    import zlib

    def png(path, w, h, depth, ctype, rows, plte=None):
        def chunk(kind, body):
            return (struct.pack(">I", len(body)) + kind + body
                    + struct.pack(">I", zlib.crc32(kind + body)))
        data = b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", struct.pack(
            ">IIBBBBB", w, h, depth, ctype, 0, 0, 0))
        if plte is not None:
            data += chunk(b"PLTE", plte.tobytes())
        path.write_bytes(data + chunk(b"IDAT", zlib.compress(rows))
                         + chunk(b"IEND", b""))

    plte = np.array([[0, 0, 0], [255, 0, 0], [0, 255, 0], [9, 9, 9]],
                    np.uint8)
    # 2-bit palette, 5 px per row: indices 0 1 2 3 1 -> 00011011 01000000
    png(tmp_path / "p.png", 5, 1, 2, 3, bytes([0, 0b00011011, 0b01000000]),
        plte)
    np.testing.assert_array_equal(read_image(tmp_path / "p.png")[0],
                                  plte[[0, 1, 2, 3, 1]])

    rgba = (np.arange(5 * 2 * 4) * 7 % 256).astype(np.uint8).reshape(5, 2, 4)
    raw = rgba.reshape(5, 8).astype(np.int64)
    rows = b""
    prior = np.zeros(8, np.int64)
    for ftype, line in enumerate(raw):      # one filter type per row
        left = np.concatenate([[0] * 4, line[:-4]])
        upleft = np.concatenate([[0] * 4, prior[:-4]])
        if ftype == 0:
            enc = line
        elif ftype == 1:
            enc = line - left
        elif ftype == 2:
            enc = line - prior
        elif ftype == 3:
            enc = line - (left + prior) // 2
        else:
            pa = np.abs(prior - upleft)
            pb = np.abs(left - upleft)
            pc = np.abs(left + prior - 2 * upleft)
            pred = np.where((pa <= pb) & (pa <= pc), left,
                            np.where(pb <= pc, prior, upleft))
            enc = line - pred
        rows += bytes([ftype]) + (enc % 256).astype(np.uint8).tobytes()
        prior = line
    png(tmp_path / "a.png", 2, 5, 8, 6, rows)
    np.testing.assert_array_equal(read_image(tmp_path / "a.png"),
                                  rgba[..., :3])


def _filtered_png(img: np.ndarray, filters) -> bytes:
    """PNG bytes of uint8/uint16 [H, W] or [H, W, 3] with the scanline
    filter types `filters` cycled over the rows (vectorised encoder)."""
    import struct
    import zlib

    h, w = img.shape[:2]
    ch = 1 if img.ndim == 2 else img.shape[2]
    depth = 16 if img.dtype == np.uint16 else 8
    bpp = ch * depth // 8
    rows = img.astype(">u2" if depth == 16 else np.uint8).reshape(h, -1)
    rows = rows.view(np.uint8).reshape(h, -1).astype(np.int32)
    left = np.zeros_like(rows)
    left[:, bpp:] = rows[:, :-bpp]
    up = np.zeros_like(rows)
    up[1:] = rows[:-1]
    upleft = np.zeros_like(rows)
    upleft[1:, bpp:] = rows[:-1, :-bpp]
    p = left + up - upleft
    pa, pb, pc = np.abs(p - left), np.abs(p - up), np.abs(p - upleft)
    paeth = np.where((pa <= pb) & (pa <= pc), left,
                     np.where(pb <= pc, up, upleft))
    ftype = np.resize(np.asarray(filters, np.uint8), h)
    preds = np.stack([np.zeros_like(rows), left, up, (left + up) >> 1,
                      paeth])[ftype, np.arange(h)]
    raw = np.concatenate([ftype[:, None], (rows - preds) % 256], 1)

    def chunk(kind, body):
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body)))

    return (b"\x89PNG\r\n\x1a\n"
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth,
                                         0 if ch == 1 else 2, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(raw.astype(np.uint8).tobytes(), 1))
            + chunk(b"IEND", b""))


@pytest.mark.parametrize("ftype", [0, 1, 2, 3, 4])
def test_png_filters_native_and_python_agree(tmp_path, rng, monkeypatch,
                                             ftype):
    """Every scanline filter decodes exactly, through the C++ unfilter and
    through the Python fallback, for 8-bit RGB and 16-bit gray."""
    from slowflow_tpu.io import images

    for img in (rng.integers(0, 256, (7, 11, 3)).astype(np.uint8),
                rng.integers(0, 65536, (6, 5)).astype(np.uint16)):
        p = tmp_path / "f.png"
        p.write_bytes(_filtered_png(img, [ftype, 4, ftype, 3]))
        np.testing.assert_array_equal(read_image(p), img)
        with monkeypatch.context() as m:
            m.setattr(images, "png_unfilter", lambda *a: None)
            np.testing.assert_array_equal(read_image(p), img)


def test_png_paeth_frame_decodes_fast(tmp_path, rng):
    """A 1080p RGB frame whose rows use Paeth and Average (the filters
    photographic encoders pick) decodes exactly in well under a second."""
    import time

    from slowflow_tpu.native import get_lib

    assert get_lib() is not None, "C++ helper failed to build"
    yy, xx = np.mgrid[0:1080, 0:1920]
    img = np.stack([128 + 100 * np.sin(xx / 37.0 + c) * np.cos(yy / 23.0)
                    for c in range(3)], -1)
    img = np.clip(img + rng.normal(0, 3, img.shape), 0, 255).astype(np.uint8)
    p = tmp_path / "frame.png"
    p.write_bytes(_filtered_png(img, [4, 4, 3, 4]))
    t0 = time.perf_counter()
    got = read_image(p)
    elapsed = time.perf_counter() - t0
    np.testing.assert_array_equal(got, img)
    assert elapsed < 1.0, elapsed
