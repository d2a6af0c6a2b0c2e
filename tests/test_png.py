"""imgio/png.py fast encoder: standards-compliant, lossless, validated
against Pillow's decoder (the serving/preview hot path depends on it)."""

import io

import numpy as np
import pytest

from mathmap_tpu.imgio.png import encode_png


def _decode(data):
    from PIL import Image

    return np.asarray(Image.open(io.BytesIO(data)))


def _frame(h=64, w=48, c=4, seed=0):
    rng = np.random.default_rng(seed)
    x = np.linspace(0, 1, w)[None, :] * np.linspace(0, 1, h)[:, None]
    arr = np.stack([x] * c, -1)
    arr = (arr * 255).astype(np.uint8)
    return np.clip(arr.astype(np.int16)
                   + rng.integers(-9, 9, arr.shape), 0, 255).astype(np.uint8)


@pytest.mark.parametrize("level", [0, 1, 6, 9])
@pytest.mark.parametrize("channels", [3, 4])
def test_roundtrip_exact(level, channels):
    arr = _frame(c=channels, seed=level)
    out = _decode(encode_png(arr, level))
    assert out.shape == arr.shape
    np.testing.assert_array_equal(out, arr)


def test_roundtrip_extremes():
    # all-0 / all-255 / alternating rows exercise the Sub filter's uint8
    # wraparound (delta is mod-256 by construction)
    h, w = 8, 8
    for fill in (0, 255):
        arr = np.full((h, w, 4), fill, np.uint8)
        np.testing.assert_array_equal(_decode(encode_png(arr)), arr)
    arr = np.zeros((h, w, 4), np.uint8)
    arr[::2] = 255
    np.testing.assert_array_equal(_decode(encode_png(arr)), arr)


def test_nonsquare_and_tiny():
    for shape in ((1, 1, 4), (1, 300, 3), (257, 3, 4)):
        arr = _frame(*shape, seed=7)
        np.testing.assert_array_equal(_decode(encode_png(arr)), arr)


def test_level0_store_is_larger_but_valid():
    arr = _frame(256, 256)
    stored = encode_png(arr, 0)
    packed = encode_png(arr, 1)
    assert len(stored) > len(packed)
    np.testing.assert_array_equal(_decode(stored), arr)


def test_rejects_bad_inputs():
    with pytest.raises(ValueError):
        encode_png(np.zeros((4, 4, 4), np.float32))
    with pytest.raises(ValueError):
        encode_png(np.zeros((4, 4, 2), np.uint8))
    with pytest.raises(ValueError):
        encode_png(np.zeros((4, 4), np.uint8))
    with pytest.raises(ValueError):
        encode_png(_frame(), level=10)
    with pytest.raises(ValueError):
        encode_png(_frame(), level=-1)


def test_noncontiguous_input():
    big = _frame(64, 64)
    view = big[::2, ::2]  # strided view
    np.testing.assert_array_equal(_decode(encode_png(view)), view)


# ---------------------------------------------------------------------------
# decoder (numpy + zlib): every row filter, checked against a per-pixel
# reference filter written out here from the PNG specification
# ---------------------------------------------------------------------------

def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    if pa <= pb and pa <= pc:
        return a
    return b if pb <= pc else c


def _filter_rows(arr, ftypes):
    """Encode (H, W, C) uint8 with the given per-row filter types, pixel
    by pixel (the specification's definition, no vectorization)."""
    h, w, c = arr.shape
    raw = arr.reshape(h, w * c).astype(np.int32)
    out = bytearray()
    for j in range(h):
        ft = ftypes[j % len(ftypes)]
        out.append(ft)
        for i in range(w * c):
            x = raw[j, i]
            a = raw[j, i - c] if i >= c else 0
            b = raw[j - 1, i] if j > 0 else 0
            cc = raw[j - 1, i - c] if (j > 0 and i >= c) else 0
            pred = (0, a, b, (a + b) // 2, _paeth(a, b, cc))[ft]
            out.append((x - pred) % 256)
    return bytes(out)


def _png_bytes(arr, ftypes, color=None, depth=8, interlace=0, idat_split=1):
    import struct
    import zlib

    from mathmap_tpu.imgio.png import _SIG, _chunk

    h, w, c = arr.shape
    color = {1: 0, 2: 4, 3: 2, 4: 6}[c] if color is None else color
    data = zlib.compress(_filter_rows(arr, ftypes))
    step = -(-len(data) // idat_split)
    idats = b"".join(_chunk(b"IDAT", data[k:k + step])
                     for k in range(0, len(data), step))
    ihdr = struct.pack(">IIBBBBB", w, h, depth, color, 0, 0, interlace)
    return _SIG + _chunk(b"IHDR", ihdr) + idats + _chunk(b"IEND", b"")


@pytest.mark.parametrize("ftype", [0, 1, 2, 3, 4])
@pytest.mark.parametrize("channels", [1, 2, 3, 4])
def test_decode_each_row_filter(ftype, channels):
    from mathmap_tpu.imgio.png import decode_png

    arr = _frame(h=9, w=11, c=channels, seed=ftype)
    got = decode_png(_png_bytes(arr, [ftype]))
    assert got.dtype == np.uint8 and got.shape == arr.shape
    np.testing.assert_array_equal(got, arr)


def test_decode_mixed_filters_and_split_idat():
    """Rows cycling through all five filters, IDAT split over chunks."""
    from mathmap_tpu.imgio.png import decode_png

    arr = _frame(h=17, w=13, c=4, seed=5)
    data = _png_bytes(arr, [4, 0, 3, 1, 2], idat_split=3)
    np.testing.assert_array_equal(decode_png(data), arr)


@pytest.mark.parametrize("channels", [3, 4])
def test_decode_own_encoder_output(channels):
    from mathmap_tpu.imgio.png import decode_png

    arr = _frame(h=40, w=70, c=channels, seed=2)
    for level in (0, 1):
        np.testing.assert_array_equal(decode_png(encode_png(arr, level)), arr)


@pytest.mark.parametrize("what", ["interlaced", "16-bit", "palette",
                                  "not-png", "truncated"])
def test_decode_refuses_what_it_does_not_handle(what):
    from mathmap_tpu.imgio.png import decode_png

    arr = _frame(h=4, w=4, c=3)
    data = {"interlaced": lambda: _png_bytes(arr, [0], interlace=1),
            "16-bit": lambda: _png_bytes(arr, [0], depth=16),
            "palette": lambda: _png_bytes(arr[..., :1], [0], color=3),
            "not-png": lambda: b"GIF89a" + b"\0" * 40,
            "truncated": lambda: encode_png(arr)[:30]}[what]()
    with pytest.raises(ValueError):
        decode_png(data)


def test_read_image_and_animation_need_no_pillow(tmp_path, monkeypatch):
    """PNG reads go through the numpy decoder: with Pillow made
    unimportable, read_image / read_animation / image_size still work
    (gray+alpha expands to RGBA)."""
    import builtins

    from mathmap_tpu.imgio import images

    arr = _frame(h=12, w=20, c=2, seed=9)
    p = tmp_path / "ga.png"
    p.write_bytes(_png_bytes(arr, [1, 4]))
    real_import = builtins.__import__

    def no_pil(name, *a, **k):
        if name == "PIL" or name.startswith("PIL."):
            raise ImportError("no Pillow here")
        return real_import(name, *a, **k)

    monkeypatch.setattr(builtins, "__import__", no_pil)
    rgba = images.read_image(str(p))
    assert rgba.shape == (12, 20, 4)
    np.testing.assert_allclose(rgba[..., 0], arr[..., 0] / 255.0, atol=1e-7)
    np.testing.assert_allclose(rgba[..., 2], arr[..., 0] / 255.0, atol=1e-7)
    np.testing.assert_allclose(rgba[..., 3], arr[..., 1] / 255.0, atol=1e-7)
    with open(p, "rb") as fh:
        stack = images.read_animation(fh, as_uint8=True)
    assert stack.dtype == np.uint8 and stack.shape == (1, 12, 20, 4)
    assert images.image_size(str(p)) == (20, 12)
    out = tmp_path / "out.png"
    images.write_image(str(out), rgba)
    np.testing.assert_array_equal(images.read_animation(str(out), True)[0],
                                  stack[0])
    # non-PNG formats still need Pillow, and say so
    gif = tmp_path / "x.gif"
    gif.write_bytes(b"GIF89a" + b"\0" * 32)
    with pytest.raises(RuntimeError, match="Pillow is required"):
        images.image_size(str(gif))


def test_serve_decode_input_png_without_pillow(monkeypatch):
    import base64
    import builtins

    from mathmap_tpu.serve import _decode_input

    arr = _frame(h=6, w=5, c=4, seed=3)
    b64 = base64.b64encode(encode_png(arr)).decode()
    real_import = builtins.__import__

    def no_pil(name, *a, **k):
        if name == "PIL" or name.startswith("PIL."):
            raise ImportError("no Pillow here")
        return real_import(name, *a, **k)

    monkeypatch.setattr(builtins, "__import__", no_pil)
    got = _decode_input(b64)
    np.testing.assert_array_equal(got, arr)
