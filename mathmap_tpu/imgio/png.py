"""PNG codec in numpy + zlib: the serving/CLI hot path needs no Pillow.

Encoder: a fixed Sub (type-1) row filter computed as one vectorized numpy
delta, then one `zlib.compress` call — Pillow's encoder spends most of its
time in its adaptive row-filter heuristics. `level=0` (store) skips the
filter for latency-critical localhost hops. The output is a fully
standard PNG (8-bit RGB/RGBA, one IDAT).

Decoder: 8-bit gray, gray+alpha, RGB and RGBA, non-interlaced, all five
row filters. Each row is unfiltered with numpy over the whole row (Sub
and Paeth need a left-to-right pass over pixels, done one pixel column
of all channels at a time). Palette, 16-bit and interlaced files are
refused with a ValueError; read_image falls back to Pillow for those.

Reference analog: rwimg/rwpng.c (libpng) [unverified — reference mount
empty, SURVEY.md §0].
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

_SIG = b"\x89PNG\r\n\x1a\n"


def _chunk(tag: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + tag + data
            + struct.pack(">I", zlib.crc32(tag + data)))


def encode_png(arr: np.ndarray, level: int = 1) -> bytes:
    """uint8 (H, W, 3|4) -> PNG bytes (lossless).

    `level` is the zlib effort 0-9; 0 stores uncompressed (fastest, for
    localhost/LAN responses), 1 (default) matches Pillow-level-1 sizes at
    a fraction of the time. Rows use the Sub filter (left-neighbor delta)
    except at level 0, where filtering is skipped — store mode gains
    nothing from it and the delta pass costs ~7 ms at 512^2.
    """
    arr = np.asarray(arr)
    if arr.dtype != np.uint8 or arr.ndim != 3 or arr.shape[2] not in (3, 4):
        raise ValueError(
            f"encode_png expects uint8 (H, W, 3|4), got {arr.dtype} "
            f"{arr.shape}")
    if not 0 <= int(level) <= 9:
        raise ValueError(f"png level must be 0..9, got {level}")
    h, w, c = arr.shape
    raw = np.ascontiguousarray(arr).reshape(h, w * c)
    if level == 0:
        ftype, rows = 0, raw
    else:
        ftype = 1  # Sub: delta against the pixel to the left (bpp stride)
        rows = raw.copy()
        rows[:, c:] = raw[:, c:] - raw[:, :-c]  # uint8 wraparound == mod 256
    buf = np.empty((h, w * c + 1), np.uint8)
    buf[:, 0] = ftype
    buf[:, 1:] = rows
    idat = zlib.compress(buf.tobytes(), int(level))
    color = 6 if c == 4 else 2  # RGBA / RGB, 8-bit
    ihdr = struct.pack(">IIBBBBB", w, h, 8, color, 0, 0, 0)
    return (_SIG + _chunk(b"IHDR", ihdr) + _chunk(b"IDAT", idat)
            + _chunk(b"IEND", b""))


#: PNG color type -> channels (8-bit depth only)
_CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}


def png_size(data: bytes) -> tuple:
    """(width, height) from a PNG's IHDR — a header-only read."""
    if data[:8] != _SIG or data[12:16] != b"IHDR":
        raise ValueError("not a PNG file")
    w, h = struct.unpack(">II", data[16:24])
    return int(w), int(h)


def decode_png(data: bytes) -> np.ndarray:
    """PNG bytes -> uint8 (H, W, C) with C = 1, 2, 3 or 4 channels.

    Raises ValueError for anything but 8-bit gray/gray+alpha/RGB/RGBA,
    non-interlaced — the caller may fall back to a full codec."""
    if data[:8] != _SIG:
        raise ValueError("not a PNG file")
    pos = 8
    ihdr = None
    idat = []
    while pos + 8 <= len(data):
        (n,) = struct.unpack(">I", data[pos:pos + 4])
        tag = data[pos + 4:pos + 8]
        body = data[pos + 8:pos + 8 + n]
        if len(body) != n:
            raise ValueError("truncated PNG chunk")
        if tag == b"IHDR":
            ihdr = struct.unpack(">IIBBBBB", body)
        elif tag == b"IDAT":
            idat.append(body)
        elif tag == b"IEND":
            break
        pos += 12 + n
    if ihdr is None or not idat:
        raise ValueError("PNG without IHDR or IDAT")
    w, h, depth, color, _comp, _filt, interlace = ihdr
    if depth != 8 or color not in _CHANNELS or interlace:
        raise ValueError(
            f"unsupported PNG (bit depth {depth}, color type {color}, "
            f"interlace {interlace})")
    c = _CHANNELS[color]
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    if raw.size != h * (w * c + 1):
        raise ValueError("PNG pixel data does not match its header")
    raw = raw.reshape(h, w * c + 1)
    ftypes = raw[:, 0]
    if ftypes.max(initial=0) > 4:
        raise ValueError(f"bad PNG row filter {int(ftypes.max())}")
    rows = raw[:, 1:].reshape(h, w, c)
    if ftypes.max(initial=0) <= 2:
        return _unfilter_rows(rows, ftypes)
    return _unfilter_wavefront(rows, ftypes)


def _unfilter_rows(rows, ftypes):
    """None/Sub/Up only: each row is one vectorized step (Sub is a
    running sum per channel, mod 256)."""
    out = np.empty_like(rows)
    prev = np.zeros_like(rows[0])
    for j, ftype in enumerate(ftypes):
        if ftype == 0:
            out[j] = rows[j]
        elif ftype == 1:
            out[j] = np.cumsum(rows[j], axis=0, dtype=np.uint8)
        else:
            out[j] = rows[j] + prev
        prev = out[j]
    return out


def _unfilter_wavefront(rows, ftypes):
    """Any mix of the five filters. Pixel (j, i) depends on its left, up
    and up-left neighbours only, so all pixels of one anti-diagonal
    i + j = d reconstruct together: h + w - 1 vectorized steps."""
    h, w, c = rows.shape
    # one zero row above and one zero column left: the neighbours the
    # filters read outside the image
    out = np.zeros((h + 1, w + 1, c), np.int16)
    ft = ftypes.astype(np.int16)
    for d in range(h + w - 1):
        js = np.arange(max(0, d - w + 1), min(h - 1, d) + 1)
        is_ = d - js
        x = rows[js, is_].astype(np.int16)
        a = out[js + 1, is_]
        b = out[js, is_ + 1]
        cc = out[js, is_]
        p = a + b - cc
        pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - cc)
        paeth = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, cc))
        f = ft[js][:, None]
        pred = np.where(f == 1, a, np.where(f == 2, b, np.where(
            f == 3, (a + b) >> 1, np.where(f == 4, paeth, 0))))
        out[js + 1, is_ + 1] = (x + pred) & 255
    return out[1:, 1:].astype(np.uint8)
