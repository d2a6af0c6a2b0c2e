"""Host-side image I/O: PNG/JPEG/GIF read/write, RGBA float <-> uint8.

Reference: `rwimg/` C codecs returning 8-bit RGBA buffers (SURVEY.md §1
layer 2 [unverified — mount empty, SURVEY.md §0]). I/O is host-side and not a
performance target (SURVEY §2.3 item 7). PNG (the CLI's and the service's
format) and PPM/PAM need only numpy and zlib (imgio/png.py, native/);
Pillow is imported lazily, for GIF, JPEG and the rarer PNG variants only.
A native C fast-path for pack/unpack lives in native/ (built lazily) for
large batch animation output.
"""

from __future__ import annotations

import numpy as np

from .png import decode_png, png_size


def _pil():
    try:
        from PIL import Image
    except ImportError as exc:
        raise RuntimeError(
            "Pillow is required for GIF/JPEG and other non-PNG image files "
            "(PNG, PPM and PAM need no extra package)") from exc
    return Image


def _read_bytes(file) -> bytes:
    if hasattr(file, "read"):
        return file.read()
    with open(file, "rb") as f:
        return f.read()


def _decode_png_rgba(data: bytes):
    """uint8 (H, W, 4) RGBA from PNG bytes, or None when the file is not
    a PNG this decoder handles (palette, 16-bit, interlaced)."""
    try:
        arr = decode_png(data)
    except ValueError:
        return None
    c = arr.shape[2]
    if c == 4:
        return arr
    alpha = (arr[..., 1:2] if c == 2
             else np.full(arr.shape[:2] + (1,), 255, np.uint8))
    rgb = arr[..., :1].repeat(3, axis=2) if c in (1, 2) else arr
    return np.concatenate([rgb, alpha], axis=2)


def image_size(path: str) -> tuple:
    """(width, height) of an image file without decoding its pixels."""
    with open(path, "rb") as f:
        head = f.read(32)
    try:
        return png_size(head)
    except ValueError:
        pass
    with _pil().open(path) as im:
        return im.size


def to_float_rgba(arr: np.ndarray) -> np.ndarray:
    """uint8 (H,W,{1,3,4}) or float array -> float32 (H,W,4) in [0,1]."""
    arr = np.asarray(arr)
    if arr.dtype == np.uint8:
        from .. import native

        arr = native.u8_to_f32(arr)
    else:
        arr = arr.astype(np.float32)
    if arr.ndim == 2:
        arr = arr[:, :, None]
    if arr.shape[2] == 1:
        arr = np.repeat(arr, 3, axis=2)
    if arr.shape[2] == 3:
        alpha = np.ones(arr.shape[:2] + (1,), np.float32)
        arr = np.concatenate([arr, alpha], axis=2)
    if arr.shape[2] != 4:
        raise ValueError(f"expected 1/3/4 channels, got {arr.shape[2]}")
    return arr


def to_uint8(arr: np.ndarray) -> np.ndarray:
    """float (H,W,4) in [0,1] -> uint8, with the reference's round-to-nearest
    8-bit packing (native hot loop when available). uint8 input passes
    through — renders with RenderOptions(output_dtype='uint8') packed on
    device with the identical rule."""
    arr = np.asarray(arr)
    if arr.dtype == np.uint8:
        return arr
    from .. import native

    return native.f32_to_u8(np.asarray(arr, dtype=np.float32))


def read_image(path: str) -> np.ndarray:
    """Read an image file -> float32 (H,W,4) RGBA in [0,1]."""
    if path.lower().endswith((".ppm", ".pam", ".pnm")):
        from .. import native

        data = native.read_image_native(path)
        if data is not None:
            return to_float_rgba(data)
        if path.lower().endswith(".pam"):
            # Pillow has no PAM codec — pure-Python reader mirrors the
            # pure-Python writer fallback in write_image
            return to_float_rgba(_read_pam_py(path))
    data = _read_bytes(path)
    rgba = _decode_png_rgba(data)
    if rgba is None:
        import io

        rgba = np.asarray(_pil().open(io.BytesIO(data)).convert("RGBA"))
    return to_float_rgba(rgba)


def _read_pam_py(path: str) -> np.ndarray:
    with open(path, "rb") as f:
        if f.readline().strip() != b"P7":
            raise ValueError(f"not a PAM file: {path}")
        hdr = {}
        while True:
            line = f.readline()
            if not line:
                raise ValueError(f"truncated PAM header: {path}")
            tok = line.split()
            if not tok or tok[0] == b"#":
                continue
            if tok[0] == b"ENDHDR":
                break
            hdr[tok[0]] = tok[1] if len(tok) > 1 else b""
        w, h = int(hdr[b"WIDTH"]), int(hdr[b"HEIGHT"])
        depth = int(hdr.get(b"DEPTH", b"4"))
        if not (0 < w <= 1 << 20 and 0 < h <= 1 << 20 and depth in (3, 4)):
            raise ValueError(f"bad PAM header dims {w}x{h}x{depth}: {path}")
        raw = np.frombuffer(f.read(w * h * depth), np.uint8)
        if raw.size != w * h * depth:
            raise ValueError(f"truncated PAM pixel data: {path}")
    arr = raw.reshape(h, w, depth)
    return arr


def read_animation(file, as_uint8: bool = False) -> np.ndarray:
    """Read a multi-frame image file (animated GIF) -> float32 (T, H, W, 4)
    stack for ANIMATED inputs (origValXY frame-indexed sampling; the
    reference's multi-frame input drawables came from GIMP layer stacks
    [unverified — mount empty]). `file` is a path or a file-like object.
    Single-frame files return (1, H, W, 4); multi-frame files whose frames
    disagree in size (multi-page TIFF with a thumbnail page) keep only the
    frames matching frame 0's geometry — an animation has one geometry.
    as_uint8=True skips the float conversion and returns the decoded
    (T, H, W, 4) uint8 — the render paths normalize u8 in-trace, so a u8
    stack ships 4× fewer bytes host→device (the serving layer's choice).
    PNG files (always one frame) decode without Pillow."""
    import io

    data = _read_bytes(file)
    rgba = _decode_png_rgba(data)
    if rgba is not None:
        return (rgba if as_uint8 else to_float_rgba(rgba))[None]
    img = _pil().open(io.BytesIO(data))
    frames = []
    try:
        i = 0
        while True:
            img.seek(i)
            f = np.asarray(img.convert("RGBA"))
            if not as_uint8:
                f = to_float_rgba(f)
            if not frames or f.shape == frames[0].shape:
                frames.append(f)
            i += 1
    except EOFError:
        pass
    return np.stack(frames)


def write_animation(path: str, frames, fps: float = 25.0) -> None:
    """Write an (F, H, W, 4) float sequence as an animated GIF (or stacked
    frames for other formats via write_image). The reference emitted one
    GIMP layer per frame; the headless analog is an animation file."""
    frames = np.asarray(frames)
    if not path.lower().endswith(".gif"):
        raise ValueError("write_animation writes .gif files")
    if frames.ndim != 4 or frames.shape[0] == 0:
        raise ValueError(
            f"write_animation needs a non-empty (F,H,W,4) sequence, got "
            f"shape {frames.shape}")
    if fps <= 0:
        raise ValueError(f"fps must be > 0, got {fps}")
    pil = _pil()
    imgs = [pil.fromarray(to_uint8(f), "RGBA").convert("P") for f in frames]
    imgs[0].save(
        path, save_all=True, append_images=imgs[1:],
        duration=int(1000 / fps), loop=0, disposal=2,
    )


def write_image(path: str, arr) -> None:
    """Write a float (H,W,4) RGBA array in [0,1] to an image file. PPM/PAM
    go through the native codec (fast batch-animation dumps, rwimg analog)."""
    data = to_uint8(np.asarray(arr))
    lower = path.lower()
    if lower.endswith((".pam", ".ppm", ".pnm")):
        from .. import native

        ok = native.write_pam(path, data) if lower.endswith(".pam") else native.write_ppm(path, data)
        if ok:
            return
        if lower.endswith(".pam"):
            # no C toolchain: pure-Python PAM writer (Pillow has no .pam
            # encoder, so falling through crashed — review r3); the format
            # is a trivial header + raw RGBA bytes
            h, w = data.shape[:2]
            with open(path, "wb") as f:
                f.write(b"P7\nWIDTH %d\nHEIGHT %d\nDEPTH 4\nMAXVAL 255\n"
                        b"TUPLTYPE RGB_ALPHA\nENDHDR\n" % (w, h))
                f.write(np.ascontiguousarray(data).tobytes())
            return
    if lower.endswith(".png"):
        from .png import encode_png

        with open(path, "wb") as f:
            f.write(encode_png(data))
        return
    img = _pil().fromarray(data, mode="RGBA")
    if lower.endswith((".jpg", ".jpeg")):
        img = img.convert("RGB")
    img.save(path)
