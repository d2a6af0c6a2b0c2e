"""Native fast-path filters: operations implemented whole-image rather than
per-pixel.

Reference: `native_filters.c` — notably gaussian blur as a separable
convolution, exposed as a function usable from filter code, with a result
cache (`native_filter_cache`) so repeated applications inside one render are
free (SURVEY.md §2.1 native-fast-path row [unverified — mount empty,
SURVEY.md §0]).

Design: separable convolution via two 1-D `lax.conv_general_dilated`
passes (SURVEY §2.3 item 6) instead of a per-pixel kernel loop, at
HIGHEST precision — a float32 convolution may otherwise run in TF32 on a
GPU's tensor cores, about three decimal digits. The cache is keyed on
(image identity, params) per invocation.
"""

from __future__ import annotations

import math

import numpy as np

from ..utils.errors import MMTypeError
from .value import InputImage


def _gauss_kernel(stddev: float, radius: int) -> np.ndarray:
    xs = np.arange(-radius, radius + 1, dtype=np.float64)
    k = np.exp(-0.5 * (xs / stddev) ** 2)
    return (k / k.sum()).astype(np.float32)


def gaussian_blur_pixels(be, pixels, stddev: float):
    """Separable gaussian blur of an (H, W, 4) image; edges use zero padding
    on premultiplied data? No — the reference blurs raw channels with
    renormalized kernels at the border [unverified]; we use SAME zero-pad
    with kernel renormalization via a ones-image divisor. Animated
    (T, H, W, 4) stacks blur frame-by-frame."""
    if getattr(pixels, "ndim", 3) == 4:
        return be.stack([gaussian_blur_pixels(be, pixels[i], stddev)
                         for i in range(pixels.shape[0])])
    stddev = max(float(stddev), 1e-3)
    radius = max(1, int(math.ceil(3.0 * stddev)))
    k = _gauss_kernel(stddev, radius)

    if be.__name__.startswith("jax"):
        import jax

        img = be.transpose(pixels, (2, 0, 1))[:, None]  # (4,1,H,W)
        ones = be.ones_like(img[:1])
        kx = be.asarray(k).reshape(1, 1, 1, len(k))
        ky = be.asarray(k).reshape(1, 1, len(k), 1)

        def conv(x, kern, pad):
            return jax.lax.conv_general_dilated(
                x, kern, window_strides=(1, 1), padding=pad,
                dimension_numbers=("NCHW", "OIHW", "NCHW"),
                precision=jax.lax.Precision.HIGHEST,
            )

        pad_x = [(0, 0), (radius, radius)]
        pad_y = [(radius, radius), (0, 0)]
        blurred = conv(conv(img, kx, pad_x), ky, pad_y)
        norm = conv(conv(ones, kx, pad_x), ky, pad_y)
        out = blurred / norm
        return be.transpose(out[:, 0], (1, 2, 0))

    # NumPy oracle: direct separable correlation with renormalization.
    img = np.asarray(pixels, dtype=np.float32)
    h, w, _ = img.shape
    padded = np.zeros((h, w + 2 * radius, 4), np.float32)
    padded[:, radius : radius + w] = img
    mask = np.zeros((h, w + 2 * radius), np.float32)
    mask[:, radius : radius + w] = 1.0
    outx = np.zeros_like(img)
    mx = np.zeros((h, w), np.float32)
    for i, kv in enumerate(k):
        outx += kv * padded[:, i : i + w]
        mx += kv * mask[:, i : i + w]
    padded = np.zeros((h + 2 * radius, w, 4), np.float32)
    padded[radius : radius + h] = outx
    masky = np.zeros((h + 2 * radius, w), np.float32)
    masky[radius : radius + h] = mx
    out = np.zeros_like(img)
    my = np.zeros((h, w), np.float32)
    for i, kv in enumerate(k):
        out += kv * padded[i : i + h]
        my += kv * masky[i : i + h]
    return out / my[:, :, None]


def native_gaussian_blur(ev, img_value, stddev_value, span):
    """Builtin entry: gaussian_blur(image, stddev) -> image."""
    from .value import image_value

    if img_value.tag != "image":
        raise MMTypeError("'gaussian_blur' expects an image argument", span)
    base = img_value.payload
    from .value import TiledInput

    if type(base) is TiledInput:
        # blurring a halo-extended LOCAL block and rewrapping it as a
        # plain image would drop row_base/global shape — every device
        # except row 0 would sample shifted data (review r3). No sound
        # per-tile blur exists without radius-aware halo sizing.
        from ..utils.errors import MMRuntimeError

        raise MMRuntimeError(
            "'gaussian_blur' is not supported under tiled/halo rendering "
            "— render unsharded or shard by frames", span)
    if not isinstance(base, InputImage):
        # Closure images must be rasterized first: evaluate over the full
        # output grid once, then blur the raster (source-level semantics
        # preserved; one extra materialization).
        from .render import coordinate_grids

        x, y = coordinate_grids(ev.ctx)
        comps = base.sample(ev, x, y)
        pixels = ev.be.stack([ev.grid(c) for c in comps], axis=-1)
        base = InputImage(pixels=pixels, name="rasterized")
    # stddev must be a trace-time constant: the kernel SIZE (radius) is a
    # static shape. Literals, unpassed-userval defaults, and
    # static_params-baked values all fold (tracer const mirror); a fully
    # traced value must raise — the old silent 3.0 fallback blurred with
    # the WRONG sigma on the jit path while the oracle used the real one
    # (review r3: breaks the oracle-is-the-spec invariant).
    stddev_f = stddev_value.static_scalar()
    if stddev_f is None:
        from ..utils.errors import MMRuntimeError

        raise MMRuntimeError(
            "'gaussian_blur' needs a trace-time-constant stddev (a "
            "literal, a param default, or a param listed in "
            "static_params/--static-params) — the kernel radius is a "
            "static shape", span)
    key = (id(base.pixels), round(stddev_f, 6))
    cache = getattr(ev.ctx, "_native_cache", None)
    if cache is None:
        cache = {}
        ev.ctx._native_cache = cache
    ent = cache.get(key)
    # pin the source array in the entry: id() alone can be REUSED after
    # the array is freed, returning another image's blur (review r3)
    if ent is None or ent[0] is not base.pixels:
        ent = (base.pixels, InputImage(
            pixels=gaussian_blur_pixels(ev.be, base.pixels, stddev_f),
            name=f"blur({base.name})",
        ))
        cache[key] = ent
    return image_value(ent[1])
