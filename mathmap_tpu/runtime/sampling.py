"""origVal source-image sampling: interpolation + edge behaviors.

Reference: the origVal macros + drawable access — THE hot inner loop for
distortion filters (SURVEY.md §2.1 origVal row, §3.6 hot-loop ranking)
[unverified — mount empty, SURVEY.md §0].

Design (SURVEY §7): compute the source-coordinate arrays for the whole
grid, apply the edge behavior arithmetically (mod for wrap, mirror for
reflect, clamp+mask for color), then gather. Gathers are expressed as flat
`take` on a (H*W, 4) linearized image so XLA lowers them to one dynamic
gather of a contiguous RGBA row per tap; bilinear = 4 gathers + lerp,
bicubic = 16 gathers with Catmull-Rom weights.

Coordinate convention [unverified — SURVEY marks the reference's exact pixel
centers LOW]: world origin at the image center, y axis pointing up, pixel
(row j, col i) center at world (i + 0.5 - W/2, H/2 - 0.5 - j).

Known numerical hazard (affects every sampler, including the reference's C):
when a source coordinate lands EXACTLY on a texel boundary, XLA may
rematerialize the coordinate computation into separate fusions whose
fast-math rounding differs by 1 ulp, making floor() disagree between the
gather-index and the interpolation-weight paths — a full-texel jump on that
pixel. Interpolation itself is continuous, so the artifact only appears at
exact boundaries.
"""

from __future__ import annotations


def world_to_pixel(be, x, y, w: int, h: int):
    """World coords -> continuous pixel-center coords (px, py)."""
    px = x + (w * 0.5 - 0.5)
    py = (h * 0.5 - 0.5) - y
    return px, py


def _edge_index(be, i, n: int, behavior: str):
    """Map integer sample index to a valid index + in-bounds mask.

    Returns (index int32 in [0, n), inside bool) — `inside` is all-true for
    wrap/reflect, and the out-of-bounds mask for 'color'.
    """
    if behavior == "wrap":
        return be.mod(i, n), None
    if behavior == "reflect":
        j = be.mod(i, 2 * n)
        return be.where(j < n, j, 2 * n - 1 - j), None
    # 'color': clamp for the gather, mask decides edge-color substitution.
    inside = (i >= 0) & (i < n)
    return be.clip(i, 0, n - 1), inside


def _tap(be, gather, ix, iy, w, h, edge_x, edge_y, edge_color):
    """One (possibly out-of-bounds) integer tap -> 4 channel arrays with the
    edge behavior applied. `gather(iy, ix)` maps GLOBAL in-range indices to
    channel values (an InputImage's flat take, or a TiledInput's halo-block
    lookup)."""
    jx, in_x = _edge_index(be, ix, w, edge_x)
    jy, in_y = _edge_index(be, iy, h, edge_y)
    chans = gather(jy, jx)
    if in_x is not None or in_y is not None:
        inside = None
        for m in (in_x, in_y):
            if m is not None:
                inside = m if inside is None else (inside & m)
        chans = [be.where(inside, c, col) for c, col in zip(chans, edge_color)]
    return chans


def _catmull_rom_weights(be, f):
    """Catmull-Rom cubic weights for fractional offset f in [0,1): taps at
    -1, 0, +1, +2. (Reference uses a Mitchell/Catmull-Rom-style kernel per
    SURVEY §2.1 [unverified coefficients].)"""
    f2 = f * f
    f3 = f2 * f
    w0 = -0.5 * f3 + f2 - 0.5 * f
    w1 = 1.5 * f3 - 2.5 * f2 + 1.0
    w2 = -1.5 * f3 + 2.0 * f2 + 0.5 * f
    w3 = 0.5 * f3 - 0.5 * f2
    return w0, w1, w2, w3


def sample_image(ev, img, x, y, frame=None):
    """Sample an input image at world coords (x, y) using the invocation's
    interpolation/edge settings. Returns 4 channel arrays (r, g, b, a).
    `img` provides global_shape and make_gather (value.InputImage API).

    `frame` indexes ANIMATED inputs ((T, H, W, 4) pixels): None samples the
    invocation's current frame (animation in -> animation out); a scalar or
    per-pixel array selects explicitly (origValXY(x,y,frame)). Indices
    round to nearest and clamp to [0, T-1]."""
    animated = getattr(img, "num_frames", 1) > 1
    if animated and frame is None:
        frame = ev.ctx.frame
    if not animated:
        frame = None  # single-frame: every index clamps to frame 0
    from .value import TiledInput

    if (type(img) is TiledInput
            and getattr(img.pixels, "ndim", 3) == 4
            and getattr(frame, "ndim", 0) == 0):
        # animated tiled stack with a scalar selector (incl. the T=1 case
        # and the current-frame default): select the frame's sharded block
        # up front. Per-pixel frame arrays fall through to the 4-D gather
        # in TiledInput.make_gather.
        import dataclasses

        fsel = 0.0 if frame is None else frame
        img = dataclasses.replace(
            img, pixels=img.pixels[img.frame_index(ev.be, fsel)])
        frame = None
    return _sample_xla(ev, img, x, y, frame=frame)


def _sample_xla(ev, img, x, y, frame=None):
    """The XLA gather formulation: the jit path and the oracle path."""
    be = ev.be
    opts = ev.ctx.opts
    h, w = img.global_shape
    gather = (img.make_gather(be, frame=frame) if frame is not None
              else img.make_gather(be))
    edge_color = [be.asarray(c, dtype=be.float32) for c in opts.edge_color]
    px, py = world_to_pixel(be, x, y, w, h)

    def tap(ix, iy):
        return _tap(be, gather, ix, iy, w, h, opts.edge_x, opts.edge_y, edge_color)

    if opts.interpolation == "nearest":
        ix = be.floor(px + 0.5).astype(be.int32)
        iy = be.floor(py + 0.5).astype(be.int32)
        return tap(ix, iy)

    x0f = be.floor(px)
    y0f = be.floor(py)
    fx = px - x0f
    fy = py - y0f
    x0 = x0f.astype(be.int32)
    y0 = y0f.astype(be.int32)

    if opts.interpolation == "bilinear":
        c00 = tap(x0, y0)
        c10 = tap(x0 + 1, y0)
        c01 = tap(x0, y0 + 1)
        c11 = tap(x0 + 1, y0 + 1)
        out = []
        for ch in range(4):
            top = c00[ch] + fx * (c10[ch] - c00[ch])
            bot = c01[ch] + fx * (c11[ch] - c01[ch])
            out.append(top + fy * (bot - top))
        return out

    # bicubic: 4x4 Catmull-Rom
    wx = _catmull_rom_weights(be, fx)
    wy = _catmull_rom_weights(be, fy)
    out = [None] * 4
    for dy in range(-1, 3):
        row = [None] * 4
        for dx in range(-1, 3):
            c = tap(x0 + dx, y0 + dy)
            wgt = wx[dx + 1]
            for ch in range(4):
                term = wgt * c[ch]
                row[ch] = term if row[ch] is None else row[ch] + term
        wgt_y = wy[dy + 1]
        for ch in range(4):
            term = wgt_y * row[ch]
            out[ch] = term if out[ch] is None else out[ch] + term
    return out
