"""Color constructors/extractors, HSVA conversion, coordinate converts,
curve/gradient application.

Reference: color.c + builtins table [unverified — mount empty, SURVEY.md §0];
op list per SURVEY.md §2.1. Colors are rgba float tuples in [0,1]; grayscale
luminance uses the reference's weights [unverified — using Rec.601
0.299/0.587/0.114, the classic choice of C image code of that era].
"""

from __future__ import annotations

from ..runtime.value import TupleValue
from ..typesys.tags import NIL
from .registry import builtin, need_args, need_length

LUMA_R, LUMA_G, LUMA_B = 0.299, 0.587, 0.114


@builtin("rgbColor")
def _rgb_color(ev, args, span):
    r, g, b = need_args(args, 3, "rgbColor", span)
    rs, gs, bs = r.scalar(span), g.scalar(span), b.scalar(span)
    # alpha matches the WIDEST component's shape (mixed scalar/grid args)
    a = ev.be.ones_like(ev.be.broadcast_arrays(rs, gs, bs)[0])
    return TupleValue("rgba", (rs, gs, bs, a))


@builtin("rgbaColor")
def _rgba_color(ev, args, span):
    r, g, b, a = need_args(args, 4, "rgbaColor", span)
    return TupleValue("rgba", (r.scalar(span), g.scalar(span), b.scalar(span), a.scalar(span)))


@builtin("grayColor")
def _gray_color(ev, args, span):
    (g,) = need_args(args, 1, "grayColor", span)
    gs = g.scalar(span)
    return TupleValue("rgba", (gs, gs, gs, ev.be.ones_like(gs)))


@builtin("grayaColor")
def _graya_color(ev, args, span):
    g, a = need_args(args, 2, "grayaColor", span)
    gs = g.scalar(span)
    return TupleValue("rgba", (gs, gs, gs, a.scalar(span)))


def _extract(name: str, idx: int):
    @builtin(name)
    def _op(ev, args, span, _idx=idx, _name=name):
        (c,) = need_args(args, 1, _name, span)
        need_length(c, 4, _name, span)
        return TupleValue(NIL, (c.arrays[_idx],))


_extract("red", 0)
_extract("green", 1)
_extract("blue", 2)
_extract("alpha", 3)


@builtin("gray")
def _gray(ev, args, span):
    (c,) = need_args(args, 1, "gray", span)
    need_length(c, 4, "gray", span)
    r, g, b, _ = c.arrays
    return TupleValue(NIL, (LUMA_R * r + LUMA_G * g + LUMA_B * b,))


@builtin("toHSVA")
def _to_hsva(ev, args, span):
    (c,) = need_args(args, 1, "toHSVA", span)
    need_length(c, 4, "toHSVA", span)
    be = ev.be
    r, g, b, a = c.arrays
    maxc = be.maximum(be.maximum(r, g), b)
    minc = be.minimum(be.minimum(r, g), b)
    v = maxc
    d = maxc - minc
    safe_max = be.where(maxc == 0, 1.0, maxc)
    s = be.where(maxc == 0, 0.0, d / safe_max)
    safe_d = be.where(d == 0, 1.0, d)
    rc = (maxc - r) / safe_d
    gc = (maxc - g) / safe_d
    bc = (maxc - b) / safe_d
    h = be.where(
        r == maxc, bc - gc, be.where(g == maxc, 2.0 + rc - bc, 4.0 + gc - rc)
    )
    h = be.where(d == 0, 0.0, be.mod(h / 6.0, 1.0))
    # mod of a tiny negative returns EXACTLY the modulus in float —
    # wrap back into [0, 1) (review r3; same defense toRGBA has)
    h = be.where(h >= 1.0, 0.0, h)
    return TupleValue("hsva", (h, s, v, a))


@builtin("toRGBA")
def _to_rgba(ev, args, span):
    (c,) = need_args(args, 1, "toRGBA", span)
    need_length(c, 4, "toRGBA", span)
    be = ev.be
    h, s, v, a = c.arrays
    h6 = be.mod(h, 1.0) * 6.0
    i = be.floor(h6)
    f = h6 - i
    p = v * (1.0 - s)
    q = v * (1.0 - s * f)
    t = v * (1.0 - s * (1.0 - f))
    i = be.mod(i, 6.0)
    r = be.where(i == 0, v, be.where(i == 1, q, be.where(i == 2, p, be.where(i == 3, p, be.where(i == 4, t, v)))))
    g = be.where(i == 0, t, be.where(i == 1, v, be.where(i == 2, v, be.where(i == 3, q, be.where(i == 4, p, p)))))
    b = be.where(i == 0, p, be.where(i == 1, p, be.where(i == 2, t, be.where(i == 3, v, be.where(i == 4, v, q)))))
    return TupleValue("rgba", (r, g, b, a))


# ---------------------------------------------------------------------------
# coordinate conversions (internals.c / builtins per SURVEY §2.1)
# ---------------------------------------------------------------------------

@builtin("toRA")
def _to_ra(ev, args, span):
    (p,) = need_args(args, 1, "toRA", span)
    need_length(p, 2, "toRA", span)
    be = ev.be
    x, y = p.arrays
    r = be.sqrt(x * x + y * y)
    # Angle convention: [0, 2*pi), counterclockwise from +x axis
    # [unverified — SURVEY §2.1 marks the internals' polar convention LOW].
    a = be.mod(be.arctan2(y, x), 6.283185307179586)
    # float mod of a tiny negative yields EXACTLY 2*pi — wrap into the
    # documented [0, 2*pi) (review r3)
    a = be.where(a >= 6.283185307179586, 0.0, a)
    return TupleValue("ra", (r, a))


@builtin("toXY")
def _to_xy(ev, args, span):
    (p,) = need_args(args, 1, "toXY", span)
    need_length(p, 2, "toXY", span)
    be = ev.be
    r, a = p.arrays
    return TupleValue("xy", (r * be.cos(a), r * be.sin(a)))


# ---------------------------------------------------------------------------
# curve / gradient application (userval.c widgets; LUT sampling per SURVEY §7)
# ---------------------------------------------------------------------------

def _lut_take(be, lut, x):
    """take-based linear interpolation into a (N,) or (N, k) LUT, clamped to
    [0,1] — one formulation for the jit path and the oracle."""
    n = lut.shape[0]
    xf = be.clip(x, 0.0, 1.0) * (n - 1)
    i0 = be.floor(xf)
    frac = xf - i0
    i0 = i0.astype(be.int32)
    i1 = be.minimum(i0 + 1, n - 1)
    if lut.ndim == 1:
        v0 = be.take(lut, i0)
        v1 = be.take(lut, i1)
        return [v0 + frac * (v1 - v0)]
    # ONE row-gather per tap (2 total) instead of 2 per channel (8 for a
    # gradient); same pattern as value.InputImage.make_gather (review r3)
    v0 = be.take(lut, i0, axis=0)
    v1 = be.take(lut, i1, axis=0)
    v = v0 + frac[..., None] * (v1 - v0)
    return [v[..., ch] for ch in range(lut.shape[1])]


def apply_curve(ev, curve, pos: TupleValue, span) -> TupleValue:
    x = pos.scalar(span)
    return TupleValue(NIL, (_lut_take(ev.be, curve.lut, x)[0],))


def apply_gradient(ev, grad, pos: TupleValue, span) -> TupleValue:
    x = pos.scalar(span)
    return TupleValue("rgba", tuple(_lut_take(ev.be, grad.lut, x)))
