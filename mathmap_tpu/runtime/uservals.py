"""User values (filter parameters): defaults and Python-value conversion.

Reference: `userval.c/h` (SURVEY.md §2.1 userval row [unverified — mount
empty, SURVEY.md §0]): int (slider w/ range), float (range+default syntax
`float d: 0-1 (0.5)`), bool, color, curve, gradient, image. GTK widgets are
replaced by plain Python values passed through the API/CLI (`--param
name=value`, SURVEY §5 config row).
"""

from __future__ import annotations

import numpy as np

from ..lang.astnodes import Param
from ..typesys.tags import NIL
from ..utils.errors import MMRuntimeError, MMTypeError
from .value import Curve, Gradient, InputImage, TupleValue, curve_value, gradient_value, image_value


def default_userval(ctx, p: Param) -> TupleValue:
    be = ctx.be
    # Numeric defaults carry a trace-time const mirror: a default-valued
    # loop bound (ridged_noise's `octaves`) is a compile-time constant of
    # that program — the jit cache's static `kinds` spec records which
    # params were passed, so an explicitly-passed value always retraces —
    # and the while engine can statically unroll it (tracer.py).
    if p.kind in ("int", "float"):
        v = p.default
        if v is None:
            v = p.lo if p.lo is not None else 0.0
        return TupleValue(NIL, (be.asarray(float(v), dtype=be.float32),),
                          const=(float(v),))
    if p.kind == "bool":
        v = p.default if p.default is not None else 0.0
        v = 1.0 if v else 0.0
        return TupleValue(NIL, (be.asarray(v, dtype=be.float32),), const=(v,))
    if p.kind == "color":
        # default opaque black [unverified GUI default]
        return TupleValue("rgba", tuple(be.asarray(c, dtype=be.float32) for c in (0.0, 0.0, 0.0, 1.0)),
                          const=(0.0, 0.0, 0.0, 1.0))
    if p.kind == "curve":
        return curve_value(Curve.identity(be))
    if p.kind == "gradient":
        return gradient_value(Gradient.default(be))
    if p.kind == "image":
        raise MMRuntimeError(
            f"image parameter {p.name!r} has no bound input image", p.span
        )
    raise MMTypeError(f"unknown userval kind {p.kind!r}", p.span)


def convert_userval(ctx, p: Param, value) -> TupleValue:
    """Convert a Python value supplied through the API/CLI into the userval's
    runtime representation (the widget->userval_t step of the reference)."""
    be = ctx.be
    if p.kind in ("int", "float"):
        v = float(value)
        if p.kind == "int":
            v = float(int(round(v)))
        if p.lo is not None:
            v = max(v, p.lo)
        if p.hi is not None:
            v = min(v, p.hi)
        return TupleValue(NIL, (be.asarray(v, dtype=be.float32),))
    if p.kind == "bool":
        return TupleValue(NIL, (be.asarray(1.0 if value else 0.0, dtype=be.float32),))
    if p.kind == "color":
        col = tuple(float(c) for c in value)
        if len(col) == 3:
            col = col + (1.0,)
        if len(col) != 4:
            raise MMTypeError(f"color userval {p.name!r} needs 3 or 4 components", p.span)
        return TupleValue("rgba", tuple(be.asarray(c, dtype=be.float32) for c in col))
    if p.kind == "curve":
        if isinstance(value, Curve):
            return curve_value(value)
        if callable(value):
            return curve_value(Curve.from_function(be, value))
        arr = np.asarray(value, dtype=np.float32)
        if arr.ndim != 1 or arr.shape[0] < 2:
            # mirror the gradient branch: a scalar or (N,4) array would
            # otherwise crash later (or silently use channel 0) far from
            # the user's mistake
            raise MMTypeError(
                f"curve userval {p.name!r} needs a 1-D LUT of >=2 samples "
                f"(or a Curve / callable)", p.span)
        return curve_value(Curve(lut=be.asarray(arr)))
    if p.kind == "gradient":
        if isinstance(value, Gradient):
            return gradient_value(value)
        arr = np.asarray(value, dtype=np.float32)
        if arr.ndim != 2 or arr.shape[1] not in (3, 4):
            raise MMTypeError(
                f"gradient userval {p.name!r} needs an (N,3) or (N,4) array", p.span
            )
        if arr.shape[1] == 3:
            arr = np.concatenate([arr, np.ones((arr.shape[0], 1), np.float32)], axis=1)
        return gradient_value(Gradient(lut=be.asarray(arr)))
    if p.kind == "image":
        if isinstance(value, InputImage):
            return image_value(value)
        arr = np.asarray(value)
        if arr.dtype == np.uint8:
            # same /255 rule as the positional inputs' in-trace
            # normalization (render.float_inputs) — a u8 image param must
            # not feed 0-255 values to the filter (review r3)
            arr = arr.astype(np.float32) / np.float32(255.0)
        else:
            arr = arr.astype(np.float32)
        # (T,H,W,4) = animated drawable, same as a positional input
        if arr.ndim not in (3, 4) or arr.shape[-1] != 4:
            raise MMTypeError(
                f"image userval {p.name!r} needs an (H,W,4) or animated "
                f"(T,H,W,4) array", p.span)
        return image_value(InputImage(pixels=be.asarray(arr), name=p.name))
    raise MMTypeError(f"unknown userval kind {p.kind!r}", p.span)
