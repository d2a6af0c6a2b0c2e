"""Image-sampling builtins: origVal and friends.

Reference: origVal macro family (SURVEY.md §2.1 origVal row) [unverified —
mount empty, SURVEY.md §0]. `origVal(xy)` samples the first input drawable at
world coords; `origValXY(x, y)` is the two-scalar variant; the optional
frame index of `origValXY(x,y,frame)` selects the frame of an ANIMATED
input drawable ((T, H, W, 4) stacks — animation in -> animation out;
indices round and clamp; single-frame inputs clamp every index to their
one frame) [syntax variants marked LOW in SURVEY]."""

from __future__ import annotations

from ..runtime.value import TupleValue
from ..utils.errors import MMRuntimeError, MMTypeError
from .registry import builtin, need_args, need_length, need_tag


def _first_input(ev, span):
    if not ev.ctx.inputs:
        raise MMRuntimeError("origVal: no input image bound to this invocation", span)
    return ev.ctx.inputs[0]


@builtin("origVal")
def _orig_val(ev, args, span):
    (p,) = need_args(args, 1, "origVal", span)
    need_length(p, 2, "origVal", span)
    img = _first_input(ev, span)
    x, y = ev.grid(p.arrays[0]), ev.grid(p.arrays[1])
    return TupleValue("rgba", tuple(img.sample(ev, x, y)))


@builtin("origValXY")
def _orig_val_xy(ev, args, span):
    if len(args) not in (2, 3):
        raise MMTypeError(f"'origValXY' expects 2 or 3 arguments, got {len(args)}", span)
    x = ev.grid(args[0].scalar(span))
    y = ev.grid(args[1].scalar(span))
    img = _first_input(ev, span)
    # scalar frame indices stay scalar; per-pixel frame arrays gather
    # per pixel along the frame axis
    frame = args[2].scalar(span) if len(args) == 3 else None
    return TupleValue("rgba", tuple(img.sample(ev, x, y, frame=frame)))


@builtin("origValImage")
def _orig_val_image(ev, args, span):
    """origValImage(image, xy) — sample an explicit image value
    [unverified name — provided for parity with multi-input sampling]."""
    img_v, p = need_args(args, 2, "origValImage", span)
    need_tag(img_v, "image", "origValImage", span)
    need_length(p, 2, "origValImage", span)
    x, y = ev.grid(p.arrays[0]), ev.grid(p.arrays[1])
    return TupleValue("rgba", tuple(img_v.payload.sample(ev, x, y)))
