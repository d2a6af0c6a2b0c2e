"""Runtime value model for the tracer.

A MathMap value is a tagged tuple (reference `tuples.c` [unverified — mount
empty, SURVEY.md §0]). The design (SURVEY.md §7): tuple components are
kept as separate backend arrays — each component is either a scalar () or a
whole-grid (H, W) array — so every scalar op of the reference's per-pixel
program becomes one elementwise array op over the grid and XLA fuses the
entire filter into a single program.

Images, curves and gradients are first-class values in the language
(SURVEY §3.5); they are represented by dedicated classes and carried in
length-1 tuples with tags 'image'/'curve'/'gradient' holding the object in
`payload` instead of arrays.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable

from ..utils.errors import MMTypeError


class TupleValue:
    """A tagged tuple of backend arrays (or a payload for opaque values).

    `const` carries trace-time-known Python values for components that came
    from source literals — ops that need STATIC parameters (e.g. the gaussian
    blur kernel radius) read it, since under jit even literals become staged
    tracers that float() cannot extract."""

    __slots__ = ("tag", "arrays", "payload", "const")

    def __init__(self, tag: str, arrays: tuple = (), payload: Any = None, const=None):
        self.tag = tag
        self.arrays = tuple(arrays)
        self.payload = payload
        self.const = const

    @property
    def length(self) -> int:
        return len(self.arrays) if self.payload is None else 1

    @property
    def is_opaque(self) -> bool:
        return self.payload is not None

    def retag(self, tag: str) -> "TupleValue":
        return TupleValue(tag, self.arrays, self.payload, self.const)

    def static_scalar(self) -> float | None:
        """Trace-time-known value of a length-1 tuple, if any."""
        if self.const is not None and len(self.const) == 1:
            return self.const[0]
        if len(self.arrays) == 1:
            try:
                return float(self.arrays[0])
            except Exception:
                return None
        return None

    def scalar(self, span=None):
        """The single component of a length-1 tuple."""
        if self.payload is not None or len(self.arrays) != 1:
            raise MMTypeError(
                f"expected a single value, got {self.tag}:{self.length}-tuple", span
            )
        return self.arrays[0]

    def __repr__(self) -> str:  # pragma: no cover - debug aid
        if self.payload is not None:
            return f"<{self.tag}:{self.payload!r}>"
        return f"<{self.tag}:{self.length}>"


@dataclass
class ImageBase:
    """Base for first-class image values; sample(ev, x, y[, frame]) -> rgba
    components. `frame` indexes animated inputs (origValXY(x,y,frame) —
    SURVEY §2.1 origVal row's frame-indexed sampling); images without a
    frame axis ignore it (any index clamps to the single frame)."""

    def sample(self, ev, x, y, frame=None):  # pragma: no cover - interface
        raise NotImplementedError


@dataclass
class InputImage(ImageBase):
    """An input drawable: pixel data (H, W, 4) float in [0,1], or an
    ANIMATED drawable (T, H, W, 4) whose frames are sampled by index.

    Equivalent of the reference's `input_drawable_t` (drawable.c, SURVEY §1
    layer 3; multi-frame drawables back origValXY(x,y,frame) — exact frame
    semantics [unverified — mount empty]; out-of-range indices clamp).
    Sampling honors the invocation's interpolation and edge behaviors via
    runtime.sampling.
    """

    pixels: Any  # backend array (H, W, 4) or (T, H, W, 4), float32 RGBA
    name: str = "in"

    @property
    def num_frames(self) -> int:
        return int(self.pixels.shape[0]) if self.pixels.ndim == 4 else 1

    @property
    def global_shape(self):
        if self.pixels.ndim == 4:
            return int(self.pixels.shape[1]), int(self.pixels.shape[2])
        return int(self.pixels.shape[0]), int(self.pixels.shape[1])

    def frame_index(self, be, frame):
        """Nearest-integer frame index clamped into [0, T-1]."""
        fi = be.floor(be.asarray(frame, dtype=be.float32) + 0.5)
        return be.clip(fi.astype(be.int32), 0, self.num_frames - 1)

    def frame_pixels(self, be, frame):
        """(H, W, 4) pixels of `frame` (scalar; traced -> dynamic index)."""
        if self.pixels.ndim != 4:
            return self.pixels
        return self.pixels[self.frame_index(be, frame)]

    def make_gather(self, be, frame=None):
        h, w = self.global_shape
        if self.pixels.ndim == 4:
            # two-axis gather (frame, within-frame): a flat T*H*W index
            # would overflow int32 for long/large animations (1080p ~1040
            # frames) and silently sample the wrong frame — the per-frame
            # index h*w*4 stays well inside int32 and XLA's gather handles
            # the frame axis with operand-internal offsets
            t = self.num_frames
            frames_flat = self.pixels.reshape(t, h * w, 4)
            fi = self.frame_index(be, 0.0 if frame is None else frame)

            def gather(iy, ix):
                q = iy * w + ix
                g = frames_flat[fi, q]  # advanced indexing -> one gather
                return [g[..., c] for c in range(4)]

            return gather
        flat = self.pixels.reshape(h * w, 4)

        def gather(iy, ix):
            # one gather of a contiguous (1,4) RGBA row per tap — 4x fewer
            # gather ops than per-channel takes
            g = be.take(flat, iy * w + ix, axis=0)
            return [g[..., c] for c in range(4)]

        return gather

    def sample(self, ev, x, y, frame=None):
        from . import sampling

        return sampling.sample_image(ev, self, x, y, frame=frame)


def localize_period(be, g, base, n, ext_n):
    """Local position of a globally edge-mapped tap index / coordinate `g`
    on a halo-extended block (TiledInput.make_gather): the plain shift
    g - base, adjusted by ONE global period when that shift is both
    outside [0, ext) AND a true period overflow. Wrap-seam
    taps move onto the ring-wrapped halo (device 0 with base=-halo sees
    global n-1 as halo-1, its lead halo); everything in-contract stays a
    plain shift. Two hazards shaped the conditions:

    - a bare mod-n gave identical results when ext <= n, but on a
      1-DEVICE axis ext = n + 2*halo > n and the mod cut a wrap boundary
      through the ext interior: bottom-edge taps (shift in [n, n+halo))
      wrapped to the LEAD halo — accidentally correct while halos held
      ring-wrap content, silently wrong once _paint_edge_halo rewrites
      global-edge halos for color/reflect (reflected bottom rows
      mirrored);
    - subtracting the period for EVERY shift >= ext sent below-block
      contract-VIOLATING taps (shift in [ext, n)) negative, which the
      caller's final clip landed on the possibly-repainted lead halo
      instead of the near-edge row the documented check=False
      clamp-into-block behavior promises (review finding) — hence the
      `l0 >= n` guard: only true overflows move."""
    l0 = g - base
    return be.where(l0 < 0, l0 + n,
                    be.where((l0 >= ext_n) & (l0 >= n), l0 - n, l0))


@dataclass
class TiledInput(InputImage):
    """A grid-sharded input: `pixels` is this device's row/col block PLUS
    halo rows/cols exchanged from ring neighbors (parallel/halo.py
    — the sequence/context-parallel analog, SURVEY §2.2 SP row). Global
    index (row_base, col_base) maps to local (0, 0). Sampling beyond the
    halo clamps into the block — the caller's bounded-displacement contract
    (recorded when `violation_hook` is set). An ANIMATED tiled input holds
    a (T, ext_h, ext_w, 4) stack of identically-sharded frames: scalar
    frame selectors (incl. the current-frame default) are resolved by
    frame-selecting the stack up front (sampling.sample_image), so only
    per-pixel frame arrays reach the 4-D gather here."""

    global_height: int = 0
    global_width: int = 0  # 0 = not column-sharded (block spans full width)
    row_base: Any = 0  # global row of local row 0 (may be traced)
    col_base: Any = 0
    #: optional callable(excess_scalar) recording how far past the halo a
    #: sample reached (<=0 = contract held) — parallel/halo.py debug check
    violation_hook: Any = None

    @property
    def global_shape(self):
        gw = self.global_width or int(self.pixels.shape[-2])
        return self.global_height, gw

    def make_gather(self, be, frame=None):
        animated = self.pixels.ndim == 4
        ext_h = int(self.pixels.shape[-3])
        ext_w = int(self.pixels.shape[-2])
        gh, gw = self.global_shape
        if animated:
            # per-pixel frame indexing: two-axis gather like InputImage's
            # animated path (frame axis via operand-internal offsets; the
            # per-frame flat index stays inside int32)
            frames_flat = self.pixels.reshape(self.num_frames,
                                              ext_h * ext_w, 4)
            fi = self.frame_index(be, 0.0 if frame is None else frame)
        else:
            flat = self.pixels.reshape(ext_h * ext_w, 4)
        row_base = self.row_base
        col_base = self.col_base
        col_sharded = bool(self.global_width)
        hook = self.violation_hook

        def gather(iy, ix):
            # the mod-global value is kept as the VIOLATION metric only:
            # a below-block contract violation shifts past ext but stays
            # under one period, so mod leaves it large (flagged), while
            # seam taps mod back inside ext (not flagged). Content reads
            # use _localize; the final clip only bounds contract-violating
            # displacements.
            lym = (iy - row_base) % gh
            ly = be.clip(localize_period(be, iy, row_base, gh, ext_h),
                         0, ext_h - 1)
            if col_sharded:
                lxm = (ix - col_base) % gw
                lx = be.clip(localize_period(be, ix, col_base, gw, ext_w),
                             0, ext_w - 1)
            else:
                lxm = lx = ix
            if hook is not None:
                excess = be.max(lym - (ext_h - 1))
                if col_sharded:
                    excess = be.maximum(excess, be.max(lxm - (ext_w - 1)))
                hook(excess)
            q = ly * ext_w + lx
            if animated:
                g = frames_flat[fi, q]  # advanced indexing -> one gather
            else:
                g = be.take(flat, q, axis=0)
            return [g[..., c] for c in range(4)]

        return gather


@dataclass
class ClosureImage(ImageBase):
    """A filter (partially) applied to arguments — an image value.

    Composition is source-level inlining in the reference (SURVEY §3.4/3.5):
    applying the closure to coordinates evaluates the filter body with those
    coordinates bound, inside the SAME trace, yielding one fused XLA program.
    """

    filter_def: Any  # lang.astnodes.FilterDef
    args: tuple = ()  # tuple[TupleValue], one per filter param
    name: str = "closure"

    def sample(self, ev, x, y, frame=None):
        # closures have no frame axis; an explicit frame index clamps to
        # the single procedural frame (i.e. is ignored), like a T=1 input
        return ev.eval_filter_at(self.filter_def, self.args, x, y)


@dataclass
class Curve:
    """A user-editable 1D function, sampled as a LUT (userval.c curve widget).

    The LUT is a (resolution,) array mapping [0,1] -> [0,1] (256 entries =
    every uint8 output level). Application outside [0,1] clamps, matching
    widget behavior [unverified].
    """

    lut: Any  # (N,) array
    name: str = "curve"

    @staticmethod
    def identity(be, resolution: int = 256) -> "Curve":
        return Curve(lut=be.linspace(0.0, 1.0, resolution, dtype=be.float32))

    @staticmethod
    def from_function(be, fn: Callable[[Any], Any], resolution: int = 256) -> "Curve":
        xs = be.linspace(0.0, 1.0, resolution, dtype=be.float32)
        return Curve(lut=be.asarray(fn(xs), dtype=be.float32))


@dataclass
class Gradient:
    """A color gradient: (N, 4) RGBA LUT over [0,1] (userval.c gradient)."""

    lut: Any  # (N, 4) array
    name: str = "gradient"

    @staticmethod
    def default(be, resolution: int = 256) -> "Gradient":
        """Black->white opaque ramp [unverified default — mount empty]."""
        ramp = be.linspace(0.0, 1.0, resolution, dtype=be.float32)
        ones = be.ones_like(ramp)
        return Gradient(lut=be.stack([ramp, ramp, ramp, ones], axis=-1))


def image_value(img: ImageBase) -> TupleValue:
    return TupleValue("image", payload=img)


def curve_value(c: Curve) -> TupleValue:
    return TupleValue("curve", payload=c)


def gradient_value(g: Gradient) -> TupleValue:
    return TupleValue("gradient", payload=g)
