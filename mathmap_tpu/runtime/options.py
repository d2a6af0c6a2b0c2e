"""Render options — the rebuild's `mathmap_invocation_t` settings.

Reference: invocation fields (image dims, uservals, edge behavior,
interpolation, supersampling flag, # frames) in `mathmap_common.c`
[unverified — mount empty, SURVEY.md §0]; dataclass form per SURVEY.md §5
config-system row.
"""

from __future__ import annotations

from dataclasses import dataclass

INTERPOLATIONS = ("nearest", "bilinear", "bicubic")
EDGE_BEHAVIORS = ("color", "wrap", "reflect")


@dataclass(frozen=True)
class RenderOptions:
    interpolation: str = "bilinear"
    edge_x: str = "color"
    edge_y: str = "color"
    #: RGBA used by the 'color' edge behavior (default transparent, per
    #: SURVEY §2.1 origVal row).
    edge_color: tuple = (0.0, 0.0, 0.0, 0.0)
    #: supersampling antialiasing: 1 = off, 2 = 2x2 subpixel grid ("4x AA",
    #: BASELINE config 4). The exact reference scheme (corner grid + center)
    #: is marked LOW-confidence in SURVEY §2.1; see supersample_scheme.
    supersample: int = 1
    #: AA sample placement when supersample > 1. 'grid': s×s subpixel grid
    #: (s² evaluations — the round-1 default, kept as THE default so
    #: goldens/records stay comparable). 'corners': the scheme SURVEY §2.1
    #: suspects the reference uses [unverified — mount empty]: evaluate
    #: the (H+1)×(W+1) pixel-CORNER grid once (corners are shared between
    #: neighbors) plus the pixel centers, and average the 5 samples per
    #: pixel — ~2.07× the work of a plain render instead of grid-2's 4×,
    #: with a 5-point quincunx footprint. Equal 1/5 weights [weighting
    #: unverified; re-adjudicate at SURVEY §8]. supersample's numeric
    #: value is ignored beyond >1 in this mode. Not supported by the
    #: input-sharded tiled renderer (render_tiled raises).
    supersample_scheme: str = "grid"
    #: output element type. 'float32' (default): (…, H, W, 4) in [0,1].
    #: 'uint8': the renderer packs ON DEVICE with the reference's
    #: round-to-nearest 8-bit rule (clip·255 + 0.5, floor — bit-identical
    #: to imgio.to_uint8 / native.f32_to_u8 on the same floats) and
    #: returns (…, H, W, 4) uint8. The pack is fused into the render
    #: program, so device→host readback shrinks 4× — the serving layer's
    #: default (mathmap_tpu.serve), and the right call on any
    #: transfer-bound link. Applies to every renderer (jit, oracle,
    #: sharded, tiled) — they all pack in runtime.render.render_frame.
    output_dtype: str = "float32"
    #: render only the (x, y, w, h) sub-rectangle of the canvas — the
    #: GIMP-selection semantics of the reference plugin (`mathmap.c` applies
    #: the filter to the drawable's selection bounds while x/y/W/H/R keep
    #: the FULL drawable's coordinate system [unverified — mount empty]).
    #: x is the left column, y the TOP row (image row order), both 0-based;
    #: the output array is (h, w, 4). Inputs stay full-canvas (a warp may
    #: sample source pixels far outside the region). None = full canvas.
    region: tuple | None = None
    #: safety cap on per-pixel `while` trip counts (the reference's compile/
    #: render resource limits, SURVEY §2.1 compiler row).
    max_loop_iters: int = 10000
    #: per-pixel loop kernel (pallas_kernels/while_kernel, Pallas-Triton):
    #: 'auto' uses it for eligible loops on big grids on a GPU, 'off'
    #: disables, 'on' forces it for any eligible loop (tests; on a CPU
    #: only with while_kernel.INTERPRET set)
    pallas_while: str = "auto"
    #: unrolled masked steps per lax.while_loop iteration on the jit path:
    #: amortizes the any() convergence check and the HBM carry round-trip
    #: (semantics are exact — steps past the cap or past convergence are
    #: masked). Higher helps long fractal loops; short loops pay up to
    #: while_unroll-1 wasted masked steps.
    while_unroll: int = 4
    #: static-trip-count unroll budget (iterations): loops whose condition
    #: folds to a trace-time constant unroll into straight-line code up to
    #: this many steps (0 disables). A bailed attempt (count > budget)
    #: traces up to this many dead body copies before falling back, so
    #: raise with care on noise-heavy bodies.
    while_static_unroll: int = 64
    #: periodic animation: t = frame/N (wraps); non-periodic: t = frame/(N-1)
    #: so the last frame reaches t=1 (SURVEY §2.1 render-engine row).
    periodic: bool = True
    #: PRNG seed for rand()
    seed: int = 0
    #: param names whose values are BAKED into the compiled program as
    #: trace-time constants (the reference's cgen.c bakes ALL uservals and
    #: recompiles on change; here it is opt-in since traced params avoid
    #: a recompile per value). A baked int param driving a loop
    #: bound statically unrolls the loop (tracer.py). Each distinct value
    #: compiles its own program (cached). Unpassed params always bake
    #: their declared default.
    static_params: tuple = ()
    #: frame-sweep unroll factor for render_all_frames / render_batch:
    #: the in-program frame loop scans over chunks of this many
    #: Python-unrolled frames. 'auto' = 1 (flat lax.map); kept as an
    #: option for experimentation. MMTPU_SWEEP_UNROLL overrides at trace
    #: time.
    sweep_unroll: object = "auto"

    def __post_init__(self):
        if self.interpolation not in INTERPOLATIONS:
            raise ValueError(f"interpolation must be one of {INTERPOLATIONS}")
        if self.edge_x not in EDGE_BEHAVIORS or self.edge_y not in EDGE_BEHAVIORS:
            raise ValueError(f"edge behaviors must be one of {EDGE_BEHAVIORS}")
        if self.supersample < 1:
            raise ValueError("supersample must be >= 1")
        if self.supersample_scheme not in ("grid", "corners"):
            raise ValueError("supersample_scheme must be 'grid' or 'corners'")
        if self.output_dtype not in ("float32", "uint8"):
            raise ValueError("output_dtype must be 'float32' or 'uint8'")
        if self.while_unroll < 1:
            # 0 steps/iteration would make the jit lax.while_loop a no-op
            # body that never converges — the render would hang, not error
            raise ValueError("while_unroll must be >= 1")
        ec = tuple(float(c) for c in self.edge_color)
        if len(ec) == 3:
            ec = ec + (1.0,)  # RGB convenience: opaque alpha
        if len(ec) != 4:
            raise ValueError(
                f"edge_color needs 3 or 4 components, got {len(ec)}")
        object.__setattr__(self, "edge_color", ec)
        if self.region is not None:
            reg = tuple(int(v) for v in self.region)
            if len(reg) != 4:
                raise ValueError("region must be (x, y, w, h)")
            if reg[2] < 1 or reg[3] < 1:
                raise ValueError("region w/h must be >= 1")
            if reg[0] < 0 or reg[1] < 0:
                raise ValueError("region x/y must be >= 0")
            # x+w <= width is checked where the canvas size is known
            # (JitRenderer / render_oracle)
            object.__setattr__(self, "region", reg)
        if self.sweep_unroll != "auto" and (
                not isinstance(self.sweep_unroll, int)
                or self.sweep_unroll < 1):
            raise ValueError("sweep_unroll must be 'auto' or an int >= 1")
        if self.pallas_while not in ("auto", "on", "off"):
            raise ValueError("pallas_while must be 'auto', 'on' or 'off'")
        if not isinstance(self.static_params, tuple) or not all(
                isinstance(n, str) for n in self.static_params):
            raise ValueError("static_params must be a tuple of param names")
