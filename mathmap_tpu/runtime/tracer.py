"""Whole-grid tracing evaluator — the replacement for the reference's
compiler middle end + C-codegen/interpreter backends.

Reference shape (SURVEY.md §3.2 [unverified — mount empty, SURVEY.md §0]):
`compile_mathmap()` parses, builds SSA, optimizes, then either emits C
(gcc+dlopen) or interprets the IR per pixel. The design (SURVEY §7):
bind `x`/`y` to whole-grid coordinate arrays and evaluate the AST ONCE —
every scalar op becomes an elementwise array op; under `jax.jit` XLA fuses
the entire filter into one program and performs the folding/CSE/DCE the
reference implemented by hand.

Control-flow semantics:
  - `if` evaluates both branches and merges assigned variables with a
    `where` phi on the condition mask (language is pure except local
    assignment, so this preserves semantics).
  - per-pixel `while` (Mandelbrot) becomes `lax.while_loop` over the grid
    with an active-pixel mask and the invocation's trip-count safety cap.

The same evaluator runs on two array backends: `jax.numpy` (the product
path, traced under jit) and `numpy` (the eager oracle interpreter — the
rebuild's analog of the reference's IR interpreter, SURVEY §2.3 item 2).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any

from ..lang import astnodes as A
from ..ops import registry as R
from ..ops.color_ops import apply_curve, apply_gradient
from ..runtime.value import ClosureImage, TupleValue
from ..typesys import tags as tagmod
from ..typesys.tags import NIL
from ..utils.errors import MMNameError, MMRuntimeError, MMTypeError

_PI = 3.141592653589793
_2PI = 6.283185307179586
_E = 2.718281828459045

#: operator token -> builtin name
_BINOP_NAME = {
    "+": "__add", "-": "__sub", "*": "__mul", "/": "__div", "%": "__mod",
    "^": "__pow", "==": "__eq", "!=": "__ne", "<": "__lt", ">": "__gt",
    "<=": "__le", ">=": "__ge", "&&": "__and", "||": "__or", "xor": "__xor",
}
_UNOP_NAME = {"-": "__neg", "!": "__not"}

#: builtins safe to constant-fold at trace time: pure scalar arithmetic that
#: only touches `ev.be` (no rand, no images, no curve/gradient/ctx state).
#: Folding powers the static-trip-count while unroll (literal-driven loop
#: counters — under jit even literals become staged tracers, so trip counts
#: must be mirrored on the host side).
_CONST_FOLD_OPS = frozenset({
    "__add", "__sub", "__mul", "__div", "__mod", "__pow",
    "__eq", "__ne", "__lt", "__gt", "__le", "__ge",
    "__and", "__or", "__xor", "__neg", "__not",
    "abs", "sign", "min", "max", "clamp", "floor", "ceil", "round",
    "fmod", "sqrt", "exp", "log", "pow",
    # round-3 extension from the library fold-miss scan
    # (benchmarks/scan_loops.py): pure scalar transcendentals and
    # tuple/color constructors that were breaking const chains
    # (lissajous's sin(const), tricorn's conj, fractal palettes'
    # rgbaColor). Same contract as exp/log above: the numpy-f32 shadow
    # mirrors the traced f32 builtin (tests/test_static_unroll.py
    # fuzzes mirror-vs-traced parity).
    "sin", "cos", "tan", "asin", "acos", "atan", "atan2",
    "sinh", "cosh", "tanh", "asinh", "acosh", "atanh",
    "exp2", "log2", "log10", "deg2rad", "rad2deg", "hypot",
    "lerp", "smoothstep", "inintv",
    "conj", "rgbaColor", "rgbColor", "grayColor", "grayaColor", "gray",
})


class _ConstShadowEv:
    """Minimal evaluator stand-in for host-side constant folding: the
    whitelisted builtins read nothing but `.be`. numpy float32 mirrors the
    traced f32 arithmetic."""

    __slots__ = ("be",)

    def __init__(self):
        import numpy as np

        self.be = np


_CONST_EV = _ConstShadowEv()

#: static-trip-count unroll budget (iterations). Voronoi's 3x3 cell scan
#: and fixed-tap convolutions sit well under this; longer literal loops
#: fall back to the masked lax path. NOTE: this is only the DEFAULT of
#: RenderOptions.while_static_unroll — the option always wins, so A/B it
#: through RenderOptions, not by mutating this constant.
WHILE_UNROLL_MAX = 64

#: Trace-time record of which engine each while loop compiled to:
#: ("unroll", n) | ("wk", max_iters) | ("lax", max_iters) | ("oracle", n).
#: Appended during tracing (tracing is single-threaded); diagnostic only —
#: cleared/read by CLI --stats and benchmarks/scan_loops.py. Module-level
#: because the RenderContext lives inside the jitted trace.
TRACE_LOOP_PATHS: list = []

#: Builtins whose call had all-constant arguments but is NOT in
#: _CONST_FOLD_OPS (so the constant chain broke there). Diagnostic for
#: whitelist coverage: benchmarks/scan_loops.py reports these per filter.
TRACE_FOLD_MISSES: set = set()


def np_like_u32(be, v):
    return be.asarray(v, dtype=be.uint32)


@dataclass
class RenderContext:
    """Per-invocation state — the rebuild's `mathmap_invocation_t` +
    `mathmap_frame_t` (SURVEY §2.1 render-engine row)."""

    be: Any  # array backend module (numpy or jax.numpy)
    width: int
    height: int
    opts: Any  # RenderOptions
    inputs: list = field(default_factory=list)  # list[InputImage]
    filters: dict = field(default_factory=dict)  # name -> FilterDef
    t: Any = 0.0  # animation time (scalar, may be traced)
    frame: Any = 0.0
    num_frames: int = 1
    is_jax: bool = True
    rand_counter: int = 0
    #: per-loop-site nonce mixed into rand() counters so sequential loops
    #: draw decorrelated streams (reset/restored like rand_counter so jit
    #: and oracle stay trace-consistent)
    rand_loop_nonce: int = 0
    #: >0 while evaluating inside a lax.while_loop body (or the oracle's
    #: eager loop) — side-channel hooks (halo violation check) must not
    #: capture traced values from there
    loop_depth: int = 0
    #: True while tracing inside the loop kernel (pallas_kernels/
    #: while_kernel): gates off anything that would nest a pallas_call
    in_pallas: bool = False
    #: component dtype; None = backend float32. The oracle interpreter can
    #: run in float64 ('1-ulp-equivalent' validation, BASELINE north star).
    dtype: Any = None
    #: Local tile shape when the grid is sharded over a device mesh
    #: (parallel/shard.py); None = unsharded, full (height, width). The
    #: semantic internals X/Y/W/H/R always use the GLOBAL size.
    grid_shape: tuple | None = None
    #: Global (row, col) origin of this device's tile (may be traced
    #: values derived from lax.axis_index under shard_map).
    row_offset: Any = 0
    col_offset: Any = 0
    #: filter-inlining depth (compile resource limit: the reference bounds
    #: compile work — SURVEY §2.1 compiler row; recursion would otherwise
    #: inline forever since composition is trace-time inlining)
    inline_depth: int = 0
    max_inline_depth: int = 32

    @property
    def shape(self):
        if self.grid_shape is not None:
            return self.grid_shape
        return (self.height, self.width)


class Evaluator:
    def __init__(self, ctx: RenderContext, x, y, env: dict, salt_extra=None):
        self.ctx = ctx
        self.be = ctx.be
        self.x = x
        self.y = y
        self.env = env
        self._cache: dict = {}
        #: extra (possibly traced) salt for rand() — the while-loop iteration
        #: counter, so loop bodies draw fresh randomness every iteration on
        #: BOTH backends (the jax trace runs once; without this the same
        #: field would repeat each iteration)
        self.salt_extra = salt_extra

    # ------------------------------------------------------------------
    # small helpers
    # ------------------------------------------------------------------
    def lit(self, v) -> Any:
        return self.be.asarray(v, dtype=self.ctx.dtype or self.be.float32)

    def grid(self, arr):
        """Broadcast a component to the full (H, W) grid."""
        return self.be.broadcast_to(arr, self.ctx.shape)

    def rand_uniform(self):
        """Deterministic per-pixel uniform in [0,1): counter-based integer
        hash on the pixel linear index — identical bits on both backends
        (SURVEY §2.3 item 4 bit-comparability strategy, applied to rand)."""
        be = self.be
        self.ctx.rand_counter += 1
        h, w = self.ctx.shape
        # Linear index in the GLOBAL pixel grid so sharded and unsharded
        # renders draw identical per-pixel randomness. The jax path builds
        # it from 2-D iotas, which also lower inside the loop kernel
        # (pallas_kernels/while_kernel).
        if self.ctx.is_jax:
            import jax

            iy = (jax.lax.broadcasted_iota(be.uint32, (h, w), 0)
                  + be.asarray(self.ctx.row_offset, dtype=be.uint32))
            ix = (jax.lax.broadcasted_iota(be.uint32, (h, w), 1)
                  + be.asarray(self.ctx.col_offset, dtype=be.uint32))
            idx = iy * be.asarray(self.ctx.width, dtype=be.uint32) + ix
        else:
            iy = be.arange(h, dtype=be.uint32) + be.asarray(self.ctx.row_offset, dtype=be.uint32)
            ix = be.arange(w, dtype=be.uint32) + be.asarray(self.ctx.col_offset, dtype=be.uint32)
            idx = iy[:, None] * be.asarray(self.ctx.width, dtype=be.uint32) + ix[None, :]
        salt = (
            (self.ctx.opts.seed * 0x9E3779B9 + self.ctx.rand_counter * 0x85EBCA6B)
            & 0xFFFFFFFF
        )
        v = idx ^ be.asarray(salt, dtype=be.uint32)
        if self.salt_extra is not None:
            v = v ^ (self.salt_extra.astype(be.uint32) * be.asarray(0x9E3779B9 & 0xFFFFFFFF, dtype=be.uint32))
        v = v ^ (v >> 16)
        v = v * be.asarray(0x7FEB352D, dtype=be.uint32)
        v = v ^ (v >> 15)
        v = v * be.asarray(0x846CA68B, dtype=be.uint32)
        v = v ^ (v >> 16)
        # cast via int32: the 24-bit value is exact either way
        return (v >> 8).astype(be.int32).astype(be.float32) * (1.0 / 16777216.0)

    def _mix_salt(self, loop_i):
        """Combine this evaluator's iteration salt (an enclosing loop's) with
        a nested loop's iteration counter, so rand() in nested loops stays
        fresh per outer iteration — identically on both backends."""
        if loop_i is None:
            return self.salt_extra
        be = self.be
        inner = (
            loop_i.astype(be.uint32)
            if hasattr(loop_i, "astype")
            else be.asarray(loop_i, dtype=be.uint32)
        )
        if self.salt_extra is None:
            return inner
        outer = self.salt_extra.astype(be.uint32)
        return outer * be.asarray(0x9E3779B9 & 0xFFFFFFFF, dtype=be.uint32) + inner

    def _truthy_mask(self, v: TupleValue, span):
        if v.is_opaque or v.length != 1:
            raise MMTypeError("condition must be a single value", span)
        return v.arrays[0] != 0

    def _select(self, mask, a: TupleValue, b: TupleValue, span) -> TupleValue:
        if a.is_opaque or b.is_opaque:
            if a.payload is b.payload:
                return a
            raise MMTypeError("cannot merge image/curve/gradient values across branches", span)
        pairs = R.broadcast_pair(a, b, span, "if")
        be = self.be
        return TupleValue(R.result_tag(a, b), tuple(be.where(mask, x, y) for x, y in pairs))

    def _zero_like(self, v: TupleValue) -> TupleValue:
        return TupleValue(v.tag, tuple(self.be.zeros_like(x) for x in v.arrays))

    # ------------------------------------------------------------------
    # variable resolution
    # ------------------------------------------------------------------
    def _internal(self, name: str):
        if name in self._cache:
            return self._cache[name]
        be, ctx = self.be, self.ctx
        v = None
        if name == "x":
            v = TupleValue(NIL, (self.x,))
        elif name == "y":
            v = TupleValue(NIL, (self.y,))
        elif name == "r":
            v = TupleValue(NIL, (be.sqrt(self.x * self.x + self.y * self.y),))
        elif name == "a":
            # angle in [0, 2pi) counterclockwise from +x [unverified, LOW
            # confidence per SURVEY §2.1 internals row]
            v = TupleValue(NIL, (be.mod(be.arctan2(self.y, self.x), _2PI),))
        elif name == "t":
            v = TupleValue(NIL, (self.lit(ctx.t),))
        elif name == "frame":
            v = TupleValue(NIL, (self.lit(ctx.frame),))
        elif name == "X":
            # geometry internals are uniform trace-time constants: const
            # mirrors let W/H-derived loop bounds statically unroll
            v = TupleValue(NIL, (self.lit(ctx.width * 0.5),),
                           const=(ctx.width * 0.5,))
        elif name == "Y":
            v = TupleValue(NIL, (self.lit(ctx.height * 0.5),),
                           const=(ctx.height * 0.5,))
        elif name == "W":
            v = TupleValue(NIL, (self.lit(float(ctx.width)),),
                           const=(float(ctx.width),))
        elif name == "H":
            v = TupleValue(NIL, (self.lit(float(ctx.height)),),
                           const=(float(ctx.height),))
        elif name == "R":
            _R = ((ctx.width * 0.5) ** 2 + (ctx.height * 0.5) ** 2) ** 0.5
            v = TupleValue(NIL, (self.lit(_R),), const=(_R,))
        elif name == "xy":
            v = TupleValue("xy", (self.x, self.y))
        elif name == "WH" or name == "wh":
            v = TupleValue(NIL, (self.lit(float(ctx.width)), self.lit(float(ctx.height))),
                           const=(float(ctx.width), float(ctx.height)))
        elif name == "pi":
            v = TupleValue(NIL, (self.lit(_PI),), const=(_PI,))
        elif name == "e":
            v = TupleValue(NIL, (self.lit(_E),), const=(_E,))
        elif name == "I":
            v = TupleValue("ri", (self.lit(0.0), self.lit(1.0)),
                           const=(0.0, 1.0))
        if v is not None:
            self._cache[name] = v
        return v

    def _lookup(self, name: str, span) -> TupleValue:
        if name in self.env:
            return self.env[name]
        v = self._internal(name)
        if v is not None:
            return v
        if name in self.ctx.filters:
            from .value import image_value

            return image_value(ClosureImage(self.ctx.filters[name], (), name=name))
        raise MMNameError(f"unknown variable {name!r}", span)

    # ------------------------------------------------------------------
    # evaluation
    # ------------------------------------------------------------------
    def eval(self, node) -> TupleValue:
        method = getattr(self, "_eval_" + type(node).__name__, None)
        if method is None:
            raise MMRuntimeError(f"cannot evaluate node {type(node).__name__}", node.span)
        return method(node)

    def _eval_Num(self, node: A.Num) -> TupleValue:
        return TupleValue(NIL, (self.lit(node.value),), const=(node.value,))

    def _eval_Var(self, node: A.Var) -> TupleValue:
        return self._lookup(node.name, node.span)

    def _eval_TupleLit(self, node: A.TupleLit) -> TupleValue:
        comps = []
        consts: list = []
        for item in node.items:
            v = self.eval(item)
            comps.append(v.scalar(item.span))
            consts.append(v.const[0] if v.const is not None
                          and len(v.const) == 1 else None)
        cst = tuple(consts) if all(c is not None for c in consts) else None
        return TupleValue(NIL, tuple(comps), const=cst)

    def _eval_Cast(self, node: A.Cast) -> TupleValue:
        v = self.eval(node.expr)
        want = tagmod.tag_length(node.tag)
        if v.is_opaque and node.tag != v.tag:
            # retagging an image/curve/gradient to a numeric tag would
            # produce a fixed-arity tuple with EMPTY arrays — downstream
            # ops (det, solve, quat mul) then crash with raw unpack
            # errors (review r3)
            raise MMTypeError(
                f"cannot retag {v.tag} value as {node.tag}:", node.span)
        if want is not None and not v.is_opaque and v.length != want:
            if v.length == 1:
                # scalar widens to the tag's arity (0 -> ri:[0,0] etc.)
                v = TupleValue(v.tag, v.arrays * want,
                               const=None if v.const is None
                               else v.const * want)
            else:
                raise MMTypeError(
                    f"cannot retag length-{v.length} tuple as {node.tag}: (length {want})",
                    node.span,
                )
        return v.retag(node.tag)

    def _eval_Subscript(self, node: A.Subscript) -> TupleValue:
        base = self.eval(node.base)
        if base.is_opaque:
            raise MMTypeError(f"cannot subscript {base.tag}", node.span)
        idx = self._static_index(node.index)
        if idx is not None:
            if not 0 <= idx < base.length:
                raise MMTypeError(
                    f"index {idx} out of range for length-{base.length} tuple", node.span
                )
            cst = (None if base.const is None
                   or len(base.const) != base.length
                   else (base.const[idx],))
            return TupleValue(NIL, (base.arrays[idx],), const=cst)
        # dynamic index: select chain
        iv = self.eval(node.index).scalar(node.span)
        be = self.be
        acc = base.arrays[0]
        for i in range(1, base.length):
            acc = be.where(iv >= i, base.arrays[i], acc)
        return TupleValue(NIL, (acc,))

    def _static_index(self, node) -> int | None:
        if isinstance(node, A.Num) and float(node.value).is_integer():
            return int(node.value)
        return None

    def _fold_const(self, name: str, args, out: TupleValue) -> TupleValue:
        """Attach a host-side constant mirror to `out` when every argument
        carries one and the builtin is fold-safe. Runs the SAME builtin on
        numpy in the context's float dtype (f32 default, f64 under the
        precision='f64' oracle), so the mirror follows the active
        backend's semantics exactly."""
        if (out.const is not None or out.is_opaque
                or name not in _CONST_FOLD_OPS or not args
                or any(a.const is None or a.is_opaque
                       or len(a.const) != len(a.arrays) for a in args)):
            if (out.const is None and not out.is_opaque
                    and name not in _CONST_FOLD_OPS and args
                    and all(a.const is not None and not a.is_opaque
                            and len(a.const) == len(a.arrays) for a in args)):
                TRACE_FOLD_MISSES.add(name)
            return out
        import numpy as np

        dt = (np.float64 if self.ctx.dtype is not None
              and np.dtype(self.ctx.dtype) == np.float64 else np.float32)
        try:
            shadow = [TupleValue(a.tag, tuple(dt(c) for c in a.const))
                      for a in args]
            res = R.lookup(name)(_CONST_EV, shadow, None)
            if not res.is_opaque and len(res.arrays) == len(out.arrays):
                out.const = tuple(float(c) for c in res.arrays)
        except Exception:
            pass
        return out

    def _eval_BinOp(self, node: A.BinOp) -> TupleValue:
        name = _BINOP_NAME.get(node.op)
        if name is None:
            raise MMRuntimeError(f"unknown operator {node.op!r}", node.span)
        fn = R.lookup(name)
        args = [self.eval(node.left), self.eval(node.right)]
        return self._fold_const(name, args, fn(self, args, node.span))

    def _eval_UnOp(self, node: A.UnOp) -> TupleValue:
        name = _UNOP_NAME[node.op]
        fn = R.lookup(name)
        operand = self.eval(node.operand)
        return self._fold_const(name, [operand], fn(self, [operand], node.span))

    def _eval_Assign(self, node: A.Assign) -> TupleValue:
        v = self.eval(node.expr)
        self.env[node.name] = v
        return v

    def _eval_SubAssign(self, node: A.SubAssign) -> TupleValue:
        if node.name not in self.env:
            raise MMNameError(f"unknown variable {node.name!r}", node.span)
        base = self.env[node.name]
        if base.is_opaque:
            raise MMTypeError(f"cannot sub-assign into {base.tag}", node.span)
        rhs = self.eval(node.expr).scalar(node.span)
        idx = self._static_index(node.index)
        comps = list(base.arrays)
        if idx is not None:
            if not 0 <= idx < base.length:
                raise MMTypeError(
                    f"index {idx} out of range for length-{base.length} tuple", node.span
                )
            comps[idx] = rhs
        else:
            iv = self.eval(node.index).scalar(node.span)
            be = self.be
            # MIRROR the dynamic read's floor/clamp semantics (the
            # where(iv >= i) chain in _eval_Subscript): l-value and
            # r-value must name the same component for any index. An
            # exact iv == i match silently DROPPED writes for fractional
            # or out-of-range computed indices that the read resolves
            # (review r5: v[1.7] = 5 left v unchanged while v[1.7] read
            # component 1).
            sel = be.clip(be.floor(iv), 0.0, float(base.length - 1))
            for i in range(base.length):
                comps[i] = be.where(sel == i, rhs, comps[i])
        self.env[node.name] = TupleValue(base.tag, tuple(comps))
        return TupleValue(NIL, (rhs,))

    def _eval_Seq(self, node: A.Seq) -> TupleValue:
        out = None
        for item in node.items:
            out = self.eval(item)
        return out

    def _eval_If(self, node: A.If) -> TupleValue:
        mask = self._truthy_mask(self.eval(node.cond), node.span)
        saved = self.env
        env_t = dict(saved)
        self.env = env_t
        v_t = self.eval(node.then)
        env_e = dict(saved)
        self.env = env_e
        v_e = self.eval(node.orelse) if node.orelse is not None else self._zero_like(v_t)
        self.env = saved
        # phi-merge assigned variables (SSA phis of compiler.c, SURVEY §3.2)
        for k in set(env_t) | set(env_e):
            vt, ve = env_t.get(k), env_e.get(k)
            if vt is ve:
                if vt is not None:
                    saved[k] = vt
                continue
            # a branch-only assignment to a name not in the env merges
            # against the name's PRE-BRANCH value: the outer binding, or —
            # for internal-named variables (y, t, ...) — the internal
            # itself, exactly what a read on the other branch would see.
            # (Review r3 finding: merging against zero silently zeroed
            # `if x > 0 then y = -y end; abs(y)` on the untaken branch.)
            def prior(other):
                if k in saved:
                    return saved[k]
                iv = self._internal(k)
                # a length-1 internal merges fine against a longer branch
                # value — _select broadcasts via broadcast_pair (review
                # r5: `if c then y = xy end; y[0]` read 0 instead of the
                # y coordinate on the untaken branch under the old
                # exact-length guard)
                if iv is not None and iv.length in (1, other.length):
                    return iv
                return self._zero_like(other)

            if vt is None:
                vt = prior(ve)
            if ve is None:
                ve = prior(vt)
            saved[k] = self._select(mask, vt, ve, node.span)
        return self._select(mask, v_t, v_e, node.span)

    # ------------------------------------------------------------------
    # while loops
    # ------------------------------------------------------------------
    def _eval_While(self, node: A.While) -> TupleValue:
        names = sorted(A.assigned_names(node.body) | A.assigned_names(node.cond))
        # Probe pass: discover each carried variable's final length/tag by
        # evaluating cond+body once on a scratch env (results discarded;
        # under jit any unused probe computation is dead code for XLA).
        # rand() trace-consistency: the jit path traces the body a fixed
        # number of times, baking the then-current rand counters in as
        # constants, while the oracle runs eagerly per iteration. To keep
        # the two streams identical the counter is snapshotted at loop
        # entry and RESET at the start of every step on both backends; the
        # (traced) iteration index salt_extra supplies per-iteration
        # freshness instead (ADVICE r1 high finding).
        counter_entry = self.ctx.rand_counter
        nonce_entry = self.ctx.rand_loop_nonce
        probe_env = dict(self.env)
        probe = Evaluator(self.ctx, self.x, self.y, probe_env)
        for n in names:
            if n not in probe_env:
                # an assigned-but-undeclared internal-named variable (y,
                # t, ...) starts as the INTERNAL's value — a first-read
                # inside the loop must see the coordinate, not zero
                # (review r3 finding; same rule as the if-phi merge)
                iv = self._internal(n)
                probe_env[n] = (iv if iv is not None
                                else TupleValue(NIL, (self.lit(0.0),)))
        if node.post:
            # do-while: the body ALWAYS runs before the first cond
            # evaluation — probe in the same order, or a cond subscripting
            # a tuple the body grows raises a spurious MMTypeError
            probe.eval(node.body)
            probe.eval(node.cond)
        else:
            probe.eval(node.cond)
            probe.eval(node.body)
        self.ctx.rand_counter = counter_entry  # probe results are discarded
        self.ctx.rand_loop_nonce = nonce_entry

        be = self.be
        shape = self.ctx.shape

        def widen(v: TupleValue, target: TupleValue) -> TupleValue:
            if v.is_opaque:
                raise MMTypeError("image values cannot be loop variables", node.span)
            arrays = v.arrays
            if len(arrays) != target.length:
                if len(arrays) == 1:
                    arrays = arrays * target.length
                else:
                    raise MMTypeError(
                        f"loop variable changes tuple length "
                        f"{len(arrays)} -> {target.length}",
                        node.span,
                    )
            tag = v.tag if v.tag != NIL else target.tag
            cst = None
            if v.const is not None:
                cs = (v.const * target.length
                      if len(v.const) == 1 and target.length > 1 else v.const)
                if len(cs) == target.length:
                    cst = tuple(float(c) for c in cs)
            return TupleValue(
                tag,
                tuple(be.broadcast_to(self.lit(x), shape) for x in arrays),
                const=cst,
            )

        init_env = dict(self.env)
        carried: list[str] = []
        for n in names:
            tgt = probe_env[n]
            if n not in init_env:
                iv = self._internal(n)
                if iv is not None and (iv.length == tgt.length
                                       or iv.length == 1):
                    # seed with the internal's value (see probe seeding
                    # above); a LENGTH-1 internal whose carried length is
                    # longer widens below exactly like any scalar carry —
                    # the old exact-length guard zero-seeded it, so
                    # `q = y[0]` before `y = xy` read 0 instead of the y
                    # coordinate (review r5). A LONGER internal (e.g. the
                    # 2-tuple `I`) carried at a different length is
                    # genuinely write-before-read (user repurposing the
                    # name as a scalar counter) — keep the zero seed so
                    # widen() doesn't reject it
                    init_env[n] = iv
                else:
                    init_env[n] = TupleValue(NIL, (self.lit(0.0),),
                                             const=(0.0,))
            init_env[n] = widen(init_env[n], tgt)
            carried.append(n)
        lengths = {n: init_env[n].length for n in carried}
        tags = {n: init_env[n].tag for n in carried}

        def pack(env):
            flat = []
            for n in carried:
                flat.extend(env[n].arrays)
            return tuple(flat)

        def unpack(flat, base_env=None, consts=None):
            env = dict(init_env if base_env is None else base_env)
            i = 0
            for n in carried:
                k = lengths[n]
                cst = None
                if consts is not None:
                    comps = consts[i : i + k]
                    if all(c is not None for c in comps):
                        cst = tuple(comps)
                env[n] = TupleValue(tags[n], tuple(flat[i : i + k]), const=cst)
                i += k
            return env

        def pack_const(env):
            """Host-side mirror of pack(): per-slot trace-time constants
            (None where unknown) — the carry for the static unroll. MUST
            emit exactly lengths[n] slots per variable, mirroring repack's
            scalar->tuple widening, or the carry misaligns and wrong
            constants attach to later variables."""
            cs: list = []
            for n in carried:
                k = lengths[n]
                v = env[n]
                c = v.const if (v.const is not None
                                and len(v.const) == len(v.arrays)) else None
                if c is not None and len(c) != k:
                    c = tuple(c) * k if len(c) == 1 else None
                if c is not None:
                    cs.extend(float(x) for x in c)
                else:
                    cs.extend(None for _ in range(k))
            return tuple(cs)

        max_iters = self.ctx.opts.max_loop_iters

        def repack(env, flat, mask, grid_shape=None):
            """Fold env's carried values back into the flat carry. `mask`
            selects which pixels take the new value (None = all)."""
            new_flat = []
            i = 0
            for n in carried:
                k = lengths[n]
                new = env[n]
                if new.is_opaque:
                    # same rule widen() enforces at loop ENTRY — without
                    # this an in-body `v = some_gradient` crashed with a
                    # raw IndexError below (opaque length is 1 but
                    # arrays is empty)
                    raise MMTypeError(
                        f"loop variable {n!r}: image/curve/gradient values "
                        f"cannot be loop variables", node.span)
                if new.length != k:
                    if new.length == 1:
                        new = TupleValue(tags[n], new.arrays * k)
                    else:
                        raise MMTypeError(
                            f"loop variable {n!r} changes tuple length inside loop", node.span
                        )
                for j in range(k):
                    if mask is None:
                        new_flat.append(be.broadcast_to(
                            new.arrays[j], grid_shape or self.ctx.shape))
                    else:
                        new_flat.append(be.where(mask, new.arrays[j], flat[i + j]))
                i += k
            return tuple(new_flat)

        #: trace-time truth of the most recent cond evaluation (None =
        #: dynamic) — drives the static-trip-count unroll below
        cond_const = [None]
        #: pack_const() of the env after the latest const-threaded
        #: eval_cond — the unroll's next-iteration const carry
        carry_consts = [None]

        def eval_cond(flat, mask, salt, tile=None, consts=None):
            """Evaluate the condition sequence on the carried env. Its
            assignments persist (sequential cond-statement semantics) for
            the pixels that evaluated it, i.e. those active in `mask`."""
            ctx, x, y, base_env = tile or (self.ctx, self.x, self.y, None)
            env = unpack(flat, base_env, consts=consts)
            ev = Evaluator(ctx, x, y, env, salt_extra=salt)
            cond_tv = ev.eval(node.cond)
            cond_mask = ev._truthy_mask(cond_tv, node.span)
            c = cond_tv.const
            cond_const[0] = (bool(c[0] != 0)
                             if c is not None and len(c) == 1 else None)
            carry_consts[0] = pack_const(env) if consts is not None else None
            return repack(env, flat, mask, grid_shape=ctx.shape), cond_mask

        def step(flat, mask, loop_i, tile=None, consts=None):
            """One iteration under `mask`; returns (new_flat, next_mask).
            The mask is carried and ANDed monotonically, so the condition is
            evaluated once per iteration (not again in lax's cond_fn).
            `tile` = (ctx, x, y, base_env) runs the step on one block of
            the loop kernel instead of the whole grid
            (pallas_kernels/while_kernel)."""
            # match the baked trace constants; the per-loop-site nonce
            # offsets the counter so two sequential loops draw different
            # streams (they'd otherwise reset to the same base)
            ctx, x, y, base_env = tile or (self.ctx, self.x, self.y, None)
            ctx.rand_counter = counter_loop + nonce * 1000003
            ctx.rand_loop_nonce = nonce_loop
            salt = self._mix_salt(loop_i)
            env = unpack(flat, base_env, consts=consts)
            ev = Evaluator(ctx, x, y, env, salt_extra=salt)
            ev.eval(node.body)
            new_flat = repack(env, flat, mask, grid_shape=ctx.shape)
            new_flat, cond_mask = eval_cond(
                new_flat, mask, salt, tile=tile,
                consts=pack_const(env) if consts is not None else None)
            # mask=None = statically-unrolled step: all pixels active, no
            # where-merging; the caller tracks liveness via cond_const
            return new_flat, (cond_mask if mask is None else mask & cond_mask)

        flat0 = pack(init_env)
        consts0 = pack_const(init_env)
        if node.post:
            # do-while's pre-pass strips consts; its first cond can still
            # fold when literal-only, but counter-driven ones stay dynamic
            flat0 = self._run_body_once(node, flat0, unpack, repack)
            consts0 = tuple(None for _ in consts0)
        flat0, mask0 = eval_cond(flat0, None, self.salt_extra, consts=consts0)
        cond0_t = cond_const[0]   # before kernel/lax tracing clobbers it
        consts0 = carry_consts[0]  # post-cond-sequence const carry
        mask0 = be.broadcast_to(mask0, self.ctx.shape)
        counter_loop = self.ctx.rand_counter
        nonce = self.ctx.rand_loop_nonce
        self.ctx.rand_loop_nonce = nonce_loop = nonce + 1

        if self.ctx.is_jax:
            import jax

            from ..pallas_kernels import while_kernel as WK

            # Static-trip-count unroll: when the condition folds to a
            # trace-time constant (literal-driven counters — voronoi's 3x3
            # cell scan, fixed convolution taps), run the loop AT TRACE
            # TIME exactly like the oracle: the precise iteration count,
            # no lax.while_loop carry round-trips through HBM, no K-step
            # mask overshoot (the masked path evaluates bodies in blocks
            # of K=4, overshooting short loops by up to K-1 noise-call-
            # heavy bodies), and straight-line code XLA fuses across
            # iterations. Tried BEFORE the loop kernel: with a static trip
            # count there is no divergence for its early exit to exploit.
            # Bails onward the moment a cond stops folding or the count
            # exceeds the budget; partially traced steps become dead
            # code XLA eliminates.
            # pallas_while='on' is documented as FORCING the loop kernel
            # (options.py) — honor it over the unroll when the loop is
            # kernel-eligible
            wk_eligible = (self.salt_extra is None
                           and WK.eligible(self.ctx, node, env=self.env))
            wk_forced = (getattr(self.ctx.opts, "pallas_while", "auto")
                         == "on" and wk_eligible)
            unroll_max = int(getattr(self.ctx.opts, "while_static_unroll",
                                     WHILE_UNROLL_MAX))
            unrolled = None
            if cond0_t is not None and not wk_forced and unroll_max > 0:
                flat_u, consts_u, active, n_u = flat0, consts0, cond0_t, 0
                self.ctx.loop_depth += 1
                try:
                    while (active and n_u < max_iters
                           and n_u < unroll_max):
                        flat_u, _ = step(flat_u, None,
                                         loop_i=np_like_u32(be, n_u + 1),
                                         consts=consts_u)
                        consts_u = carry_consts[0]
                        n_u += 1
                        active = cond_const[0]
                finally:
                    self.ctx.loop_depth -= 1
                if active is False or (active and n_u >= max_iters):
                    unrolled = flat_u
            if unrolled is not None:
                TRACE_LOOP_PATHS.append(("unroll", n_u))
                self.ctx.rand_counter = counter_loop
                self.ctx.rand_loop_nonce = nonce_loop
                # keep the final const carry: a constant loop result (e.g.
                # an accumulated count) can drive a later loop's bound or
                # a static_scalar consumer
                final_env = unpack(unrolled, consts=consts_u)
                for n in carried:
                    self.env[n] = final_env[n]
                return TupleValue(NIL, (self.lit(0.0),))

            flat_pallas = None
            if wk_eligible:
                # fractal fast path: carries stay in registers, each
                # block exits on its own; None = a dependency disqualified
                # it, use the XLA loop
                self.ctx.loop_depth += 1
                try:
                    flat_pallas = WK.launch(
                        self, node, flat0, mask0, init_env=init_env,
                        carried=carried, step=step, max_iters=max_iters,
                    )
                finally:
                    self.ctx.loop_depth -= 1
            if flat_pallas is not None:
                TRACE_LOOP_PATHS.append(("wk", max_iters))
                self.ctx.rand_counter = counter_loop
                self.ctx.rand_loop_nonce = nonce_loop
                final_env = unpack(flat_pallas)
                for n in carried:
                    self.env[n] = final_env[n]
                return TupleValue(NIL, (self.lit(0.0),))

            # Unroll K masked steps per lax iteration: steps are exact (each
            # re-ANDs the mask, and steps whose global index reaches
            # max_iters are gated off so the safety cap stops EXACTLY where
            # the oracle does), while the per-iteration any() reduction and
            # carry round-trip amortize over K — a large win for fractals.
            K = int(getattr(self.ctx.opts, "while_unroll", 4))

            def cond_fn(state):
                i, mask, _flat = state
                return be.any(mask) & (i < max_iters)

            def body_fn(state):
                i, mask, flat = state
                for k in range(K):
                    gate = (i + k) < max_iters
                    flat, mask = step(flat, mask & gate, loop_i=i + (k + 1))
                return (i + K, mask, flat)

            TRACE_LOOP_PATHS.append(("lax", max_iters))
            self.ctx.loop_depth += 1
            try:
                _, _, flat_out = jax.lax.while_loop(
                    cond_fn, body_fn, (be.asarray(0, be.int32), mask0, flat0)
                )
            finally:
                self.ctx.loop_depth -= 1
        else:
            flat, mask = flat0, mask0
            i = 0
            self.ctx.loop_depth += 1
            try:
                while bool(mask.any()) and i < max_iters:
                    flat, mask = step(flat, mask, loop_i=np_like_u32(be, i + 1))
                    i += 1
            finally:
                self.ctx.loop_depth -= 1
            TRACE_LOOP_PATHS.append(("oracle", i))
            flat_out = flat

        # The number of steps is data-dependent; leave the counter at the
        # loop-entry state so post-loop rand() draws identically on both
        # backends (post-loop calls use salt_extra=None / the outer salt,
        # so they cannot collide with in-loop draws). The nonce is restored
        # the same way (each step reset it) so nested loops stay
        # trace-consistent; subsequent sibling loops see nonce_loop.
        self.ctx.rand_counter = counter_loop
        self.ctx.rand_loop_nonce = nonce_loop

        final_env = unpack(flat_out)
        for n in carried:
            self.env[n] = final_env[n]
        return TupleValue(NIL, (self.lit(0.0),))

    def _run_body_once(self, node, flat0, unpack, repack):
        """do-while: execute the body unconditionally once before looping.

        The result folds back through repack() (mask=None = all pixels),
        NOT a raw pack(): repack widens length-1 values to the carried
        length and rejects opaque values with a clean MMTypeError — raw
        pack emitted the body's literal slot count, silently misaligning
        the flat carry whenever the pre-pass left a variable at a
        different length than its carried one (review r5)."""
        env = unpack(flat0)
        ev = Evaluator(self.ctx, self.x, self.y, env, salt_extra=self.salt_extra)
        ev.eval(node.body)
        return repack(env, flat0, None, grid_shape=self.ctx.shape)

    # ------------------------------------------------------------------
    # calls / application
    # ------------------------------------------------------------------
    def _eval_Call(self, node: A.Call) -> TupleValue:
        func = node.func
        if isinstance(func, A.Var):
            name = func.name
            # 1. a local/param holding an applicable value
            if name in self.env and self.env[name].is_opaque:
                return self._apply_value(self.env[name], node)
            # 2. a user-defined filter: build a closure image (SURVEY §3.5)
            if name in self.ctx.filters and name not in self.env:
                fdef = self.ctx.filters[name]
                args = tuple(self.eval(a) for a in node.args)
                from .value import image_value

                return image_value(ClosureImage(fdef, args, name=name))
            # 3. builtin
            fn = R.lookup(name)
            if fn is not None:
                args = [self.eval(a) for a in node.args]
                return self._fold_const(name, args, fn(self, args, node.span))
            raise MMNameError(f"unknown function {name!r}", node.span)
        # computed callee: must evaluate to an applicable value
        v = self.eval(func)
        if v.is_opaque:
            return self._apply_value(v, node)
        raise MMTypeError("cannot call a numeric tuple", node.span)

    def _apply_value(self, v: TupleValue, node: A.Call) -> TupleValue:
        span = node.span
        if v.tag == "image":
            if len(node.args) != 1:
                raise MMTypeError("image application expects one xy argument", span)
            p = self.eval(node.args[0])
            R.need_length(p, 2, "image application", span)
            x, y = self.grid(p.arrays[0]), self.grid(p.arrays[1])
            return TupleValue("rgba", tuple(v.payload.sample(self, x, y)))
        if v.tag == "curve":
            if len(node.args) != 1:
                raise MMTypeError("curve application expects one argument", span)
            return apply_curve(self, v.payload, self.eval(node.args[0]), span)
        if v.tag == "gradient":
            if len(node.args) != 1:
                raise MMTypeError("gradient application expects one argument", span)
            return apply_gradient(self, v.payload, self.eval(node.args[0]), span)
        raise MMTypeError(f"cannot apply value of type {v.tag}", span)

    # ------------------------------------------------------------------
    # filter invocation (closures / top level)
    # ------------------------------------------------------------------
    def eval_filter_at(self, fdef: A.FilterDef, args: tuple, x, y):
        """Evaluate `fdef` at coordinate arrays (x, y) — composition is
        trace-time inlining (SURVEY §3.4: no runtime representation)."""
        if self.ctx.inline_depth >= self.ctx.max_inline_depth:
            raise MMRuntimeError(
                f"filter inlining exceeds depth {self.ctx.max_inline_depth} "
                f"(recursive filter {fdef.name!r}?)",
                fdef.span,
            )
        env = bind_params(self.ctx, fdef, args)
        # propagate the loop-iteration salt so rand() inside an inlined
        # filter stays fresh (and backend-consistent) inside while loops
        ev = Evaluator(self.ctx, x, y, env, salt_extra=self.salt_extra)
        self.ctx.inline_depth += 1
        try:
            out = ev.eval(fdef.body)
        finally:
            self.ctx.inline_depth -= 1
        return coerce_rgba(ev, out, fdef)


def bind_params(ctx: RenderContext, fdef: A.FilterDef, args: tuple) -> dict:
    """Bind call arguments to filter params positionally; unbound params fall
    back to declared defaults (userval semantics, SURVEY §2.1 userval row)."""
    from .uservals import default_userval

    env: dict = {}
    if len(args) > len(fdef.params):
        raise MMTypeError(
            f"filter {fdef.name!r} takes {len(fdef.params)} argument(s), got {len(args)}",
            fdef.span,
        )
    for i, p in enumerate(fdef.params):
        if i < len(args):
            env[p.name] = args[i]
        else:
            env[p.name] = default_userval(ctx, p)
    return env


def coerce_rgba(ev: Evaluator, out: TupleValue, fdef: A.FilterDef):
    """A filter's result must be a color; image results are auto-sampled at
    the current coordinates."""
    if out.is_opaque and out.tag == "image":
        return out.payload.sample(ev, ev.grid(ev.x), ev.grid(ev.y))
    if out.is_opaque or out.length != 4:
        raise MMTypeError(
            f"filter {fdef.name!r} must return an rgba color (length-4 tuple), "
            f"got {out.tag}:{out.length}",
            fdef.span,
        )
    return tuple(ev.grid(c) for c in out.arrays)
