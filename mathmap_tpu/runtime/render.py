"""Render engine: jit/pjit entry points.

Reference: `mathmap_common.c` render loop — slice threads over rows, per-pixel
filter calls, supersampling, 8-bit packing (SURVEY.md §2.1 render-engine row,
§3.1 call stack [unverified — mount empty, SURVEY.md §0]).

Design (SURVEY §7): one traced program evaluates the whole grid; the
row-slice thread pool is replaced by XLA's on-device parallelism (and by mesh
sharding for multi-chip — parallel/shard.py). Supersampling evaluates the
filter at an s×s subpixel offset grid and averages — the loop is unrolled at
trace time so XLA fuses all s² evaluations.
"""

from __future__ import annotations

import numpy as np

from ..lang import astnodes as A
from ..utils.errors import MMRuntimeError
from .tracer import Evaluator, RenderContext, coerce_rgba
from .uservals import convert_userval, default_userval
from .value import InputImage, image_value


def coordinate_grids(ctx: RenderContext, dx: float = 0.0, dy: float = 0.0):
    """Centered world-coordinate grids: GLOBAL pixel (row j, col i) center at
    (i + 0.5 - W/2, H/2 - 0.5 - j), y pointing up. (dx, dy) are subpixel
    offsets in pixel units for supersampling. When the grid is sharded
    (ctx.grid_shape set), each device builds only its local tile using its
    row/col offsets — coordinates are identical to the unsharded render."""
    be = ctx.be
    h, w = ctx.shape
    dt = ctx.dtype or be.float32
    xs = (be.arange(w, dtype=dt)
          + be.asarray(ctx.col_offset, dtype=dt)
          + be.asarray(0.5 + dx, dtype=dt)
          - be.asarray(ctx.width * 0.5, dtype=dt))
    ys = (be.asarray(ctx.height * 0.5, dtype=dt)
          - (be.arange(h, dtype=dt)
             + be.asarray(ctx.row_offset, dtype=dt)
             + be.asarray(0.5 + dy, dtype=dt)))
    x = be.broadcast_to(xs[None, :], (h, w))
    y = be.broadcast_to(ys[:, None], (h, w))
    return x, y


def resolve_region(opts, width: int, height: int):
    """Validate opts.region against the canvas -> (x, y, w, h) or None.

    The GIMP-selection semantics (reference `mathmap.c` renders the
    drawable's selection bounds with full-drawable coordinates
    [unverified — mount empty]): only the sub-rectangle is evaluated, but
    x/y/W/H/R and input sampling use the FULL canvas."""
    reg = getattr(opts, "region", None)
    if reg is None:
        return None
    x, y, w, h = reg
    if x + w > width or y + h > height:
        raise ValueError(
            f"region {reg} exceeds the {width}x{height} canvas")
    return reg


def region_ctx_fields(region):
    """RenderContext overrides that evaluate only the region's grid: the
    region is a grid_shape + row/col offsets, the same fields the sharded
    renderers use for a device tile. World coordinates stay GLOBAL, so the
    region render is the full render's crop."""
    if region is None:
        return {}
    x, y, w, h = region
    return dict(grid_shape=(h, w), row_offset=y, col_offset=x)


def subpixel_offsets(s: int):
    """s×s subpixel offset grid within one pixel (s=1 -> center only)."""
    return [((i + 0.5) / s - 0.5, (j + 0.5) / s - 0.5) for j in range(s) for i in range(s)]


def build_env(ctx: RenderContext, fdef: A.FilterDef, uservals: dict):
    """Bind filter params: image params consume ctx.inputs positionally,
    others come from the `uservals` dict (already TupleValues) or defaults."""
    env = {}
    img_idx = 0
    for p in fdef.params:
        if p.kind == "image":
            if img_idx < len(ctx.inputs):
                env[p.name] = image_value(ctx.inputs[img_idx])
                img_idx += 1
            elif p.name in uservals:
                env[p.name] = uservals[p.name]
            else:
                raise MMRuntimeError(
                    f"filter {fdef.name!r}: no input bound for image parameter {p.name!r}",
                    p.span,
                )
        elif p.name in uservals:
            env[p.name] = uservals[p.name]
        else:
            env[p.name] = default_userval(ctx, p)
    return env


def _eval_rgba_once(ctx: RenderContext, fdef: A.FilterDef, uservals: dict,
                    dx: float, dy: float, extra: int = 0):
    """One unclipped (lh+extra, lw+extra, 4) evaluation at subpixel offset
    (dx, dy) on a grid extended by `extra` rows/cols past the frame — the
    building block of the corner-grid AA scheme (pixel (i, j)'s corners
    live on the (H+1, W+1) grid at offset (-0.5, -0.5)). World coordinates
    and the X/Y/W/H/R internals keep the REAL frame geometry; only the
    evaluation grid grows. Returns (rgba_array, sub_ctx) — the caller
    threads sub_ctx.rand_counter so sequential evaluations keep drawing
    distinct rand() streams (mirroring the s×s loop, which mutates one
    shared ctx)."""
    from dataclasses import replace

    be = ctx.be
    if ctx.grid_shape is not None:
        gh, gw = ctx.grid_shape
        sub = replace(ctx, grid_shape=(gh + extra, gw + extra))
    else:
        lh, lw = ctx.height + extra, ctx.width + extra
        sub = replace(ctx, grid_shape=(lh, lw) if extra else None)
    x, y = coordinate_grids(sub, dx, dy)
    env = build_env(sub, fdef, uservals)
    ev = Evaluator(sub, x, y, env)
    comps = coerce_rgba(ev, ev.eval(fdef.body), fdef)
    return be.stack(comps, axis=-1), sub


def pack_uint8(be, rgba):
    """Device-side 8-bit packing, bit-identical to imgio.to_uint8 /
    native.f32_to_u8 on the same float values: clip to [0,1], ·255 + 0.5,
    floor. The explicit floor makes the float→int convert exact (an
    integer-valued float converts identically under every rounding mode,
    so GPU/CPU/NumPy all agree)."""
    x = be.clip(rgba, 0.0, 1.0) * be.asarray(255.0, dtype=rgba.dtype)
    return be.floor(x + be.asarray(0.5, dtype=rgba.dtype)).astype(be.uint8)


def float_inputs(be, arrays):
    """Normalize render inputs: uint8 (…,H,W,4) arrays become float32/255
    IN-TRACE (bit-identical to imgio.to_float_rgba's u8 path) so callers
    can ship 4× fewer bytes host→device; float arrays pass through."""
    return [a.astype(be.float32) / be.asarray(255.0, dtype=be.float32)
            if a.dtype == np.uint8 else a for a in arrays]


def sweep_unroll_for(opts, width: int, height: int) -> int:
    """Resolve RenderOptions.sweep_unroll for a (width, height) sweep.

    'auto' = 1 (flat lax.map); an int forces that chunk factor. Whether
    unrolling pays on the GPU has not been measured (ROADMAP S2); the
    option and MMTPU_SWEEP_UNROLL stay for that experiment."""
    u = getattr(opts, "sweep_unroll", "auto")
    if u == "auto":
        return 1
    return max(1, int(u))


def render_frame(ctx: RenderContext, fdef: A.FilterDef, uservals: dict):
    """Render one frame -> (H, W, 4) float32 array in [0,1] (uint8 when
    opts.output_dtype='uint8' — packed here so every renderer (jit,
    oracle, sharded, tiled) shares the same rule)."""
    out = _render_frame_f32(ctx, fdef, uservals)
    if getattr(ctx.opts, "output_dtype", "float32") == "uint8":
        return pack_uint8(ctx.be, out)
    return out


def _render_frame_f32(ctx: RenderContext, fdef: A.FilterDef, uservals: dict):
    be = ctx.be
    s = ctx.opts.supersample
    if s > 1 and getattr(ctx.opts, "supersample_scheme", "grid") == "corners":
        # corner-grid + center AA (SURVEY §2.1's suspected reference
        # scheme [unverified — mount empty]): ONE (H+1, W+1) evaluation at
        # the pixel corners — each interior corner is shared by 4 pixels —
        # plus the centers; average the 5 samples per pixel. ~2.07x a
        # plain render vs the s×s grid's s²x. Equal 1/5 weights
        # [weighting unverified; re-adjudicate at SURVEY §8].
        corner, sub = _eval_rgba_once(ctx, fdef, uservals, -0.5, -0.5, 1)
        ctx.rand_counter = sub.rand_counter
        ctx.rand_loop_nonce = sub.rand_loop_nonce
        center, sub2 = _eval_rgba_once(ctx, fdef, uservals, 0.0, 0.0, 0)
        ctx.rand_counter = sub2.rand_counter
        ctx.rand_loop_nonce = sub2.rand_loop_nonce
        out = (corner[:-1, :-1] + corner[:-1, 1:] + corner[1:, :-1]
               + corner[1:, 1:] + center) * be.asarray(
                   0.2, dtype=center.dtype)
        return be.clip(out, 0.0, 1.0)
    acc = None
    for dx, dy in subpixel_offsets(s):
        x, y = coordinate_grids(ctx, dx, dy)
        env = build_env(ctx, fdef, uservals)
        ev = Evaluator(ctx, x, y, env)
        out = ev.eval(fdef.body)
        comps = coerce_rgba(ev, out, fdef)
        if acc is None:
            acc = list(comps)
        else:
            acc = [a + c for a, c in zip(acc, comps)]
    inv = 1.0 / (s * s)
    comps = [a * inv for a in acc]
    rgba = be.stack(comps, axis=-1)
    # clamp to displayable range (the reference clamps when packing 8-bit)
    return be.clip(rgba, 0.0, 1.0)


# ---------------------------------------------------------------------------
# JAX product path: jitted, cached per static configuration
# ---------------------------------------------------------------------------

def _validate_param_names(fdef: A.FilterDef, params: dict) -> None:
    """Reject param NAMES the filter doesn't declare: a typo'd
    `--param raduis=5` would otherwise render with the default and exit 0
    — silently wrong output. Shared by the jit path and the oracle.
    (The reference's userval binding is by declared name too —
    userval.c [unverified, mount empty].)"""
    declared = {p.name for p in fdef.params}
    unknown = [n for n in params if n not in declared]
    if unknown:
        raise ValueError(
            f"unknown param(s) for filter {fdef.name!r}: {unknown} "
            f"(declares: {sorted(declared)})")


def _validate_static_params(fdef: A.FilterDef, static_names) -> None:
    """Reject static_params names the filter doesn't declare, and opaque
    (curve/gradient/image) params that cannot be baked. Shared by the jit
    path and the oracle so both raise identically."""
    if not static_names:
        return
    declared = {p.name: p for p in fdef.params}
    unknown = [n for n in static_names if n not in declared]
    if unknown:
        raise ValueError(
            f"static_params names not declared by filter "
            f"{fdef.name!r}: {unknown} (has: {sorted(declared)})")
    bad = [n for n in static_names
           if declared[n].kind in ("curve", "gradient", "image")]
    if bad:
        raise ValueError(
            f"static_params cannot bake opaque params {bad} "
            f"(curve/gradient/image values stay traced)")


def _userval_pytree(ctx, fdef: A.FilterDef, params: dict):
    """Split user params into (traced pytree of arrays, static remainder).

    Numeric/color/curve/gradient/image values become traced arrays so
    changing them does NOT retrigger compilation — mirroring the reference,
    where uservals are runtime inputs to the compiled .so. Names listed in
    opts.static_params instead BAKE the value into the static spec (the
    reference's cgen.c behavior — recompile per value), which lets a baked
    loop bound statically unroll (tracer.py)."""
    arrays = {}
    kinds = {}
    static_names = getattr(ctx.opts, "static_params", ())
    _validate_static_params(fdef, static_names)
    _validate_param_names(fdef, params)
    for p in fdef.params:
        if p.name not in params:
            continue
        tv = convert_userval(ctx, p, params[p.name])
        if p.name in static_names and not tv.is_opaque:
            vals = ",".join(repr(float(a)) for a in tv.arrays)
            kinds[p.name] = f"static:{tv.tag}:{vals}"
            continue
        if tv.is_opaque:
            payload = tv.payload
            if hasattr(payload, "lut"):
                kinds[p.name] = "lut:" + p.kind
                arrays[p.name] = payload.lut
            else:
                kinds[p.name] = "image"
                arrays[p.name] = payload.pixels
        else:
            kinds[p.name] = "tuple:" + tv.tag
            arrays[p.name] = list(tv.arrays)
    # kinds is returned as a hashable static spec (jit static argument)
    return arrays, tuple(sorted(kinds.items()))


def _rebuild_uservals(be, arrays: dict, kinds: tuple):
    from .value import Curve, Gradient, TupleValue, curve_value, gradient_value

    out = {}
    for name, kind in kinds:
        if kind.startswith("static:"):
            _, tag, vals = kind.split(":", 2)
            comps = tuple(float(v) for v in vals.split(","))
            out[name] = TupleValue(
                tag, tuple(be.asarray(v, dtype=be.float32) for v in comps),
                const=comps)
            continue
        payload = arrays[name]
        if kind.startswith("tuple:"):
            out[name] = TupleValue(kind.split(":", 1)[1], tuple(payload))
        elif kind == "lut:curve":
            out[name] = curve_value(Curve(lut=payload))
        elif kind == "lut:gradient":
            out[name] = gradient_value(Gradient(lut=payload))
        elif kind == "image":
            out[name] = image_value(InputImage(pixels=payload, name=name))
    return out


def stage_inputs(jnp, arrays):
    """Host arrays -> device, preserving uint8 (the in-trace /255
    conversion means a u8 upload ships 4× fewer bytes); device arrays pass
    through untouched
    (np.asarray on them would round-trip host<->device every call). The
    ONE staging rule — shared by JitRenderer._stage and ShardedRenderer
    (a diverged copy in the sharded path once shipped raw 0-255 floats
    into the tiles; review r4 finding)."""
    out = []
    for a in arrays:
        if isinstance(a, jnp.ndarray):
            out.append(a)
            continue
        a = np.asarray(a)
        if a.dtype != np.uint8:
            a = np.asarray(a, dtype=np.float32)
        out.append(jnp.asarray(a))
    return out


def _merge_shared(mask, shared, per_job):
    """Re-interleave SHARED inputs (one array for every job) with this
    job's sliced inputs, in original position order."""
    ins = []
    si = bi = 0
    for m in mask:
        if m:
            ins.append(shared[si])
            si += 1
        else:
            ins.append(per_job[bi])
            bi += 1
    return ins


class JitRenderer:
    """Compile-once renderer for a (filter, W, H, options) configuration —
    the analog of the reference's compiled-filter cache (cgen.c)."""

    def __init__(self, program_filters: dict, fdef: A.FilterDef, width: int,
                 height: int, opts, num_frames: int = 1):
        import jax
        import jax.numpy as jnp

        self.jnp = jnp
        self.fdef = fdef
        self.filters = program_filters
        self.width, self.height, self.opts = width, height, opts
        self.num_frames = num_frames

        # region renders (GIMP-selection semantics): the evaluated grid
        # covers only the region; width/height stay full-canvas
        region = resolve_region(opts, width, height)

        def run(input_arrays, userval_arrays, kinds, t, frame):
            inputs = [InputImage(pixels=a, name=f"in{i}")
                      for i, a in enumerate(float_inputs(jnp, input_arrays))]
            ctx = RenderContext(
                be=jnp, width=width, height=height, opts=opts,
                inputs=inputs,
                filters=program_filters, t=t, frame=frame,
                num_frames=num_frames, is_jax=True,
                **region_ctx_fields(region),
            )
            uservals = _rebuild_uservals(jnp, userval_arrays, kinds)
            return render_frame(ctx, fdef, uservals)

        self._jitted = jax.jit(run, static_argnums=(2,))

        def _unrolled_map(one, xs):
            """lax.map with the body UNROLLED in chunks of the sweep
            unroll factor (RenderOptions.sweep_unroll). Sweeps not
            divisible by the chunk pad by REPEATING the last element
            (dropped from the result); short sweeps unroll whole with no
            scan. MMTPU_SWEEP_UNROLL overrides at trace time;
            sweep_unroll=1 is the flat map."""
            import os

            import jax.tree_util as jtu

            env = os.environ.get("MMTPU_SWEEP_UNROLL")
            if env is not None:
                u = max(1, int(env))
            else:
                u = sweep_unroll_for(opts, width, height)
            n = int(jtu.tree_leaves(xs)[0].shape[0])
            if u <= 1:
                return jax.lax.map(one, xs)

            def at(tree, i):
                return jtu.tree_map(lambda a: a[i], tree)

            if n <= u:
                return jnp.stack([one(at(xs, i)) for i in range(n)])
            pad = (-n) % u
            if pad:
                xs = jtu.tree_map(
                    lambda a: jnp.concatenate(
                        [a, jnp.repeat(a[-1:], pad, axis=0)]), xs)
            xs_c = jtu.tree_map(
                lambda a: a.reshape((n + pad) // u, u, *a.shape[1:]), xs)

            def chunk(args_c):
                return jnp.stack([one(at(args_c, i)) for i in range(u)])

            res = jax.lax.map(chunk, xs_c)
            res = res.reshape(n + pad, *res.shape[2:])
            return res[:n] if pad else res

        def run_frames(input_arrays, userval_arrays, kinds, ts, frame0):
            # whole t-sweep in ONE device program: a map over frames keeps
            # each frame's fused program and amortizes dispatch + transfer
            # (the reference renders frames in a host loop). frame0 offsets
            # the `frame` internal when the sweep is chunked
            # (api.render_animation).
            frames = jnp.arange(ts.shape[0], dtype=jnp.float32) + frame0

            def one(args):
                frame, t = args
                return run(input_arrays, userval_arrays, kinds, t, frame)

            return _unrolled_map(one, (frames, ts))

        self._jitted_frames = jax.jit(run_frames, static_argnums=(2,))

        def run_jobs(shared_ins, batched_ins, userval_arrays, kinds, mask,
                     ts, frames):
            # N independent jobs (each its own input image(s) + t) in ONE
            # device program, amortizing dispatch over N frames exactly
            # like render_all_frames does for t-sweeps. Batched inputs
            # carry a leading job axis; the map slices per job (no per-job
            # retrace). `mask` (static) marks SHARED inputs — one image
            # every job samples (the param-animation workload).
            def one(args):
                frame, t, ins_i = args
                ins = _merge_shared(mask, shared_ins, ins_i)
                return run(ins, userval_arrays, kinds, t, frame)

            return _unrolled_map(
                one, (frames, ts, [a for a in batched_ins]))

        self._jitted_jobs = jax.jit(run_jobs, static_argnums=(3, 4))

        def run_jobs_pp(shared_ins, batched_ins, batched_uv, kinds, mask,
                        ts, frames):
            # per-job PARAMS variant: every userval leaf carries a leading
            # N axis and rides the same map (the serving layer batches
            # same-filter requests whose param VALUES differ — the kinds
            # spec must still match, so one trace covers the batch)
            def one(args):
                frame, t, uv_i, ins_i = args
                ins = _merge_shared(mask, shared_ins, ins_i)
                return run(ins, uv_i, kinds, t, frame)

            return _unrolled_map(
                one, (frames, ts, batched_uv, [a for a in batched_ins]))

        self._jitted_jobs_pp = jax.jit(run_jobs_pp, static_argnums=(3, 4))

    def _stage(self, arrays):
        return stage_inputs(self.jnp, arrays)

    def _frame_args(self, input_arrays, params, t, frame):
        jnp = self.jnp
        ctx = RenderContext(
            be=jnp, width=self.width, height=self.height, opts=self.opts,
            inputs=[], filters=self.filters, is_jax=True,
        )
        arrays, kinds = _userval_pytree(ctx, self.fdef, params)
        return (self._stage(input_arrays), arrays, kinds, jnp.float32(t),
                jnp.float32(frame))

    def __call__(self, input_arrays, params: dict, t: float = 0.0, frame: float = 0.0):
        return self._jitted(*self._frame_args(input_arrays, params, t, frame))

    def lower(self, input_arrays, params: dict, t: float = 0.0,
              frame: float = 0.0):
        """The single-frame program lowered for these arguments (no
        device work): `.compile().as_text()` shows what the compiler made
        of it, e.g. whether a loop kernel is in it."""
        return self._jitted.lower(
            *self._frame_args(input_arrays, params, t, frame))

    def render_batch(self, batched_inputs, params: dict, ts, frames=None,
                     shared_mask=None):
        """Render N independent jobs in one device call -> (N, H, W, 4).

        Each element of `batched_inputs` is an (N, H, W, 4) stack; job i
        renders inputs [a[i] for a in batched_inputs] at t=ts[i]. `params`
        is either ONE dict shared across the batch, or a LIST of N dicts —
        per-job values for the same param names (each value set rides the
        lax.map as a stacked traced pytree; the static kinds spec must
        match across jobs, so static_params values may not vary). This is
        the product path's answer to the per-call dispatch cost on small
        frames.

        `shared_mask[i]` marks input i as SHARED: ONE (H, W, 4) image (or
        (T, H, W, 4) animated stack) with no job axis that every job
        samples — the param-animation workload (api.shared wraps this)."""
        jnp = self.jnp
        ctx = RenderContext(
            be=jnp, width=self.width, height=self.height, opts=self.opts,
            inputs=[], filters=self.filters, is_jax=True,
        )
        ins = self._stage(batched_inputs)
        # `is None` (not truthiness): an empty sequence must still hit the
        # length check, and a numpy bool array would raise on bool()
        mask = ((False,) * len(ins) if shared_mask is None
                else tuple(bool(m) for m in shared_mask))
        if len(mask) != len(ins):
            raise ValueError(
                f"render_batch: shared_mask length {len(mask)} != "
                f"{len(ins)} inputs")
        shared = [a for a, m in zip(ins, mask) if m]
        per_job = [a for a, m in zip(ins, mask) if not m]
        ts = jnp.asarray(ts, dtype=jnp.float32)
        n_jobs = int(ts.shape[0])
        if frames is None:
            frames = jnp.arange(ts.shape[0], dtype=jnp.float32)
        else:
            frames = jnp.asarray(frames, dtype=jnp.float32)
            if int(frames.shape[0]) != n_jobs:
                raise ValueError(
                    f"render_batch: {int(frames.shape[0])} frames for a "
                    f"batch of {n_jobs} jobs (ts)")
        # per-job batched inputs must carry one leading entry per job —
        # caught here as a readable error instead of an opaque lax.map
        # leading-axis trace failure (review r5)
        for i, a in enumerate(per_job):
            lead = getattr(a, "shape", (n_jobs,))[0]
            if int(lead) != n_jobs:
                raise ValueError(
                    f"render_batch: per-job input {i} has leading dim "
                    f"{int(lead)} for a batch of {n_jobs} jobs (mark it "
                    f"mm.shared(...) if it is one image for every job)")
        if isinstance(params, (list, tuple)):
            import jax

            if len(params) != int(ts.shape[0]):
                raise ValueError(
                    f"render_batch: {len(params)} param dicts for a batch "
                    f"of {int(ts.shape[0])} jobs")
            per = [_userval_pytree(ctx, self.fdef, p) for p in params]
            kinds = per[0][1]
            if any(k != kinds for _, k in per[1:]):
                raise ValueError(
                    "render_batch: per-job params must declare the same "
                    "names and kinds in every job (and identical values "
                    "for any static_params — baked values key the "
                    "compiled program)")
            stacked = jax.tree_util.tree_map(
                lambda *xs: jnp.stack([jnp.asarray(x) for x in xs]),
                *[a for a, _ in per]) if per[0][0] else {}
            return self._jitted_jobs_pp(shared, per_job, stacked, kinds,
                                        mask, ts, frames)
        arrays, kinds = _userval_pytree(ctx, self.fdef, params)
        return self._jitted_jobs(shared, per_job, arrays, kinds, mask,
                                 ts, frames)

    def render_all_frames(self, input_arrays, params: dict, ts, frame0: float = 0.0):
        """Render every frame of a t-sweep in one device call -> (F,H,W,4)."""
        jnp = self.jnp
        ctx = RenderContext(
            be=jnp, width=self.width, height=self.height, opts=self.opts,
            inputs=[], filters=self.filters, is_jax=True,
        )
        arrays, kinds = _userval_pytree(ctx, self.fdef, params)
        ins = self._stage(input_arrays)
        return self._jitted_frames(
            ins, arrays, kinds, jnp.asarray(ts, dtype=jnp.float32), jnp.float32(frame0)
        )


def render_oracle(program_filters: dict, fdef: A.FilterDef, input_arrays, params: dict,
                  width: int, height: int, opts, t: float = 0.0, frame: float = 0.0,
                  num_frames: int = 1, precision: str = "f32"):
    """NumPy oracle render — the semantic spec (reference IR interpreter
    analog, SURVEY §2.3 item 2). Eager, slow, used by tests and
    `--interpret`. precision='f64' runs the whole evaluation in float64
    (the reference computes in C doubles — SURVEY §7 hard part 2)."""
    dt = np.float64 if precision == "f64" else np.float32

    def conv(a):
        # u8 inputs normalize exactly like the jit path's in-trace /255
        # (float_inputs) and imgio.to_float_rgba's u8 branch
        a = np.asarray(a)
        if a.dtype == np.uint8:
            a = a.astype(np.float32) / np.float32(255.0)
        return np.asarray(a, dtype=dt)

    ctx = RenderContext(
        be=np, width=width, height=height, opts=opts,
        inputs=[InputImage(pixels=conv(a), name=f"in{i}")
                for i, a in enumerate(input_arrays)],
        filters=program_filters, t=dt(t), frame=dt(frame),
        num_frames=num_frames, is_jax=False, dtype=dt,
        **region_ctx_fields(resolve_region(opts, width, height)),
    )
    _validate_static_params(fdef, getattr(opts, "static_params", ()))
    _validate_param_names(fdef, params)
    uservals = {}
    for p in fdef.params:
        if p.name in params:
            uservals[p.name] = convert_userval(ctx, p, params[p.name])
    return render_frame(ctx, fdef, uservals)
