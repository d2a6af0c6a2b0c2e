"""Per-pixel while loops as one Pallas-Triton kernel — the fractal fast path.

The tracer's jit loop (`runtime/tracer._eval_While`) runs the whole grid
through `lax.while_loop`: every `while_unroll` masked steps it writes each
carry to device memory and reads it back (mandelbrot: 3 carries + mask, about
16 B per pixel each way), every trip reduces the mask over the whole grid to
decide whether to go on, and no pixel stops before the slowest pixel of the
frame. This kernel runs the loop per block of pixels instead: one
`pallas_call` (Triton route) whose programs each load their block once, keep
every carry in registers through an in-kernel `lax.while_loop`, and stop as
soon as none of THEIR pixels is active or `max_iters` is reached.

Eligibility is decided statically (`eligible`): the loop body/cond may only
call elementwise builtins that lower on the Triton route (no image/curve/
gradient application, no gather-based noise, no nested while); rand() is
allowed (its index grid is built from 2-D iotas). The step semantics (mask
gating, cond-assignment persistence, max_iters cap, rand counters) are the
SAME closure the XLA path uses — this module only owns the blocking/launch
mechanics. Mesh-sharded renders run the kernel per device tile: the tile's
traced global offsets enter as (1, 1) scalar inputs.

The kernel compiles for a GPU only. On a CPU it runs in Pallas interpret
mode when `INTERPRET` is set, which tests do; nothing sets it from the
backend.
"""

from __future__ import annotations

from dataclasses import replace

from ..lang import astnodes as A

#: pixels per program, warps, and masked steps per in-kernel trip (the
#: block's "any pixel active?" reduction runs once per trip): the fastest
#: of (8, 256), (16, 128), (32, 64), (16, 256) × 4/8 warps × 1/4 steps by
#: device time on 4K mandelbrot at maxiter 64 and 1024 (PERF.md, "Loop
#: kernel")
BLOCK_H = 32
BLOCK_W = 64
NUM_WARPS = 8
STEPS_PER_CHECK = 4
#: 'auto' uses the kernel from this many pixels up: the smallest grid
#: measured, where it already beat the lax loop (PERF.md, "Loop kernel")
MIN_PIXELS = 128 * 128
#: run the kernel in Pallas interpret mode (CPU tests); never set on a GPU
INTERPRET = False

#: builtins whose jax implementations lower on the Pallas Triton route,
#: in every overload (tests/test_while_kernel.py cross-lowers one loop per
#: name for "cuda" and asserts the Triton call). Out: `round` (Pallas GPU
#: has no lowering for it), image/curve/gradient sampling and noise
#: (their tables would be captured constants), gaussian_blur/solve/det,
#: and the GSL-class specials (gamma/beta/elliptic/jacobi lower, but
#: nothing measured them in the kernel; the lax loop keeps them).
SAFE_CALLS = frozenset({
    "__add", "__sub", "__mul", "__div", "__mod", "__pow", "__eq", "__ne",
    "__lt", "__gt", "__le", "__ge", "__and", "__or", "__xor", "__neg",
    "__not",
    "abs", "sign", "min", "max", "clamp", "lerp", "smoothstep", "inintv",
    "floor", "ceil", "fmod", "hypot",
    "sqrt", "exp", "exp2", "log", "log2", "log10", "pow",
    "sin", "cos", "tan", "tanh", "asin", "acos", "atan", "atan2",
    "sinh", "cosh", "asinh", "acosh", "atanh",
    "deg2rad", "rad2deg", "rand",
    "rgbColor", "rgbaColor", "grayColor", "grayaColor",
    "red", "green", "blue", "alpha", "gray",
    "toXY", "toRA", "arg", "toHSVA", "toRGBA",
    "conj", "length", "dotp", "crossp", "normalize", "scale",
})


def _calls_safe(node, env=None, filters=None) -> bool:
    for sub in A.walk(node):
        if isinstance(sub, A.Call):
            f = sub.func
            if not isinstance(f, A.Var) or f.name not in SAFE_CALLS:
                return False
            # a SAFE_CALLS name shadowed by an env value (curve param
            # named `sin`) or a user filter resolves to THAT in the
            # evaluator — but launch() drops opaque deps, so the
            # in-kernel call would silently fall through to the builtin
            # and diverge from the XLA/oracle path (review r3 finding)
            if env is not None and f.name in env:
                return False
            if filters and f.name in filters:
                return False
        if isinstance(sub, A.While) and sub is not node:
            return False  # nested while: one loop level per kernel
    return True


def eligible(ctx, node: A.While, env=None) -> bool:
    import jax

    if not ctx.is_jax or getattr(ctx, "in_pallas", False):
        return False
    mode = getattr(ctx.opts, "pallas_while", "auto")
    if mode == "off":
        return False
    if mode != "on":
        # 'on' FORCES the kernel (tests, cross-lowering); 'auto' takes it
        # only on a GPU and only for grids that amortize the launch
        h, w = ctx.shape
        if jax.default_backend() != "gpu" or h * w < MIN_PIXELS:
            return False
    filters = getattr(ctx, "filters", None)
    return (_calls_safe(node.body, env, filters)
            and _calls_safe(node.cond, env, filters))


def launch(ev, node: A.While, flat0, mask0, *, init_env, carried, step,
           max_iters: int):
    """Run the loop in one blocked kernel; returns the final flat carry
    tuple, or None when a dependency's shape/dtype disqualifies the path
    (caller falls back to the XLA loop)."""
    import jax
    import jax.numpy as jnp
    from jax.experimental import pallas as pl
    from jax.experimental.pallas import triton as plt

    from ..runtime.value import TupleValue

    ctx = ev.ctx
    H, W = ctx.shape
    n_flat = len(flat0)
    f32 = jnp.float32

    for a in flat0:
        if getattr(a, "dtype", None) != f32 or getattr(a, "shape", None) != (H, W):
            return None

    # non-block-aligned grids: pad every grid array with edge values and a
    # FALSE mask (padding pixels never update), slice the carry back after
    Ht = -(-H // BLOCK_H) * BLOCK_H
    Wt = -(-W // BLOCK_W) * BLOCK_W
    pad = (Ht, Wt) != (H, W)

    def _pad(a):
        return jnp.pad(a, ((0, Ht - H), (0, Wt - W)), mode="edge") if pad else a

    # ---- dependencies: non-carried env values the loop reads ----
    reads = {s.name for s in A.walk(node) if isinstance(s, A.Var)}
    dep_names = sorted(
        n for n in reads
        if n in init_env and n not in carried and not init_env[n].is_opaque)
    dep_specs = []  # (name, tag, [is_grid per component])
    dep_arrays = []
    dep_is_grid = []
    for n in dep_names:
        tv = init_env[n]
        comps = []
        for a in tv.arrays:
            a = jnp.asarray(a)
            if a.shape == (H, W):
                comps.append(True)
                dep_arrays.append(_pad(a.astype(f32)))
                dep_is_grid.append(True)
            elif a.ndim == 0:
                comps.append(False)
                dep_arrays.append(a.astype(f32).reshape(1, 1))
                dep_is_grid.append(False)
            else:
                return None  # odd-shaped dependency: fall back
        dep_specs.append((n, tv.tag, comps))
    n_dep = len(dep_arrays)

    # t/frame and the tile's global offsets may be TRACED (under shard_map
    # the offsets derive from lax.axis_index) — a kernel cannot close over
    # traced values, so they enter as (1, 1) scalar inputs
    t_arr = jnp.asarray(ctx.t, f32).reshape(1, 1)
    fr_arr = jnp.asarray(ctx.frame, f32).reshape(1, 1)
    ro_arr = jnp.asarray(ctx.row_offset, jnp.int32).reshape(1, 1)
    co_arr = jnp.asarray(ctx.col_offset, jnp.int32).reshape(1, 1)
    x_arr = jnp.asarray(ev.x, f32)
    y_arr = jnp.asarray(ev.y, f32)
    if x_arr.shape != (H, W) or y_arr.shape != (H, W):
        return None
    mask_init = mask0.astype(f32)
    if pad:
        # padding pixels start inactive and their carries are edge copies;
        # they are sliced away below
        mask_init = jnp.pad(mask_init, ((0, Ht - H), (0, Wt - W)))
    grid_args = [_pad(x_arr), _pad(y_arr), mask_init] + [_pad(a) for a in flat0]

    small = pl.BlockSpec((1, 1), lambda i, j: (0, 0))
    block = pl.BlockSpec((BLOCK_H, BLOCK_W), lambda i, j: (i, j))

    def kernel(t_ref, fr_ref, ro_ref, co_ref, x_ref, y_ref, m_ref, *rest):
        flat_refs = rest[:n_flat]
        dep_refs = rest[n_flat:n_flat + n_dep]
        out_refs = rest[n_flat + n_dep:]
        ctx2 = replace(
            ctx, grid_shape=(BLOCK_H, BLOCK_W),
            row_offset=ro_ref[0, 0] + pl.program_id(0) * BLOCK_H,
            col_offset=co_ref[0, 0] + pl.program_id(1) * BLOCK_W,
            t=t_ref[0, 0], frame=fr_ref[0, 0], in_pallas=True, inputs=[],
        )
        base_env = {}
        idx = 0
        for name, tag, comps in dep_specs:
            arrs = []
            for is_grid in comps:
                r = dep_refs[idx]
                idx += 1
                arrs.append(r[...] if is_grid else r[0, 0])
            base_env[name] = TupleValue(tag, tuple(arrs))
        tile = (ctx2, x_ref[...], y_ref[...], base_env)

        def cond(state):
            i, maskv, _flat = state
            # jnp.any has no Triton lowering (reduce_or); max over int does
            return (i < max_iters) & (jnp.max(maskv.astype(jnp.int32)) > 0)

        def body(state):
            i, maskv, flat = state
            for k in range(STEPS_PER_CHECK):
                gate = (i + k) < max_iters
                flat, maskv = step(flat, maskv & gate, loop_i=i + (k + 1),
                                   tile=tile)
            return i + STEPS_PER_CHECK, maskv, flat

        _, _, flat = jax.lax.while_loop(
            cond, body,
            (jnp.int32(0), m_ref[...] > 0.5,
             tuple(r[...] for r in flat_refs)))
        for r, a in zip(out_refs, flat):
            r[...] = a.astype(f32)

    call = pl.pallas_call(
        kernel,
        grid=(Ht // BLOCK_H, Wt // BLOCK_W),
        in_specs=[small] * 4 + [block] * (3 + n_flat)
        + [block if g else small for g in dep_is_grid],
        out_specs=[block] * n_flat,
        out_shape=[jax.ShapeDtypeStruct((Ht, Wt), f32)] * n_flat,
        backend="triton",
        compiler_params=plt.CompilerParams(num_warps=NUM_WARPS,
                                           num_stages=1),
        interpret=INTERPRET,
        name="mm_while_loop",
    )
    flat_out = call(t_arr, fr_arr, ro_arr, co_arr, *grid_args, *dep_arrays)
    if pad:
        flat_out = [a[:H, :W] for a in flat_out]
    return tuple(flat_out)
