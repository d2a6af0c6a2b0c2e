"""Halo-exchange tiled rendering: the sequence/context-parallel analog.

Reference has no distributed comm at all (SURVEY.md §2.2) — the structural
analog of sequence parallelism is large-canvas tiling: when a 4K+ render or
multi-image composite exceeds HBM with replicated inputs, shard the INPUT
image rows (and optionally columns) across devices and exchange `halo`
boundary rows/cols with ring neighbors via `lax.ppermute` (NCCL between
GPUs)
(SURVEY §2.2 SP row, §5 long-context row). Each device then renders its
output block sampling only within its extended local block.

Correctness contract: the filter's source displacement must be bounded by
`halo` rows (and cols, when column-sharded). Three enforcement layers:
  - halo="auto" infers the displacement bound from the filter AST
    (parallel/bounds.py affine-interval analysis) and sizes the halo;
  - check=True (default) additionally records, per gather, how far past
    the halo any sample reached and raises MMRuntimeError on violation
    instead of silently clamping;
  - out-of-halo displacements clamp into the block when check=False.
"""

from __future__ import annotations

import math

import numpy as np

from ..runtime.render import float_inputs, render_frame
from ..runtime.tracer import RenderContext
from ..runtime.value import TiledInput
from ..utils.errors import MMRuntimeError
from .bounds import infer_displacement_bound
from .mesh import COL_AXIS, ROW_AXIS, axis_size


def exchange_halo(inp_local, halo: int, axis_name: str = ROW_AXIS, axis: int = 0):
    """Extend a local block with `halo` rows (axis=0) or cols (axis=1) from
    ring neighbors. Returns the block extended by 2*halo along `axis`; at
    the global edges the halo wraps around the ring (correct for edge
    'wrap'; other edge modes never index there)."""
    import jax
    import jax.numpy as jnp

    if halo == 0:
        # slice(-0, None) would select the WHOLE block and prepend the
        # entire neighbor (review r3: silently corrupt output that even
        # check=True missed) — zero halo means no exchange at all
        return inp_local
    if halo < 0:
        raise MMRuntimeError(f"halo must be >= 0, got {halo}")
    n = jax.lax.axis_size(axis_name)
    down = [(i, (i + 1) % n) for i in range(n)]  # send to next (below/right)
    up = [(i, (i - 1) % n) for i in range(n)]  # send to prev (above/left)
    take_lo = [slice(None)] * inp_local.ndim
    take_lo[axis] = slice(None, halo)
    take_hi = [slice(None)] * inp_local.ndim
    take_hi[axis] = slice(-halo, None)
    # my trailing rows become the NEXT device's leading halo
    from_before = jax.lax.ppermute(inp_local[tuple(take_hi)], axis_name, down)
    # my leading rows become the PREVIOUS device's trailing halo
    from_after = jax.lax.ppermute(inp_local[tuple(take_lo)], axis_name, up)
    return jnp.concatenate([from_before, inp_local, from_after], axis=axis)


def auto_halo(program_filters, fdef, width: int, height: int,
              opts, uservals=None, ny: int = 2, nx: int = 2):
    """(halo_rows, halo_cols) from the static displacement bound, or raises
    MMRuntimeError when the filter's displacement is unbounded/unknown.
    ny/nx: mesh extent per axis — an UNSHARDED axis (extent 1) never
    exchanges halos, so its displacement bound is irrelevant (review r3:
    a horizontal flip on a rows-only mesh was wrongly rejected)."""
    bound = infer_displacement_bound(program_filters, fdef, width, height,
                                     uservals)
    if bound is not None:
        dy0 = bound[0] if ny > 1 else 0.0
        dx0 = bound[1] if nx > 1 else 0.0
        bound = (dy0, dx0)
    if bound is None or bound[0] >= height or bound[1] >= width:
        raise MMRuntimeError(
            f"cannot infer a usable displacement bound for filter "
            f"{fdef.name!r} ({'unbounded' if bound is None else f'bound {bound}'}"
            f" at {width}x{height}): pass an explicit halo= (or render "
            f"unsharded)")
    dy, dx = bound
    # interpolation taps extend up to 2 texels past the displaced floor
    # (bicubic); +1 covers the pixel-center half-texel
    margin = {"nearest": 1, "bilinear": 2, "bicubic": 3}[opts.interpolation]
    return int(math.ceil(dy)) + margin, int(math.ceil(dx)) + margin


def render_frame_tiled(mesh, program_filters, fdef, width, height, opts,
                       input_array, halo, uservals=None, t=0.0, frame=0.0,
                       check: bool = True, region=None):
    """One frame with the input(s) sharded P(y[, x]) and halo exchange.

    input_array: (H, W, 4) with H == output height (the common identity-
    geometry case), or a list/tuple of such arrays for multi-input
    filters — each input is sharded, halo-exchanged, and edge-painted
    identically (the displacement bound covers every origVal/origValImage
    sample, so one halo serves all). halo: int (rows; cols derived when
    column-sharded) or (rows, cols). Returns ((H, W, 4) sharded, max halo
    excess scalar — <= 0 when the bounded-displacement contract held).

    region=(x, y, w, h): GIMP-selection semantics on a sharded drawable
    (reference `mathmap.c` renders into the drawable's selection
    [unverified — mount empty]): only the selection is evaluated (world
    coordinates stay full-canvas), and — unlike the single-chip region
    render, which returns the (h, w) crop — the result is the FULL
    canvas with the selection replaced and every other pixel passed
    through from input 0 unchanged (the in-place drawable semantics this
    path models: applying a filter to a selection of a drawable too
    large to replicate). Each device evaluates a uniform
    (min(h,tile_h), min(w,tile_w)) window dynamically clamped inside its
    own tile so it covers the tile∩region overlap; the window is
    composited into the identity background and re-masked to the exact
    region bounds. Devices that don't intersect the region still
    evaluate one window's worth of in-tile positions (SPMD uniformity —
    bounded by the region size per device) and discard it."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    ny = axis_size(mesh, ROW_AXIS)
    nx = axis_size(mesh, COL_AXIS)
    if height % ny:
        raise MMRuntimeError(f"height ({height}) must be divisible by mesh rows ({ny})")
    if width % nx:
        raise MMRuntimeError(f"width ({width}) must be divisible by mesh cols ({nx})")
    tile_h = height // ny
    tile_w = width // nx
    halo_y, halo_x = halo if isinstance(halo, tuple) else (halo, halo)
    if halo_y < 0 or halo_x < 0:
        raise MMRuntimeError(f"halo must be >= 0, got {halo!r}")
    if halo_y > tile_h:
        raise MMRuntimeError(f"halo ({halo_y}) larger than tile height ({tile_h})")
    if nx > 1 and halo_x > tile_w:
        raise MMRuntimeError(f"halo ({halo_x}) larger than tile width ({tile_w})")
    uservals = uservals or {}

    arrays = (tuple(input_array)
              if isinstance(input_array, (list, tuple)) else (input_array,))
    if region is not None and not arrays:
        raise MMRuntimeError(
            "region on the tiled path needs at least one input: input 0 "
            "is the drawable whose unselected pixels pass through")

    if region is not None:
        rx, ry, rw, rh = (int(v) for v in region)
        re_h = min(rh, tile_h)
        re_w = min(rw, tile_w)

    def tile_render(*inp_locals):
        row_off = jax.lax.axis_index(ROW_AXIS) * tile_h
        if nx > 1:
            col_off = jax.lax.axis_index(COL_AXIS) * tile_w
        else:
            col_off = 0
        excess = [jnp.float32(-(2 ** 30))]
        ctx_cell = []

        def hook(e):
            # Samples inside while-loop bodies are NOT checked: the traced
            # excess would leak out of lax.while_loop (it cannot join the
            # loop carry — it isn't a language-level variable). Top-level
            # samples — the overwhelmingly common case — are covered.
            if ctx_cell and ctx_cell[0].loop_depth == 0:
                excess[0] = jnp.maximum(excess[0], e.astype(jnp.float32))

        imgs = []
        bg_raw = bg_flt = None  # input 0's local block (region background)
        for k, inp_local in enumerate(inp_locals):
            if k == 0 and region is not None:
                bg_raw = inp_local
            # u8 blocks ship 4x fewer bytes host->device; float_inputs is
            # the single source of the in-trace /255 normalization rule
            (inp_local,) = float_inputs(jnp, [inp_local])
            if k == 0 and region is not None:
                bg_flt = inp_local
            # animated (T, tile_h, W, 4) blocks exchange their frame
            # row/col axes (every frame shares the device's row range).
            # At the global edges the halo holds ring-wrapped rows; the
            # gather edge-maps every tap GLOBALLY before localizing, so
            # in-contract samples never read them under color/reflect.
            ax0 = inp_local.ndim - 3
            ext = exchange_halo(inp_local, halo_y, ROW_AXIS, axis=ax0)
            if nx > 1:
                ext = exchange_halo(ext, halo_x, COL_AXIS, axis=ax0 + 1)
            imgs.append(TiledInput(
                pixels=ext, name=f"in{k}",
                global_height=height, global_width=width if nx > 1 else 0,
                row_base=row_off - halo_y,
                col_base=(col_off - halo_x) if nx > 1 else 0,
                violation_hook=hook if check else None,
            ))
        if region is None:
            ey, ex = row_off, col_off
            gs = (tile_h, tile_w)
        else:
            # evaluation window: uniform (re_h, re_w) shape, dynamically
            # positioned INSIDE this device's tile (local offset >= 0, so
            # the composite below is a plain dynamic_update_slice) while
            # covering the tile∩region overlap; world coordinates stay
            # global, so evaluating in-tile positions outside the region
            # is semantically harmless (re-masked away below) and keeps
            # every sample within this device's halo contract
            ey = jnp.clip(jnp.int32(ry), row_off, row_off + tile_h - re_h)
            ex = jnp.clip(jnp.int32(rx), col_off, col_off + tile_w - re_w)
            gs = (re_h, re_w)
        ctx = RenderContext(
            be=jnp, width=width, height=height, opts=opts,
            inputs=imgs, filters=program_filters, t=t, frame=frame,
            is_jax=True, grid_shape=gs,
            row_offset=ey, col_offset=ex,
        )
        ctx_cell.append(ctx)
        out = render_frame(ctx, fdef, uservals)
        if region is not None:
            # identity background = input 0's current frame, in the
            # OUTPUT dtype (raw u8 block when both sides are u8 — the
            # pass-through is then bitwise; else pack the float block)
            from ..runtime.render import pack_uint8

            def cur_frame(a):
                if a.ndim != 4:
                    return a
                fi = jnp.clip(jnp.floor(
                    jnp.asarray(frame, jnp.float32) + 0.5).astype(jnp.int32),
                    0, a.shape[0] - 1)
                return a[fi]

            if getattr(opts, "output_dtype", "float32") == "uint8":
                bg = (cur_frame(bg_raw) if bg_raw.dtype == jnp.uint8
                      else pack_uint8(jnp, cur_frame(bg_flt)))
            else:
                bg = cur_frame(bg_flt)
            canvas = jax.lax.dynamic_update_slice(
                bg, out.astype(bg.dtype), (ey - row_off, ex - col_off,
                                           jnp.int32(0)))
            gr = row_off + jax.lax.broadcasted_iota(
                jnp.int32, (tile_h, tile_w, 1), 0)
            gc = col_off + jax.lax.broadcasted_iota(
                jnp.int32, (tile_h, tile_w, 1), 1)
            in_reg = ((gr >= ry) & (gr < ry + rh)
                      & (gc >= rx) & (gc < rx + rw))
            out = jnp.where(in_reg, canvas, bg)
        worst = jax.lax.pmax(jax.lax.pmax(excess[0], ROW_AXIS), COL_AXIS)
        return out, worst

    shard = jax.shard_map(
        tile_render, mesh=mesh,
        in_specs=tuple(
            P(None, ROW_AXIS, COL_AXIS, None) if a.ndim == 4
            else P(ROW_AXIS, COL_AXIS, None) for a in arrays),
        out_specs=(P(ROW_AXIS, COL_AXIS, None), P()),
        check_vma=False,
    )
    return shard(*arrays)


class TiledRenderer:
    """jit wrapper for the halo-exchange path.

    halo: int, (rows, cols), or "auto" (static displacement inference).
    check=True raises MMRuntimeError when any sample reached beyond the
    halo (the silent-clamp hazard, VERDICT r1 item 10)."""

    def __init__(self, mesh, program_filters, fdef, width, height, opts,
                 halo, uservals=None, check: bool = True):
        import jax
        import jax.numpy as jnp

        from ..runtime.render import _rebuild_uservals, _userval_pytree
        from ..runtime.tracer import RenderContext as _Ctx

        from ..runtime.render import resolve_region

        self.jnp = jnp
        self.check = check
        # region (GIMP selection) composes with input sharding: the
        # output is the FULL sharded canvas with the selection replaced
        # and everything else passed through from input 0 (the in-place
        # drawable semantics — see render_frame_tiled). Validated here,
        # statically, against the canvas.
        region = resolve_region(opts, width, height)
        if opts.supersample > 1 and opts.supersample_scheme == "corners":
            # the corner grid extends each device's tile by one row/col of
            # EVALUATION positions whose samples would need their own halo
            # accounting; not wired into the input-sharded path — use the
            # default s×s grid scheme here (render()/render_sharded support
            # corners)
            raise ValueError(
                "supersample_scheme='corners' is not supported by the "
                "tiled (input-sharded) renderer; use 'grid'")
        if halo == "auto":
            halo = auto_halo(program_filters, fdef, width, height, opts,
                             uservals, ny=axis_size(mesh, ROW_AXIS),
                             nx=axis_size(mesh, COL_AXIS))
        self.halo = halo
        # raw param VALUES -> TupleValues, resolved at construction like
        # ShardedRenderer (changing params rebuilds the renderer); also
        # validates unknown names eagerly
        _ctx = _Ctx(be=jnp, width=width, height=height, opts=opts,
                    filters=program_filters, is_jax=True)
        uv_arrays, uv_kinds = _userval_pytree(_ctx, fdef, uservals or {})

        def run(inp, t, frame):
            return render_frame_tiled(
                mesh, program_filters, fdef, width, height, opts, inp,
                halo, uservals=_rebuild_uservals(jnp, uv_arrays, uv_kinds),
                t=t, frame=frame, check=check, region=region,
            )

        self._jitted = jax.jit(run)

    def __call__(self, input_array, t=0.0, frame=0.0):
        import numpy as _np

        jnp = self.jnp

        def conv(a):
            # jnp.asarray is a no-op for device-resident arrays (no host
            # round-trip) and uploads host arrays once per call. uint8
            # stays u8 (4x smaller upload; normalized in-trace per block)
            if getattr(a, "dtype", None) == _np.uint8:
                return jnp.asarray(a)
            return jnp.asarray(a, dtype=jnp.float32)

        if isinstance(input_array, (list, tuple)):
            inp = tuple(conv(a) for a in input_array)
        else:
            inp = conv(input_array)
        out, excess = self._jitted(inp, jnp.float32(t), jnp.float32(frame))
        if self.check and float(excess) > 0:
            raise MMRuntimeError(
                f"tiled render violated the bounded-displacement contract: "
                f"a sample reached {float(excess):.0f} texel(s) beyond the "
                f"halo {self.halo}; increase halo= or render unsharded")
        return out
