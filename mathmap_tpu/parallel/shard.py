"""Sharded rendering over a device mesh with shard_map.

Design (SURVEY.md §2.2 / §7): pointwise+generative filters are fully
sharded-parallel — each device builds its OWN tile's coordinate grids from
its mesh position and evaluates the same fused program; zero collectives.
Sampling filters replicate the (small vs HBM) input images per device, so
arbitrary-displacement origVal gathers stay local; the halo-exchange tiled
path for HBM-exceeding canvases lives in parallel/halo.py. Animation frames
shard over the "f" axis (pure DP). Output is materialized sharded
(P(f, y, x)) and only assembled on host transfer.
"""

from __future__ import annotations

import numpy as np

from ..runtime.render import float_inputs, render_frame
from ..runtime.tracer import RenderContext
from ..runtime.value import InputImage
from ..utils.errors import MMRuntimeError
from .mesh import COL_AXIS, FRAME_AXIS, ROW_AXIS, axis_size


def _check_divisible(total: int, parts: int, what: str):
    if total % parts:
        raise MMRuntimeError(f"{what} ({total}) must be divisible by its mesh axis ({parts})")


def render_frame_sharded(mesh, program_filters, fdef, width, height, opts,
                         input_arrays, uservals, t=0.0, frame=0.0, num_frames=1):
    """One frame, grid sharded over mesh axes (y, x). Returns the traced
    (H, W, 4) output with sharding P(y, x, None) — call under jit."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    ny, nx = axis_size(mesh, ROW_AXIS), axis_size(mesh, COL_AXIS)
    _check_divisible(height, ny, "height")
    _check_divisible(width, nx, "width")
    tile_h, tile_w = height // ny, width // nx

    def tile_render(*ins):
        row_off = jax.lax.axis_index(ROW_AXIS) * tile_h
        col_off = jax.lax.axis_index(COL_AXIS) * tile_w
        # u8 inputs replicate as u8 (4x fewer bytes) and normalize /255
        # in-trace, like the unsharded renderer (render.run())
        fins = float_inputs(jnp, list(ins))
        ctx = RenderContext(
            be=jnp, width=width, height=height, opts=opts,
            inputs=[InputImage(pixels=fa, name=f"in{i}")
                    for i, fa in enumerate(fins)],
            filters=program_filters, t=t, frame=frame,
            num_frames=num_frames, is_jax=True,
            grid_shape=(tile_h, tile_w),
            row_offset=row_off, col_offset=col_off,
        )
        return render_frame(ctx, fdef, uservals)

    shard = jax.shard_map(
        tile_render,
        mesh=mesh,
        in_specs=tuple(P() for _ in input_arrays),  # inputs replicated
        out_specs=P(ROW_AXIS, COL_AXIS, None),
        check_vma=False,
    )
    return shard(*input_arrays)


class ShardedRenderer:
    """jit-compiled mesh-sharded renderer (single frame or frame batch).

    The multi-chip analog of the reference's slice-thread pool: frames shard
    over "f" (DP), rows over "y", columns over "x". Inputs are replicated
    (images are small vs HBM — SURVEY §7); generative filters need zero
    collectives end to end.
    """

    def __init__(self, mesh, program_filters, fdef, width, height, opts,
                 num_frames=1, params=None):
        import jax
        import jax.numpy as jnp
        from jax.sharding import PartitionSpec as P

        from ..runtime.render import _userval_pytree
        from ..runtime.tracer import RenderContext as _Ctx

        self.mesh = mesh
        self.jnp = jnp
        if getattr(opts, "region", None) is not None:
            # a region render IS a tile of the canvas — composing it with
            # mesh tiling would need region-aware shard geometry; render
            # the region single-chip (JitRenderer) instead
            raise ValueError(
                "options.region is not supported by render_sharded; "
                "use render() for the region crop, or render_tiled() for "
                "the sharded-drawable selection semantics (the region "
                "rendered in place on the full canvas)")
        nf = axis_size(mesh, FRAME_AXIS)

        # uservals resolved at construction (sharded renders are batch jobs;
        # changing params rebuilds the renderer)
        _ctx = _Ctx(be=jnp, width=width, height=height, opts=opts,
                    filters=program_filters, is_jax=True)
        uv_arrays, uv_kinds = _userval_pytree(_ctx, fdef, params or {})
        from ..runtime.render import _rebuild_uservals

        def make_uservals():
            return _rebuild_uservals(jnp, uv_arrays, uv_kinds)

        if num_frames == 1:
            def run(input_arrays, t, frame):
                return render_frame_sharded(
                    mesh, program_filters, fdef, width, height, opts,
                    input_arrays, make_uservals(), t=t, frame=frame,
                )
            self._jitted = jax.jit(run)
        else:
            _check_divisible(num_frames, nf, "num_frames")
            frames_per_dev = num_frames // nf

            def run(input_arrays, ts):
                ny, nx = axis_size(mesh, ROW_AXIS), axis_size(mesh, COL_AXIS)
                _check_divisible(height, ny, "height")
                _check_divisible(width, nx, "width")
                tile_h, tile_w = height // ny, width // nx

                def frames_on_device(ts_local, *ins):
                    row_off = jax.lax.axis_index(ROW_AXIS) * tile_h
                    col_off = jax.lax.axis_index(COL_AXIS) * tile_w
                    f0 = jax.lax.axis_index(FRAME_AXIS) * frames_per_dev
                    # /255 of the full replicated inputs HOISTED out of the
                    # frame loop: inside `one` it sat in the lax.map body,
                    # and XLA's loop-invariant motion declines to hoist
                    # size-inflating ops — every frame repaid a full-image
                    # u8->f32 convert (review r4 finding)
                    fins = float_inputs(jnp, list(ins))

                    def one(i, t):
                        ctx = RenderContext(
                            be=jnp, width=width, height=height, opts=opts,
                            inputs=[InputImage(pixels=fa, name=f"in{k}")
                                    for k, fa in enumerate(fins)],
                            filters=program_filters, t=t,
                            frame=(f0 + i).astype(jnp.float32),
                            num_frames=num_frames, is_jax=True,
                            grid_shape=(tile_h, tile_w),
                            row_offset=row_off, col_offset=col_off,
                        )
                        return render_frame(ctx, fdef, make_uservals())

                    idx = jnp.arange(frames_per_dev)
                    return jax.lax.map(lambda args: one(*args), (idx, ts_local))

                shard = jax.shard_map(
                    frames_on_device,
                    mesh=mesh,
                    in_specs=(P(FRAME_AXIS),) + tuple(P() for _ in input_arrays),
                    out_specs=P(FRAME_AXIS, ROW_AXIS, COL_AXIS, None),
                    check_vma=False,
                )
                return shard(ts, *input_arrays)

            self._jitted = jax.jit(run)
        self.num_frames = num_frames

    def __call__(self, input_arrays, t=0.0, ts=None, frame=0.0):
        jnp = self.jnp
        from ..runtime.render import stage_inputs

        # uint8 preserved: 4x smaller replication, /255 in-trace in the
        # tile code — the ONE staging rule
        ins = stage_inputs(jnp, input_arrays)
        if self.num_frames == 1:
            return self._jitted(ins, jnp.float32(t), jnp.float32(frame))
        return self._jitted(ins, jnp.asarray(ts, dtype=jnp.float32))
