"""Public Python API: compile MathMap source -> Filter; render on the GPU.

The front-end replacement for the reference's GIMP plugin/CLI entry points
(SURVEY.md §1 layer 10 [unverified — mount empty, SURVEY.md §0]): the same
`.mm` sources compile to a `Filter` whose `render()` executes one fused
jitted program per frame.
"""

from __future__ import annotations

import numpy as np

from .imgio.images import to_float_rgba
from .lang import astnodes as A
from .lang.parser import parse
from .runtime.options import RenderOptions
from .runtime.render import JitRenderer, render_oracle
from .utils.errors import MMError, MMNameError


def _is_device_array(a) -> bool:
    """True for a jax device array (without importing jax when the caller
    never passed one)."""
    if isinstance(a, np.ndarray):
        return False
    mod = type(a).__module__ or ""
    if not (mod.startswith("jax") or mod.startswith("jaxlib")):
        return False
    import jax

    return isinstance(a, jax.Array)


def _passthrough_rgba(a, ndim: int) -> bool:
    """(…, H, W, 4) float32/uint8 arrays skip host conversion: float32 is
    already the render dtype; uint8 converts IN-TRACE on device (÷255,
    bit-identical to to_float_rgba) so the upload ships 4× fewer bytes."""
    return (getattr(a, "ndim", None) == ndim and a.shape[-1] == 4
            and a.dtype in (np.float32, np.uint8))


class Shared:
    """Marker wrapping ONE input every job of a render_batch samples
    (see `shared`)."""

    __slots__ = ("value",)

    def __init__(self, value):
        self.value = value


def shared(value):
    """Mark a render_batch input as SHARED across the batch: one
    (H, W, C) image — or (T, H, W, 4) animated stack — with NO job axis,
    that every job samples. This is the param-animation workload (N
    param/t values over one image); without the marker the caller must
    broadcast the image into an (N, H, W, 4) stack and upload N copies."""
    return Shared(value)


class Filter:
    """A compiled MathMap filter (plus the filter environment of its file)."""

    def __init__(self, program: A.Program, fdef: A.FilterDef, source: str):
        self.program = program
        self.fdef = fdef
        self.source = source
        self.filters = {f.name: f for f in program.filters}
        self._jit_cache: dict = {}

    # -- metadata -----------------------------------------------------------
    @property
    def name(self) -> str:
        return self.fdef.name

    @property
    def params(self):
        return self.fdef.params

    @property
    def image_params(self):
        return [p for p in self.fdef.params if p.kind == "image"]

    # -- rendering ------------------------------------------------------------
    def _resolve_size(self, inputs, width, height):
        # shape[-2]/[-3] so animated (T, H, W, 4) inputs resolve too
        if width is None:
            width = inputs[0].shape[-2] if inputs else 512
        if height is None:
            height = inputs[0].shape[-3] if inputs else 512
        return int(width), int(height)

    @staticmethod
    def _conv_input(a):
        """(H,W,C)-convertible -> (H,W,4); a 4-D array is an ANIMATED
        input -> (T,H,W,4) (render_batch instead treats 4-D as a batch of
        independent frames — the two entries differ on purpose). float32
        and uint8 RGBA pass through unconverted (u8 normalizes in-trace,
        4× smaller upload); device-resident arrays pass through untouched
        (np.asarray would pull them back to host)."""
        if _is_device_array(a) and (_passthrough_rgba(a, 3)
                                    or _passthrough_rgba(a, 4)):
            return a
        arr = np.asarray(a)
        if arr.ndim == 4:
            if _passthrough_rgba(arr, 4):
                return arr
            return np.stack([to_float_rgba(f) for f in arr])
        if _passthrough_rgba(arr, 3) and arr.dtype == np.uint8:
            return arr
        return to_float_rgba(arr)

    def _renderer(self, width, height, options, num_frames) -> JitRenderer:
        key = (width, height, options, num_frames)
        if key not in self._jit_cache:
            self._jit_cache[key] = JitRenderer(
                self.filters, self.fdef, width, height, options, num_frames
            )
        return self._jit_cache[key]

    def render(self, *inputs, width: int | None = None, height: int | None = None,
               t: float = 0.0, frame: float = 0.0, options: RenderOptions | None = None,
               params: dict | None = None, interpret: bool = False,
               precision: str = "f32", on_error: str = "raise"):
        """Render one frame -> float32 (H, W, 4) RGBA in [0,1].

        inputs: zero or more (H,W,4)-convertible arrays bound to the filter's
        image parameters in order. `interpret=True` uses the NumPy oracle.
        on_error='interpret' falls back to the oracle when the jit path
        fails to compile/execute — the reference's gcc-failure->interpreter
        behavior (SURVEY §5 failure row); default 'raise' surfaces the bug.
        """
        options = options or RenderOptions()
        params = params or {}
        ins = [self._conv_input(a) for a in inputs]
        width, height = self._resolve_size(ins, width, height)
        if interpret:
            return render_oracle(
                self.filters, self.fdef, ins, params, width, height, options,
                t=t, frame=frame, precision=precision,
            )
        try:
            renderer = self._renderer(width, height, options, 1)
            return np.asarray(renderer(ins, params, t=t, frame=frame))
        except MMError:
            raise
        except Exception:
            if on_error != "interpret":
                raise
            import logging

            logging.getLogger("mathmap_tpu").warning(
                "jit render failed; falling back to the NumPy interpreter",
                exc_info=True,
            )
            return render_oracle(
                self.filters, self.fdef, ins, params, width, height, options,
                t=t, frame=frame, precision=precision,
            )

    def render_animation(self, *inputs, num_frames: int, width: int | None = None,
                         height: int | None = None, options: RenderOptions | None = None,
                         params: dict | None = None):
        """Whole t-sweep in ONE device program (lax.map over frames) ->
        (F, H, W, 4). Fastest path for animation batches; for frame-by-frame
        streaming use render_frames()."""
        options = options or RenderOptions()
        params = params or {}
        ins = [self._conv_input(a) for a in inputs]
        width, height = self._resolve_size(ins, width, height)
        denom = num_frames if options.periodic else max(num_frames - 1, 1)
        ts = np.arange(num_frames, dtype=np.float32) / denom
        # chunk the sweep so the on-device frame stack stays within a few GB
        # of HBM (a 120-frame 4K sweep would otherwise be 16 GB)
        frame_bytes = height * width * 4 * 4
        chunk = max(1, min(num_frames, int(4e9 // max(frame_bytes, 1))))
        out = []
        for start in range(0, num_frames, chunk):
            ts_c = ts[start : start + chunk]
            renderer = self._renderer(width, height, options, len(ts_c))
            out.append(np.asarray(
                renderer.render_all_frames(ins, params, ts_c, frame0=float(start))
            ))
        return out[0] if len(out) == 1 else np.concatenate(out, axis=0)

    def render_batch(self, *batched_inputs, ts=None, frames=None,
                     width: int | None = None,
                     height: int | None = None,
                     options: RenderOptions | None = None,
                     params: dict | None = None):
        """Render N independent frames in ONE device program -> (N, H, W, 4).

        Each batched input is an (N, H, W, 4) stack (or a list of (H, W, 4)
        frames); job i renders the i-th slice of every input at t=ts[i]
        (default 0.0). `params` may be one dict shared by every job, or a
        list of N dicts with per-job VALUES for the same param names (the
        serving layer batches same-filter requests this way). `frames`
        optionally sets each job's `frame` internal (default: job index,
        the t-sweep reading; the serving layer passes zeros so a batched
        render equals its lone-render twin). All jobs
        share the render options. This
        is the batched small-render entry: one fenced dispatch covers the
        whole batch, so the per-call dispatch cost amortizes across N
        frames — the analog of the reference's in-process render loop,
        where issuing a 512² frame costs nothing but the pixels
        (mathmap_cmdline.c option loop [unverified — mount empty]).

        Wrap an input in `mathmap_tpu.shared(img)` to pass ONE image (or
        one (T, H, W, 4) animated stack) every job samples — the
        param-animation workload; the output is bitwise identical to the
        broadcast-stacked form."""
        options = options or RenderOptions()
        params = params or {}
        def conv(batch):
            if isinstance(batch, (list, tuple)):
                return np.stack([to_float_rgba(np.asarray(f)) for f in batch])
            if _is_device_array(batch) and _passthrough_rgba(batch, 4):
                # device-resident stack: hand it straight to the renderer —
                # an np.asarray here would round-trip the whole batch
                # host<->device on every dispatch
                return batch
            arr = np.asarray(batch)
            if arr.ndim == 4 and arr.shape[-1] == 4 \
                    and arr.dtype in (np.float32, np.uint8):
                return arr  # float/u8 RGBA stack — no copy (u8: 4× smaller
                #             upload, normalized in-trace)
            if arr.ndim == 3 and arr.shape[-1] in (1, 3, 4):
                # a lone (H, W, C) frame would otherwise be iterated over
                # its ROWS and silently render H garbage jobs
                raise ValueError(
                    "render_batch inputs need a leading batch axis; wrap a "
                    "single frame in a list (or use render())")
            return np.stack([to_float_rgba(f) for f in arr])

        mask = tuple(isinstance(b, Shared) for b in batched_inputs)
        # shared entries convert with render()'s single-input rules (a
        # 4-D shared array is an ANIMATED stack, not a job batch)
        ins = [self._conv_input(b.value) if m else conv(b)
               for b, m in zip(batched_inputs, mask)]
        per_job = [a for a, m in zip(ins, mask) if not m]
        if per_job:
            n = per_job[0].shape[0]
        elif ts is not None:
            n = len(ts)
        elif isinstance(params, (list, tuple)):
            n = len(params)
        else:
            n = 1
        for a in per_job:
            if a.ndim != 4 or a.shape[0] != n:
                raise ValueError(
                    "render_batch inputs must share a leading batch axis")
        if ts is not None and len(ts) != n:
            raise ValueError(
                f"render_batch: {len(ts)} ts for a batch of {n} jobs")
        # _resolve_size reads shape[-2]/[-3], so the (N, H, W, 4) stacks
        # resolve directly — no a[0] slice (which would enqueue a device op
        # per input on device-resident stacks)
        width, height = self._resolve_size(ins, width, height)
        if ts is None:
            ts = np.zeros(n, dtype=np.float32)
        renderer = self._renderer(width, height, options, 1)
        if frames is not None and len(frames) != n:
            raise ValueError(
                f"render_batch: {len(frames)} frames for a batch of {n} jobs")
        return np.asarray(renderer.render_batch(ins, params, ts, frames,
                                                shared_mask=mask))

    def render_sharded(self, *inputs, mesh=None, num_frames: int = 1,
                       width: int | None = None, height: int | None = None,
                       options: RenderOptions | None = None, ts=None,
                       t: float = 0.0, frame: float = 0.0,
                       params: dict | None = None):
        """Render across a device mesh: frames shard over 'f' (DP), grid
        rows/cols over 'y'/'x' (parallel/shard.py — the multi-device analog of
        the reference's slice threads). `mesh=None` builds a rows-only mesh
        over all devices. 4-D inputs are ANIMATED (T,H,W,4) drawables
        (replicated per device, frame-indexed by origValXY — same semantics
        as render()). Returns (H,W,4) or (F,H,W,4)."""
        from .parallel.mesh import make_mesh
        from .parallel.shard import ShardedRenderer

        options = options or RenderOptions()
        ins = [self._conv_input(a) for a in inputs]
        # u8 inputs pass through AS u8: they replicate at 4x fewer bytes
        # and normalize /255 in-trace inside each tile (parallel/shard.py
        # tile code — same rules as the single-chip render.run())
        width, height = self._resolve_size(ins, width, height)
        if mesh is None:
            mesh = make_mesh()
        def _hashable(v):
            return tuple(v) if isinstance(v, (list, tuple)) else v

        key = ("sharded", width, height, options, num_frames, id(mesh),
               tuple(sorted((k, _hashable(v))
                            for k, v in (params or {}).items())))
        if key not in self._jit_cache:
            self._jit_cache[key] = ShardedRenderer(
                mesh, self.filters, self.fdef, width, height, options,
                num_frames, params=params,
            )
        renderer = self._jit_cache[key]
        if num_frames == 1:
            return np.asarray(renderer(ins, t=t, frame=frame))
        if ts is None:
            denom = num_frames if options.periodic else max(num_frames - 1, 1)
            ts = np.arange(num_frames, dtype=np.float32) / denom
        return np.asarray(renderer(ins, ts=ts))

    def render_tiled(self, *input_images, halo: int | tuple | str = "auto",
                     mesh=None, width: int | None = None,
                     height: int | None = None,
                     options: RenderOptions | None = None, t: float = 0.0,
                     frame: float = 0.0,
                     params: dict | None = None, check: bool = True):
        """Render with the INPUT(s) row- (and, on a 2-D mesh, column-)
        sharded across the mesh and halo rows/cols exchanged between devices
        (parallel/halo.py) — for canvases whose inputs exceed per-device HBM
        when replicated. Multi-input filters pass one array per image
        parameter (every input sharded + halo-exchanged identically; all
        must share the output geometry). Animated (T, H, W, 4) inputs shard
        every frame identically (`frame` selects the current frame, same
        semantics as render()). The filter's source displacement
        must be bounded by `halo`; halo="auto" infers the bound from the
        filter AST (parallel/bounds.py) and check=True turns a violated
        bound into an MMRuntimeError instead of a silent clamp."""
        from .parallel.halo import TiledRenderer
        from .parallel.mesh import make_mesh

        options = options or RenderOptions()
        # no np.asarray here: device-resident inputs pass through untouched
        # (pulling a huge sharded-candidate stack back to host per call is
        # exactly what this path exists to avoid). uint8 inputs stay u8 all
        # the way to the device tiles — 4x less host->device traffic on
        # the very path built for inputs too large to replicate — and
        # normalize /255 in-trace per block (render_frame_tiled) — the
        # same rule as render(); downstream fusion may differ by 1 ulp
        # from a host-side pre-conversion.
        imgs = [self._conv_input(a) for a in input_images]
        width, height = self._resolve_size(imgs, width, height)
        for a in imgs:
            if a.shape[-3:-1] != (height, width):
                raise ValueError(
                    f"tiled inputs must share the output geometry "
                    f"{height}x{width}; got {a.shape[-3]}x{a.shape[-2]}")
        if mesh is None:
            mesh = make_mesh()
        def _hashable(v):
            return tuple(v) if isinstance(v, (list, tuple)) else v

        key = ("tiled", width, height, options, halo, id(mesh), check,
               len(imgs), tuple(sorted((k, _hashable(v))
                                       for k, v in (params or {}).items())))
        if key not in self._jit_cache:
            self._jit_cache[key] = TiledRenderer(
                mesh, self.filters, self.fdef, width, height, options, halo,
                uservals=params, check=check,
            )
        inp = imgs[0] if len(imgs) == 1 else imgs
        return np.asarray(self._jit_cache[key](inp, t=t, frame=frame))

    def render_frames(self, *inputs, num_frames: int, width: int | None = None,
                      height: int | None = None, options: RenderOptions | None = None,
                      params: dict | None = None):
        """Animation: t-sweep over `num_frames` (SURVEY §2.1 render row —
        periodic: t=frame/N; else t=frame/(N-1)). Yields (H,W,4) frames.
        Compiles once; each frame reuses the executable."""
        options = options or RenderOptions()
        params = params or {}
        ins = [self._conv_input(a) for a in inputs]
        width, height = self._resolve_size(ins, width, height)
        # the per-frame program is identical for every sweep length (the
        # trace reads nothing from num_frames) — share ONE compiled
        # renderer across render() and all render_frames sweeps
        renderer = self._renderer(width, height, options, 1)
        # upload inputs once; every frame reuses the device-resident copies
        import jax

        ins = [jax.device_put(a) for a in ins]
        denom = num_frames if options.periodic else max(num_frames - 1, 1)
        for frame in range(num_frames):
            t = frame / denom
            yield np.asarray(renderer(ins, params, t=t, frame=float(frame)))


def compile_source(source: str, main: str | None = None) -> Filter:
    """Compile MathMap source. `main` selects a filter by name; default is
    the last filter in the file (the reference composer convention
    [unverified])."""
    try:
        program = parse(source)
    except MMError as exc:
        if exc.source is None:
            exc.source = source
        raise
    if not program.filters:
        raise MMNameError("source contains no filters")
    if main is None:
        fdef = program.filters[-1]
    else:
        by_name = {f.name: f for f in program.filters}
        if main not in by_name:
            raise MMNameError(f"no filter named {main!r} in source")
        fdef = by_name[main]
    return Filter(program, fdef, source)


def compile_file(path: str, main: str | None = None) -> Filter:
    with open(path) as f:
        return compile_source(f.read(), main=main)
