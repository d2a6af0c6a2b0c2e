"""AOT deployment artifacts: serialize a compiled filter, load without
the compiler.

`export_artifact` lowers one (filter, geometry, options, param-NAMES)
configuration through `jax.export` and writes a single portable file
(.mmxa): a JSON manifest (geometry, param spec, input count) plus the
exported StableHLO module(s) with their calling convention. `load_artifact` reconstructs a callable
from it using ONLY jax + numpy — no parser, tracer, op registry, or
filter sources at load time. Param VALUES (sliders, colors, curve and
gradient LUTs) remain runtime inputs of the exported module, exactly as
in the live renderer: the artifact serves any value without recompiling.

This is the deployment analog of the reference shipping a compiled
filter .so (cgen.c + dlopen [unverified — reference mount empty,
SURVEY.md §0]): compile on a box with the full toolchain, serve where
only the runtime exists. The StableHLO text export
(generators/standalone.py) remains the human-readable variant; this one
is executable.

Portability: an artifact runs on the platform(s) it was lowered for
(`Exported.platforms`), and — since the program record is pickled with
jax's own types (see `_serialize`) — under the jax version that wrote
it. Export on the GPU for GPU serving; CPU artifacts are handy for tests
and edge fallbacks. Load only artifacts you trust: the loader refuses
classes outside jax and numpy, but a program runs what it holds.
"""

from __future__ import annotations

import dataclasses
import io
import json
import pickle
import struct

import numpy as np

_MAGIC = b"MMXA1\n"


#: packages whose classes an artifact's program record may hold: jax's
#: Exported record (avals, pytree definitions, shardings) and numpy /
#: ml_dtypes dtypes. Anything else in the stream is refused at load.
_PICKLE_PACKAGES = ("jax", "jaxlib", "numpy", "ml_dtypes")


class _ExportUnpickler(pickle.Unpickler):
    def find_class(self, module, name):
        if module.split(".")[0] not in _PICKLE_PACKAGES:
            raise pickle.UnpicklingError(
                f"artifact program record refers to {module}.{name}")
        return super().find_class(module, name)


def _serialize(exported) -> bytes:
    """One exported program as bytes: jax.export's Exported record
    (StableHLO bytecode plus calling convention) pickled. jax's own
    Exported.serialize needs the `flatbuffers` package, which a GPU
    deployment may lack; the record pickles with jax's own types. The
    VJP hook is a closure and is dropped: artifacts render, they are
    never differentiated."""
    return pickle.dumps(dataclasses.replace(exported, _get_vjp=None),
                        protocol=pickle.HIGHEST_PROTOCOL)


def _deserialize(raw: bytes, path: str):
    try:
        return _ExportUnpickler(io.BytesIO(raw)).load()
    except (pickle.UnpicklingError, EOFError, AttributeError,
            ImportError, IndexError, TypeError) as e:
        raise ValueError(f"{path}: corrupt artifact program ({e})") from e


def _leaf_spec(a) -> dict:
    a = np.asarray(a)
    return {"shape": list(a.shape), "dtype": str(a.dtype)}


def export_artifact(filt, path: str, width: int, height: int,
                    options=None, params: dict | None = None,
                    batch_sizes=(), anim_frames: int | None = None) -> None:
    """Write a .mmxa artifact for `filt` at the given geometry.

    `params` supplies a VALUE for every param that should be a runtime
    input of the artifact (defaults are used for the export-time trace;
    the values themselves stay changeable at call time). Params omitted
    here are rendered at their declared defaults and are NOT inputs of
    the artifact. Image params become positional inputs of the loaded
    callable.

    `batch_sizes` additionally exports the N-job batched program for
    each size N (the renderer's render_batch path: per-job inputs, t,
    frame, and param VALUES in ONE device dispatch — the serving
    answer to the per-dispatch floor on small frames). The loaded
    artifact then offers `render_batch`; requests pad up to the next
    exported size, so (4, 16) covers any batch <= 16 with at most 3
    programs.

    `anim_frames=F` additionally exports the whole-t-sweep program
    (render_animation's lax.map over F frames in one dispatch; the frame
    count is part of the compiled program). The loaded artifact then
    offers `render_animation()` -> (F, H, W, 4), with the t spacing
    (periodic or not) fixed by the export-time options.
    """
    import jax

    from ..runtime.options import RenderOptions
    from ..runtime.render import _userval_pytree
    from ..runtime.tracer import RenderContext

    opts = options or RenderOptions()
    renderer = filt._renderer(width, height, opts, 1)
    jnp = renderer.jnp
    ctx = RenderContext(be=jnp, width=width, height=height, opts=opts,
                        filters=filt.filters, is_jax=True)
    uv_arrays, kinds = _userval_pytree(ctx, filt.fdef, params or {})
    n_img = len(filt.image_params)
    ins_spec = [jax.ShapeDtypeStruct((height, width, 4), jnp.float32)
                for _ in range(n_img)]
    uv_spec = jax.tree.map(
        lambda a: jax.ShapeDtypeStruct(np.shape(a),
                                       np.asarray(a).dtype), uv_arrays)
    scal = jax.ShapeDtypeStruct((), jnp.float32)
    exp = jax.export.export(renderer._jitted)(
        ins_spec, uv_spec, kinds, scal, scal)
    batch_blobs = []
    for bn in batch_sizes:
        bn = int(bn)
        ins_b = [jax.ShapeDtypeStruct((bn, height, width, 4), jnp.float32)
                 for _ in range(n_img)]
        uv_b = jax.tree.map(
            lambda a: jax.ShapeDtypeStruct((bn,) + tuple(np.shape(a)),
                                           np.asarray(a).dtype), uv_arrays)
        vec = jax.ShapeDtypeStruct((bn,), jnp.float32)

        # the same program Filter.render_batch runs (per-job param values
        # ride a lax.map). The shared-input mask is baked all-False:
        # artifact batch calls take per-job input stacks (the serving
        # layer's shape), so the exported calling convention stays
        # (ins, uv, ts, frames)
        def fnb(ins, uv, kinds, ts, frames):
            return renderer._jitted_jobs_pp(
                [], ins, uv, kinds, (False,) * n_img, ts, frames)

        batch_blobs.append(_serialize(
            jax.export.export(jax.jit(fnb, static_argnums=(2,)))(
                ins_b, uv_b, kinds, vec, vec)))
    anim_blob = None
    if anim_frames is not None:
        fn = int(anim_frames)
        if fn < 1:
            raise ValueError(f"anim_frames must be >= 1, got {anim_frames}")
        # the frame count (and num_frames internal) is part of the traced
        # program — the animation renderer is built with num_frames=F,
        # exactly like api.render_animation's live path
        anim_renderer = filt._renderer(width, height, opts, fn)
        tspec = jax.ShapeDtypeStruct((fn,), jnp.float32)
        anim_blob = _serialize(jax.export.export(anim_renderer._jitted_frames)(
            ins_spec, uv_spec, kinds, tspec, scal))
    manifest = {
        "filter": filt.name,
        "width": width, "height": height,
        "n_inputs": n_img,
        "platforms": list(exp.platforms),
        # param name -> leaf structure so the loader can rebuild the
        # userval pytree from plain values (dict of name -> array |
        # tuple-of-scalars, mirroring _userval_pytree)
        "params": {
            name: ({"tuple": [_leaf_spec(x) for x in a]}
                   if isinstance(a, (list, tuple))
                   else {"array": _leaf_spec(a)})
            for name, a in uv_arrays.items()
        },
        "interpolation": opts.interpolation,
        "edges": [opts.edge_x, opts.edge_y],
        "batch_sizes": [int(n) for n in batch_sizes],
        "anim_frames": int(anim_frames) if anim_frames is not None else None,
        "periodic": bool(opts.periodic),
    }
    blob = _serialize(exp)
    head = json.dumps(manifest).encode()
    with open(path, "wb") as f:
        f.write(_MAGIC)
        f.write(struct.pack("<I", len(head)))
        f.write(head)
        if batch_blobs or anim_blob is not None:
            # multi-program layout: every remaining blob is u64-length-
            # prefixed (main, then one per batch size, then the animation
            # program — manifest order)
            for b in [blob] + batch_blobs + (
                    [anim_blob] if anim_blob is not None else []):
                f.write(struct.pack("<Q", len(b)))
                f.write(b)
        else:
            f.write(blob)  # legacy layout: main blob runs to EOF


class LoadedArtifact:
    """A deserialized .mmxa: `render(*inputs, params=..., t=, frame=)`.

    `inputs` are (H, W, 4) float32 arrays matching the exported
    geometry; `params` gives values for the params recorded in the
    manifest (floats/bools, length-n sequences for colors/tuples, 1-D
    LUT arrays for curves, (N, 4) for gradients — the same leaf shapes
    as at export)."""

    def __init__(self, manifest: dict, exported, batch_exported=None,
                 anim_exported=None):
        self.manifest = manifest
        self._exp = exported
        #: batch size -> exported N-job program (render_batch analog)
        self._exp_batch = dict(zip(manifest.get("batch_sizes", []),
                                   batch_exported or []))
        self._exp_anim = anim_exported

    @property
    def batch_sizes(self) -> tuple:
        return tuple(sorted(self._exp_batch))

    @property
    def platforms(self):
        return tuple(self.manifest.get("platforms", ()))

    def _build_uv(self, params: dict):
        spec = self.manifest["params"]
        params = params or {}
        unknown = set(params) - set(spec)
        if unknown:
            raise ValueError(
                f"artifact has no param(s) {sorted(unknown)}; exported "
                f"params: {sorted(spec)}")
        uv = {}
        for name, leaf in spec.items():
            if name not in params:
                raise ValueError(
                    f"artifact param {name!r} needs a value (it was "
                    f"exported as a runtime input)")
            v = params[name]
            if "tuple" in leaf:
                shapes = leaf["tuple"]
                if isinstance(v, np.ndarray):
                    # reshape(-1) also handles 0-d scalars (list() on a
                    # 0-d array raises TypeError)
                    vals = list(v.reshape(-1))
                elif isinstance(v, (list, tuple)):
                    vals = list(v)
                else:
                    vals = [v]
                if len(vals) == 3 and len(shapes) == 4:
                    vals = vals + [1.0]  # rgb -> rgba like the live path
                if len(vals) != len(shapes):
                    raise ValueError(
                        f"param {name!r} expects {len(shapes)} components, "
                        f"got {len(vals)}")
                # a LIST, matching the export-time pytree structure
                # (_userval_pytree stores numeric tuples as lists)
                uv[name] = [
                    np.asarray(x, dtype=s["dtype"]).reshape(s["shape"])
                    for x, s in zip(vals, shapes)]
            else:
                s = leaf["array"]
                arr = np.asarray(v, dtype=s["dtype"])
                if list(arr.shape) != s["shape"]:
                    raise ValueError(
                        f"param {name!r} expects shape {s['shape']} "
                        f"{s['dtype']}, got {list(arr.shape)}")
                uv[name] = arr
        return uv

    def render(self, *inputs, params: dict | None = None, t: float = 0.0,
               frame: float = 0.0):
        m = self.manifest
        if len(inputs) != m["n_inputs"]:
            raise ValueError(
                f"artifact expects {m['n_inputs']} input image(s), got "
                f"{len(inputs)}")
        # uint8 inputs normalize /255 like every other render entry point
        # (a bare float cast would feed 0-255 values to a [0,1] program)
        ins = [np.asarray(a, dtype=np.float32) / 255.0
               if np.asarray(a).dtype == np.uint8
               else np.asarray(a, dtype=np.float32) for a in inputs]
        for a in ins:
            if a.shape != (m["height"], m["width"], 4):
                raise ValueError(
                    f"artifact inputs must be ({m['height']}, "
                    f"{m['width']}, 4); got {a.shape}")
        uv = self._build_uv(params or {})
        out = self._exp.call(ins, uv, np.float32(t), np.float32(frame))
        return np.asarray(out)

    def render_animation(self, *inputs, params: dict | None = None):
        """Whole t-sweep in one dispatch -> (F, H, W, 4); F and the t
        spacing (periodic or not) were fixed at export (anim_frames)."""
        m = self.manifest
        if self._exp_anim is None:
            raise ValueError(
                "artifact has no animation program; export with "
                "anim_frames=F to enable render_animation")
        if len(inputs) != m["n_inputs"]:
            raise ValueError(
                f"artifact expects {m['n_inputs']} input image(s), got "
                f"{len(inputs)}")
        ins = [np.asarray(a, dtype=np.float32) / 255.0
               if np.asarray(a).dtype == np.uint8
               else np.asarray(a, dtype=np.float32) for a in inputs]
        for a in ins:
            if a.shape != (m["height"], m["width"], 4):
                raise ValueError(
                    f"artifact inputs must be ({m['height']}, "
                    f"{m['width']}, 4); got {a.shape}")
        fn = int(m["anim_frames"])
        denom = fn if m.get("periodic") else max(fn - 1, 1)
        ts = np.arange(fn, dtype=np.float32) / denom
        uv = self._build_uv(params or {})
        return np.asarray(self._exp_anim.call(ins, uv, ts, np.float32(0.0)))

    def render_batch(self, *input_stacks, params, ts, frames=None):
        """N independent jobs in one device dispatch -> (N, H, W, 4).

        Mirrors Filter.render_batch: each element of `input_stacks` is an
        (N, H, W, 4) stack, job i renders at t=ts[i] with params[i]
        (`params` may be ONE dict shared by all jobs). Requires the
        artifact to have been exported with `batch_sizes`; a batch pads
        up to the next exported size (repeating the last job), so sizes
        are buckets, not exact-match requirements."""
        m = self.manifest
        if not self._exp_batch:
            raise ValueError(
                "artifact has no batched programs; export with "
                "batch_sizes=(...) to enable render_batch")
        ts = np.asarray(ts, np.float32).reshape(-1)
        n = int(ts.shape[0])
        params = [params] * n if isinstance(params, dict) else list(params)
        if len(params) != n:
            raise ValueError(
                f"render_batch: {len(params)} param dicts for {n} jobs")
        if len(input_stacks) != m["n_inputs"]:
            raise ValueError(
                f"artifact expects {m['n_inputs']} input stack(s), got "
                f"{len(input_stacks)}")
        ins = []
        for a in input_stacks:
            arr = np.asarray(a)
            # np.asarray form: no copy when the stack is already float32
            # (the serving layer pre-normalizes — a 16x512² f32 stack is
            # 64 MB; astype would memcpy it again)
            arr = (arr.astype(np.float32) / 255.0
                   if arr.dtype == np.uint8
                   else np.asarray(arr, dtype=np.float32))
            if arr.shape != (n, m["height"], m["width"], 4):
                raise ValueError(
                    f"input stacks must be ({n}, {m['height']}, "
                    f"{m['width']}, 4); got {arr.shape}")
            ins.append(arr)
        frames = (np.arange(n, dtype=np.float32) if frames is None
                  else np.asarray(frames, np.float32).reshape(-1))
        if frames.shape[0] != n:
            # same readable validation as Filter.render_batch (review r5:
            # a wrong-length frames died inside the exported module with
            # an opaque XLA shape error after padding)
            raise ValueError(
                f"render_batch: {frames.shape[0]} frame values for {n} jobs")
        bucket = next((s for s in sorted(self._exp_batch) if s >= n), None)
        if bucket is None:
            raise ValueError(
                f"batch of {n} exceeds the largest exported batch size "
                f"{max(self._exp_batch)}; chunk the batch or re-export")
        if bucket > n:
            pad = bucket - n
            ins = [np.concatenate([a, np.repeat(a[-1:], pad, 0)])
                   for a in ins]
            params = params + [params[-1]] * pad
            ts = np.concatenate([ts, np.repeat(ts[-1:], pad)])
            frames = np.concatenate([frames, np.repeat(frames[-1:], pad)])
        uvs = [self._build_uv(p) for p in params]
        stacked = {}
        for name in self.manifest["params"]:
            leaves = [u[name] for u in uvs]
            if isinstance(leaves[0], list):  # tuple param: stack per comp
                stacked[name] = [
                    np.stack([lv[i] for lv in leaves])
                    for i in range(len(leaves[0]))]
            else:
                stacked[name] = np.stack(leaves)
        out = self._exp_batch[bucket].call(ins, stacked, ts, frames)
        return np.asarray(out)[:n]


#: JAX backend names that stand for several lowering platforms
_PLATFORM_ALIASES = {"gpu": ("cuda", "rocm")}


def _platform_names(name: str) -> set:
    name = name.lower()
    return set(_PLATFORM_ALIASES.get(name, (name,)))


def current_platform() -> str:
    """This process's lowering platform, named as jax.export records it in
    Exported.platforms ('cuda', 'rocm', 'cpu', ...) — not the backend
    name jax.default_backend() returns ('gpu')."""
    import jax

    return jax.export.default_export_platform()


def _check_platform(platforms, current: str, path: str) -> None:
    """jax.export programs are platform-pinned at lowering time; calling
    a module lowered for another platform dies deep inside XLA with an
    opaque error. Fail at LOAD time instead, with re-export guidance.
    Names compare canonically ('gpu' and 'cuda' are one platform)."""
    plats = tuple(p.lower() for p in platforms)
    known = set().union(*(_platform_names(p) for p in plats)) if plats else set()
    if plats and not (_platform_names(current) & known):
        raise ValueError(
            f"{path}: artifact was exported for platform(s) "
            f"{list(plats)} but this process runs on "
            f"{current.lower()!r}. jax.export programs are "
            f"platform-pinned — re-export the artifact on this "
            f"platform (mathmap-tpu --export-artifact ... or "
            f"export_artifact(...)), or serve it on "
            f"{'/'.join(plats)}.")


def load_artifact(path: str) -> LoadedArtifact:
    """Load a .mmxa written by export_artifact (jax + numpy only).

    Raises ValueError if the artifact was exported for a different
    platform than this process's jax backend (platform pinning is a
    property of jax.export lowering, not of this file format)."""
    with open(path, "rb") as f:
        magic = f.read(len(_MAGIC))
        if magic != _MAGIC:
            raise ValueError(f"{path}: not a mathmap_tpu artifact")
        head = f.read(4)
        if len(head) < 4:
            raise ValueError(f"{path}: truncated artifact")
        (n,) = struct.unpack("<I", head)
        raw = f.read(n)
        if len(raw) < n:
            raise ValueError(f"{path}: truncated artifact")
        try:
            manifest = json.loads(raw)
        except json.JSONDecodeError as e:
            raise ValueError(f"{path}: corrupt artifact manifest") from e
        _check_platform(manifest.get("platforms", ()),
                        current_platform(), path)
        batch_exps = []
        anim_exp = None
        if manifest.get("batch_sizes") or manifest.get("anim_frames"):
            # multi-program layout: u64-prefixed main blob, then one per
            # batch size, then the animation program (manifest order)
            def read_blob():
                head = f.read(8)
                if len(head) < 8:
                    raise ValueError(f"{path}: truncated artifact")
                (bn,) = struct.unpack("<Q", head)
                braw = f.read(bn)
                if len(braw) < bn:
                    raise ValueError(f"{path}: truncated artifact")
                return braw

            blob = read_blob()
            batch_exps = [_deserialize(read_blob(), path)
                          for _ in manifest.get("batch_sizes", [])]
            if manifest.get("anim_frames"):
                anim_exp = _deserialize(read_blob(), path)
        else:
            blob = f.read()
    return LoadedArtifact(manifest, _deserialize(blob, path),
                          batch_exps, anim_exp)
