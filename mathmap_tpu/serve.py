"""Production render service: micro-batching queue + HTTP front end.

The reference ships as an in-process GIMP plugin / CLI; its production
analog for an accelerator-backed deployment is a long-lived service that keeps
compiled programs warm and amortizes the per-dispatch cost across
concurrent requests (docs/SERVING.md rules 1-2). This module is that
component:

- `RenderService`: a thread-safe job queue. A single dispatcher thread
  drains the queue, groups jobs that share a program signature
  (filter, size, options, param NAMES — values may differ per job via
  `render_batch`'s per-job params list; with static_params the values
  are baked into the program, so grouping falls back to values), and
  issues ONE batched device dispatch per group (api.Filter.render_batch,
  padded to power-of-2 bucket sizes so at most log2(max_batch)+1 batch
  programs exist per configuration). Groups dispatch OLDEST-FIRST, so a
  minority signature can never be starved by sustained traffic of
  another.
- `serve()` / `python -m mathmap_tpu.serve`: a stdlib ThreadingHTTPServer
  JSON API over the service. Concurrent HTTP clients are what feed the
  micro-batcher; each handler thread blocks on its own job's future.

Endpoints:
  GET  /healthz          {"ok": true, "platform": ..., "programs": N}
  GET  /stats            counters + batch-size histogram + latency
  POST /warmup           {"filter": name|{"source": src}, "width", "height",
                          "batch_sizes": [1, 4, ...], ...options} ->
                          precompiles the single-frame program and the
                          batched program at each requested bucket size
  POST /render           {"filter": ..., "width", "height", "t", "params",
                          "inputs": [base64 PNG/JPEG/GIF, ...],
                          "format": "png"|"raw"} -> {"image": base64}
                          (raw: {"shape", "dtype", "data"} — uint8 by
                          default, see below). {"artifact": name} instead
                          of "filter" runs a precompiled .mmxa program
                          (load_artifacts) — no compiler at serve time.
  POST /animate          {"filter": ..., "num_frames", "fps", ...} ->
                          {"gif": base64} (or "format": "raw" ->
                          (F, H, W, 4) bytes + declared dtype) — whole
                          t-sweep in ONE device program (render_animation)
  GET  /artifacts        loaded .mmxa programs + their geometry/params

Any render/animate request may set {"binary": true} to receive the bytes
directly (Content-Type image/png, image/gif, or application/octet-stream
with X-Shape/X-Dtype headers) instead of base64-in-JSON — base64 costs
+33% bytes plus an encode pass on the single-core serving host.

I/O dtype: the service renders with output_dtype='uint8' by default —
the 8-bit pack runs ON DEVICE (bit-identical to the host pack PNG/GIF
encode needs anyway) and decoded request images stay uint8, so both
transfer directions ship 4× fewer bytes than float32 (a 512² f32 frame
is 4 MB, its u8 twin 1 MB).
RenderService(output_dtype='float32') restores raw float results.

Client errors (bad JSON, unknown filter, bad params) return 400; render
timeouts 503; backend/compile failures 500.

No external dependencies (stdlib http.server + the package's own imgio).
Reference analog: mathmap.c's PDB entry point / mathmap_cmdline.c driver
[unverified — reference mount empty, SURVEY.md §0]; the batching layer is
this system's own design (no reference equivalent — the C renderer has no
per-dispatch cost to amortize).
"""

from __future__ import annotations

import base64
import io
import json
import queue
import threading
import time
from dataclasses import dataclass, field
from typing import Any

import numpy as np

from .runtime.options import RenderOptions

#: options forwarded from request JSON to RenderOptions. JSON arrays
#: become tuples (edge_color, static_params — RenderOptions is frozen
#: and hashable, lists would break the jit-cache key).
_OPT_KEYS = ("interpolation", "edge_x", "edge_y", "edge_color",
             "supersample", "supersample_scheme",
             "periodic", "seed", "static_params", "region")


def _opts_from(req: dict) -> RenderOptions:
    kw = {k: tuple(req[k]) if isinstance(req[k], list) else req[k]
          for k in _OPT_KEYS if k in req}
    return RenderOptions(**kw)


def _params_key(params: dict, by_value: bool) -> tuple:
    """Grouping key for a job's params. render_batch accepts per-job param
    VALUES (a params list), so by default only the param NAMES and value
    SHAPES must match for jobs to share a dispatch; with static_params in
    play the values are baked into the program, so group by value."""
    def norm(v):
        if isinstance(v, (list, tuple)):
            return tuple(float(x) for x in v) if by_value else len(v)
        if isinstance(v, (int, float, bool)):
            return float(v) if by_value else 0
        return str(v)

    return tuple(sorted((str(k), norm(v)) for k, v in params.items()))


@dataclass
class _Job:
    sig: tuple
    filt: Any
    inputs: list  # list of (H, W, 4) float arrays (may be empty)
    t: float
    params: dict
    width: int
    height: int
    options: RenderOptions
    done: threading.Event = field(default_factory=threading.Event)
    result: Any = None
    error: Exception | None = None
    enqueued: float = field(default_factory=time.perf_counter)
    #: not None -> an animation job: one render_animation dispatch for the
    #: whole t-sweep (never grouped; its sig is unique)
    num_frames: int | None = None
    #: not None -> a LoadedArtifact job (filt is None): groups dispatch
    #: through the artifact's exported batch programs when it has them
    artifact: Any = None
    frame: float = 0.0
    #: unique-sig jobs (animations, batchless artifacts) dispatch the
    #: moment the dispatcher sees them — a batching window would add
    #: latency with zero chance of a companion
    solo: bool = False


class RenderService:
    """Micro-batching render queue over compiled filters.

    One dispatcher thread; jobs whose (filter, size, options, params)
    signature matches are rendered in a single `render_batch` dispatch.
    `window_ms` is how long the dispatcher waits to gather companions for
    the first job of a group; `max_batch` bounds a group's size.
    """

    def __init__(self, db=None, max_batch: int = 32, window_ms: float = 4.0,
                 output_dtype: str = "uint8"):
        from .expression_db import default_db

        self.db = db if db is not None else default_db()
        self.artifacts: dict = {}    # name -> LoadedArtifact (.mmxa)
        self._artifact_paths: dict = {}  # name -> abspath it was loaded from
        self.max_batch = int(max_batch)
        self.window_ms = float(window_ms)
        #: the dtype every job renders at. 'uint8' (default): results are
        #: device-packed (H, W, 4) uint8 — bit-identical to imgio.to_uint8
        #: of the float render, 4× less device→host traffic (the encode
        #: step needs u8 anyway for PNG/GIF). 'float32' restores raw float
        #: results for API users doing further math.
        if output_dtype not in ("float32", "uint8"):
            raise ValueError("output_dtype must be 'float32' or 'uint8'")
        self.output_dtype = output_dtype
        self._q: queue.Queue = queue.Queue()
        self._filters: dict = {}     # cache key -> Filter
        self._lock = threading.Lock()
        self.stats = {
            "jobs": 0, "dispatches": 0, "errors": 0,
            "batch_hist": {},        # batch size -> count
            "latency_ms_sum": 0.0,   # submit -> result, summed over jobs
        }
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="mmtpu-dispatcher")
        self._thread.start()

    def _svc_opts(self, options: RenderOptions | None) -> RenderOptions:
        """Request options + the service's output dtype (every dispatch
        renders at self.output_dtype; the dtype is part of both the group
        signature and the jit program)."""
        from dataclasses import replace

        options = options or RenderOptions()
        if options.output_dtype != self.output_dtype:
            options = replace(options, output_dtype=self.output_dtype)
        return options

    # -- filter/program management ------------------------------------
    def get_filter(self, spec):
        """spec: a library filter name, or {"source": mm_source}."""
        from . import compile_source

        if isinstance(spec, dict) and "source" in spec:
            key = ("src", spec["source"], spec.get("main"))
        else:
            key = ("name", str(spec))
        with self._lock:
            filt = self._filters.get(key)
            if filt is None:
                if key[0] == "src":
                    filt = compile_source(spec["source"], spec.get("main"))
                else:
                    filt = self.db.compile(str(spec))
                self._filters[key] = filt
            return filt

    def load_artifacts(self, path) -> list:
        """Register .mmxa AOT artifacts (a file or a directory of them)
        under their exported filter names (file stem on collision).

        Artifact requests ({"artifact": name} on /render) run the
        precompiled program — no parse/trace/compile at serve time,
        geometry fixed at export. Artifacts exported with batch_sizes
        micro-batch exactly like live filters (concurrent requests
        coalesce into one exported-batch-program dispatch); others
        dispatch as singletons."""
        import os

        from .generators.artifact import load_artifact

        files = ([os.path.join(path, f) for f in sorted(os.listdir(path))
                  if f.endswith(".mmxa")]
                 if os.path.isdir(path) else [path])
        names = []
        for f in files:
            art = load_artifact(f)
            src = os.path.abspath(f)
            name = art.manifest.get("filter") or os.path.basename(f)
            if (name in self.artifacts
                    and self._artifact_paths.get(name) != src):
                name = os.path.splitext(os.path.basename(f))[0]
            if (name in self.artifacts
                    and self._artifact_paths.get(name) != src):
                # two DIFFERENT files claiming the same name — refusing is
                # the only honest option (silent overwrite would reroute
                # clients to a different program); same-path reloads above
                # replace in place
                raise ValueError(
                    f"artifact name {name!r} already serves "
                    f"{self._artifact_paths[name]}; rename {f} to load it")
            self.artifacts[name] = art
            self._artifact_paths[name] = src
            names.append(name)
        return names

    def render_artifact(self, name: str, inputs, params: dict | None = None,
                        t: float = 0.0, frame: float = 0.0,
                        timeout: float | None = 600.0) -> np.ndarray:
        """Render a loaded .mmxa through the job queue. Artifacts exported
        with batch_sizes micro-batch like live filters (concurrent
        requests share one exported-batch-program dispatch); others
        dispatch as singletons (unique sig — no pointless window wait)."""
        art = self.artifacts.get(name)
        if art is None:
            raise ValueError(
                f"unknown artifact {name!r}; loaded: "
                f"{sorted(self.artifacts)}")
        # validate against the manifest BEFORE enqueueing: jobs that group
        # into one exported-batch dispatch must never be able to poison
        # their companions (a bad stack shape or param LUT inside
        # _dispatch_artifact would fail EVERY coalesced request)
        self._check_artifact_request(art, inputs, params)
        sig = (("art", id(art)) if art.batch_sizes
               else ("art", id(art), object()))
        job = _Job(sig=sig, filt=None, inputs=list(inputs), t=float(t),
                   params=params or {}, width=art.manifest["width"],
                   height=art.manifest["height"], options=RenderOptions(),
                   artifact=art, frame=float(frame),
                   solo=not art.batch_sizes)
        self._q.put(job)
        if not job.done.wait(timeout):
            raise TimeoutError("render timed out")
        if job.error is not None:
            raise job.error
        return job.result

    @staticmethod
    def _check_artifact_request(art, inputs, params):
        """Raise the artifact's own ValueErrors for bad inputs/params
        WITHOUT dispatching (shape checks + _build_uv validation)."""
        m = art.manifest
        if len(inputs) != m["n_inputs"]:
            raise ValueError(
                f"artifact expects {m['n_inputs']} input image(s), got "
                f"{len(inputs)}")
        for a in inputs:
            if np.asarray(a).shape != (m["height"], m["width"], 4):
                raise ValueError(
                    f"artifact inputs must be ({m['height']}, "
                    f"{m['width']}, 4); got {np.asarray(a).shape}")
        art._build_uv(params or {})

    def animate_artifact(self, name: str, inputs,
                         params: dict | None = None,
                         num_frames: int | None = None,
                         timeout: float | None = 600.0) -> np.ndarray:
        """Run a loaded artifact's exported animation program (one
        whole-sweep dispatch; F fixed at export — a conflicting
        `num_frames` request is an error, not a silent reinterpretation).
        Never grouped."""
        art = self.artifacts.get(name)
        if art is None:
            raise ValueError(
                f"unknown artifact {name!r}; loaded: "
                f"{sorted(self.artifacts)}")
        exported = art.manifest.get("anim_frames")
        if num_frames is not None and num_frames != exported:
            raise ValueError(
                f"artifact animation has "
                f"{exported or 'no'} frames (fixed at export); requested "
                f"num_frames={num_frames} — re-export with anim_frames="
                f"{num_frames} or drop the field")
        if not exported:
            raise ValueError(
                "artifact has no animation program; export with "
                "anim_frames=F to enable render_animation")
        self._check_artifact_request(art, inputs, params)
        job = _Job(sig=("art-anim", id(art), object()), filt=None,
                   inputs=list(inputs), t=0.0, params=params or {},
                   width=art.manifest["width"],
                   height=art.manifest["height"], options=RenderOptions(),
                   artifact=art, solo=True,
                   num_frames=int(art.manifest.get("anim_frames") or 0))
        self._q.put(job)
        if not job.done.wait(timeout):
            raise TimeoutError("animation timed out")
        if job.error is not None:
            raise job.error
        return job.result

    def warmup(self, spec, width: int, height: int,
               options: RenderOptions | None = None,
               params: dict | None = None, batch_sizes=(1,)):
        """Precompile the programs for a configuration (blocking).

        Each bucket size in `batch_sizes` is a DISTINCT jit program (the
        dispatcher pads groups to power-of-2 buckets, so (1, 2, 4, ...,
        max_batch) covers every dispatch this configuration can see).
        The param NAME SET is part of the program signature — warm with
        the same `params` names production requests will send."""
        filt = self.get_filter(spec)
        options = self._svc_opts(options)
        params = params or {}
        n_img = sum(1 for p in filt.fdef.params if p.kind == "image")
        # u8 blanks: production inputs arrive as decoded uint8 (the input
        # dtype is part of the jit program signature — warm the program
        # production will actually hit)
        blank = np.zeros((height, width, 4), np.uint8)
        for n in batch_sizes:
            n = int(n)
            if n <= 1:
                filt.render(*([blank] * n_img), width=width, height=height,
                            options=options, params=params)
                continue
            stacks = [np.broadcast_to(blank, (n, height, width, 4))
                      for _ in range(n_img)]
            filt.render_batch(*stacks, ts=np.zeros(n, np.float32),
                              frames=np.zeros(n, np.float32),
                              width=width, height=height, options=options,
                              params=[params] * n)
        return filt

    # -- job path -------------------------------------------------------
    def submit(self, spec, inputs, width: int, height: int, t: float = 0.0,
               params: dict | None = None,
               options: RenderOptions | None = None,
               num_frames: int | None = None) -> _Job:
        filt = self.get_filter(spec)
        params = params or {}
        options = self._svc_opts(options)
        # Filter._conv_input handles (H,W,C) and animated (T,H,W,4) inputs
        # in any convertible dtype — the same normalization render() does
        inputs = [filt._conv_input(a) for a in inputs]
        # RenderOptions is a frozen dataclass (hashable). Grouping keys on
        # param NAMES (render_batch takes per-job values) — except under
        # static_params, where values are baked into the program (see
        # _params_key). Input geometries join the signature (batching
        # stacks inputs). Animated (T, H, W, 4) inputs can't join a batch
        # stack — they get a unique signature and dispatch as singletons.
        # dtype joins the signature: np.stack would silently promote a
        # uint8 frame grouped with a float32 one to 0-255 floats, which
        # skip the in-trace /255 normalization (review r3: reproduced as
        # an all-white render for the u8 job)
        shapes = tuple((tuple(a.shape), str(a.dtype)) for a in inputs)
        animated = any(a.ndim == 4 for a in inputs)
        sig = (id(filt), width, height, options,
               _params_key(params, by_value=bool(options.static_params)),
               shapes,
               object() if (animated or num_frames is not None) else None)
        job = _Job(sig=sig, filt=filt, inputs=list(inputs), t=float(t),
                   params=params, width=width, height=height,
                   options=options, num_frames=num_frames,
                   solo=animated or num_frames is not None)
        self._q.put(job)
        return job

    def render_sync(self, spec, inputs, width: int, height: int,
                    t: float = 0.0, params: dict | None = None,
                    options: RenderOptions | None = None,
                    timeout: float | None = 600.0) -> np.ndarray:
        job = self.submit(spec, inputs, width, height, t, params, options)
        if not job.done.wait(timeout):
            raise TimeoutError("render timed out")
        if job.error is not None:
            raise job.error
        return job.result

    def animate_sync(self, spec, inputs, width: int, height: int,
                     num_frames: int, params: dict | None = None,
                     options: RenderOptions | None = None,
                     timeout: float | None = 600.0) -> np.ndarray:
        """Whole t-sweep as ONE device program -> (F, H, W, 4). Queued like
        any job (serializes device access) but never grouped."""
        job = self.submit(spec, inputs, width, height, 0.0, params, options,
                          num_frames=int(num_frames))
        if not job.done.wait(timeout):
            raise TimeoutError("animation timed out")
        if job.error is not None:
            raise job.error
        return job.result

    # -- dispatcher -----------------------------------------------------
    def _run(self):
        # pending groups live HERE, not on the queue: the previous design
        # requeued mismatched jobs to the tail, which let sustained traffic
        # of one signature starve another indefinitely. Groups now dispatch
        # oldest-first; a group goes when its window expires or it fills.
        pending: dict = {}  # sig -> list[_Job], each list enqueue-ordered
        while not self._stop.is_set():
            try:
                j = self._q.get(timeout=0.005 if pending else 0.1)
                pending.setdefault(j.sig, []).append(j)
                while True:  # drain whatever else arrived, without blocking
                    try:
                        j = self._q.get_nowait()
                    except queue.Empty:
                        break
                    pending.setdefault(j.sig, []).append(j)
            except queue.Empty:
                pass
            if not pending:
                continue
            # unique-sig jobs gain nothing from the gathering window —
            # dispatch them immediately, oldest first
            solos = sorted((s for s, g in pending.items() if g[0].solo),
                           key=lambda s: pending[s][0].enqueued)
            for s in solos:
                self._dispatch(pending.pop(s))
            if not pending:
                continue
            sig, group = min(pending.items(),
                             key=lambda kv: kv[1][0].enqueued)
            now = time.perf_counter()
            if (len(group) < self.max_batch
                    and now - group[0].enqueued < self.window_ms / 1e3):
                continue  # oldest group's window still open — keep gathering
            rest = group[self.max_batch:]
            if rest:
                pending[sig] = rest
            else:
                del pending[sig]
            self._dispatch(group[:self.max_batch])
        # unblock anything still waiting at shutdown
        for group in pending.values():
            for g in group:
                g.error = RuntimeError("service shut down")
                g.done.set()

    def _dispatch(self, group: list):
        try:
            if group[0].artifact is not None:
                return self._dispatch_artifact(group)
            if len(group) == 1:
                j = group[0]
                if j.num_frames is not None:
                    out = j.filt.render_animation(
                        *j.inputs, num_frames=j.num_frames, width=j.width,
                        height=j.height, params=j.params, options=j.options)
                else:
                    out = j.filt.render(*j.inputs, width=j.width,
                                        height=j.height, t=j.t,
                                        params=j.params, options=j.options)
                j.result = np.asarray(out)
            else:
                j0 = group[0]
                # pad to the next power-of-2 bucket (repeat the last job):
                # each batch size N is a distinct jit program (~1-3 min
                # remote compile), so buckets bound the program count per
                # configuration to log2(max_batch)+1 — a padded lax.map
                # frame costs microseconds, a surprise compile costs
                # minutes of every client's latency
                n = len(group)
                bucket = 1
                while bucket < n:
                    bucket *= 2
                padded = group + [group[-1]] * (bucket - n)
                stacks = [np.stack([g.inputs[i] for g in padded])
                          for i in range(len(j0.inputs))]
                ts = np.asarray([g.t for g in padded], np.float32)
                # a lone render runs at frame=0 — its batched twin must too
                outs = j0.filt.render_batch(
                    *stacks, ts=ts, frames=np.zeros(bucket, np.float32),
                    width=j0.width, height=j0.height,
                    params=[g.params for g in padded], options=j0.options)
                for i, g in enumerate(group):
                    g.result = np.asarray(outs[i])
        except Exception as e:  # noqa: BLE001 — propagate to every waiter
            for g in group:
                g.error = e
            with self._lock:
                self.stats["errors"] += len(group)
        finally:
            now = time.perf_counter()
            with self._lock:
                self.stats["jobs"] += len(group)
                self.stats["dispatches"] += 1
                h = self.stats["batch_hist"]
                h[str(len(group))] = h.get(str(len(group)), 0) + 1
                for g in group:
                    self.stats["latency_ms_sum"] += (now - g.enqueued) * 1e3
            for g in group:
                g.done.set()

    def _dispatch_artifact(self, group: list):
        """Artifact jobs: exported-batch-program dispatch when available
        (chunked to the largest exported size), singletons otherwise.
        Stats/done bookkeeping stays in _dispatch's finally."""
        art = group[0].artifact

        def nrm(a):
            a = np.asarray(a)
            return (a.astype(np.float32) / 255.0 if a.dtype == np.uint8
                    else np.asarray(a, np.float32))

        if group[0].num_frames is not None:
            (g,) = group  # animation sigs are unique — never grouped
            g.result = art.render_animation(*g.inputs, params=g.params)
            return
        if len(group) == 1 or not art.batch_sizes:
            for g in group:
                g.result = art.render(*g.inputs, params=g.params, t=g.t,
                                      frame=g.frame)
            return
        cap = max(art.batch_sizes)
        n_in = len(group[0].inputs)
        for s in range(0, len(group), cap):
            chunk = group[s:s + cap]
            # normalize PER JOB before stacking: np.stack of mixed
            # u8+f32 inputs would promote u8 to 0-255 floats (the same
            # hazard the live batch path guards with its dtype signature)
            stacks = [np.stack([nrm(g.inputs[i]) for g in chunk])
                      for i in range(n_in)]
            outs = art.render_batch(
                *stacks, params=[g.params for g in chunk],
                ts=np.asarray([g.t for g in chunk], np.float32),
                frames=np.asarray([g.frame for g in chunk], np.float32))
            for g, o in zip(chunk, outs):
                g.result = np.asarray(o)

    def snapshot(self) -> dict:
        with self._lock:
            s = dict(self.stats)
            s["batch_hist"] = dict(self.stats["batch_hist"])
            s["programs"] = len(self._filters)
            if s["jobs"]:
                s["mean_latency_ms"] = round(s.pop("latency_ms_sum") / s["jobs"], 2)
            else:
                s.pop("latency_ms_sum")
        return s

    def shutdown(self):
        self._stop.set()
        self._thread.join(timeout=5)


# ---------------------------------------------------------------------------
# HTTP front end
# ---------------------------------------------------------------------------

def _decode_input(b64: str) -> np.ndarray:
    from .imgio.images import read_animation

    # keep the decoded uint8: the renderers normalize u8 in-trace, so the
    # upload ships 4× fewer bytes than a host float conversion would
    stack = read_animation(io.BytesIO(base64.b64decode(b64)), as_uint8=True)
    # single-frame files render as plain (H, W, 4) inputs; multi-frame
    # stays (T, H, W, 4) for origValXY frame-indexed sampling
    return stack[0] if stack.shape[0] == 1 else stack


def make_handler(service: RenderService):
    from http.server import BaseHTTPRequestHandler

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):  # quiet
            pass

        def _json(self, code: int, obj: dict):
            body = json.dumps(obj).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def _binary(self, data: bytes, ctype: str, headers: dict = None):
            # "binary": true responses skip base64 (+33% bytes) AND the
            # JSON wrapper — on the single-core serving host the encode
            # step rivals device dispatch (docs/SERVING.md)
            self.send_response(200)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(data)))
            for k, v in (headers or {}).items():
                self.send_header(k, v)
            self.end_headers()
            self.wfile.write(data)

        def _send_array(self, arr: np.ndarray, req: dict):
            """Shared /render response tail: raw|png x json|binary."""
            from .imgio.images import to_uint8
            from .imgio.png import encode_png

            binary = bool(req.get("binary"))
            if req.get("format") == "raw":
                data = np.ascontiguousarray(arr).tobytes()
                if binary:
                    return self._binary(
                        data, "application/octet-stream",
                        {"X-Shape": ",".join(map(str, arr.shape)),
                         "X-Dtype": str(arr.dtype)})
                return self._json(200, {
                    "shape": list(arr.shape), "dtype": str(arr.dtype),
                    "data": base64.b64encode(data).decode()})
            # png_level 0-9: zlib effort (0 = store — fastest for
            # localhost hops; default 1 ~= Pillow level-1 sizes)
            png = encode_png(to_uint8(arr), int(req.get("png_level", 1)))
            if binary:
                return self._binary(png, "image/png")
            return self._json(200, {"image": base64.b64encode(png).decode()})

        def do_GET(self):
            if self.path == "/healthz":
                import jax

                self._json(200, {"ok": True,
                                 "platform": jax.default_backend(),
                                 "programs": len(service._filters)})
            elif self.path == "/stats":
                self._json(200, service.snapshot())
            elif self.path == "/artifacts":
                self._json(200, {
                    name: {"width": a.manifest["width"],
                           "height": a.manifest["height"],
                           "n_inputs": a.manifest["n_inputs"],
                           "params": sorted(a.manifest["params"])}
                    for name, a in service.artifacts.items()})
            else:
                self._json(404, {"error": "unknown path"})

        def do_POST(self):
            try:
                n = int(self.headers.get("Content-Length", 0))
                req = json.loads(self.rfile.read(n) or b"{}")
            except Exception as e:  # noqa: BLE001
                return self._json(400, {"error": f"bad JSON: {e}"})
            try:
                if self.path == "/warmup":
                    filt = service.warmup(
                        req["filter"], int(req.get("width", 256)),
                        int(req.get("height", 256)), _opts_from(req),
                        req.get("params"),
                        batch_sizes=tuple(req.get("batch_sizes", (1,))))
                    return self._json(200, {"ok": True, "filter": filt.name})
                if self.path == "/animate":
                    inputs = [_decode_input(b) for b in req.get("inputs", [])]
                    if "artifact" in req:
                        # exported whole-sweep program: F fixed at export;
                        # a conflicting num_frames request is a 400
                        nf = req.get("num_frames")
                        frames = service.animate_artifact(
                            req["artifact"], inputs,
                            params=req.get("params"),
                            num_frames=None if nf is None else int(nf))
                    else:
                        w = int(req.get("width") or
                                (inputs[0].shape[-2] if inputs else 256))
                        h = int(req.get("height") or
                                (inputs[0].shape[-3] if inputs else 256))
                        frames = service.animate_sync(
                            req["filter"], inputs, w, h,
                            num_frames=int(req.get("num_frames", 8)),
                            params=req.get("params"),
                            options=_opts_from(req))
                    from .imgio.images import to_uint8

                    if req.get("format") == "raw":
                        data = np.ascontiguousarray(frames).tobytes()
                        if req.get("binary"):
                            return self._binary(
                                data, "application/octet-stream",
                                {"X-Shape": ",".join(map(str, frames.shape)),
                                 "X-Dtype": str(frames.dtype)})
                        return self._json(200, {
                            "shape": list(frames.shape),
                            "dtype": str(frames.dtype),
                            "data": base64.b64encode(data).decode()})
                    from .imgio.images import _pil

                    pil_frames = [_pil().fromarray(to_uint8(f))
                                  for f in frames]
                    buf = io.BytesIO()
                    pil_frames[0].save(
                        buf, format="GIF", save_all=True, loop=0,
                        append_images=pil_frames[1:],
                        duration=int(1000 / float(req.get("fps", 25))))
                    if req.get("binary"):
                        return self._binary(buf.getvalue(), "image/gif")
                    return self._json(200, {"gif": base64.b64encode(
                        buf.getvalue()).decode()})
                if self.path == "/render":
                    inputs = [_decode_input(b) for b in req.get("inputs", [])]
                    if "artifact" in req:
                        # precompiled .mmxa: no parse/trace/compile at
                        # serve time; batch-exported artifacts micro-batch
                        out = service.render_artifact(
                            req["artifact"], inputs,
                            params=req.get("params"),
                            t=float(req.get("t", 0.0)),
                            frame=float(req.get("frame", 0.0)))
                        return self._send_array(out, req)
                    w = int(req.get("width") or
                            (inputs[0].shape[-2] if inputs else 256))
                    h = int(req.get("height") or
                            (inputs[0].shape[-3] if inputs else 256))
                    out = service.render_sync(
                        req["filter"], inputs, w, h,
                        t=float(req.get("t", 0.0)),
                        params=req.get("params"),
                        options=_opts_from(req))
                    return self._send_array(out, req)
                return self._json(404, {"error": "unknown path"})
            except KeyError as e:
                return self._json(400, {"error": f"missing field {e}"})
            except TimeoutError as e:
                # the device stalled — a retryable server condition
                return self._json(503, {"error": f"render timed out: {e}"})
            except Exception as e:  # noqa: BLE001
                from .utils.errors import MMError

                # caller mistakes (bad source, unknown filter/param, bad
                # values) are 4xx; backend/compile failures are 5xx so load
                # balancers and retry middleware treat them as server
                # health, not client bugs
                code = 400 if isinstance(e, (MMError, ValueError, TypeError,
                                             KeyError)) else 500
                return self._json(code, {"error": f"{type(e).__name__}: {e}"})

    return Handler


def serve(port: int = 8723, host: str = "127.0.0.1",
          service: RenderService | None = None, block: bool = True):
    """Start the HTTP render service; returns (httpd, service)."""
    from http.server import ThreadingHTTPServer

    service = service or RenderService()
    httpd = ThreadingHTTPServer((host, port), make_handler(service))
    if block:
        try:
            httpd.serve_forever()
        finally:
            service.shutdown()
    return httpd, service


def main(argv=None):
    import argparse

    ap = argparse.ArgumentParser(
        description="mathmap_tpu production render service")
    ap.add_argument("--port", type=int, default=8723)
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--max-batch", type=int, default=32)
    ap.add_argument("--window-ms", type=float, default=4.0)
    ap.add_argument("--output-dtype", choices=("uint8", "float32"),
                    default="uint8",
                    help="render dtype for every dispatch (uint8 packs "
                         "on device, 4x less readback; float32 restores "
                         "raw float results for raw-format clients)")
    ap.add_argument("--cpu", action="store_true",
                    help="force the CPU backend (like preview --cpu)")
    ap.add_argument("--artifacts", default=None, metavar="PATH",
                    help="a .mmxa file or directory of them to serve as "
                         "precompiled programs ({'artifact': name} on "
                         "/render; GET /artifacts lists them)")
    args = ap.parse_args(argv)
    if args.cpu:
        import jax

        jax.config.update("jax_platforms", "cpu")
    svc = RenderService(max_batch=args.max_batch, window_ms=args.window_ms,
                        output_dtype=args.output_dtype)
    if args.artifacts:
        names = svc.load_artifacts(args.artifacts)
        print(f"loaded {len(names)} artifact(s): {', '.join(names)}")
    print(f"serving on http://{args.host}:{args.port}  "
          f"(max_batch={args.max_batch}, window={args.window_ms}ms)")
    serve(args.port, args.host, svc)


if __name__ == "__main__":
    main()
