"""Command-line renderer.

Reference: `mathmap_cmdline.c` (SURVEY.md §2.1 CLI row [unverified — mount
empty, SURVEY.md §0]): `mathmap [options] 'expression|file' in.png out.png`
with flags for size, frames, interpolation, edge behavior; multiple input
images as extra args; drives the same compile+render pipeline headless.

Usage:
    python -m mathmap_tpu 'expr or file.mm' [in.png ...] out.png \
        --size 512x512 --frames 1 --interpolation bilinear \
        --edge-x color --edge-y color --supersample \
        --param name=value --interpret --profile DIR --verbose

AOT artifacts (generators/artifact.py):
    python -m mathmap_tpu twirl --export-artifact tw.mmxa \
        --size 512x512 --param angle=3          # compile + serialize
    python -m mathmap_tpu tw.mmxa in.png out.png --param angle=5
                                                # render, no compiler
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

from .api import compile_file, compile_source
from .imgio.images import read_image, write_image
from .runtime.options import EDGE_BEHAVIORS, INTERPOLATIONS, RenderOptions
from .utils.errors import MMError


def build_arg_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="mathmap_tpu",
        description="MathMap renderer on JAX (CLI front end)",
    )
    p.add_argument("expression", nargs="?", default=None,
                   help="MathMap expression, path to a .mm/.mmc file, or a library filter name")
    p.add_argument("--list", action="store_true",
                   help="list the bundled filter library (expression database) and exit")
    p.add_argument("--selftest", action="store_true",
                   help="run the deployment acceptance sweep on the active "
                        "backend (each path class vs the NumPy oracle; "
                        "seconds) and exit 0/1")
    p.add_argument("--library", default=None, metavar="DIR",
                   help="scan DIR as the filter library instead of the bundled one")
    p.add_argument("--chain", default=None, metavar="SPEC",
                   help='compose library filters: "grayscale | twirl angle=4" '
                        "(used instead of the expression argument)")
    p.add_argument("--save-chain", default=None, metavar="FILE.mmc",
                   help="with --chain: also save the graph as a composer file")
    p.add_argument("images", nargs="*", help="input image(s)..., then the output image")
    p.add_argument("--size", default=None, help="output WxH (default: first input's size, else 512x512)")
    p.add_argument("--frames", type=int, default=1, help="number of animation frames")
    p.add_argument("--non-periodic", action="store_true", help="t = frame/(N-1) instead of frame/N")
    p.add_argument("--interpolation", choices=INTERPOLATIONS, default="bilinear")
    p.add_argument("--edge-x", choices=EDGE_BEHAVIORS, default="color")
    p.add_argument("--edge-y", choices=EDGE_BEHAVIORS, default="color")
    p.add_argument("--edge-color", default="0,0,0,0", help="RGBA floats for 'color' edge behavior")
    p.add_argument("--supersample", nargs="?", type=int, const=2, default=1,
                   metavar="N", help="NxN supersampling AA (default 2 when given bare)")
    p.add_argument("--supersample-scheme", choices=("grid", "corners"),
                   default="grid",
                   help="AA sample placement: s×s subpixel grid, or the "
                        "shared corner grid + pixel centers (5 samples/px "
                        "at ~2.07x one render — the scheme SURVEY §2.1 "
                        "suspects the reference uses)")
    p.add_argument("--output-dtype", choices=("float32", "uint8"),
                   default="float32",
                   help="uint8 packs the 8-bit output ON DEVICE (bit-"
                        "identical to the host pack) — 4x less "
                        "device->host transfer per frame")
    p.add_argument("--filter", dest="filter_name", default=None, help="filter name when the file defines several")
    p.add_argument("--param", action="append", default=[], metavar="NAME=VALUE", help="set a userval")
    p.add_argument("--static-params", default="", metavar="NAME[,NAME...]",
                   help="bake these uservals into the compiled program as "
                   "constants (recompiles per value; a baked int loop bound "
                   "statically unrolls its loop)")
    p.add_argument("--seed", type=int, default=0, help="rand() seed")
    p.add_argument("--pallas-while", choices=("auto", "on", "off"), default="auto",
                   help="per-pixel loop kernel for fractal loops (auto: on "
                        "a GPU, for large grids)")
    p.add_argument("--region", default=None, metavar="X,Y,WxH",
                   help="render only the (X, Y, WxH) sub-rectangle of the "
                        "canvas (GIMP-selection semantics: x/y/W/H/R and "
                        "input sampling keep the FULL canvas; the output "
                        "image is WxH). With --tiled the output is the "
                        "FULL canvas — the selection rendered in place, "
                        "unselected pixels passed through from the input "
                        "(the sharded-drawable semantics)")
    p.add_argument("--t", type=float, default=0.0, help="animation time for single-frame renders")
    p.add_argument("--interpret", action="store_true", help="use the NumPy oracle interpreter")
    p.add_argument("--fallback", action="store_true",
                   help="fall back to the interpreter if the jit path fails")
    p.add_argument("--resume", action="store_true", help="skip animation frames whose output file exists")
    p.add_argument("--batch", action="store_true",
                   help="render all animation frames in ONE device program (lax.map)")
    p.add_argument("--fps", type=float, default=25.0, help="GIF animation frame rate")
    p.add_argument("--sharded", action="store_true",
                   help="shard the render across all local devices (mesh over grid rows)")
    p.add_argument("--tiled", action="store_true",
                   help="shard the INPUT across devices with halo exchange "
                        "(parallel/halo.py) — for inputs too large to "
                        "replicate; requires a bounded source displacement")
    p.add_argument("--halo", default="auto",
                   help="tiled-mode halo: rows, rows,cols, or 'auto' "
                        "(infer the displacement bound from the filter)")
    p.add_argument("--input-dir", default=None, metavar="DIR",
                   help="batch mode: apply the filter to every image in DIR "
                        "(same-geometry images render N per device dispatch "
                        "via render_batch); the output argument is a "
                        "directory")
    p.add_argument("--batch-size", type=int, default=16,
                   help="images per device dispatch in --input-dir mode")
    p.add_argument("--export-artifact", default=None, metavar="FILE.mmxa",
                   help="compile + serialize the filter as an AOT artifact "
                        "at --size geometry instead of rendering (--param "
                        "names become the artifact's runtime inputs; "
                        "--frames N also ships the N-frame animation "
                        "program). Render one with: mathmap_tpu FILE.mmxa "
                        "in.png out.png")
    p.add_argument("--artifact-batch-sizes", default="", metavar="N[,N...]",
                   help="with --export-artifact: also ship the batched "
                        "render_batch programs at these sizes")
    p.add_argument("--param-sweep", default=None, metavar="NAME=LO:HI",
                   help="animate a numeric param over --frames steps "
                        "(t stays --t; the `frame` internal is the step "
                        "index) in ONE device program, the input image "
                        "passed SHARED to every step. Output: GIF or a "
                        "frame sequence, like --frames")
    p.add_argument("--profile", default=None, metavar="DIR", help="write a jax.profiler trace to DIR")
    p.add_argument("--stats", action="store_true", help="print one JSON line of render statistics")
    p.add_argument("--verbose", "-v", action="store_true", help="print per-phase timing and render stats")
    return p


def _parse_params(items):
    params = {}
    for item in items:
        if "=" not in item:
            raise SystemExit(f"--param expects NAME=VALUE, got {item!r}")
        name, value = item.split("=", 1)
        try:
            params[name] = json.loads(value)
        except json.JSONDecodeError:
            params[name] = value
    return params


def _parse_halo(spec):
    if spec == "auto":
        return "auto"
    parts = [s.strip() for s in str(spec).split(",")]
    try:
        vals = [int(s) for s in parts]
    except ValueError:
        raise SystemExit(f"--halo expects an int, 'rows,cols', or 'auto'; "
                         f"got {spec!r}")
    return vals[0] if len(vals) == 1 else (vals[0], vals[1])


def _sweep_ts(args):
    import numpy as np

    denom = (args.frames if not args.non_periodic
             else max(args.frames - 1, 1))
    return np.arange(args.frames, dtype=np.float32) / denom


def _region_inplace(crop, inputs, opts, frame=0.0):
    """Host-side twin of render_tiled's in-place region semantics
    (parallel/halo.render_frame_tiled) for the oracle/fallback path:
    full canvas out, the selection replaced by `crop`, every other pixel
    passed through from input 0's current frame. Keeps `--tiled
    --region`'s full-canvas output contract when --interpret/--fallback
    route the render through the single-chip engine (review r5: the
    shape/semantics silently changed to a crop there)."""
    import numpy as np

    if not inputs:
        from .utils.errors import MMRuntimeError

        raise MMRuntimeError(
            "region on the tiled path needs at least one input: input 0 "
            "is the drawable whose unselected pixels pass through")
    rx, ry, rw, rh = opts.region
    bg = np.asarray(inputs[0])
    if bg.ndim == 4:  # animated drawable: current-frame rule
        fi = int(np.clip(np.floor(float(frame) + 0.5), 0, bg.shape[0] - 1))
        bg = bg[fi]
    crop = np.asarray(crop)
    if crop.dtype == np.uint8 and bg.dtype != np.uint8:
        from .imgio.images import to_uint8

        bg = to_uint8(bg)
    elif crop.dtype != np.uint8 and bg.dtype == np.uint8:
        bg = bg.astype(np.float32) / 255.0
    out = bg.copy()
    out[ry:ry + rh, rx:rx + rw] = crop
    return out


def _render_sweep(args, filt, inputs, width, height, opts, params):
    """All animation frames as one (F, H, W, 4) array, honoring the flags
    the one-program path cannot: --interpret/--fallback render each frame
    through the oracle/fallback, --sharded runs the frame sweep on the
    device mesh (review r3: these flags were silently ignored for
    multi-frame runs)."""
    import numpy as np

    if args.interpret or args.fallback:
        ts = _sweep_ts(args)
        frames = [
            np.asarray(filt.render(
                *inputs, width=width, height=height, t=float(t),
                frame=float(i), options=opts, params=params,
                interpret=args.interpret,
                on_error="interpret" if args.fallback else "raise"))
            for i, t in enumerate(ts)]
        if args.tiled and getattr(opts, "region", None) is not None:
            frames = [_region_inplace(f, inputs, opts, frame=float(i))
                      for i, f in enumerate(frames)]
        return np.stack(frames)
    if args.tiled:
        # one TiledRenderer program (cached per geometry), F executions;
        # frame tracks the sweep so animated inputs map frame i -> output
        # frame i like every other sweep path. Inputs upload ONCE — the
        # per-call path would re-ship the whole (possibly animated) stack
        # host->device every frame (review finding)
        import jax

        inputs = [jax.device_put(np.asarray(a, np.float32))
                  for a in inputs]
        return np.stack([
            np.asarray(filt.render_tiled(
                *inputs, halo=_parse_halo(args.halo), width=width,
                height=height, options=opts, params=params, t=float(t),
                frame=float(i)))
            for i, t in enumerate(_sweep_ts(args))])
    if args.sharded:
        return np.asarray(filt.render_sharded(
            *inputs, num_frames=args.frames, width=width, height=height,
            options=opts, params=params))
    return np.asarray(filt.render_animation(
        *inputs, num_frames=args.frames, width=width, height=height,
        options=opts, params=params))


def _parse_param_sweep(spec, filt, n):
    """NAME=LO:HI -> (name, [n values LO..HI]). int params round each
    step; non-numeric params are rejected (a sweep needs an axis)."""
    name, _, rng = spec.partition("=")
    lo_s, _, hi_s = rng.partition(":")
    if not (name and lo_s and hi_s):
        raise SystemExit(f"--param-sweep expects NAME=LO:HI, got {spec!r}")
    try:
        lo, hi = float(lo_s), float(hi_s)
    except ValueError:
        raise SystemExit(f"--param-sweep expects numeric LO:HI, got {spec!r}")
    kinds = {p.name: p.kind for p in filt.params}
    if name not in kinds:
        raise SystemExit(f"--param-sweep: filter has no param {name!r} "
                         f"(has: {', '.join(sorted(kinds)) or 'none'})")
    if kinds[name] not in ("float", "int"):
        raise SystemExit(f"--param-sweep: param {name!r} is "
                         f"{kinds[name]!r}; only float/int params sweep")
    if n < 2:
        raise SystemExit("--param-sweep needs --frames >= 2 (the number "
                         "of sweep steps)")
    vals = [lo + (hi - lo) * i / (n - 1) for i in range(n)]
    if kinds[name] == "int":
        # half-UP, not round()'s half-to-even: banker's rounding makes a
        # linear slider sweep cluster at .5 midpoints (0,2,2,4,4...)
        import math

        vals = [int(math.floor(v + 0.5)) for v in vals]
    return name, vals


def _run_param_sweep(args, filt, inputs, width, height, opts, params):
    """--param-sweep: N jobs over ONE shared input in one render_batch
    program (the parameter-animation workload; the reference only animates
    t — its users keyframed sliders by re-invoking the plugin
    [unverified — mount empty])."""
    import numpy as np

    from .api import shared

    name, vals = _parse_param_sweep(args.param_sweep, filt, args.frames)
    if (args.interpret or args.fallback or args.sharded or args.tiled
            or args.input_dir is not None or args.batch):
        raise SystemExit("--param-sweep runs the one-program batch path; "
                         "it does not combine with --interpret/--fallback/"
                         "--sharded/--tiled/--input-dir/--batch")
    n = args.frames
    return np.asarray(filt.render_batch(
        *[shared(a) for a in inputs],
        ts=np.full(n, args.t, np.float32),
        frames=np.arange(n, dtype=np.float32),
        width=width, height=height, options=opts,
        params=[{**params, name: v} for v in vals]))


def _frame_path(path: str, frame: int, num_frames: int) -> str:
    if num_frames == 1:
        return path
    root, ext = os.path.splitext(path)
    return f"{root}_{frame:04d}{ext or '.png'}"


def _run_batch_dir(args, filt, out_dir, width, height, opts, params, log):
    """--input-dir mode: render every image in a directory through
    render_batch (same-geometry images grouped, `--batch-size` frames per
    fenced device dispatch — the production batch workflow the reference
    covered with shell loops over mathmap_cmdline invocations
    [unverified — mount empty]). Returns the number of frames written."""
    import numpy as np

    from .imgio.images import read_image, write_image

    exts = (".png", ".jpg", ".jpeg", ".ppm", ".pam", ".pnm", ".bmp", ".tif",
            ".tiff", ".webp")
    names = sorted(n for n in os.listdir(args.input_dir)
                   if n.lower().endswith(exts))
    if not names:
        raise SystemExit(f"--input-dir: no images found in {args.input_dir}")
    os.makedirs(out_dir, exist_ok=True)
    # group by geometry (header-only reads — a big folder must not be
    # decoded into RAM all at once); one compiled program per (H, W)
    from .imgio.images import image_size

    groups: dict = {}
    for n in names:
        w, h = image_size(os.path.join(args.input_dir, n))
        groups.setdefault((h, w), []).append(n)
    done = 0
    for (h, w), group in groups.items():
        ow, oh = width or w, height or h
        log(f"batch group {w}x{h}: {len(group)} image(s) -> {ow}x{oh}")
        if args.resume:
            # skip-before-render: a resumed job must not re-render done
            # images just to skip their writes (review r3)
            group = [n for n in group if not os.path.exists(
                os.path.join(out_dir, os.path.splitext(n)[0] + ".png"))]
        if args.interpret or args.fallback:
            # the batched device path cannot run the oracle — honor the
            # flags with per-image renders (review r3: silently ignored)
            for n in group:
                img_n = read_image(os.path.join(args.input_dir, n))
                out = filt.render(
                    img_n, width=ow, height=oh, t=args.t, options=opts,
                    params=params, interpret=args.interpret,
                    on_error="interpret" if args.fallback else "raise")
                write_image(os.path.join(
                    out_dir, os.path.splitext(n)[0] + ".png"), out)
                done += 1
            continue
        for start in range(0, len(group), max(1, args.batch_size)):
            chunk = group[start:start + max(1, args.batch_size)]
            stack = np.stack([
                read_image(os.path.join(args.input_dir, n)) for n in chunk])
            outs = filt.render_batch(stack, ts=[args.t] * len(chunk),
                                     # frame=0 for every image, like a lone
                                     # render (the default arange is for
                                     # t-sweeps — a frame-reading filter
                                     # must not vary with chunk position)
                                     frames=np.zeros(len(chunk), np.float32),
                                     width=ow, height=oh, options=opts,
                                     params=params)
            for n, frame in zip(chunk, outs):
                # outputs are RGBA: always write PNG (a .jpg input name
                # would make PIL reject the alpha channel)
                path = os.path.join(out_dir, os.path.splitext(n)[0] + ".png")
                if args.resume and os.path.exists(path):
                    continue
                write_image(path, frame)
                done += 1
    return done


def _run_artifact(args, input_paths, out_path, verbose, log) -> int:
    """Render from a precompiled .mmxa (no parser/tracer/compile): single
    frame by default; --frames matching the exported animation program
    runs the whole-sweep dispatch (GIF out or a frame sequence)."""
    from .generators.artifact import load_artifact

    t0 = time.perf_counter()
    try:
        art = load_artifact(args.expression)
    except (ValueError, OSError) as exc:
        print(exc, file=sys.stderr)
        return 1
    m = art.manifest
    log(f"loaded {args.expression}: filter {m['filter']!r} "
        f"{m['width']}x{m['height']}, params {sorted(m['params'])}, "
        f"load {time.perf_counter() - t0:.3f}s")
    inputs = [read_image(p) for p in input_paths]
    params = _parse_params(args.param)
    try:
        t1 = time.perf_counter()
        if args.frames > 1:
            if m.get("anim_frames") != args.frames:
                raise SystemExit(
                    f"artifact has {'no' if not m.get('anim_frames') else m['anim_frames']}-frame "
                    f"animation program; re-export with --frames "
                    f"{args.frames} (got --frames {args.frames})")
            frames = art.render_animation(*inputs, params=params)
            if out_path.lower().endswith(".gif"):
                from .imgio.images import write_animation

                write_animation(out_path, frames, fps=args.fps)
            else:
                for i, fr in enumerate(frames):
                    write_image(_frame_path(out_path, i, len(frames)), fr)
            n = len(frames)
        else:
            out = art.render(*inputs, params=params, t=args.t)
            write_image(out_path, out)
            n = 1
        dt = time.perf_counter() - t1
        log(f"render: {dt:.3f}s  {n} frame(s)  "
            f"{n * m['width'] * m['height'] / max(dt, 1e-9) / 1e6:.2f} Mpix/s")
    except ValueError as exc:
        print(exc, file=sys.stderr)
        return 1
    return 0


def main(argv=None) -> int:
    args = build_arg_parser().parse_args(argv)
    if args.tiled and args.sharded:
        raise SystemExit("--tiled (input-sharded) and --sharded "
                         "(output-sharded) are mutually exclusive")
    region = None
    if args.region is not None:
        if args.sharded:
            raise SystemExit(
                "--region cannot be combined with --sharded (an output-"
                "sharded region IS a tile); use --tiled for the sharded-"
                "drawable selection semantics, or render single-chip")
        try:
            parts = args.region.split(",")
            if len(parts) != 3 or "x" not in parts[2].lower():
                raise ValueError
            rx, ry = int(parts[0]), int(parts[1])
            rw, rh = (int(v) for v in parts[2].lower().split("x"))
            # validate here, not in RenderOptions.__post_init__: int('-1')
            # parses fine, and an opts-construction ValueError would be an
            # uncaught traceback instead of the CLI's one-line errors
            if rx < 0 or ry < 0 or rw < 1 or rh < 1:
                raise ValueError
            region = (rx, ry, rw, rh)
        except ValueError:
            raise SystemExit(
                f"--region wants X,Y,WxH (X,Y >= 0; W,H >= 1; "
                f"e.g. 100,50,640x480); got {args.region!r}")
    verbose = args.verbose

    def log(msg):
        if verbose:
            print(msg, file=sys.stderr)

    def get_db():
        from .expression_db import ExpressionDB, default_db

        return ExpressionDB.scan(args.library) if args.library else default_db()

    if args.selftest:
        from .selftest import run_selftest

        size = 128
        if args.size:
            # same parsing rule as the render path (line ~357): lowercase,
            # both dims; the selftest sweep is square-only, so reject a
            # non-square request instead of silently dropping the height
            dims = [int(v) for v in args.size.lower().split("x")]
            if len(dims) == 1:
                dims = dims * 2
            if len(dims) != 2 or dims[0] != dims[1]:
                raise SystemExit(
                    "--selftest runs square renders; use --size NxN")
            size = dims[0]
        return 1 if run_selftest(size=size, verbose=verbose) else 0

    if args.list:
        db = get_db()
        print(db.tree())
        for path, err in db.errors:
            print(f"# skipped {path}: {err}", file=sys.stderr)
        return 0

    if args.expression is None and args.chain is None:
        raise SystemExit("missing expression (or use --list / --chain)")
    if args.chain is not None and args.expression is not None:
        args.images.insert(0, args.expression)  # expression slot was an image
    if not args.images and not args.export_artifact:
        raise SystemExit("missing output image path")
    if args.export_artifact:
        input_paths, out_path = args.images, None
    else:
        *input_paths, out_path = args.images

    if args.expression and args.expression.endswith(".mmxa"):
        if args.export_artifact:
            raise SystemExit(
                "cannot --export-artifact from a .mmxa (artifacts carry "
                "no filter source); export from the .mm source instead")
        return _run_artifact(args, input_paths, out_path, verbose, log)

    t0 = time.perf_counter()
    try:
        if args.chain is not None:
            from .designer.graph import from_pipeline

            graph = from_pipeline(args.chain, db=get_db())
            if args.save_chain:
                graph.save(args.save_chain)
            filt = graph.compile()
        elif args.expression.endswith(".mmc"):
            # composer graph -> composite source (SURVEY §3.4)
            from .designer.graph import load_mmc

            graph = load_mmc(args.expression, db=get_db())
            filt = graph.compile()
        elif args.expression.endswith(".mm") or os.path.exists(args.expression):
            filt = compile_file(args.expression, main=args.filter_name)
        else:
            db = get_db()
            if args.expression in db.entries:
                filt = db.compile(args.expression)  # library filter by name
            else:
                filt = compile_source(args.expression, main=args.filter_name)
    except MMError as exc:
        print(exc.format(), file=sys.stderr)
        return 1
    log(f"parse: {time.perf_counter() - t0:.3f}s  (filter {filt.name!r})")

    def read_input(p):
        if p.lower().endswith(".gif"):
            # multi-frame GIFs become ANIMATED inputs ((T,H,W,4) stacks —
            # origValXY(x,y,frame) / current-frame sampling); single-frame
            # GIFs stay plain images
            from .imgio.images import read_animation

            stack = read_animation(p)
            return stack if stack.shape[0] > 1 else stack[0]
        return read_image(p)

    inputs = [read_input(p) for p in input_paths]
    width = height = None
    if args.size:
        # one-line errors for malformed sizes, same treatment as --region
        # (review r5: '--size 512' raised a raw unpacking traceback)
        try:
            dims = [int(v) for v in args.size.lower().split("x")]
            if len(dims) == 1:
                dims = dims * 2  # square shorthand, like --selftest
            width, height = dims
            if width < 1 or height < 1:
                raise ValueError
        except ValueError:
            raise SystemExit(
                f"--size wants WxH (or one N for NxN); got {args.size!r}")

    try:
        edge_color = tuple(float(c) for c in args.edge_color.split(","))
    except ValueError:
        raise SystemExit(
            f"--edge-color wants comma-separated floats (R,G,B[,A]); "
            f"got {args.edge_color!r}")
    try:
        opts = RenderOptions(
            interpolation=args.interpolation,
            edge_x=args.edge_x,
            edge_y=args.edge_y,
            edge_color=edge_color,
            supersample=args.supersample,
            supersample_scheme=args.supersample_scheme,
            output_dtype=args.output_dtype,
            periodic=not args.non_periodic,
            seed=args.seed,
            pallas_while=args.pallas_while,
            static_params=tuple(n.strip()
                                for n in args.static_params.split(",")
                                if n.strip()),
            region=region,
        )
    except ValueError as exc:
        # RenderOptions validates everything else (edge_color arity,
        # supersample range, ...) — print its message, not a traceback
        raise SystemExit(str(exc))
    params = _parse_params(args.param)

    if region is not None:
        # one-line bounds error here (the renderer raises the same check
        # as a ValueError deep in a traceback); canvas defaulting goes
        # through the API's own _resolve_size so the two checks can never
        # disagree if the defaulting rule changes
        cw, ch = filt._resolve_size(inputs, width, height)
        if region[0] + region[2] > cw or region[1] + region[3] > ch:
            print(f"--region {args.region} exceeds the {cw}x{ch} canvas",
                  file=sys.stderr)
            return 1

    if args.export_artifact:
        from .generators.artifact import export_artifact

        w = width or (inputs[0].shape[-2] if inputs else 512)
        h = height or (inputs[0].shape[-3] if inputs else 512)
        bs = tuple(int(x) for x in args.artifact_batch_sizes.split(",")
                   if x.strip())
        try:
            export_artifact(
                filt, args.export_artifact, int(w), int(h), options=opts,
                params=params, batch_sizes=bs,
                anim_frames=args.frames if args.frames > 1 else None)
        except MMError as exc:
            print(exc.format(), file=sys.stderr)
            return 1
        log(f"exported {args.export_artifact}: {int(w)}x{int(h)}, "
            f"params {sorted(params)}, batch_sizes {list(bs)}, "
            f"anim_frames {args.frames if args.frames > 1 else None}")
        return 0

    profile_ctx = None
    if args.profile:
        import jax

        jax.profiler.start_trace(args.profile)
        profile_ctx = True

    try:
        t1 = time.perf_counter()
        if args.param_sweep is not None:
            # dispatched FIRST so its flag-combination guard fires even
            # with --input-dir (which would otherwise silently win)
            frames = _run_param_sweep(args, filt, inputs, width, height,
                                      opts, params)
            if out_path.lower().endswith(".gif"):
                from .imgio.images import write_animation

                write_animation(out_path, frames, fps=args.fps)
            else:
                for i in range(args.frames):
                    write_image(_frame_path(out_path, i, args.frames),
                                frames[i])
            frames_done = args.frames
        elif args.input_dir is not None:
            frames_done = _run_batch_dir(args, filt, out_path, width, height,
                                         opts, params, log)
        elif args.frames <= 1 and args.tiled and not (args.interpret
                                                      or args.fallback):
            out = filt.render_tiled(
                *inputs, halo=_parse_halo(args.halo), width=width,
                height=height, options=opts, params=params, t=args.t,
            )
            write_image(out_path, out)
            frames_done = 1
        elif args.frames <= 1 and args.sharded and not (args.interpret
                                                        or args.fallback):
            out = filt.render_sharded(
                *inputs, width=width, height=height, t=args.t,
                options=opts, params=params,
            )
            write_image(out_path, out)
            frames_done = 1
        elif args.frames <= 1:
            out = filt.render(
                *inputs, width=width, height=height, t=args.t,
                options=opts, params=params, interpret=args.interpret,
                on_error="interpret" if args.fallback else "raise",
            )
            if args.tiled and getattr(opts, "region", None) is not None:
                # --tiled --region through --interpret/--fallback keeps
                # the tiled contract: full canvas, selection in place
                out = _region_inplace(out, inputs, opts, frame=0.0)
            write_image(out_path, out)
            frames_done = 1
        elif out_path.lower().endswith(".gif"):
            from .imgio.images import write_animation

            frames = _render_sweep(args, filt, inputs, width, height, opts,
                                   params)
            write_animation(out_path, frames, fps=args.fps)
            frames_done = args.frames
        elif args.batch:
            frames = _render_sweep(args, filt, inputs, width, height, opts,
                                   params)
            frames_done = 0
            for i in range(args.frames):
                path = _frame_path(out_path, i, args.frames)
                if args.resume and os.path.exists(path):
                    continue
                write_image(path, frames[i])
                frames_done += 1
        elif args.interpret or args.fallback or args.sharded or args.tiled:
            # per-frame loop honoring the oracle/fallback/mesh/tiled flags,
            # with frame-granular resume BEFORE each render (--tiled was
            # previously only routed for GIF/--batch sweeps: a PNG-sequence
            # sweep silently fell through to the replicated render_frames
            # path — review finding)
            frames_done = 0
            loop_inputs = inputs
            if args.tiled and not (args.interpret or args.fallback):
                import jax
                import numpy as np

                # upload once; every tiled frame reuses the device copies
                loop_inputs = [jax.device_put(np.asarray(a, np.float32))
                               for a in inputs]
            for i, t in enumerate(_sweep_ts(args)):
                path = _frame_path(out_path, i, args.frames)
                if args.resume and os.path.exists(path):
                    continue
                if args.interpret or args.fallback:
                    frame = filt.render(
                        *inputs, width=width, height=height, t=float(t),
                        frame=float(i), options=opts, params=params,
                        interpret=args.interpret,
                        on_error="interpret" if args.fallback else "raise")
                elif args.tiled:
                    frame = filt.render_tiled(
                        *loop_inputs, halo=_parse_halo(args.halo),
                        width=width, height=height, t=float(t),
                        frame=float(i), options=opts, params=params)
                elif args.sharded:
                    frame = filt.render_sharded(
                        *inputs, width=width, height=height, t=float(t),
                        options=opts, params=params)
                write_image(path, frame)
                frames_done += 1
        else:
            frames_done = 0
            for i, frame in enumerate(
                filt.render_frames(
                    *inputs, num_frames=args.frames, width=width, height=height,
                    options=opts, params=params,
                )
            ):
                path = _frame_path(out_path, i, args.frames)
                if args.resume and os.path.exists(path):
                    continue  # frame-granular resume (SURVEY §5 checkpoint row)
                write_image(path, frame)
                frames_done += 1
        dt = time.perf_counter() - t1
        if verbose:
            h = height or (inputs[0].shape[-3] if inputs else 512)
            w = width or (inputs[0].shape[-2] if inputs else 512)
            mpix = frames_done * h * w / 1e6
            log(f"render: {dt:.3f}s  {frames_done} frame(s)  {mpix / dt:.2f} Mpix/s")
        if args.stats:
            from .utils.log import RenderStats

            stats = RenderStats(
                width=width or (inputs[0].shape[-2] if inputs else 512),
                height=height or (inputs[0].shape[-3] if inputs else 512),
                frames=frames_done, parse_s=t1 - t0, render_s=dt,
            )
            print(stats.to_json())
    except MMError as exc:
        print(exc.format(), file=sys.stderr)
        return 1
    finally:
        if profile_ctx:
            import jax

            jax.profiler.stop_trace()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
