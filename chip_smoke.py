#!/usr/bin/env python3
"""Smoke test of the render path on one GPU, through the public entry points.

    python chip_smoke.py               # one GPU: phases 0-5
    python chip_smoke.py --four-cards  # four GPUs: the sharded paths only

Everything runs in ONE process: a JAX process reserves most of a card's
memory when it starts, so the CLI phase calls `mathmap_tpu.cli.main`
in-process and the HTTP service runs in a thread on port 0.

Phases (each prints one line: its max error against the reference, the
tolerance, its wall time):

  0 device   jax.devices()[0] must be a GPU; prints the card's name and
             power limit (nvidia-smi), the JAX version and XLA_FLAGS.
  1 suite    fisheye, twirl and pond at 3840x2160, bilinear, via
             Filter.render, against the NumPy oracle: float32 in/out
             (<= half an 8-bit step, and at most 0.2% of values beyond
             2e-4: XLA's transcendentals differ from NumPy's in the last
             bits, which moves a sample by up to ~1e-3 px at a 4K canvas
             rim) and uint8 in/out (<= 1 LSB).
  2 matrix   one render per path class at 512², <= 2e-4 (nearest: at
             most 0.5% of pixels may pick the neighbouring texel)
             (interpolation x edge,
             LUTs, noise, specials, static unroll, animated inputs, 4x AA,
             region, tiled halo on a 1-device mesh, render_batch x32,
             a 1080p render_animation, gaussian_blur) plus the selftest.
  3 loop     4K mandelbrot on the loop kernel ('auto') and on the
             lax.while_loop path ('off'); both against the oracle on a
             512² region (fraction rule: |Δiter| <= 1 near the escape
             boundary moves a whole gradient step); the kernel's compiled
             program must hold the Triton call.
  4 served   RenderService over HTTP (port 0): 8 concurrent 1080p PNG
             /render requests, uint8 out, bytes equal to Filter.render;
             an .mmxa exported here and served with load_artifacts.
  5 cli      cli.main on a PNG input vs the API render.

--four-cards runs only the sharded paths on 4 GPUs against one card:
ShardedRenderer on 1x4x1 and 2x2x1 meshes (8 frames of 4K twirl,
bitwise) and TiledRenderer rows=4 (4K pond, wrap/reflect edges, region;
<= 5e-5, the tiled route's rebased block coordinates).

The last line of stdout is one JSON object: {"ok": true, "device": {...}}.
Any failed phase exits 1 without it; no GPU, or no mathmap_tpu beside
this script, exits 2.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
import traceback

ROOT = os.path.dirname(os.path.abspath(__file__))
F32_TOL = 2e-4      # XLA vs NumPy transcendental rounding through a warp
# at 4K the same few-ulp angle differences move a sample by up to ~1e-3 px
# at the canvas rim (r ~ 2200 px), and a sharp edge in the image turns that
# into ~1e-3 of value: hold float32 output to half an 8-bit step, which
# keeps the quantized image within the 1-LSB bar of the uint8 run
F32_UHD_TOL = 0.5 / 255
F32_UHD_FRAC = 2e-3  # ...and at most this share of values beyond F32_TOL
NEAREST_FRAC = 5e-3  # nearest: share of pixels whose source coordinate
#                      sits within ulps of a texel boundary and may pick
#                      the neighbouring texel
ITER_FRAC = 0.02    # escape-time loops: share of pixels allowed to differ
TILED_TOL = 5e-5    # tiled route vs one card: per-block coordinate rebase

# sizes (width, height): what users render. A CPU rehearsal shrinks them.
UHD = (3840, 2160)
FHD = (1920, 1080)
MATRIX = 512        # the path matrix's square canvas
LOOP_REGION = (1600, 800, 512, 512)
BATCH = 32


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the sharded paths on 4 GPUs")
    return ap.parse_args(argv)


class Phases:
    """Runs named phases, prints one line each, never swallows a failure:
    a phase that raises or misses its tolerance makes the run fail."""

    def __init__(self):
        self.failed = []

    def run(self, name, fn):
        t0 = time.perf_counter()
        try:
            checks = fn()
        except Exception:  # noqa: BLE001 — reported, and fails the run
            traceback.print_exc()
            print(f"phase {name}: EXCEPTION wall={time.perf_counter() - t0:.1f}s",
                  flush=True)
            self.failed.append(name)
            return
        wall = time.perf_counter() - t0
        ok = all(c[3] for c in checks)

        def closeness(c):  # error as a share of its tolerance
            return c[1] / c[2] if c[2] else (0.0 if c[1] == 0 else 1e30)

        worst = (f"closest {w[0]}: err={w[1]:.3g} tol={w[2]:g}"
                 if (w := max(checks, key=closeness, default=None))
                 else "no checks")
        print(f"phase {name}: {len(checks)} checks, {worst}; "
              f"wall={wall:.1f}s {'OK' if ok else 'FAIL'}", flush=True)
        if not ok:
            for c in checks:
                print(f"    {c[0]}: err={c[1]:.4g} tol={c[2]:g} "
                      f"{'OK' if c[3] else 'FAIL'}", flush=True)
            self.failed.append(name)


def check(name, got, want, tol):
    import numpy as np

    got = np.asarray(got)
    want = np.asarray(want)
    if got.shape != want.shape:
        return (f"{name}[shape {got.shape} vs {want.shape}]", float("inf"),
                tol, False)
    d = np.abs(got.astype(np.float64) - want.astype(np.float64))
    err = float(d.max()) if d.size else 0.0
    return (name, err, tol, bool(np.isfinite(got.astype(np.float64)).all()
                                 and err <= tol))


def check_frac(name, got, want, tol, max_frac):
    """Share of pixels whose largest channel difference exceeds `tol`."""
    import numpy as np

    d = np.abs(np.asarray(got) - np.asarray(want)).max(-1)
    frac = float((d > tol).mean())
    return (name + "[frac]", frac, max_frac, frac <= max_frac)


def check_iter(name, got, want):
    return check_frac(name, got, want, 1e-2, ITER_FRAC)


def image(h, w, seed, frames=0):
    import numpy as np

    rs = np.random.RandomState(seed)
    shape = (frames, h, w, 4) if frames else (h, w, 4)
    # smooth structure plus noise: warps sample real gradients, not only
    # white noise
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    base = np.stack([0.5 + 0.5 * np.sin(xx / 37.0), 0.5 + 0.5 * np.cos(yy / 23.0),
                     ((xx // 64 + yy // 64) % 2).astype(np.float32),
                     np.ones_like(xx)], -1)
    a = 0.8 * base + 0.2 * rs.rand(*shape).astype(np.float32)
    a[..., 3] = 1.0
    return np.clip(a, 0.0, 1.0).astype(np.float32)


def to_u8(a):
    import numpy as np

    return (np.clip(a, 0, 1) * 255 + 0.5).astype(np.uint8)


def phase_device(jax):
    d = jax.devices()[0]
    if d.platform != "gpu":
        raise RuntimeError(f"device 0 is {d.platform!r}, not a GPU")
    try:
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        smi = f"nvidia-smi unavailable: {e}"
    print(f"card: {smi}", flush=True)
    print(f"jax {jax.__version__} devices={len(jax.devices())} "
          f"kind={d.device_kind!r} XLA_FLAGS={os.environ.get('XLA_FLAGS', '')!r}",
          flush=True)
    return []


def phase_suite(mm):
    import numpy as np

    W, H = UHD
    img = image(H, W, 1)
    img8 = to_u8(img)
    O = mm.RenderOptions
    out = []
    for name, t in (("fisheye", 0.0), ("twirl", 0.37), ("pond", 0.37)):
        f = mm.compile_file(os.path.join(ROOT, "filters", "Distorts",
                                         f"{name}.mm"))
        got = f.render(img, t=t)
        want = f.render(img, t=t, interpret=True)
        out.append(check(f"{name}/f32", got, want, F32_UHD_TOL))
        share = float((np.abs(got - want) > F32_TOL).mean())
        out.append((f"{name}/f32[share>{F32_TOL:g}]", share, F32_UHD_FRAC,
                    share <= F32_UHD_FRAC))
        print(f"    {name}/f32: share of values off by more than "
              f"{F32_TOL:g}: {share:.2e}", flush=True)
        o8 = O(output_dtype="uint8")
        got8 = f.render(img8, t=t, options=o8)
        want8 = f.render(img8, t=t, options=o8, interpret=True)
        assert got8.dtype == np.uint8, got8.dtype
        out.append(check(f"{name}/u8", got8, want8, 1))
    return out


def phase_matrix(mm):
    import numpy as np

    from mathmap_tpu.parallel.halo import TiledRenderer
    from mathmap_tpu.parallel.mesh import make_mesh
    from mathmap_tpu.selftest import run_selftest

    import jax

    S = MATRIX
    O = mm.RenderOptions
    img = image(S, S, 7)
    out = []

    def drive(name, src, tol, opts=None, inputs=(img,), t=0.0, params=None,
              iter_rule=False):
        f = (mm.compile_file(os.path.join(ROOT, "filters", src))
             if src.endswith(".mm") else mm.compile(src))
        ins = inputs if f.image_params else ()
        got = f.render(*ins, width=S, height=S, t=t, options=opts,
                       params=params)
        want = f.render(*ins, width=S, height=S, t=t, options=opts,
                        params=params, interpret=True)
        if iter_rule:
            out.append(check_iter(name, got, want))
        elif opts is not None and opts.interpolation == "nearest":
            out.append(check_frac(name, got, want, tol, NEAREST_FRAC))
        else:
            out.append(check(name, got, want, tol))

    warp = "origVal(xy + xy:[9 * sin(y / 23), 7 * cos(x / 19)] + xy:[0, t * 300])"
    for interp in ("nearest", "bilinear", "bicubic"):
        for edge in ("wrap", "reflect", "color"):
            drive(f"{interp}/{edge}", warp, F32_TOL,
                  O(interpolation=interp, edge_x=edge, edge_y=edge,
                    edge_color=(0.2, 0.4, 0.6, 1.0)), t=0.37)
    drive("twirl/bicubic", "Distorts/twirl.mm", F32_TOL,
          O(interpolation="bicubic"), t=0.8)
    drive("polar_invert", "Distorts/polar_invert.mm", F32_TOL)
    drive("aniso", "filter f (image in) in(xy * xy:[3, 1]) end", F32_TOL)
    drive("gradient_map/LUT", "Colors/gradient_map.mm", F32_TOL)
    drive("curve_adjust/LUT", "Colors/curve_adjust.mm", F32_TOL)
    drive("clouds/noise", "Noise/clouds.mm", F32_TOL, t=0.3)
    drive("elliptic_rings/specials", "Render/elliptic_rings.mm", F32_TOL)
    drive("newton/complex-loop", "Render/newton.mm", 0, iter_rule=True)
    drive("quat_julia/while", "Render/quat_julia.mm", 0, iter_rule=True)
    drive("lissajous/static-unroll", "Render/lissajous.mm", F32_TOL)
    drive("animated/origValXY", "origValXY(x, y, 1)", F32_TOL,
          O(interpolation="nearest"), inputs=(image(S, S, 9, frames=3),))
    drive("twirl/4xAA", "Distorts/twirl.mm", F32_TOL, O(supersample=2),
          t=0.8)
    drive("twirl/static-params", "Distorts/twirl.mm", F32_TOL,
          O(static_params=("angle",)), params={"angle": 2.5}, t=0.8)
    drive("sharpen/gaussian_blur", "Colors/sharpen.mm", F32_TOL)

    # region: oracle parity at an unaligned origin, and bitwise crop
    reg = (S // 5, S // 15, S // 2, S // 4)
    drive("twirl/region", "Distorts/twirl.mm", F32_TOL, O(region=reg), t=0.8)
    f = mm.compile_file(os.path.join(ROOT, "filters", "Distorts", "twirl.mm"))
    full = f.render(img, t=0.8)
    crop = f.render(img, t=0.8, options=O(region=reg))
    rx, ry, rw, rh = reg
    out.append(check("region/crop-bitwise", crop,
                     full[ry:ry + rh, rx:rx + rw], 0))

    # tiled/halo on a 1-device mesh: still ppermute + halo bookkeeping
    tsrc = "origVal(xy + xy:[6 * sin(y / 19), 5 * cos(x / 23 + t)])"
    tf = mm.compile(tsrc)
    topts = O(edge_x="wrap", edge_y="reflect")
    mesh1 = make_mesh(1, 1, 1, devices=jax.devices()[:1])
    tr = TiledRenderer(mesh1, tf.filters, tf.fdef, S, S, topts, 8)
    out.append(check("tiled-1dev/wrap-reflect", tr(img, t=0.3),
                     tf.render(img, t=0.3, options=topts, interpret=True),
                     F32_TOL))

    # render_batch 512² x32 against per-frame renders (jit vs jit)
    rf = mm.compile_file(os.path.join(ROOT, "filters", "Distorts",
                                      "ripple.mm"))
    stack = np.stack([image(S, S, 100 + i) for i in range(BATCH)])
    # t values off round fractions: a sample exactly on a texel boundary
    # may floor differently in two differently fused programs
    ts = (0.0317 + 0.0291 * np.arange(BATCH)).astype(np.float32)
    got = rf.render_batch(stack, ts=ts, frames=np.zeros(BATCH, np.float32))
    want = np.stack([rf.render(stack[i], t=float(ts[i]))
                     for i in range(BATCH)])
    out.append(check(f"render_batch/{BATCH}", got, want, F32_TOL))

    # 1080p render_animation of ripple, oracle on 3 frames
    anim_in = image(FHD[1], FHD[0], 11)
    n = 12
    frames = rf.render_animation(anim_in, num_frames=n)
    for i in (0, 5, 11):
        want = rf.render(anim_in, t=i / n, frame=float(i), interpret=True)
        out.append(check(f"animation-1080p/frame{i}", frames[i], want,
                         F32_TOL))

    failures = run_selftest(size=S)
    out.append(("selftest[failures]", float(failures), 0, failures == 0))
    return out


def phase_loop(mm):
    import numpy as np

    import jax

    W, H = UHD
    f = mm.compile_file(os.path.join(ROOT, "filters", "Render",
                                     "mandelbrot.mm"))
    params = {"maxiter": 256, "zoom": 1.3, "cx": -0.6, "cy": 0.1}
    out = []
    reg = LOOP_REGION
    rx, ry, rw, rh = reg
    want = f.render(width=W, height=H, params=params, interpret=True,
                    options=mm.RenderOptions(region=reg))
    times = {}
    for mode in ("auto", "off"):
        opts = mm.RenderOptions(pallas_while=mode)
        r = f._renderer(W, H, opts, 1)
        text = r.lower([], params).compile().as_text()
        has_triton = "__gpu$xla.gpu.triton" in text
        if mode == "auto":
            out.append(("kernel/triton-call", 0.0 if has_triton else 1.0, 0,
                        has_triton))
        else:
            out.append(("lax/no-triton-call", 1.0 if has_triton else 0.0, 0,
                        not has_triton))
        jax.block_until_ready(r([], params))  # compile + warm up
        reps = 5
        t0 = time.perf_counter()
        for _ in range(reps):
            res = r([], params)
        jax.block_until_ready(res)
        times[mode] = (time.perf_counter() - t0) / reps
        got = np.asarray(res)[ry:ry + rh, rx:rx + rw]
        out.append(check_iter(f"mandelbrot-4K/{mode}", got, want))
    print(f"    mandelbrot 4K maxiter=256: kernel {times['auto'] * 1e3:.2f} ms, "
          f"lax loop {times['off'] * 1e3:.2f} ms (wall per fenced render)",
          flush=True)
    return out


def phase_served(mm, workdir):
    import base64
    import threading
    import urllib.request

    import numpy as np

    from mathmap_tpu.generators.artifact import export_artifact
    from mathmap_tpu.imgio.images import to_uint8
    from mathmap_tpu.imgio.png import decode_png, encode_png
    from mathmap_tpu.serve import RenderService, serve

    W, H = FHD
    svc = RenderService(max_batch=8, window_ms=20.0)
    httpd, _ = serve(0, "127.0.0.1", svc, block=False)
    th = threading.Thread(target=httpd.serve_forever, daemon=True)
    th.start()
    port = httpd.server_address[1]
    out = []
    try:
        twirl_src = open(os.path.join(ROOT, "filters", "Distorts",
                                      "twirl.mm")).read()
        imgs = [to_u8(image(H, W, 200 + i)) for i in range(8)]
        angles = [0.5 + 0.4 * i for i in range(8)]

        def post(path, body):
            req = urllib.request.Request(
                f"http://127.0.0.1:{port}{path}",
                data=json.dumps(body).encode(),
                headers={"Content-Type": "application/json"})
            with urllib.request.urlopen(req, timeout=600) as resp:
                return resp.read(), dict(resp.headers)

        def body(i, **extra):
            b = {"inputs": [base64.b64encode(encode_png(imgs[i])).decode()],
                 "params": {"angle": angles[i]}, "format": "raw",
                 "binary": True}
            b.update(extra)
            return b

        post("/warmup", {"filter": {"source": twirl_src}, "width": W,
                         "height": H, "params": {"angle": 1.0},
                         "batch_sizes": [1, 2, 4, 8]})
        results = [None] * 8
        errors = []

        def client(i):
            try:
                results[i] = post("/render", body(
                    i, filter={"source": twirl_src}))
            except Exception as e:  # noqa: BLE001 — recorded, fails below
                errors.append(e)

        threads = [threading.Thread(target=client, args=(i,))
                   for i in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        if errors:
            raise errors[0]
        f = mm.compile(twirl_src)
        o8 = mm.RenderOptions(output_dtype="uint8")
        worst = 0.0
        same = True
        for i, (data, hdr) in enumerate(results):
            got = np.frombuffer(data, np.uint8).reshape(H, W, 4)
            want = f.render(imgs[i], options=o8,
                            params={"angle": angles[i]})
            same &= bool(np.array_equal(got, want))
            worst = max(worst, float(np.abs(got.astype(np.int16)
                                            - want.astype(np.int16)).max()))
        out.append(("served/8x1080p-bytes-equal", worst, 0, same))

        # an artifact exported on this card, served by the same service
        path = os.path.join(workdir, "twirl.mmxa")
        export_artifact(f, path, W, H, params={"angle": 1.0},
                        batch_sizes=(2,))
        names = svc.load_artifacts(path)
        req = body(3, artifact=names[0])
        del req["format"]  # the artifact renders float32: take the PNG
        data, _ = post("/render", req)
        got = decode_png(data)
        # the artifact normalizes u8 on the host; the same float input
        # through the live renderer is the same exported program
        f32_in = imgs[3].astype(np.float32) / np.float32(255.0)
        want = to_uint8(f.render(f32_in, params={"angle": angles[3]}))
        out.append(check("served/artifact", got, want, 0))
    finally:
        httpd.shutdown()
        httpd.server_close()
        svc.shutdown()
    return out


def phase_cli(mm, workdir):
    from mathmap_tpu import cli
    from mathmap_tpu.imgio.images import read_image, to_uint8, write_image

    src = os.path.join(workdir, "in.png")
    dst = os.path.join(workdir, "out.png")
    img = image(FHD[1] * 2 // 3, FHD[0] * 2 // 3, 300)
    write_image(src, img)
    rc = cli.main([os.path.join(ROOT, "filters", "Distorts", "pond.mm"),
                   src, dst, "--param", "amplitude=7", "--t", "0.37"])
    if rc not in (0, None):
        raise RuntimeError(f"cli.main returned {rc}")
    f = mm.compile_file(os.path.join(ROOT, "filters", "Distorts", "pond.mm"))
    want = to_uint8(f.render(read_image(src), t=0.37,
                             params={"amplitude": 7}))
    got = to_uint8(read_image(dst))
    return [check("cli/pond-png", got, want, 0)]


def phase_four_cards(mm):
    import numpy as np

    import jax

    from mathmap_tpu.parallel.halo import TiledRenderer
    from mathmap_tpu.parallel.mesh import make_mesh
    from mathmap_tpu.parallel.shard import ShardedRenderer

    devs = jax.devices()
    if len(devs) < 4:
        raise RuntimeError(f"--four-cards needs 4 GPUs, found {len(devs)}")
    devs = devs[:4]
    W, H = UHD
    out = []
    img = image(H, W, 5)
    tw = mm.compile_file(os.path.join(ROOT, "filters", "Distorts",
                                      "twirl.mm"))
    n = 8
    ts = (np.arange(n, dtype=np.float32) + 0.37) / n
    one = np.stack([tw.render(img, t=float(ts[i]), frame=float(i))
                    for i in range(n)])
    for shape in ((1, 4, 1), (2, 2, 1)):
        mesh = make_mesh(*shape, devices=devs)
        r = ShardedRenderer(mesh, tw.filters, tw.fdef, W, H,
                            mm.RenderOptions(), n)
        res = r([img], ts=ts)
        spread = len(res.sharding.device_set)
        out.append((f"sharded-{shape}/devices-missing", float(4 - spread), 0,
                    spread == 4))
        out.append(check(f"sharded-{shape}/8x4K-twirl-bitwise", res, one, 0))

    pond = mm.compile_file(os.path.join(ROOT, "filters", "Distorts",
                                        "pond.mm"))
    reg = (W // 5, H // 7, W // 2, H // 2)
    opts = mm.RenderOptions(edge_x="wrap", edge_y="reflect", region=reg)
    rows = make_mesh(1, 4, 1, devices=devs)
    tr = TiledRenderer(rows, pond.filters, pond.fdef, W, H, opts, "auto")
    res = tr(img, t=0.37)
    spread = len(res.sharding.device_set)
    out.append(("tiled-rows4/devices-missing", float(4 - spread), 0,
                spread == 4))
    got = np.asarray(res)
    ref = pond.render(img, t=0.37, options=opts)
    rx, ry, rw, rh = reg
    out.append(check("tiled-rows4/pond-region", got[ry:ry + rh, rx:rx + rw],
                     ref, TILED_TOL))
    mask = np.zeros((H, W, 1), bool)
    mask[ry:ry + rh, rx:rx + rw] = True
    out.append(check("tiled-rows4/pass-through", np.where(mask, img, got),
                     img, 0))
    return out


def main(argv=None) -> int:
    args = parse_args(argv)
    try:
        import jax

        import mathmap_tpu as mm
    except ImportError as e:
        print(f"chip_smoke: cannot import the program: {e}", file=sys.stderr)
        return 2
    if jax.devices()[0].platform != "gpu":
        print(f"chip_smoke: no GPU (jax found {jax.devices()[0].platform})",
              file=sys.stderr)
        return 2

    import tempfile

    phases = Phases()
    phases.run("0 device", lambda: phase_device(jax))
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as workdir:
        if args.four_cards:
            phases.run("4cards sharded+tiled", lambda: phase_four_cards(mm))
        else:
            phases.run("1 suite-4K", lambda: phase_suite(mm))
            phases.run("2 matrix", lambda: phase_matrix(mm))
            phases.run("3 loop", lambda: phase_loop(mm))
            phases.run("4 served", lambda: phase_served(mm, workdir))
            phases.run("5 cli", lambda: phase_cli(mm, workdir))
    if phases.failed:
        print(f"chip_smoke: FAILED phases: {phases.failed}", file=sys.stderr)
        return 1
    d = jax.devices()[0]
    print(json.dumps({"ok": True, "device": {
        "platform": d.platform, "kind": d.device_kind,
        "count": 4 if args.four_cards else len(jax.devices())}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
