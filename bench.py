"""Benchmark driver: the distortion suite and its secondary phases on one
GPU, printed as ONE JSON line on stdout (diagnostics go to stderr).

Metric: Mpix/s on the distortion suite (fisheye, twirl, pond — BASELINE
config 2 filters) at 4K with bilinear origVal sampling, inputs resident on
the device, fenced on device completion. vs_baseline: the ratio over a
measured C per-pixel CPU renderer (benchmarks/c_baseline/ — the
reference's cgen+gcc architecture reproduced for these filters) run on
this host; `c_threads` and `c_load_1min` record what that number got.

Secondary phases: a statically unrolled loop (lissajous), a 24-frame
ripple t-sweep in one program, the suite as param-varying batches of 8
(float and u8 in/out), a generative filter (moire) and pond at 8K.

Usage: python bench.py [--size WxH] [--iters N] [--quick]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "benchmarks"))

from device import best_time, require_gpu  # noqa: E402

SUITE = ("filters/Distorts/fisheye.mm", "filters/Distorts/twirl.mm",
         "filters/Distorts/pond.mm")
#: first slider of each suite filter, varied per job in the batched phases
#: (the suite ignores t, so a plain t-sweep would let XLA compute one frame
#: and replicate it)
BATCH_PARAM = {
    "filters/Distorts/fisheye.mm": ("strength", 2.0, 0.03),
    "filters/Distorts/twirl.mm": ("angle", 3.0, 0.05),
    "filters/Distorts/pond.mm": ("phase", 0.0, 0.07),
}


def _build(filter_path, w, h, opts):
    import mathmap_tpu as mm

    filt = mm.compile_file(filter_path)
    return filt, filt._renderer(w, h, opts, 1)


def time_frame(renderer, inputs, iters, t0=0.37):
    """Steady-state seconds per frame, inputs resident on the device (the
    reference's drawable lives in RAM next to its render loop); t moves
    per call so no two calls are the same program input."""
    import jax

    inputs = [jax.device_put(a) for a in inputs]
    return best_time(lambda i: renderer(inputs, {}, t=t0 + 1e-3 * i), iters)


def c_baseline(img, quick):
    """(Mpix/s, threads) of the C per-pixel renderer on this host, or the
    NumPy oracle as a stand-in (threads 0) when no C compiler exists."""
    import importlib.util

    import mathmap_tpu as mm

    spec = importlib.util.spec_from_file_location(
        "c_baseline_runner",
        os.path.join(os.path.dirname(os.path.abspath(__file__)),
                     "benchmarks", "c_baseline", "runner.py"))
    runner = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(runner)
    result = runner.measure(img if quick else img[:1080, :1920], iters=2)
    if result is not None:
        mpix, per, threads = result
        print(f"# C baseline: {mpix:.2f} Mpix/s on {threads} thread(s) "
              f"({', '.join(f'{k} {v:.1f}' for k, v in per.items())})",
              file=sys.stderr)
        return mpix, threads
    bw, bh = 480, 270
    filt = mm.compile_file(SUITE[0])
    start = time.perf_counter()
    filt.render(img[:bh, :bw], width=bw, height=bh, t=0.37, interpret=True)
    mpix = bw * bh / (time.perf_counter() - start) / 1e6
    print(f"# oracle stand-in baseline: {mpix:.2f} Mpix/s", file=sys.stderr)
    return mpix, 0


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--size", default="3840x2160")
    ap.add_argument("--iters", type=int, default=24)
    ap.add_argument("--quick", action="store_true", help="small size, 2 iters")
    args = ap.parse_args(argv)
    device = require_gpu()

    import jax

    import mathmap_tpu as mm

    if args.quick:
        w, h, iters = 960, 540, 2
    else:
        w, h = (int(v) for v in args.size.lower().split("x"))
        iters = args.iters
    opts = mm.RenderOptions(interpolation="bilinear")
    img = np.random.RandomState(42).rand(h, w, 4).astype(np.float32)
    img[..., 3] = 1.0
    img_u8 = mm.to_uint8(img)
    phase_times = {}
    t_phase = [time.perf_counter()]

    def mark(name):
        now = time.perf_counter()
        phase_times[name] = round(now - t_phase[0], 1)
        t_phase[0] = now

    built = [_build(path, w, h, opts) for path in SUITE]
    suite_dt = [time_frame(r, [img], iters) for _, r in built]
    for path, dt in zip(SUITE, suite_dt):
        print(f"# {path}: {dt * 1e3:.3f} ms/frame  {w * h / dt / 1e6:.1f} "
              f"Mpix/s", file=sys.stderr)
    value = float(np.mean([w * h / dt / 1e6 for dt in suite_dt]))
    mark("suite")

    load = os.getloadavg()[0]
    cpu_mpix, c_threads = c_baseline(img, args.quick)
    mark("c_baseline")

    _, r = _build("filters/Render/lissajous.mm", w, h, opts)
    dt = time_frame(r, [], iters)
    loop_mpix = w * h / dt / 1e6
    print(f"# lissajous (64-iter static unroll): {dt * 1e3:.3f} ms/frame",
          file=sys.stderr)
    mark("loop_unroll")

    # the production animation path: a t-sweep in ONE device program
    sw, sh = min(1920, w), min(1080, h)
    _, r = _build("filters/Distorts/ripple.mm", sw, sh, opts)
    n_sweep = 24 if not args.quick else 6
    ts = np.arange(n_sweep, dtype=np.float32) / n_sweep
    sweep_in = [jax.device_put(img[:sh, :sw])]
    best = best_time(lambda i: r.render_all_frames(sweep_in, {}, ts + 1e-3 * i),
                     1)
    sustained = sw * sh * n_sweep / best / 1e6
    print(f"# sustained (ripple {sw}x{sh} x{n_sweep} in one program): "
          f"{best / n_sweep * 1e3:.3f} ms/frame", file=sys.stderr)
    mark("sustained_ripple")

    # the suite as param-varying batches, the ONE image passed shared:
    # float in/out, then u8 in/out (the reference's 8-bit drawables)
    n_b = 8 if not args.quick else 3
    ts_b = (np.arange(n_b, dtype=np.float32) + 0.37) / n_b
    batched = {}
    for io, inp, o in (("f32", img, opts),
                       ("u8", img_u8, mm.RenderOptions(
                           interpolation="bilinear", output_dtype="uint8"))):
        dev = jax.device_put(inp)
        per = []
        for path, (filt, _) in zip(SUITE, built):
            pname, base, step = BATCH_PARAM[path]
            params = [{pname: base + step * i} for i in range(n_b)]
            rb = filt._renderer(w, h, o, 1)
            dt = best_time(lambda i, rb=rb, params=params: rb.render_batch(
                [dev], params, ts_b + 1e-3 * i, shared_mask=(True,)), 1) / n_b
            per.append(w * h / dt / 1e6)
            print(f"# {path} batched x{n_b} {io}: {dt * 1e3:.3f} ms/frame",
                  file=sys.stderr)
        batched[io] = float(np.mean(per))
    mark("suite_batched")

    _, r = _build("filters/Render/moire.mm", w, h, opts)
    dt = time_frame(r, [], iters)
    print(f"# moire (generative): {dt * 1e3:.3f} ms/frame", file=sys.stderr)
    mark("moire")

    pond8k_mpix = 0.0
    if not args.quick:
        w8, h8 = 2 * w, 2 * h
        _, r8 = _build("filters/Distorts/pond.mm", w8, h8, opts)
        dt8 = time_frame(r8, [np.tile(img, (2, 2, 1))], 8)
        pond8k_mpix = w8 * h8 / dt8 / 1e6
        print(f"# pond {w8}x{h8}: {dt8 * 1e3:.3f} ms/frame", file=sys.stderr)
    mark("pond_8k")

    print(json.dumps({
        "metric": ("distortion_suite_quick" if args.quick
                   else "distortion_suite_4k_bilinear"),
        "value": round(value, 2),
        "unit": "Mpix/s",
        "vs_baseline": round(value / cpu_mpix, 1) if cpu_mpix else 0.0,
        "c_baseline_mpix": round(cpu_mpix, 2),
        "c_threads": c_threads,
        "c_load_1min": round(load, 2),
        "sustained_ripple_mpix": round(sustained, 1),
        "suite_batched_mpix": round(batched["f32"], 1),
        "suite_u8io_mpix": round(batched["u8"], 1),
        "loop_unroll_mpix": round(loop_mpix, 1),
        "pond_8k_mpix": round(pond8k_mpix, 1),
        "phase_times_s": phase_times,
        "device": device,
    }))


if __name__ == "__main__":
    main()
