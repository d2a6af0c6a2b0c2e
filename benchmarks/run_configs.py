"""Benchmark driver for the five BASELINE.json configs (SURVEY.md §6).

Prints one JSON object per config plus a summary line. Runs on one GPU:

    python benchmarks/run_configs.py [--quick]

Configs (BASELINE.json `configs`):
  1. pointwise color filter (invert) on 512x512 RGBA
  2. polar distortions (fisheye, twirl, pond) at 1080p, bilinear origVal
  3. two-input compositing (blend) with edge-behavior variants at 1080p
  4. animated ripple: 120-frame t-sweep at 1080p with 4x supersampling AA
  5. generative complex-math (mandelbrot, moire) at 4K
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

_repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, _repo)
sys.path.insert(0, os.path.join(_repo, "benchmarks"))

import mathmap_tpu as mm  # noqa: E402
from device import best_time, require_gpu  # noqa: E402


def _img(h, w, seed=0):
    img = np.random.RandomState(seed).rand(h, w, 4).astype(np.float32)
    img[..., 3] = 1.0
    return img


def time_filter(path_or_src, inputs, w, h, opts, iters, from_file=True):
    import jax

    filt = mm.compile_file(path_or_src) if from_file else mm.compile_source(path_or_src)
    renderer = filt._renderer(w, h, opts, 1)
    ins = [jax.device_put(np.asarray(a)) for a in inputs]
    return best_time(lambda i: renderer(ins, {}, t=0.37 + 0.001 * i), iters)


def batch_time(renderer, stacks, ts):
    """Best-of-3 seconds per render_batch dispatch of `stacks` (leading
    batch axis)."""
    return best_time(lambda i: renderer.render_batch(stacks, {},
                                                     ts + 0.001 * i), 1)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--quick", action="store_true")
    args = ap.parse_args()
    device = require_gpu()
    it = 8
    results = []

    root = os.path.join(_repo, "filters")

    def report(config, mpix_s, detail):
        rec = {"config": config, "mpix_per_s": round(mpix_s, 2), **detail}
        results.append(rec)
        print(json.dumps(rec), flush=True)

    # 1. pointwise 512x512 — measured through the batched product entry
    # (render_batch: N independent frames per dispatch), the same way
    # config 4 measures animation; the unbatched single-frame number is
    # kept as detail.
    import jax

    w, h = 512, 512
    nb = 8 if args.quick else 32
    filt = mm.compile_file(os.path.join(root, "Colors", "invert.mm"))
    renderer = filt._renderer(w, h, mm.RenderOptions(), 1)
    batch = jax.device_put(np.stack([_img(h, w, seed=i) for i in range(nb)]))
    best = batch_time(renderer, [batch], np.zeros(nb, np.float32))
    dt1 = time_filter(os.path.join(root, "Colors", "invert.mm"), [_img(h, w)], w, h,
                      mm.RenderOptions(), it)
    report("1_pointwise_invert_512", nb * w * h / best / 1e6,
           {"batch": nb, "ms_per_batch": round(best * 1e3, 2),
            "ms_per_frame_unbatched": round(dt1 * 1e3, 2),
            "mpix_per_s_per_frame": round(w * h / dt1 / 1e6, 2)})

    # 2. polar distortions 1080p — per frame (headline) plus 16 frames per
    # dispatch via render_batch
    w, h = 1920, 1080
    times = {}
    batched = {}
    nb2 = 4 if args.quick else 16
    for name in ("fisheye", "twirl", "pond"):
        path = os.path.join(root, "Distorts", f"{name}.mm")
        dt = time_filter(path, [_img(h, w)], w, h,
                         mm.RenderOptions(interpolation="bilinear"), it)
        times[name] = round(dt * 1e3, 2)
        filt = mm.compile_file(path)
        r = filt._renderer(w, h, mm.RenderOptions(interpolation="bilinear"), 1)
        stack = jax.device_put(np.stack([_img(h, w, seed=i) for i in range(nb2)]))
        ts2 = (np.arange(nb2, dtype=np.float32) + 0.37) / nb2
        best = batch_time(r, [stack], ts2)
        batched[name] = round(best / nb2 * 1e3, 2)
    mean_dt = sum(times.values()) / len(times) / 1e3
    mean_b = sum(batched.values()) / len(batched) / 1e3
    report("2_polar_distortions_1080p", w * h / mean_dt / 1e6,
           {"ms_per_frame": times, "ms_per_frame_batched": batched,
            "batch": nb2,
            "mpix_per_s_batched": round(w * h / mean_b / 1e6, 2)})

    # 3. two-input compositing, edge variants — per-frame plus a batched
    # pair (VERDICT r3 item 6: every config reports both)
    variants = {}
    variants_b = {}
    blend_path = os.path.join(root, "Combine", "blend.mm")
    stack_a = jax.device_put(
        np.stack([_img(h, w, seed=10 + i) for i in range(nb2)]))
    stack_b = jax.device_put(
        np.stack([_img(h, w, seed=40 + i) for i in range(nb2)]))
    ts3 = np.zeros(nb2, np.float32)
    for ex in ("color", "wrap", "reflect"):
        o3 = mm.RenderOptions(edge_x=ex, edge_y=ex)
        dt = time_filter(blend_path, [_img(h, w, 1), _img(h, w, 2)], w, h,
                         o3, it)
        variants[ex] = round(dt * 1e3, 2)
        r3 = mm.compile_file(blend_path)._renderer(w, h, o3, 1)
        bestb = batch_time(r3, [stack_a, stack_b], ts3)
        variants_b[ex] = round(bestb / nb2 * 1e3, 2)
    mean_dt = sum(variants.values()) / len(variants) / 1e3
    mean_b = sum(variants_b.values()) / len(variants_b) / 1e3
    report("3_compositing_1080p", w * h / mean_dt / 1e6,
           {"ms_per_frame": variants, "ms_per_frame_batched": variants_b,
            "batch": nb2,
            "mpix_per_s_batched": round(w * h / mean_b / 1e6, 2)})

    # 4. animated ripple, 120 frames, 4x AA
    frames = 8 if args.quick else 120
    filt = mm.compile_file(os.path.join(root, "Distorts", "ripple.mm"))
    opts = mm.RenderOptions(supersample=2)
    renderer = filt._renderer(w, h, opts, frames)
    ins = [jax.device_put(np.asarray(_img(h, w)))]
    ts = (np.arange(frames, dtype=np.float32) + 0.37) / frames
    dt = best_time(lambda i: renderer.render_all_frames(ins, {},
                                                        ts + 0.001 * i), 1)
    # per-frame pair: one supersampled frame (this config's headline is
    # inherently the batched sweep)
    dt_pf = best_time(lambda i: renderer(ins, {}, t=0.37 + 0.001 * i), it)
    report("4_animated_ripple_120f_4xAA", frames * w * h / dt / 1e6,
           {"frames": frames, "s_total": round(dt, 2),
            "ms_per_frame_unbatched": round(dt_pf * 1e3, 2),
            "mpix_per_s_per_frame": round(w * h / dt_pf / 1e6, 2)})

    # 5. generative 4K — per-frame plus an 8-frame t-sweep pair
    w4, h4 = 3840, 2160
    gen = {}
    gen_b = {}
    n5 = 3 if args.quick else 8
    ts5 = (np.arange(n5, dtype=np.float32) + 0.37) / n5
    for name in ("mandelbrot", "moire"):
        path5 = os.path.join(root, "Render", f"{name}.mm")
        dt = time_filter(path5, [], w4, h4, mm.RenderOptions(), it)
        gen[name] = round(dt * 1e3, 2)
        r5 = mm.compile_file(path5)._renderer(w4, h4, mm.RenderOptions(), 1)
        bestb = best_time(lambda i, r5=r5: r5.render_all_frames(
            [], {}, ts5 + 0.001 * i), 1)
        gen_b[name] = round(bestb / n5 * 1e3, 2)
    mean_dt = sum(gen.values()) / len(gen) / 1e3
    mean_b = sum(gen_b.values()) / len(gen_b) / 1e3
    report("5_generative_4k", w4 * h4 / mean_dt / 1e6,
           {"ms_per_frame": gen, "ms_per_frame_batched": gen_b,
            "sweep": n5,
            "mpix_per_s_batched": round(w4 * h4 / mean_b / 1e6, 2)})

    print(json.dumps({"summary": {r["config"]: r["mpix_per_s"]
                                  for r in results},
                      "device": device}))


if __name__ == "__main__":
    main()
