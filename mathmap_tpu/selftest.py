"""Deployment self-test: a fast acceptance sweep on the ACTIVE backend.

`python -m mathmap_tpu --selftest` renders a battery of path-exercising
configs (pointwise math, warp sampling at each interpolation/edge class,
LUT application, noise, the while loop, static unroll, animated frame
indexing, supersampling) and checks each against the NumPy oracle — a
seconds-long subset of chip_smoke.py's path matrix. Use it after deploying
to new hardware or a new jax build: the CPU tests cannot see what the
GPU's compiler makes of a program, this can.

Tolerances (max abs error vs the oracle): 1e-5 on CPU, where XLA and
NumPy share the host's libm up to fusion order; 2e-4 on a GPU, where
XLA's own transcendental implementations differ from NumPy's in the last
bits and a warp carries that coordinate difference into the sampled
value. Two classes use a fraction rule instead: escape-time loops
(|Δiter| <= 1 on a chaotic boundary moves a whole gradient step), and
nearest sampling on a GPU, where a coordinate within ulps of a texel
boundary may round to the neighbouring texel (at most 0.5% of pixels).
Exit code 0 = all passed.

Reference analog: none — the reference has no automated acceptance suite
(SURVEY.md §4); this is deployment tooling.
"""

from __future__ import annotations

import time


def _configs():
    """(name, source, options_kw, frame) — sized for a ~128px canvas."""
    return [
        ("pointwise", "grayColor(clamp(sin(x / 9) * cos(y / 7) * 0.5 + 0.5,"
                      " 0, 1))", {}, 0.0),
        ("warp/bilinear/wrap",
         "origVal(xy + xy:[4 * sin(y / 11), 3 * cos(x / 13)])",
         dict(interpolation="bilinear", edge_x="wrap", edge_y="wrap"), 0.0),
        ("warp/bicubic/reflect",
         "origVal(xy * 0.8 + xy:[2, -1])",
         dict(interpolation="bicubic", edge_x="reflect", edge_y="reflect"),
         0.0),
        ("warp/nearest/color",
         "origVal(toXY(ra:[r * 1.2, a + 0.3]))",
         dict(interpolation="nearest", edge_color=(1.0, 0.0, 0.0, 1.0)),
         0.0),
        ("lut/gradient",
         "filter f (image in, gradient g) g(clamp(r / R, 0, 1)) end",
         {}, 0.0),
        ("noise", "grayColor(clamp(noise([x / 17, y / 17, 0.4]) * 0.5 + 0.5,"
                  " 0, 1))", {}, 0.0),
        ("while-loop",
         "i = 0; z = ri:[x / 64, y / 64]; c = z;"
         " while abs(z) < 2 && i < 12 do z = z * z + c; i = i + 1 end;"
         " grayColor(i / 12)", {}, 0.0),
        ("static-unroll",
         "i = 0; s = 0; while i < 5 do s = s + sin(x / 9 + i); i = i + 1 "
         "end; grayColor(clamp(s / 5 + 0.5, 0, 1))", {}, 0.0),
        ("animated-frame", "origValXY(x, y, 1)",
         dict(interpolation="nearest"), 0.0),
        ("supersample", "origVal(xy + xy:[2 * sin(y / 9), 0])",
         dict(supersample=2), 0.0),
    ]


def run_selftest(size: int = 128, verbose: bool = False) -> int:
    """Render every config on the active backend vs the oracle; print a
    PASS/FAIL line per config and return the number of failures."""
    import numpy as np

    import jax

    from . import RenderOptions, compile_source

    backend = jax.default_backend()
    # see the module docstring for why the two backends differ
    lim = 1e-5 if backend == "cpu" else 2e-4
    rng = np.random.RandomState(7)
    img = rng.rand(size, size, 4).astype(np.float32)
    img[..., 3] = 1.0
    stack = np.stack([img, img[::-1]])
    failures = 0
    print(f"mathmap_tpu selftest: backend={backend} size={size}")
    for name, src, kw, frame in _configs():
        t0 = time.perf_counter()
        try:
            f = compile_source(src)
            opts = RenderOptions(**kw)
            inp = stack if name == "animated-frame" else img
            args = [inp] if f.image_params else []
            got = np.asarray(f.render(*args, width=size, height=size,
                                      t=0.25, frame=frame, options=opts))
            want = np.asarray(f.render(*args, width=size, height=size,
                                       t=0.25, frame=frame, options=opts,
                                       interpret=True))
            err = float(np.abs(got - want).max())
            if name == "while-loop":
                frac = float((np.abs(got - want) > 0.02).mean())
                ok = frac < 0.01
                detail = f"frac>{0.02}={frac:.4f}"
            elif backend != "cpu" and kw.get("interpolation") == "nearest":
                frac = float((np.abs(got - want).max(-1) > lim).mean())
                ok = frac <= 5e-3
                detail = f"frac>{lim:g}={frac:.4f} max={err:.2e}"
            else:
                ok = err <= lim
                detail = f"max={err:.2e} tol={lim:g}"
            dt = time.perf_counter() - t0
            status = "OK" if ok else "FAIL"
            print(f"  {name:24s} {status:4s} {detail}"
                  + (f"  [{dt:.1f}s]" if verbose else ""))
            failures += 0 if ok else 1
        except Exception as e:  # noqa: BLE001 — a crash IS a failure
            print(f"  {name:24s} FAIL {type(e).__name__}: {e}")
            failures += 1
    print(f"selftest: {'OK' if not failures else 'FAILED'} "
          f"({len(_configs()) - failures}/{len(_configs())} passed)")
    return failures
