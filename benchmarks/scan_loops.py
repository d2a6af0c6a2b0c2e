"""Library-wide while-loop engine scan (a CPU trace, no accelerator needed).

For every library filter whose source contains a while/do loop, trace it
once under jit on CPU and report which engine each loop compiled to
(static unroll / loop kernel / masked lax) plus any fold-miss
builtins — calls whose arguments were all trace-time constants but whose
name is missing from tracer._CONST_FOLD_OPS (i.e. the spots where the
constant chain breaks, the candidates for whitelist extension).

Usage: python benchmarks/scan_loops.py [--size 64x32]
"""

from __future__ import annotations

import argparse
import collections
import pathlib
import sys

import jax

jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

import mathmap_tpu as mm  # noqa: E402
from mathmap_tpu.runtime import tracer  # noqa: E402


def scan(w: int = 64, h: int = 32):
    """Trace every library filter containing a loop; return
    (rows, errors) where rows = [(relpath, [(engine, n), ...],
    [fold-miss builtin names])]. Used by the CLI report below and pinned
    by tests/test_loop_engines.py (VERDICT r3 item 9: a library filter
    with a foldable bound that misses the static unroll must FAIL a
    test, not wait for a human to re-run the scan)."""
    root = pathlib.Path(__file__).resolve().parent.parent / "filters"
    img = np.random.RandomState(0).rand(h, w, 4).astype(np.float32)
    opts = mm.RenderOptions()
    db = mm.default_db()

    rows = []
    errors = []
    for path in sorted(root.rglob("*.mm")):
        src = path.read_text()
        if "while" not in src and "do" not in src.split():
            continue
        rel = str(path.relative_to(root))
        try:
            filt = db.compile(path.stem)
        except Exception as e:
            errors.append((rel, f"compile: {e}"))
            continue
        n_imgs = sum(1 for p in filt.fdef.params if p.kind == "image")
        tracer.TRACE_LOOP_PATHS.clear()
        tracer.TRACE_FOLD_MISSES.clear()
        try:
            filt.render(*([img] * n_imgs), width=w, height=h, t=0.37,
                        options=opts)
        except Exception as e:
            errors.append((rel, f"render: {type(e).__name__}: {e}"))
            continue
        if tracer.TRACE_LOOP_PATHS:
            rows.append((rel, list(tracer.TRACE_LOOP_PATHS),
                         sorted(tracer.TRACE_FOLD_MISSES)))
    return rows, errors


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--size", default="64x32")
    args = ap.parse_args(argv)
    w, h = (int(v) for v in args.size.lower().split("x"))
    rows, errors = scan(w, h)

    by_engine = collections.Counter()
    print(f"{'filter':40s} {'loops (engine, n)':38s} fold-misses")
    for rel, paths, misses in rows:
        by_engine.update(p[0] for p in paths)
        pstr = " ".join(f"{k}:{n}" for k, n in paths)
        print(f"{rel:40s} {pstr:38s} {','.join(misses) if misses else '-'}")
    print(f"\nloop totals: {dict(by_engine)}  "
          f"({len(rows)} filters with loops)")
    miss_total = collections.Counter()
    for _, _, misses in rows:
        miss_total.update(misses)
    if miss_total:
        print("fold-miss builtins across the library:",
              dict(miss_total.most_common()))
    if errors:
        print(f"\n{len(errors)} filters failed:")
        for rel, msg in errors:
            print(f"  {rel}: {msg[:120]}")


if __name__ == "__main__":
    main()
