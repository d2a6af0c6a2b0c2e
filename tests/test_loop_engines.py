"""Pin which loop engine every library filter compiles to (VERDICT r3
item 9).

The tracer picks one of three engines per while/do loop: trace-time static
unroll (literal/const-foldable trip counts), the per-pixel loop kernel
(pallas_kernels/while_kernel, on a GPU), or masked lax iteration. The
scan traces on the CPU, where 'auto' never takes the kernel, so loops on
a dynamic condition read 'lax' here. A regression that silently demotes
a statically-unrollable loop to masked lax costs a multiple of that
filter's time, and a builtin that becomes
const-foldable without joining tracer._CONST_FOLD_OPS breaks the constant
chain invisibly. The scan (benchmarks/scan_loops.py) makes both visible;
this test makes them FAIL.
"""

import sys

sys.path.insert(0, __file__.rsplit("/tests/", 1)[0] + "/benchmarks")

import scan_loops  # noqa: E402

# engine expectation per loop-bearing library filter: 'unroll' filters
# have literal or const-foldable trip counts; 'lax' filters iterate on a
# traced escape condition (mandelbrot family: maxiter is a user PARAM and
# stays traced by design — baking it is static_params' job)
EXPECTED_ENGINES = {
    "Distorts/do_while_demo.mm": {"lax"},
    "Noise/ridged_noise.mm": {"unroll"},
    "Render/biomorph.mm": {"lax"},
    "Render/burning_ship.mm": {"lax"},
    "Render/julia.mm": {"lax"},
    "Render/lissajous.mm": {"unroll"},
    "Render/mandelbrot.mm": {"lax"},
    "Render/newton.mm": {"unroll"},
    "Render/quat_julia.mm": {"lax"},
    "Render/sierpinski.mm": {"unroll"},
    "Render/tricorn.mm": {"unroll", "lax"},  # either acceptable
    "Render/voronoi.mm": {"unroll"},
}


def test_library_loop_engines_and_fold_misses():
    rows, errors = scan_loops.scan(48, 24)
    assert not errors, f"library filters failed to trace: {errors}"
    seen = {}
    for rel, paths, misses in rows:
        assert not misses, (
            f"{rel}: builtins called with all-constant args but missing "
            f"from tracer._CONST_FOLD_OPS: {misses} — add them to the "
            f"whitelist so the constant chain (and static unroll) holds")
        seen[rel] = {engine for engine, _n in paths}
    # every known loop filter still traces a loop, on the expected engine
    for rel, allowed in EXPECTED_ENGINES.items():
        assert rel in seen, f"{rel} no longer reports a loop path"
        assert seen[rel] <= allowed, (
            f"{rel}: loop engine regressed to {seen[rel]} (expected within "
            f"{allowed}) — a statically-unrollable loop falling back to "
            f"masked lax costs a multiple of the unrolled time")
    # new loop-bearing filters must be added to the expectation table
    unknown = set(seen) - set(EXPECTED_ENGINES)
    assert not unknown, (
        f"new loop-bearing filters {unknown} — pin their engine in "
        f"EXPECTED_ENGINES")
