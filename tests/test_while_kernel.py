"""The per-pixel loop kernel (pallas_kernels/while_kernel) on the Triton
route, tested without a GPU: every loop is LOWERED for "cuda" here (the
Triton custom call must appear in the module — no interpret mode), one
case per kernel-eligible builtin, plus mandelbrot and a rand() body.
What the GPU's own compiler does with the Triton IR shows only on the card
(chip_smoke.py phase 3)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import mathmap_tpu as mm
from mathmap_tpu.pallas_kernels import while_kernel as WK
from mathmap_tpu.runtime import tracer as T
from mathmap_tpu.runtime.render import _userval_pytree
from mathmap_tpu.runtime.tracer import RenderContext

TRITON_CALL = "__gpu$xla.gpu.triton"

#: one loop body per SAFE_CALLS name (v: scalar, p: xy, z: ri, q: v3)
BODIES = {
    "__add": "v = v + 0.5", "__sub": "v = v - 0.5", "__mul": "v = v * 0.9",
    "__div": "v = v / 1.1", "__mod": "v = v % 0.7", "__pow": "v = v ^ 1.01",
    "__eq": "v = v + (v == 0.3)", "__ne": "v = v + (v != 0.3)",
    "__lt": "v = v + (v < 0.3)", "__gt": "v = v + (v > 0.3)",
    "__le": "v = v + (v <= 0.3)", "__ge": "v = v + (v >= 0.3)",
    "__and": "v = v + (v > 0.1 && v < 0.9)",
    "__or": "v = v + (v > 0.1 || v < 0.9)",
    "__xor": "v = v + (v > 0.1 xor v < 0.9)", "__neg": "v = -v",
    "__not": "v = v + !(v > 0.5)",
    "abs": "v = abs(v) * 0.5", "sign": "v = sign(v) * 0.5",
    "min": "v = min(v, 0.3)", "max": "v = max(v, 0.3)",
    "clamp": "v = clamp(v, 0, 1)", "lerp": "v = lerp(0.3, v, 1)",
    "smoothstep": "v = smoothstep(0, 1, v)",
    "inintv": "v = v + inintv(v, 0, 1)",
    "floor": "v = floor(v) * 0.5", "ceil": "v = ceil(v) * 0.5",
    "fmod": "v = fmod(v, 0.3)", "hypot": "v = hypot(v, 0.3)",
    "sqrt": "v = sqrt(v) * 0.5", "exp": "v = exp(v) * 0.5",
    "exp2": "v = exp2(v) * 0.5", "log": "v = log(v) * 0.5",
    "log2": "v = log2(v) * 0.5", "log10": "v = log10(v) * 0.5",
    "pow": "v = pow(v, 1.1)",
    "sin": "v = sin(v) * 0.5", "cos": "v = cos(v) * 0.5",
    "tan": "v = tan(v) * 0.5", "tanh": "v = tanh(v) * 0.5",
    "asin": "v = asin(v) * 0.5", "acos": "v = acos(v) * 0.5",
    "atan": "v = atan(v) * 0.5", "atan2": "v = atan2(v, 0.3)",
    "sinh": "v = sinh(v) * 0.5", "cosh": "v = cosh(v) * 0.5",
    "asinh": "v = asinh(v) * 0.5", "acosh": "v = acosh(v) * 0.5",
    "atanh": "v = atanh(v) * 0.5",
    "deg2rad": "v = deg2rad(v)", "rad2deg": "v = rad2deg(v) * 0.01",
    "rand": "v = v + rand(0, 1)",
    "rgbColor": "v = red(rgbColor(v, v, v))",
    "rgbaColor": "v = green(rgbaColor(v, v, v, 1))",
    "grayColor": "v = blue(grayColor(v))",
    "grayaColor": "v = alpha(grayaColor(v, 0.5))",
    "red": "v = red(rgbaColor(v, 0, 0, 1))",
    "green": "v = green(rgbaColor(0, v, 0, 1))",
    "blue": "v = blue(rgbaColor(0, 0, v, 1))",
    "alpha": "v = alpha(rgbaColor(0, 0, 0, v))",
    "gray": "v = gray(rgbaColor(v, v, 0, 1))",
    "toXY": "p = toXY(p)", "toRA": "p = toRA(p)", "arg": "v = arg(z)",
    "toHSVA": "v = red(toHSVA(rgbaColor(v, 0.5, 0.2, 1)))",
    "toRGBA": "v = red(toRGBA(rgbaColor(v, 0.5, 0.2, 1)))",
    "conj": "z = conj(z)", "length": "v = length(p)",
    "dotp": "v = dotp(p, p)", "crossp": "q = crossp(q, v3:[0, 1, v])",
    "normalize": "p = normalize(p)", "scale": "v = scale(v, 0, 1, 2, 3)",
}

#: complex (ri:) overloads of eligible names: their split re/im forms reach
#: sinh/cosh/atan2/exp/log, all of which lower on the Triton route
COMPLEX_BODIES = {
    "c_sin": "z = sin(z)", "c_cos": "z = cos(z)", "c_tan": "z = tan(z)",
    "c_sqrt": "z = sqrt(z)", "c_log": "z = log(z)", "c_exp": "z = exp(z)",
    "c_pow": "z = z ^ 2", "c_pow_real": "z = pow(z, 1.5)",
    "c_div": "z = z / (z + ri:[1, 1])",
    "c_internals": "v = v + a * 0.01 + r * 0.01",
}


def _probe_src(body):
    # n stays a traced param (passed below), so the loop cannot unroll
    return ("filter probe (int n: 1-64 (8))\n"
            "  v = x / 97; p = xy:[x / 50, y / 50]; z = ri:[x / 50, y / 50];"
            " q = v3:[1, 0, 0];\n"
            "  i = 0;\n"
            f"  while i < n do {body}; i = i + 1 end;\n"
            "  rgbaColor(v + p[0] + z[0] + q[0], p[1], z[1], 1)\nend")


def _lower_for_cuda(f, width, height, opts, params):
    """Trace and lower one frame's program for CUDA on this CPU-only host;
    returns (module text, loop engines the tracer chose)."""
    r = f._renderer(width, height, opts, 1)
    ctx = RenderContext(be=jnp, width=width, height=height, opts=opts,
                        filters=f.filters, is_jax=True)
    arrays, kinds = _userval_pytree(ctx, f.fdef, params)
    T.TRACE_LOOP_PATHS.clear()
    low = jax.jit(lambda a, t, fr: r._jitted([], a, kinds, t, fr)).trace(
        arrays, jnp.float32(0), jnp.float32(0)).lower(
            lowering_platforms=("cuda",))
    return low.as_text(), [p for p, _ in T.TRACE_LOOP_PATHS]


def test_every_safe_call_has_a_lowering_case():
    assert set(BODIES) == set(WK.SAFE_CALLS)


@pytest.mark.parametrize("name", sorted(BODIES) + sorted(COMPLEX_BODIES))
def test_eligible_builtin_lowers_to_triton(name):
    body = {**BODIES, **COMPLEX_BODIES}[name]
    f = mm.compile(_probe_src(body))
    text, engines = _lower_for_cuda(f, 256, 128,
                                    mm.RenderOptions(pallas_while="on"),
                                    {"n": 8})
    assert engines == ["wk"], engines
    assert TRITON_CALL in text


def test_mandelbrot_lowers_to_one_triton_call():
    """The library mandelbrot lowers to ONE Triton call on a ragged grid
    (tracing and lowering only — nothing runs; chip_smoke.py compiles it
    at 4K on the card)."""
    f = mm.compile_file("filters/Render/mandelbrot.mm")
    text, engines = _lower_for_cuda(f, 600, 340,
                                    mm.RenderOptions(pallas_while="on"),
                                    {"maxiter": 256})
    assert engines == ["wk"]
    assert text.count(TRITON_CALL) == 1


def test_rand_body_lowers_to_triton():
    f = mm.compile("filter r () s = 0; i = 0; while i + x * 0 < 6 do "
                   "s = s + rand(0, 1); i = i + 1 end; grayColor(s / 6) end")
    text, engines = _lower_for_cuda(f, 200, 120,
                                    mm.RenderOptions(pallas_while="on"), {})
    assert engines == ["wk"]
    assert TRITON_CALL in text


@pytest.mark.parametrize("name", ["round", "noise", "gamma", "ellK"])
def test_ineligible_builtin_keeps_the_lax_loop(name):
    body = {"round": "v = round(v * 3)",
            "noise": "v = noise(v, 0.5, 0.2)",
            "gamma": "v = gamma(v + 1)", "ellK": "v = ellK(v * 0.5)"}[name]
    f = mm.compile(_probe_src(body))
    text, engines = _lower_for_cuda(f, 256, 128,
                                    mm.RenderOptions(pallas_while="on"),
                                    {"n": 8})
    assert engines == ["lax"]
    assert TRITON_CALL not in text


def test_auto_stays_off_the_kernel_on_cpu():
    """'auto' takes the kernel only where JAX's default backend is a GPU;
    nothing picks interpret mode from the backend."""
    assert WK.INTERPRET is False
    f = mm.compile_file("filters/Render/mandelbrot.mm")
    text, engines = _lower_for_cuda(f, 512, 512, mm.RenderOptions(),
                                    {"maxiter": 64})
    assert engines == ["lax"]


def test_auto_gate_by_grid_size(monkeypatch):
    """On a GPU backend 'auto' takes the kernel from MIN_PIXELS up."""
    import types

    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    node = mm.compile("i = 0; while i + x * 0 < 4 do i = i + 1 end; "
                      "grayColor(i)").fdef.body
    loop = next(s for s in mm.lang.astnodes.walk(node)
                if isinstance(s, mm.lang.astnodes.While))
    side = int(WK.MIN_PIXELS ** 0.5)

    def ctx(h, w, mode="auto"):
        return types.SimpleNamespace(
            is_jax=True, in_pallas=False, shape=(h, w), filters={},
            opts=mm.RenderOptions(pallas_while=mode))

    assert WK.eligible(ctx(side, side), loop)
    assert not WK.eligible(ctx(side, side - 1), loop)
    assert WK.eligible(ctx(8, 8, "on"), loop)
    assert not WK.eligible(ctx(4096, 4096, "off"), loop)


@pytest.mark.parametrize("hw", [(13, 100), (64, 64), (70, 130)])
def test_kernel_matches_lax_loop_interpret(hw, while_kernel_interpret):
    """Interpret mode (asked for by the fixture): the blocked kernel with
    its edge padding agrees with the lax loop on block-aligned and
    ragged grids."""
    h, w = hw
    f = mm.compile("filter m () z = ri:[x / W * 3, y / H * 3]; c = z; "
                   "i = 0; while z[0]*z[0] + z[1]*z[1] < 4 && i < 30 do "
                   "z = z * z + c; i = i + 1 end; grayColor(i / 30) end")
    a = np.asarray(f.render(width=w, height=h,
                            options=mm.RenderOptions(pallas_while="on")))
    b = np.asarray(f.render(width=w, height=h,
                            options=mm.RenderOptions(pallas_while="off")))
    np.testing.assert_array_equal(a, b)
