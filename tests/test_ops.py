"""Per-builtin unit tests against NumPy formulas (SURVEY.md §4 item 1).

Each expression renders through the oracle backend on a small grid and is
compared with a direct NumPy computation of the same math.
"""

import math

import numpy as np
import pytest

import mathmap_tpu as mm

W, H = 8, 6


def grids():
    xs = np.arange(W, dtype=np.float32) + 0.5 - W / 2
    ys = H / 2 - (np.arange(H, dtype=np.float32) + 0.5)
    return np.broadcast_to(xs[None, :], (H, W)), np.broadcast_to(ys[:, None], (H, W))


def run_gray(expr: str, **params):
    """Render `grayColor(expr)` via the oracle and return the red channel."""
    f = mm.compile(f"grayColor({expr})")
    img = np.zeros((H, W, 4), np.float32)
    out = f.render(img, interpret=True)
    return out[..., 0]


X, Y = grids()
R = np.sqrt(X * X + Y * Y)
A = np.mod(np.arctan2(Y, X), 2 * np.pi)


def clip01(v):
    return np.clip(v, 0.0, 1.0)


@pytest.mark.parametrize(
    "expr,expected",
    [
        ("x / 4 + 0.5", clip01(X / 4 + 0.5)),
        ("(x + y) / 8", clip01((X + Y) / 8)),
        ("x * y / 16", clip01(X * Y / 16)),
        ("x % 3 / 3", clip01(np.mod(X, 3) / 3)),
        ("2 ^ x / 16", clip01(2.0 ** X / 16)),
        ("sin(x)", clip01(np.sin(X))),
        ("cos(y)", clip01(np.cos(Y))),
        ("atan(y, x) / 4", clip01(np.arctan2(Y, X) / 4)),
        ("atan2(y, x) / 4", clip01(np.arctan2(Y, X) / 4)),
        ("exp(-(x*x))", clip01(np.exp(-X * X))),
        ("sqrt(abs(x))/2", clip01(np.sqrt(np.abs(X)) / 2)),
        ("floor(x) / 4", clip01(np.floor(X) / 4)),
        ("ceil(x) / 4", clip01(np.ceil(X) / 4)),
        ("sign(x)", clip01(np.sign(X))),
        ("min(x, y)", clip01(np.minimum(X, Y))),
        ("max(x, y) / 4", clip01(np.maximum(X, Y) / 4)),
        ("clamp(x, 0, 1)", clip01(np.clip(X, 0, 1))),
        ("lerp(0.25, x, y)", clip01(X + 0.25 * (Y - X))),
        ("inintv(x, 0, 2)", ((X >= 0) & (X <= 2)).astype(np.float32)),
        ("x < y", (X < Y).astype(np.float32)),
        ("x == y", (X == Y).astype(np.float32)),
        ("x >= 0 && y >= 0", ((X >= 0) & (Y >= 0)).astype(np.float32)),
        ("x >= 0 || y >= 0", ((X >= 0) | (Y >= 0)).astype(np.float32)),
        ("!(x >= 0)", (~(X >= 0)).astype(np.float32)),
        ("x >= 0 xor y >= 0", ((X >= 0) ^ (Y >= 0)).astype(np.float32)),
        ("r / 5", clip01(R / 5)),
        ("a / 7", clip01(A / 7)),
        ("tanh(x)", clip01(np.tanh(X))),
        ("gamma(x / 8 + 2) / 2", clip01(np.vectorize(math.gamma)(X / 8 + 2) / 2)),
    ],
)
def test_scalar_expr(expr, expected):
    got = run_gray(expr)
    np.testing.assert_allclose(got, expected.astype(np.float32), rtol=2e-5, atol=2e-6)


def test_internals_values():
    np.testing.assert_allclose(run_gray("W / 8"), np.full((H, W), W / 8.0))
    np.testing.assert_allclose(run_gray("H / 8"), np.full((H, W), H / 8.0))
    np.testing.assert_allclose(run_gray("X / 8"), clip01(np.full((H, W), W / 2 / 8)))
    np.testing.assert_allclose(run_gray("Y / 8"), clip01(np.full((H, W), H / 2 / 8)))
    rr = np.sqrt((W / 2) ** 2 + (H / 2) ** 2)
    np.testing.assert_allclose(run_gray("R / 8"), clip01(np.full((H, W), rr / 8)), rtol=1e-6)


def test_tuple_ops():
    # dotp, crossp, normalize, subscript
    np.testing.assert_allclose(
        run_gray("dotp([1,2,3],[4,5,6]) / 32"), np.full((H, W), 1.0), rtol=1e-6
    )
    np.testing.assert_allclose(
        run_gray("crossp(v3:[1,0,0], v3:[0,1,0])[2]"), np.ones((H, W)), rtol=1e-6
    )
    np.testing.assert_allclose(
        run_gray("normalize(v2:[3,4])[1]"), np.full((H, W), 0.8), rtol=1e-6
    )
    np.testing.assert_allclose(run_gray("abs(v2:[3,4]) / 5"), np.ones((H, W)), rtol=1e-6)


def test_complex_ops():
    np.testing.assert_allclose(
        run_gray("(ri:[1,2] * ri:[3,4])[1] / 10"), np.ones((H, W)), rtol=1e-6
    )
    z = (1 + 2j) / (3 + 4j)
    np.testing.assert_allclose(
        run_gray(f"(ri:[1,2] / ri:[3,4])[0] / {z.real}"), np.ones((H, W)), rtol=1e-5
    )
    ez = np.exp(0.5 + 0.25j)
    np.testing.assert_allclose(
        run_gray(f"exp(ri:[0.5,0.25])[0] / {ez.real}"), np.ones((H, W)), rtol=1e-5
    )
    np.testing.assert_allclose(
        run_gray("abs(ri:[3,4]) / 5"), np.ones((H, W)), rtol=1e-6
    )
    np.testing.assert_allclose(
        run_gray("arg(ri:[0,1]) / (pi/2)"), np.ones((H, W)), rtol=1e-6
    )
    sz = np.sin(0.5 + 0.25j)
    np.testing.assert_allclose(
        run_gray(f"sin(ri:[0.5,0.25])[0] / {sz.real}"), np.ones((H, W)), rtol=1e-5
    )


def test_matrix_ops():
    np.testing.assert_allclose(
        run_gray("(m2x2:[1,2,3,4] * v2:[5,6])[0] / 17"), np.ones((H, W)), rtol=1e-6
    )
    np.testing.assert_allclose(
        run_gray("det(m2x2:[1,2,3,4]) / -2"), np.ones((H, W)), rtol=1e-6
    )
    # solve([[1,2],[3,4]] x = [5,6]) -> x = [-4, 4.5]
    np.testing.assert_allclose(
        run_gray("solve(m2x2:[1,2,3,4], v2:[5,6])[1] / 4.5"), np.ones((H, W)), rtol=1e-5
    )
    m = np.array([[2, 1, 0], [1, 3, 1], [0, 1, 2]], np.float64)
    v = np.array([1, 2, 3], np.float64)
    sol = np.linalg.solve(m, v)
    np.testing.assert_allclose(
        run_gray(f"solve(m3x3:[2,1,0,1,3,1,0,1,2], v3:[1,2,3])[2] / {sol[2]}"),
        np.ones((H, W)),
        rtol=1e-5,
    )


def test_quaternion_mul():
    # i * j = k  (Hamilton)
    np.testing.assert_allclose(
        run_gray("(quat:[0,1,0,0] * quat:[0,0,1,0])[3]"), np.ones((H, W)), rtol=1e-6
    )
    # j * i = -k
    np.testing.assert_allclose(
        run_gray("-(quat:[0,0,1,0] * quat:[0,1,0,0])[3]"), np.ones((H, W)), rtol=1e-6
    )


def test_color_ops():
    np.testing.assert_allclose(
        run_gray("red(rgbColor(0.3, 0.5, 0.9))") , np.full((H, W), 0.3), rtol=1e-6
    )
    np.testing.assert_allclose(
        run_gray("alpha(rgbaColor(0.1, 0.2, 0.3, 0.4))"), np.full((H, W), 0.4), rtol=1e-6
    )
    g = 0.299 * 0.3 + 0.587 * 0.5 + 0.114 * 0.9
    np.testing.assert_allclose(
        run_gray("gray(rgbColor(0.3, 0.5, 0.9))"), np.full((H, W), g), rtol=1e-5
    )


def test_hsva_roundtrip():
    got = run_gray("red(toRGBA(toHSVA(rgbColor(0.3, 0.7, 0.2))))")
    np.testing.assert_allclose(got, np.full((H, W), 0.3), rtol=1e-5, atol=1e-6)
    # known hue: pure red -> h=0, s=1, v=1
    got_h = run_gray("toHSVA(rgbColor(1, 0, 0))[0]")
    np.testing.assert_allclose(got_h, np.zeros((H, W)), atol=1e-6)
    got_s = run_gray("toHSVA(rgbColor(1, 0, 0))[1]")
    np.testing.assert_allclose(got_s, np.ones((H, W)), atol=1e-6)


def test_coordinate_converts():
    np.testing.assert_allclose(run_gray("toRA(xy)[0] / 5"), clip01(R / 5), rtol=1e-5)
    np.testing.assert_allclose(
        run_gray("toXY(toRA(xy))[0] / 4 + 0.5"), clip01(X / 4 + 0.5), rtol=1e-4, atol=1e-5
    )


def test_elliptic_agm():
    from scipy import special  # available via baked-in scipy

    k = 0.5
    np.testing.assert_allclose(
        run_gray(f"ell_int_Kcomp({k}) / {special.ellipk(k * k)}"),
        np.ones((H, W)),
        rtol=1e-4,
    )
    np.testing.assert_allclose(
        run_gray(f"ell_int_Ecomp({k}) / {special.ellipe(k * k)}"),
        np.ones((H, W)),
        rtol=1e-4,
    )


def test_jacobi_sn():
    from scipy import special

    u, k = 0.7, 0.6
    sn, cn, dn, _ = special.ellipj(u, k * k)
    np.testing.assert_allclose(
        run_gray(f"ell_jac_sn({u}, {k}) / {sn}"), np.ones((H, W)), rtol=1e-4
    )
    np.testing.assert_allclose(
        run_gray(f"ell_jac_cn({u}, {k}) / {cn}"), np.ones((H, W)), rtol=1e-4
    )
    np.testing.assert_allclose(
        run_gray(f"ell_jac_dn({u}, {k}) / {dn}"), np.ones((H, W)), rtol=1e-4
    )


def test_beta():
    from scipy import special

    np.testing.assert_allclose(
        run_gray(f"beta(2.5, 1.5) / {special.beta(2.5, 1.5)}"), np.ones((H, W)), rtol=1e-4
    )


def test_noise_deterministic_and_bounded():
    f = mm.compile("grayColor(0.5 + 0.5 * noise([x/4, y/4, 0.3]))")
    img = np.zeros((H, W, 4), np.float32)
    a = f.render(img, interpret=True)
    b = f.render(img, interpret=True)
    np.testing.assert_array_equal(a, b)
    assert a.min() >= 0.0 and a.max() <= 1.0
    assert a[..., 0].std() > 0.01  # actually varies


def test_noise_zero_at_lattice():
    # Perlin noise is 0 at integer lattice points
    f = mm.compile("grayColor(noise([floor(x), floor(y), 1]))")
    img = np.zeros((H, W, 4), np.float32)
    out = f.render(img, interpret=True)
    np.testing.assert_allclose(out[..., 0], np.zeros((H, W)), atol=1e-6)


def test_rand_deterministic_in_range():
    f = mm.compile("grayColor(rand(0.25, 0.75))")
    img = np.zeros((H, W, 4), np.float32)
    a = f.render(img, interpret=True)
    b = f.render(img, interpret=True)
    np.testing.assert_array_equal(a, b)
    assert a[..., 0].min() >= 0.25 and a[..., 0].max() <= 0.75
    assert a[..., 0].std() > 0.01


def test_additional_scalar_utilities():
    np.testing.assert_allclose(run_gray("log2(8) / 3"), np.ones((H, W)), rtol=1e-6)
    np.testing.assert_allclose(run_gray("log10(100) / 2"), np.ones((H, W)), rtol=1e-6)
    np.testing.assert_allclose(run_gray("exp2(3) / 8"), np.ones((H, W)), rtol=1e-6)
    np.testing.assert_allclose(run_gray("hypot(3, 4) / 5"), np.ones((H, W)), rtol=1e-6)
    # fmod follows the dividend's sign; % is floored
    np.testing.assert_allclose(run_gray("fmod(0-7, 3) + 1.5"),
                               np.full((H, W), 0.5), rtol=1e-5)
    np.testing.assert_allclose(run_gray("(0-7) % 3 - 1.5"),
                               np.full((H, W), 0.5), rtol=1e-5)
    np.testing.assert_allclose(run_gray("smoothstep(0, 4, 2)"),
                               np.full((H, W), 0.5), rtol=1e-6)


# -- review r3: op semantics fixes -------------------------------------

def _g1(src, **kw):
    import mathmap_tpu as mm

    f = mm.compile(src)
    img = np.zeros((2, 2, 4), np.float32)
    return float(np.asarray(f.render(img, interpret=True, **kw))[0, 0, 0])


def test_complex_reciprocal():
    """1/z dispatches complex division when the denominator is ri
    (regression: elementwise divide gave [inf, 1] for 1/i)."""
    assert abs(_g1("z = 1 / ri:[0, 1]; grayColor(-z[1] - 0.5)") - 0.5) < 1e-6
    # z / scalar stays elementwise (complex scaling)
    assert abs(_g1("z = ri:[1, 2] / 2; grayColor(z[1])") - 1.0) < 1e-6


def test_tuple_ne_is_negation_of_eq():
    """[1,2] != [1,3] must be TRUE (any component differs) — De Morgan of
    the componentwise-AND eq rule (regression: AND made it false)."""
    assert _g1("grayColor([1,2] != [1,3])") == 1.0
    assert _g1("grayColor([1,2] == [1,3])") == 0.0
    assert _g1("grayColor([1,2] != [1,2])") == 0.0


def test_fmod_exact_for_large_quotients():
    assert abs(_g1("grayColor(fmod(100000000, 3) / 2)") - 0.5) < 1e-6


def test_lgamma_no_overflow():
    """lgamma uses the log-form Lanczos (regression: log(gamma(x))
    overflowed f32 for x > ~35)."""
    import math

    got = _g1("grayColor(lgamma(40) / 256)") * 256
    assert abs(got - math.lgamma(40)) < 1e-3, got


def test_pow_builtin_complex_overload():
    """pow(z, w) must match the '^' operator's complex dispatch
    (regression: elementwise re^re, im^im)."""
    assert abs(_g1("z = pow(ri:[0, 1], 2); grayColor(-z[0] - 0.5)") - 0.5) < 1e-6


def test_clamp_mixed_lengths_broadcast():
    assert abs(_g1("c = clamp(0.5, rgba:[0,0,0,0], 1); grayColor(c[3])") - 0.5) < 1e-6


def test_transcendental_on_image_raises():
    import mathmap_tpu as mm
    from mathmap_tpu.utils.errors import MMTypeError

    img = np.zeros((2, 2, 4), np.float32)
    for fn in ("sin", "exp", "sqrt", "log", "atan"):
        f = mm.compile(f"filter f (image in) grayColor(gray({fn}(in))) end")
        with pytest.raises(MMTypeError, match="not defined on"):
            f.render(img, interpret=True)


def test_wk_engine_declines_complex_carry(while_kernel_interpret):
    """An ri: value carried through ^ (its complex overload reaches
    atan2/exp/log) no longer declines the loop kernel: every one of those
    lowers on the Triton route, so the loop runs in the kernel and
    matches the oracle."""
    import mathmap_tpu as mm

    WK = while_kernel_interpret
    img = np.random.RandomState(0).rand(8, 256, 4).astype(np.float32)
    opts = mm.RenderOptions(pallas_while="on")
    results = []
    orig = WK.launch

    def spy(*a, **k):
        r = orig(*a, **k)
        results.append(r is not None)
        return r

    WK.launch = spy
    try:
        f = mm.compile(
            "z = ri:[x * 0.01, y * 0.01]; i = 0; "
            "while i + x * 0 < 4 do z = z ^ 2 + ri:[0.1, 0.1]; i = i + 1 end; "
            "grayColor(clamp(z[0], 0, 1))")
        j = f.render(img, width=256, height=8, options=opts)
        assert results == [True], "ri carry through ^ runs in the kernel"
        o = f.render(img, width=256, height=8, interpret=True)
        # 4 iterations of a quadratic map: fused-XLA vs eager-numpy f32
        # rounding reaches ~2e-5
        np.testing.assert_allclose(np.asarray(j), np.asarray(o), atol=1e-4)
    finally:
        WK.launch = orig


def test_opaque_retag_and_matrix_opaque_raise():
    """Retagging an image to a numeric tag, and m2x2 * image, raise
    MMTypeError instead of raw unpack errors (review r3)."""
    import mathmap_tpu as mm
    from mathmap_tpu.utils.errors import MMTypeError

    img = np.zeros((2, 2, 4), np.float32)
    for src in ("filter f (image in) grayColor(det(m2x2:in)) end",
                "filter f (image in) grayColor(gray(m2x2:[1,0,0,1] * in)) end"):
        f = mm.compile(src)
        with pytest.raises(MMTypeError):
            f.render(img, interpret=True)


def test_tora_angle_strictly_below_two_pi():
    """toRA's angle stays in [0, 2*pi) even when atan2 returns a tiny
    negative (mod rounds to exactly 2*pi — review r3)."""
    from mathmap_tpu.ops.color_ops import _to_ra  # registered builtin
    from mathmap_tpu.ops.registry import lookup
    from mathmap_tpu.runtime.value import TupleValue

    class _Ev:
        be = np

    v = TupleValue("xy", (np.float32(1.0), np.float32(-1e-30)))
    out = lookup("toRA")(_Ev(), [v], None)
    a = float(out.arrays[1])
    assert 0.0 <= a < 6.283185307179586, a


def test_gradient_lut_row_gather_parity():
    """The row-gather _lut_take matches per-channel takes (and the jit
    path) on a gradient application."""
    import mathmap_tpu as mm

    lut = np.stack([np.linspace(0, 1, 64)] * 4, axis=1).astype(np.float32)
    lut[:, 1] = lut[::-1, 1]
    f = mm.compile("filter f (gradient g) g(x / W + 0.5) end")
    img = np.zeros((8, 16, 4), np.float32)
    o = f.render(img, interpret=True, params={"g": lut})
    j = f.render(img, params={"g": lut})
    np.testing.assert_allclose(np.asarray(j), np.asarray(o), atol=5e-3)


def test_builtin_reference_complete():
    """docs/BUILTINS.md must name every public builtin in the registry
    (and not document names that don't exist) — the reference manual
    cannot drift from the op table."""
    import pathlib
    import re

    from mathmap_tpu.ops import registry

    doc = (pathlib.Path(__file__).parent.parent / "docs" /
           "BUILTINS.md").read_text()
    documented = set(re.findall(r"`([A-Za-z_][A-Za-z_0-9-]*)`", doc))
    public = {n for n in registry.BUILTINS if not n.startswith("__")}
    missing = sorted(public - documented)
    assert not missing, f"builtins missing from docs/BUILTINS.md: {missing}"
