"""Property-style fuzzing: random expressions must (a) parse+trace+render
without crashing, (b) agree between the traced-JAX path and the NumPy oracle
(SURVEY.md §4 item 2). Deterministic seeds — failures reproduce."""

import numpy as np
import pytest

import mathmap_tpu as mm

H, W = 10, 12


class ExprGen:
    """Generate random well-typed scalar expressions over the internals."""

    SCALARS = ["x / 8", "y / 8", "r / 8", "a", "t", "0.3", "1.7", "-0.4",
               "gray(origVal(xy))", "red(origVal(xy))"]
    UN = ["sin", "cos", "exp", "tanh", "abs", "floor", "sqrt"]
    BIN = ["+", "-", "*"]

    def __init__(self, seed):
        self.rng = np.random.RandomState(seed)

    def scalar(self, depth=0):
        roll = self.rng.rand()
        if depth > 3 or roll < 0.3:
            return self.rng.choice(self.SCALARS)
        if roll < 0.55:
            fn = self.rng.choice(self.UN)
            inner = self.scalar(depth + 1)
            if fn == "sqrt":
                inner = f"abs({inner})"
            return f"{fn}({inner})"
        if roll < 0.8:
            op = self.rng.choice(self.BIN)
            return f"({self.scalar(depth + 1)} {op} {self.scalar(depth + 1)})"
        if roll < 0.9:
            return (f"(if {self.scalar(depth + 1)} >= 0 then "
                    f"{self.scalar(depth + 1)} else {self.scalar(depth + 1)} end)")
        return f"clamp({self.scalar(depth + 1)}, 0, 1)"

    def program(self):
        kind = self.rng.rand()
        body = self.scalar()
        if kind < 0.5:
            return f"grayColor(clamp({body}, 0, 1))"
        if kind < 0.65:
            return (f"v = {body}; w = {self.scalar()}; "
                    f"grayColor(clamp(v * 0.5 + w * 0.25, 0, 1))"
                    )
        if kind < 0.75:
            n = int(self.rng.randint(2, 8))  # NOT pinned to the K=4 unroll
            return (f"i = 0; s = 0; while i < {n} do s = s + {body}; "
                    f"i = i + 1 end; grayColor(clamp(s / {n}, 0, 1))")
        if kind < 0.82:
            # static bound derived from geometry internals (W=12 here) —
            # folds through the const mirror and unrolls
            return (f"i = 0; s = 0; while i < W / 4 do s = s + {body}; "
                    f"i = i + 1 end; grayColor(clamp(s / 3, 0, 1))")
        if kind < 0.9:
            # nested loops: outer static (unrolls), inner alternates
            # static / pixel-dependent (stays masked-lax) per seed
            ni, no = int(self.rng.randint(2, 5)), int(self.rng.randint(2, 4))
            inner_cond = (f"j < {ni}" if self.rng.rand() < 0.5
                          else f"j + abs(x) * 0 < {ni}")
            return (f"s = 0; i = 0; while i < {no} do "
                    f"  j = 0; while {inner_cond} do "
                    f"    s = s + {body} * 0.1; j = j + 1 end; "
                    f"  i = i + 1 end; "
                    f"grayColor(clamp(s / {ni * no}, 0, 1))")
        if kind < 0.95:
            # INTERNAL-variable shadowing (review r3 semantics): branch-
            # only and in-loop assignments to y/t must merge against the
            # internal's value on both backends
            iv = self.rng.choice(["y", "t"])
            n = int(self.rng.randint(2, 5))
            if self.rng.rand() < 0.5:
                return (f"if {self.scalar()} > 0 then {iv} = -{iv} end; "
                        f"grayColor(clamp(abs({iv}) / 8 + {body} * 0.1, 0, 1))")
            return (f"i = 0; s = 0; while i < {n} do {iv} = {iv} * 0.7; "
                    f"s = s + {iv}; i = i + 1 end; "
                    f"grayColor(clamp(abs(s) / 8, 0, 1))")
        # rand() inside a loop + after it (the r1 divergence class), and
        # assignments in the loop condition
        n = int(self.rng.randint(2, 7))
        return (f"i = 0; s = 0; k = 0; "
                f"while k = k + 1; i < {n} do "
                f"s = s + rand(0, 1) * 0.1 + {body} * 0.1; i = i + 1 end; "
                f"grayColor(clamp(s / {n} + rand(0, 0.25) + k / 100, 0, 1))")


@pytest.mark.parametrize("seed", range(60))
def test_random_expression_parity(seed):
    src = ExprGen(seed).program()
    img = np.random.RandomState(seed).rand(H, W, 4).astype(np.float32)
    img[..., 3] = 1.0
    f = mm.compile(src)
    oracle = f.render(img, interpret=True)
    jax_out = f.render(img)
    assert np.isfinite(oracle).all(), src
    np.testing.assert_allclose(jax_out, oracle, rtol=1e-3, atol=1e-4, err_msg=src)


@pytest.mark.parametrize("seed", range(100, 112))
def test_random_warp_matches_oracle(seed):
    """Random bounded warps through origVal (random amplitude/frequency and
    interpolation) on the jit gather path vs the oracle."""
    rng = np.random.RandomState(seed)
    amp = float(rng.uniform(0.5, 6.0))
    fx = float(rng.uniform(0.05, 0.4))
    fy = float(rng.uniform(0.05, 0.4))
    src = (f"filter fwarp (image in)\n"
           f"  in(xy + xy:[{amp:.3f} * sin(y * {fy:.3f}),"
           f" {amp:.3f} * cos(x * {fx:.3f})])\nend")
    interp = ["bilinear", "bicubic"][seed % 2]
    img = rng.rand(72, 320, 4).astype(np.float32)
    f = mm.compile(src)
    opts = mm.RenderOptions(interpolation=interp)
    a = f.render(img, width=320, height=72, t=0.0, options=opts)
    b = f.render(img, width=320, height=72, t=0.0, options=opts,
                 interpret=True)
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=5e-5,
                               err_msg=f"{interp} amp={amp}")


@pytest.mark.parametrize("seed", range(200, 210))
def test_random_anisotropic_affine_warp_matches_oracle(seed):
    """Random ANISOTROPIC affine warps (independent x/y scales and a
    shear) at each interpolation: jit gather vs the oracle."""
    rng = np.random.RandomState(seed)
    sx = float(rng.uniform(0.3, 3.5))
    sy = float(rng.uniform(0.3, 3.5))
    shear = float(rng.uniform(-1.5, 1.5))
    src = (f"filter aff (image in)\n"
           f"  in(xy:[x * {sx:.3f} + y * {shear:.3f}, y * {sy:.3f}])\nend")
    img = rng.rand(64, 256, 4).astype(np.float32)
    interp = ["nearest", "bilinear", "bicubic"][seed % 3]
    f = mm.compile(src)
    opts = mm.RenderOptions(interpolation=interp)
    a = f.render(img, width=256, height=64, options=opts)
    b = f.render(img, width=256, height=64, options=opts, interpret=True)
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=1e-4,
                               err_msg=f"sx={sx} sy={sy} shear={shear}")


@pytest.mark.parametrize("seed", range(220, 228))
def test_random_animated_frame_indexing_parity(seed):
    """Random frame-index expressions over animated inputs: jit must match
    the oracle."""
    rng = np.random.RandomState(seed)
    t_frames = int(rng.randint(2, 5))
    k = int(rng.randint(0, t_frames + 2))  # may exceed T-1: clamps
    exprs = [
        f"origValXY(x, y, {k})",
        f"origValXY(x * 0.9, y, if x > 0 then {k} else 0 end)",
        "origVal(xy * 0.8)",
    ]
    src = exprs[seed % 3]
    stack = rng.rand(t_frames, 24, 64, 4).astype(np.float32)
    f = mm.compile(src)
    frame = float(rng.randint(0, t_frames))
    opts = mm.RenderOptions(interpolation=["nearest", "bilinear"][seed % 2])
    a = f.render(stack, frame=frame, options=opts)
    b = f.render(stack, frame=frame, options=opts, interpret=True)
    np.testing.assert_allclose(a, b, atol=2e-5, err_msg=src)


@pytest.mark.parametrize("seed", range(40, 60))
def test_random_expression_supersampled_and_f64(seed):
    src = ExprGen(seed).program()
    img = np.random.RandomState(seed).rand(H, W, 4).astype(np.float32)
    img[..., 3] = 1.0
    f = mm.compile(src)
    o32 = f.render(img, interpret=True,
                   options=mm.RenderOptions(supersample=2))
    o64 = f.render(img, interpret=True, precision="f64",
                   options=mm.RenderOptions(supersample=2))
    assert np.isfinite(o32).all(), src
    np.testing.assert_allclose(o32, o64, atol=2e-4, err_msg=src)


@pytest.mark.parametrize("seed", range(200, 206))
def test_random_static_vs_traced_param_parity(seed):
    """Baking an int param (static_params) must be bit-identical to the
    traced-param program AND the oracle, for random loop bodies."""
    g = ExprGen(seed)
    body = g.scalar()
    n = int(g.rng.randint(2, 7))
    src = (f"filter f (int n: 1-8 ({n})) "
           f"s = 0; i = 0; while i < n do s = s + {body} * 0.1; "
           f"i = i + 1 end; grayColor(clamp(s / n, 0, 1)) end")
    f = mm.compile(src)
    img = np.random.RandomState(seed).rand(H, W, 4).astype(np.float32)
    img[..., 3] = 1.0
    val = int(g.rng.randint(1, 9))
    o = f.render(img, interpret=True, params={"n": val})
    traced = f.render(img, params={"n": val})
    baked = f.render(img, params={"n": val},
                     options=mm.RenderOptions(static_params=("n",)))
    np.testing.assert_allclose(traced, o, rtol=1e-3, atol=1e-4, err_msg=src)
    np.testing.assert_allclose(baked, o, rtol=1e-3, atol=1e-4, err_msg=src)


def test_static_params_validation_consistent_with_oracle():
    """The oracle path raises the same static_params errors as jit."""
    f = mm.compile("filter f (int n: 1-8 (3)) grayColor(n / 8) end")
    img = np.zeros((H, W, 4), np.float32)
    for interp in (False, True):
        with pytest.raises(ValueError, match="not declared"):
            f.render(img, interpret=interp,
                     options=mm.RenderOptions(static_params=("zzz",)))


class ConstBoundGen:
    """Random literal-only expressions through the round-3 extended
    _CONST_FOLD_OPS (transcendentals, constructors): used as while-loop
    bounds, they must fold at trace time and the loop must UNROLL, with
    jit == oracle. NaN-producing compositions (log2 of a negative, ...)
    are fair game: a NaN bound means a 0-iteration loop on BOTH paths."""

    LITS = ["1.3", "0.7", "2.0", "0.25", "3.1", "-0.6"]
    UN = ["sin", "cos", "tanh", "exp2", "log2", "atan", "sinh", "asinh",
          "deg2rad", "rad2deg", "sqrt", "acos", "atanh"]
    BIN = ["+", "*", "-"]

    def __init__(self, seed):
        self.rng = np.random.RandomState(seed)

    def expr(self, depth=0):
        roll = self.rng.rand()
        if depth > 2 or roll < 0.35:
            return self.rng.choice(self.LITS)
        if roll < 0.6:
            return f"{self.rng.choice(self.UN)}({self.expr(depth + 1)})"
        if roll < 0.75:
            return (f"atan2({self.expr(depth + 1)}, {self.expr(depth + 1)})")
        if roll < 0.85:
            return f"gray(rgbaColor({self.expr(depth + 1)}, 0.5, 0.25, 1))"
        op = self.rng.choice(self.BIN)
        return f"({self.expr(depth + 1)} {op} {self.expr(depth + 1)})"


@pytest.mark.parametrize("seed", range(200, 215))
def test_fuzz_const_bound_folds_and_unrolls(seed):
    from tests.test_language import _WhileSpy

    g = ConstBoundGen(seed)
    bound = f"clamp(floor(abs({g.expr()})) % 5 + 2, 2, 8)"
    src = (f"n = {bound}; s = 0; i = 0; while i < n do "
           f"s = s + 0.1; i = i + 1 end; grayColor(clamp(s, 0, 1))")
    img = np.random.RandomState(seed).rand(H, W, 4).astype(np.float32)
    f = mm.compile(src)
    oracle = f.render(img, interpret=True)
    with _WhileSpy() as spy:
        jax_out = f.render(img)
    assert spy.calls == 0, f"bound must fold+unroll: {src}"
    np.testing.assert_allclose(jax_out, oracle, atol=1e-6, err_msg=src)


@pytest.mark.parametrize("seed", range(300, 316))
def test_random_expression_sharded_parity(seed, while_kernel_interpret):
    """Random programs (loops, shadowing, rand, sampling) rendered over a
    virtual device mesh must match the unsharded render to ~1 ulp — the
    sharding layer may not change semantics for any language feature.
    (Not bitwise: XLA lowers transcendentals with shape-dependent
    vectorization, so sin() on a 16x8 tile can differ from the 16x32
    program by 1 ulp even with identical inputs — observed on seed 311's
    column mesh with DEFAULT options.) Odd seeds force the per-pixel loop
    kernel (interpret mode; it runs inside mesh tiles), so loop-bearing
    programs fuzz that path sharded too."""
    from mathmap_tpu.parallel.mesh import make_mesh
    from mathmap_tpu.parallel.shard import ShardedRenderer

    h, w = 16, 32
    src = ExprGen(seed).program()
    img = np.random.RandomState(seed).rand(h, w, 4).astype(np.float32)
    img[..., 3] = 1.0
    opts = (mm.RenderOptions(pallas_while="on") if seed % 2
            else mm.RenderOptions())
    f = mm.compile(src)
    want = np.asarray(f.render(img, width=w, height=h, t=0.3, options=opts))
    mesh = make_mesh(1, 8, 1) if seed % 4 < 2 else make_mesh(1, 2, 4)
    r = ShardedRenderer(mesh, f.filters, f.fdef, w, h, opts, 1)
    got = np.asarray(r([img], t=0.3))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6, err_msg=src)


@pytest.mark.parametrize("seed", range(400, 412))
def test_random_batch_matches_lone_renders(seed):
    """render_batch over random programs with PER-JOB param values, ts and
    inputs must equal each job's lone render — the serving layer's core
    coalescing invariant, fuzzed (its unit tests pin fixed filters only).
    frames=0 per job matches render()'s default frame."""
    g = ExprGen(seed)
    body = g.scalar()
    src = (f"filter f (image in, float p: 0-2 (1)) "
           f"grayColor(clamp(({body}) * 0.3 + p * 0.2, 0, 1)) end")
    f = mm.compile(src)
    rng = np.random.RandomState(seed)
    n = int(rng.randint(2, 5))
    imgs = rng.rand(n, H, W, 4).astype(np.float32)
    ts = rng.rand(n).astype(np.float32)
    ps = [{"p": float(rng.uniform(0, 2))} for _ in range(n)]
    batched = f.render_batch(imgs, ts=ts, frames=[0.0] * n, params=ps)
    for i in range(n):
        lone = f.render(imgs[i], t=float(ts[i]), params=ps[i])
        np.testing.assert_allclose(
            batched[i], lone, rtol=1e-5, atol=1e-5,
            err_msg=f"{src} job {i} p={ps[i]}")


@pytest.mark.parametrize("seed", range(500, 508))
def test_random_warp_random_edges_matches_oracle(seed):
    """Random bounded warps under random per-axis edge behaviors (wrap,
    reflect, color with a random color): taps past the image edge map
    through the edge rule on the jit path exactly as in the oracle."""
    rng = np.random.RandomState(seed)
    amp = float(rng.uniform(0.5, 6.0))
    fx = float(rng.uniform(0.05, 0.4))
    fy = float(rng.uniform(0.05, 0.4))
    src = (f"filter fwarp (image in)\n"
           f"  in(xy + xy:[{amp:.3f} * sin(y * {fy:.3f}),"
           f" {amp:.3f} * cos(x * {fx:.3f})])\nend")
    edges = ("wrap", "reflect", "color")
    ex, ey = edges[int(rng.randint(3))], edges[int(rng.randint(3))]
    color = tuple(float(c) for c in rng.rand(4))
    img = rng.rand(72, 320, 4).astype(np.float32)
    f = mm.compile(src)
    opts = mm.RenderOptions(edge_x=ex, edge_y=ey, edge_color=color)
    a = f.render(img, width=320, height=72, t=0.0, options=opts)
    b = f.render(img, width=320, height=72, t=0.0, options=opts,
                 interpret=True)
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=5e-5,
                               err_msg=f"edges={ex}/{ey} amp={amp}")


class AlgebraGen:
    """Random well-typed programs over the ALGEBRAIC surface the scalar
    generator skips: complex `ri:` arithmetic (incl. the dispatching
    overloads review r3 fixed), tuple literals + sub-assignment, color
    space round-trips, polar converts, matrix/vector and quat products."""

    def __init__(self, seed):
        self.rng = np.random.RandomState(seed)

    def scalar(self):
        return self.rng.choice([
            "x / 8", "y / 8", "r / 9", "t", "0.3", "-0.45", "1.2",
            "gray(origVal(xy))", "sin(a)"])

    def cplx(self, depth=0):
        roll = self.rng.rand()
        if depth > 2 or roll < 0.3:
            return self.rng.choice([
                f"ri:[{self.scalar()}, {self.scalar()}]",
                "ri:[0.3, -0.2]", "I * (x / 9)", "ri:(y / 8)"])
        z, w = self.cplx(depth + 1), self.cplx(depth + 1)
        if roll < 0.45:
            return f"({z} * {w})"
        if roll < 0.55:  # guarded division
            return f"({z} / ({w} + ri:[2, 0]))"
        if roll < 0.65:
            return f"({z} + {w})"
        if roll < 0.72:
            return f"conj({z})"
        if roll < 0.8:
            return f"({z} ^ 2)"
        if roll < 0.88:
            return f"exp({z} * 0.3)"
        if roll < 0.94:
            return f"sqrt({z})"
        return f"(1 / ({z} + ri:[1.5, 0]))"  # review r3: 1/z dispatch

    def program(self):
        kind = self.rng.rand()
        if kind < 0.3:
            z = self.cplx()
            out = self.rng.choice([f"abs({z}) / 4",
                                   f"arg({z} + ri:[1.5, 0]) / 7",
                                   f"({z})[0] * 0.5 + 0.5"])
            return f"grayColor(clamp({out}, 0, 1))"
        if kind < 0.5:
            i = int(self.rng.randint(0, 3))
            return (f"v = [{self.scalar()}, {self.scalar()}, "
                    f"{self.scalar()}]; v[{i}] = {self.scalar()}; "
                    f"rgbColor(clamp(v[0], 0, 1), clamp(v[1], 0, 1), "
                    f"clamp(v[2], 0, 1))")
        if kind < 0.62:
            sh = self.rng.choice(["0.25", "t", "x / W + 0.5"])
            return (f"c = toHSVA(origVal(xy)); c[0] = c[0] + {sh}; "
                    f"c[0] = c[0] - floor(c[0]); toRGBA(c)")
        if kind < 0.74:
            da = self.rng.choice(["0.5", "a * 0.1", "t + 0.2"])
            return (f"p = toRA(xy); p[1] = p[1] + {da}; "
                    f"origVal(toXY(p))")
        if kind < 0.86:
            s = self.scalar()
            return (f"m = m2x2:[1.1, {s}, 0.2, 0.9]; w = m * xy:[x/8, y/8]; "
                    f"grayColor(clamp(abs(w) / 4 + det(m) * 0.05, 0, 1))")
        q = f"quat:[{self.scalar()}, {self.scalar()}, 0.2, 0.8]"
        tag = self.rng.choice(["quat", "cquat", "hyper"])
        return (f"q = {tag}:{q}; p = q * q; "
                f"grayColor(clamp(abs(p) / 6, 0, 1))")


@pytest.mark.parametrize("seed", range(400, 440))
def test_random_algebra_parity(seed):
    src = AlgebraGen(seed).program()
    img = np.random.RandomState(seed).rand(H, W, 4).astype(np.float32)
    img[..., 3] = 1.0
    f = mm.compile(src)
    oracle = f.render(img, interpret=True)
    jax_out = f.render(img)
    assert np.isfinite(oracle).all(), src
    np.testing.assert_allclose(jax_out, oracle, rtol=1e-3, atol=1e-4,
                               err_msg=src)


@pytest.mark.parametrize("seed", range(500, 512))
def test_random_curve_gradient_lut_parity(seed):
    """Random curve/gradient LUT params through both backends (the LUT
    application rides the sampling kernel on the jit path)."""
    rng = np.random.RandomState(seed)
    lut = np.clip(rng.rand(int(rng.randint(2, 40))), 0, 1).astype(np.float32)
    grad = np.clip(rng.rand(int(rng.randint(2, 17)), 4), 0, 1).astype(np.float32)
    src = ("filter f (image in, curve cv, gradient g) "
           "u = clamp(abs(x / X), 0, 1); "
           "0.5 * g(u) + 0.5 * grayColor(cv(clamp(abs(y / Y), 0, 1))) end")
    img = np.random.RandomState(seed + 1).rand(H, W, 4).astype(np.float32)
    f = mm.compile(src)
    params = {"cv": lut, "g": grad}
    oracle = f.render(img, params=params, interpret=True)
    jax_out = f.render(img, params=params)
    np.testing.assert_allclose(jax_out, oracle, rtol=1e-3, atol=2e-4,
                               err_msg=f"lut={lut.shape} grad={grad.shape}")


class ExoticGen:
    """Random programs over the round-5-fixed exotic semantics classes:
    do-while loops (carry pre-pass repacking), branch-only shadowing of
    internals at a WIDER length, internal reads before in-loop shadowing,
    dynamic-index sub-assignment (floor/clamp l-value rule), assignment-
    as-expression nesting, and user tags. Each class had a silent
    both-backend or oracle/jit divergence bug found by targeted review —
    this fuzzes their compositions."""

    def __init__(self, seed):
        self.rng = np.random.RandomState(seed)

    def scalar(self):
        return self.rng.choice([
            "x / 9", "y / 9", "t", "0.7", "-0.3", "a * 0.2",
            "gray(origVal(xy))"])

    def idx(self):
        # dynamic indices: fractional (floors), negative / past-end (clamps)
        return self.rng.choice([
            "1.7", "-0.5", "4.2", "0.0", "abs(x) / 5", "2 + t",
            "(if x > 0 then 1 else 2 end)"])

    def program(self):
        r = self.rng.rand()
        sc = self.scalar()
        if r < 0.18:
            n = int(self.rng.randint(2, 6))
            body = f"s = s + {sc}; i = i + 1"
            return (f"i = 0; s = 0; do {body} while i < {n} end; "
                    f"grayColor(clamp(s / {n}, 0, 1))")
        if r < 0.34:
            # do-while whose body momentarily narrows a carried var
            n = int(self.rng.randint(2, 5))
            return (f"i = 0; v = [0.1, 0.2]; do v = v[0]; "
                    f"v = [v + {sc} * 0.1, v * 0.5]; i = i + 1 "
                    f"while i < {n} end; "
                    f"grayColor(clamp(abs(v[0]) + abs(v[1]), 0, 1))")
        if r < 0.5:
            iv = self.rng.choice(["y", "t", "a"])
            # the trailing term must not reference the (possibly widened)
            # internal at scalar length — that is an ill-typed program
            return (f"if {sc} > 0 then {iv} = xy end; "
                    f"grayColor(clamp(abs({iv}[0]) / 9 + x * 0.01, 0, 1))")
        if r < 0.64:
            n = int(self.rng.randint(2, 5))
            iv = self.rng.choice(["y", "t"])
            return (f"i = 0; s = 0; while i < {n} do s = s + {iv}[0]; "
                    f"{iv} = xy * 0.8; i = i + 1 end; "
                    f"grayColor(clamp(abs(s) / 20, 0, 1))")
        if r < 0.8:
            return (f"v = [0.2, 0.4, 0.6]; v[{self.idx()}] = {sc}; "
                    f"v[{self.idx()}] = {self.scalar()}; "
                    f"grayColor(clamp((v[0] + v[1] + v[2]) / 3, 0, 1))")
        if r < 0.9:
            return (f"q = (p = {sc}) * 3 + (z = {self.scalar()}); "
                    f"grayColor(clamp(abs(q) / 4 + p * 0.1 + abs(z) * 0.1, "
                    f"0, 1))")
        return (f"w = tagx:[{sc}, 0.2]; w[{self.idx()}] = {self.scalar()}; "
                f"grayColor(clamp(abs(w[0]) + abs(w[1]), 0, 1))")


@pytest.mark.parametrize("seed", range(600, 630))
def test_random_exotic_semantics_parity(seed):
    src = ExoticGen(seed).program()
    img = np.random.RandomState(seed).rand(H, W, 4).astype(np.float32)
    img[..., 3] = 1.0
    f = mm.compile(src)
    oracle = f.render(img, interpret=True)
    jax_out = f.render(img)
    assert np.isfinite(oracle).all(), src
    np.testing.assert_allclose(jax_out, oracle, rtol=1e-3, atol=1e-4,
                               err_msg=src)


def test_mutated_sources_raise_mmerror_only():
    """Error-surface fuzz: random token soup and span-mutated library
    sources must either compile or raise a structured MMError — never a
    raw Python exception (400 committed trials; a 4000-trial offline
    sweep ran clean)."""
    import glob
    import random

    from mathmap_tpu.utils.errors import MMError

    srcs = [open(p).read()
            for p in sorted(glob.glob("filters/*/*.mm"))[:40]]
    toks = ["filter", "if", "then", "else", "end", "while", "do", "(",
            ")", "[", "]", ",", ";", ":", "=", "+", "-", "*", "/", "^",
            "%", "xy", "x", "y", "1.5", "2", "in", "origVal",
            "grayColor", '"s"', "!", "<", ">", "&&", "||", "ri",
            "image", "float", "int", "color", "curve"]
    rng = random.Random(0)
    for trial in range(400):
        mode = trial % 3
        if mode == 0:
            s = " ".join(rng.choice(toks)
                         for _ in range(rng.randrange(1, 40)))
        elif mode == 1:
            s = rng.choice(srcs)
            i = rng.randrange(len(s))
            s = s[:i] + s[min(len(s), i + rng.randrange(1, 30)):]
        else:
            s = rng.choice(srcs)
            i = rng.randrange(len(s) + 1)
            ins = " ".join(rng.choice(toks)
                           for _ in range(rng.randrange(1, 6)))
            s = s[:i] + ins + s[i:]
        try:
            mm.compile(s)
        except (MMError, RecursionError):
            pass  # structured error / documented nesting limit
