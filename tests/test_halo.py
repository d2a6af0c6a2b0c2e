"""Halo-exchange tiled rendering tests (SURVEY.md §2.2 SP row, §4 item 4):
input rows sharded over the mesh, halos exchanged via ppermute, output must
match the replicated-input render when displacement <= halo."""

import numpy as np
import pytest

import mathmap_tpu as mm
from mathmap_tpu.parallel.halo import TiledRenderer
from mathmap_tpu.parallel.mesh import make_mesh

H, W = 32, 16


def _image(seed=9):
    img = np.random.RandomState(seed).rand(H, W, 4).astype(np.float32)
    img[..., 3] = 1.0
    return img


def _tiled(src, img, halo, t=0.0, opts=None):
    f = mm.compile(src)
    mesh = make_mesh(1, 8, 1)
    r = TiledRenderer(mesh, f.filters, f.fdef, W, H, opts or mm.RenderOptions(), halo)
    return np.asarray(r(img, t=t))


def test_identity_tiled_matches():
    img = _image()
    src = "origVal(xy)"
    got = _tiled(src, img, halo=1)
    want = mm.compile(src).render(img, width=W, height=H)
    np.testing.assert_array_equal(got, want)


def test_bounded_shift_within_halo():
    img = _image()
    src = "origVal(xy + xy:[0, 2])"  # vertical shift by 2 rows
    got = _tiled(src, img, halo=3)
    want = mm.compile(src).render(img, width=W, height=H)
    np.testing.assert_array_equal(got, want)


def test_wave_displacement_within_halo():
    img = _image()
    src = "origVal(xy + xy:[0, 2 * sin(x / 3 + t)])"
    got = _tiled(src, img, halo=4, t=0.41)
    want = mm.compile(src).render(img, width=W, height=H, t=0.41)
    np.testing.assert_allclose(got, want, atol=1e-6)


def test_horizontal_access_unrestricted():
    img = _image()
    src = "origVal(xy + xy:[7 * sin(y / 5), 1])"
    got = _tiled(src, img, halo=2)
    want = mm.compile(src).render(img, width=W, height=H)
    np.testing.assert_allclose(got, want, atol=1e-6)


def test_halo_too_large_raises():
    img = _image()
    f = mm.compile("origVal(xy)")
    mesh = make_mesh(1, 8, 1)
    from mathmap_tpu.utils.errors import MMRuntimeError

    with pytest.raises(MMRuntimeError):
        TiledRenderer(mesh, f.filters, f.fdef, W, H, mm.RenderOptions(), halo=5)(img)


def test_filter_render_tiled_api():
    img = _image()
    f = mm.compile("origVal(xy + xy:[0, 2])")
    got = f.render_tiled(img, halo=3, mesh=make_mesh(1, 8, 1))
    want = f.render(img, width=W, height=H)
    np.testing.assert_array_equal(got, want)

def test_wrap_edge_across_global_seam():
    """edge_y='wrap' sampling across the global top/bottom seam must use the
    ring-wrapped halo rows (ADVICE r1 medium finding: the local index used
    to clip into the block, returning wrong rows at the seam)."""
    img = _image()
    opts = mm.RenderOptions(edge_y="wrap", edge_x="wrap")
    src = "origVal(xy + xy:[0, 3])"  # shifts past the top for the top rows
    got = _tiled(src, img, halo=3, opts=opts)
    want = mm.compile(src).render(img, width=W, height=H, options=opts)
    np.testing.assert_array_equal(got, want)


def test_reflect_edge_tiled():
    img = _image()
    opts = mm.RenderOptions(edge_y="reflect")
    src = "origVal(xy + xy:[0, 2])"
    got = _tiled(src, img, halo=3, opts=opts)
    want = mm.compile(src).render(img, width=W, height=H, options=opts)
    np.testing.assert_array_equal(got, want)

def test_auto_halo_inference():
    """halo='auto' sizes the halo from the static displacement bound
    (parallel/bounds.py) — VERDICT r1 item 10."""
    img = _image()
    src = "origVal(xy + xy:[0, 2 * sin(x / 3 + t)])"
    f = mm.compile(src)
    got = f.render_tiled(img, halo="auto", mesh=make_mesh(1, 8, 1), t=0.41)
    want = f.render(img, width=W, height=H, t=0.41)
    np.testing.assert_allclose(got, want, atol=1e-6)


def test_auto_halo_unbounded_raises():
    from mathmap_tpu.utils.errors import MMRuntimeError

    f = mm.compile("origVal(xy * xy)")
    with pytest.raises(MMRuntimeError, match="displacement bound"):
        f.render_tiled(_image(), halo="auto", mesh=make_mesh(1, 8, 1))


def test_too_small_halo_raises_not_clamps():
    """check=True turns an out-of-halo sample into an error instead of the
    silent clamp (VERDICT r1 item 10 'weak' finding)."""
    from mathmap_tpu.utils.errors import MMRuntimeError

    img = _image()
    f = mm.compile("origVal(xy + xy:[0, 3])")  # needs halo >= 4 rows
    with pytest.raises(MMRuntimeError, match="bounded-displacement"):
        f.render_tiled(img, halo=1, mesh=make_mesh(1, 8, 1))
    # same render with check=False silently clamps (legacy behavior)
    out = f.render_tiled(img, halo=1, mesh=make_mesh(1, 8, 1), check=False)
    assert np.isfinite(out).all()


def test_column_sharded_tiles():
    img = _image()
    src = "origVal(xy + xy:[2 * sin(y / 4), 2 * sin(x / 3)])"
    f = mm.compile(src)
    got = f.render_tiled(img, halo="auto", mesh=make_mesh(1, 2, 4))
    want = f.render(img, width=W, height=H)
    np.testing.assert_allclose(got, want, atol=1e-6)


def test_column_sharded_wrap_seam():
    img = _image()
    opts = mm.RenderOptions(edge_x="wrap", edge_y="wrap")
    f = mm.compile("origVal(xy + xy:[3, 2])")
    got = f.render_tiled(img, halo=(3, 4), mesh=make_mesh(1, 2, 4), options=opts)
    want = f.render(img, width=W, height=H, options=opts)
    np.testing.assert_array_equal(got, want)


def test_bounds_inference_cases():
    from mathmap_tpu.parallel.bounds import infer_displacement_bound

    cases = [
        ("origVal(xy)", (0.0, 0.0)),
        ("origVal(xy + xy:[0, 2])", (2.0, 0.0)),
        ("origVal(xy + xy:[3 * sin(y/5), 2 * sin(x/3 + t)])", (2.0, 3.0)),
        ("filter f (image in, float amp: 0-5 (2)) in(xy + xy:[0, amp * sin(x)]) end",
         (5.0, 0.0)),
        ("v = 1; if x > 0 then v = 4 end; origVal(xy + xy:[0, v])", (4.0, 0.0)),
        ("origVal(toXY(ra:[r + 5 * sin(r * 0.3), a]))", (5.0, 5.0)),
    ]
    for src, want in cases:
        f = mm.compile(src)
        got = infer_displacement_bound(f.filters, f.fdef, 320, 200)
        assert got is not None, src
        np.testing.assert_allclose(got, want, err_msg=src)
    f = mm.compile("origVal(xy * xy)")
    got = infer_displacement_bound(f.filters, f.fdef, 320, 200)
    assert got is None or got[0] > 200  # unbounded or larger than any tile


def test_tiled_check_with_sampling_inside_loop():
    """check=True must not leak the violation tracer out of a while loop
    (r2 review finding: UnexpectedTracerError); loop-body samples are
    excluded from the check but the render must succeed and match."""
    img = _image()
    src = ("s = 0; i = 0; while i < 3 do "
           "s = s + red(origVal(xy + xy:[0, i])); i = i + 1 end; "
           "grayColor(s / 3)")
    f = mm.compile(src)
    got = f.render_tiled(img, halo=3, mesh=make_mesh(1, 8, 1))
    want = f.render(img, width=W, height=H)
    np.testing.assert_allclose(got, want, atol=1e-6)


# -- review r3 regressions: halo soundness --------------------------------

def test_halo_zero_is_no_exchange():
    """halo=0 must render the identity exactly (regression: slice(-0,None)
    prepended the ENTIRE neighbor block — silent corruption even
    check=True missed)."""
    img = _image(11)
    got = _tiled("origVal(xy)", img, 0,
                 opts=mm.RenderOptions(interpolation="nearest"))
    want = mm.compile("origVal(xy)").render(
        img, options=mm.RenderOptions(interpolation="nearest"))
    np.testing.assert_allclose(got, np.asarray(want), atol=1e-6)


def test_negative_halo_rejected():
    from mathmap_tpu.utils.errors import MMRuntimeError

    with pytest.raises(MMRuntimeError, match=">= 0"):
        _tiled("origVal(xy)", _image(), -1)


def test_auto_halo_rows_only_ignores_x_bound():
    """A horizontal flip (dx = width) on a rows-only mesh must work with
    halo='auto': columns are unsharded, so the x-bound is irrelevant
    (regression: auto wrongly raised 'cannot infer')."""
    img = _image(12)
    f = mm.compile("origValXY(-x, y)")
    got = f.render_tiled(img, halo="auto", mesh=make_mesh(1, 8, 1),
                         options=mm.RenderOptions(interpolation="nearest"))
    want = f.render(img, options=mm.RenderOptions(interpolation="nearest"))
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=1e-6)


def test_auto_halo_covers_origval_image():
    """origValImage is a sampling site for displacement inference
    (regression: its displacement was ignored entirely)."""
    img = _image(13)
    f = mm.compile("filter g (image in) origValImage(in, xy + xy:[0, 2]) end")
    got = f.render_tiled(img, halo="auto", mesh=make_mesh(1, 8, 1),
                         options=mm.RenderOptions(interpolation="nearest"))
    want = f.render(img, options=mm.RenderOptions(interpolation="nearest"))
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=1e-6)


def test_bounds_soundness_review_cases():
    """Interval-inference soundness (review r3): patterns that used to
    UNDER-estimate displacement now bound (or reject) correctly."""
    from mathmap_tpu.parallel.bounds import infer_displacement_bound

    def bound(src, w=40, h=128):
        f = mm.compile(src)
        return infer_displacement_bound(f.filters, f.fdef, w, h, None)

    # if-without-else yields ZERO on the false branch — affine
    # cancellation must not hide the displacement
    b = bound("d = (if x > 0 then y end) - y; origVal(xy + xy:[0, d])")
    assert b is not None and b[0] >= 64.0, b
    # clamp bounds are per-component
    b = bound("d = xy * xy; origVal(xy + clamp(d, xy:[-2, -12], xy:[2, 12]))")
    assert b == (12.0, 2.0), b
    # while in expression position: loop-assigned vars are unbounded ->
    # inference must return None (auto refuses), not (0, 0)
    b = bound("s = 0; q = 1 + (while s < 9 do s = s + 3 end); "
              "origVal(xy + xy:[0, s])")
    assert b is None, b
    # samples inside a sub-assignment INDEX are recorded
    b = bound("v = xy; v[origVal(xy + xy:[0, 8])[0]] = 1; origVal(xy)")
    assert b is not None and b[0] >= 8.0, b
    # samples inside origValXY's frame argument are recorded
    b = bound("origValXY(x, y, origVal(xy + xy:[0, 8])[0])")
    assert b is not None and b[0] >= 8.0, b


def test_bounds_soundness_alias_and_unknown_calls():
    """Review r5: image-ALIAS calls (q = in; q(...)) were invisible to the
    walker — an unsound (0, 0) auto-halo bound; computed callees, calls of
    unclassified names and gaussian_blur's unmodeled footprint silently
    returned TOP with no sample recorded. Aliases now record the sample
    site; the rest go unbounded (None — auto refuses with guidance)."""
    from mathmap_tpu.parallel.bounds import infer_displacement_bound

    def bound(src, w=40, h=128):
        f = mm.compile(src)
        return infer_displacement_bound(f.filters, f.fdef, w, h, None)

    # direct alias and alias-of-alias record the sampling displacement
    b = bound("filter f (image in) q = in; q(xy + xy:[10, 0]) end")
    assert b is not None and b[1] >= 10.0, b
    b = bound("filter f (image in) q = in; p = q; p(xy + xy:[0, 3]) end")
    assert b is not None and b[0] >= 3.0, b
    # calling an unclassified local (may hold an image/closure) -> None
    assert bound("filter f (image in) q = 5; q(xy) end") is None
    # native blur footprint is not modeled -> None, not footprint-free
    assert bound("filter f (image in) gaussianBlur(in, 2) end") is None
    # curve/gradient params stay bounded under the strict unknown-call rule
    b = bound("filter f (image in, curve cv, gradient g) "
              "0.5 * g(clamp(x / X, 0, 1)) + 0.5 * "
              "grayColor(cv(clamp(y / Y, 0, 1))) * in(xy) end")
    assert b == (0.0, 0.0), b


@pytest.mark.parametrize("name", ["emboss", "edge_detect", "ripple",
                                  "jitter", "mirror"])
def test_library_filters_tiled_auto_halo_match_plain(name):
    """Representative library filters render identically under
    render_tiled(halo='auto') vs the plain render — the committed slice of
    the round-5 whole-library sweep (101 bounded filters exact, 41
    correctly refused, 0 failures). Bound shapes covered: conv-kernel
    taps (emboss/edge_detect), trig displacement (ripple), rand
    displacement (jitter), and a full-width x-flip whose x-bound is
    irrelevant on a rows-only mesh (mirror)."""
    import jax

    from mathmap_tpu.expression_db import default_db

    db = default_db()
    f = db.compile(name)
    h = w = 128
    img = np.random.RandomState(11).rand(h, w, 4).astype(np.float32)
    img[..., 3] = 1.0
    # 2-row mesh: 64-row tiles fit every bound here (ripple needs 27)
    mesh = make_mesh(1, 2, 1, devices=jax.devices()[:2])
    want = np.asarray(f.render(img, width=w, height=h, t=0.3))
    got = np.asarray(f.render_tiled(img, width=w, height=h, halo="auto",
                                    mesh=mesh, t=0.3))
    # 1e-5, not 1e-6: differently-fused tiled programs sit ~1 ulp off the
    # plain render on trig-heavy filters (ripple: 7.6e-6 max)
    np.testing.assert_allclose(got, want, atol=1e-5)


def test_library_unbounded_filter_refuses_auto_halo():
    """A filter whose displacement the walker cannot bound (sharpen uses
    gaussian_blur — unmodeled conv footprint, review r5) refuses
    halo='auto' with guidance instead of rendering wrong."""
    import jax

    from mathmap_tpu.expression_db import default_db
    from mathmap_tpu.utils.errors import MMRuntimeError

    f = default_db().compile("sharpen")
    img = _image()
    mesh = make_mesh(1, 2, 1, devices=jax.devices()[:2])
    with pytest.raises(MMRuntimeError, match="displacement bound"):
        f.render_tiled(img, halo="auto", mesh=mesh)


def test_auto_halo_through_image_alias_end_to_end():
    """The aliased-sampling program renders exactly under halo='auto'
    (pre-r5 the bound was (0,0): check=True raised, check=False silently
    clamped at tile seams)."""
    img = _image(17)
    f = mm.compile("filter f (image in) q = in; q(xy + xy:[0, 2]) end")
    got = f.render_tiled(img, halo="auto", mesh=make_mesh(1, 8, 1))
    want = f.render(img)
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=1e-6)


class _DispGen:
    """Random bounded displacement expressions: the inferred bound must
    DOMINATE the empirical per-pixel displacement (soundness fuzz for
    parallel/bounds.py — review r3 found several under-estimates)."""

    def __init__(self, seed):
        self.rng = np.random.RandomState(seed)

    def scalar(self, depth=0):
        r = self.rng.rand()
        if depth > 2 or r < 0.3:
            return self.rng.choice(
                ["x / 8", "y / 8", "t * 2", "1.5", "-0.7", "0.3"])
        if r < 0.5:
            fn = self.rng.choice(["sin", "cos", "tanh"])
            return f"{fn}({self.scalar(depth + 1)})"
        if r < 0.62:
            return (f"clamp({self.scalar(depth + 1)}, "
                    f"{-self.rng.randint(1, 6)}, {self.rng.randint(1, 6)})")
        if r < 0.72:
            return (f"(if {self.scalar(depth + 1)} > 0 then "
                    f"{self.scalar(depth + 1)} end)")
        if r < 0.82:
            return f"abs({self.scalar(depth + 1)})"
        op = self.rng.choice(["+", "-", "*"])
        return f"({self.scalar(depth + 1)} {op} {self.scalar(depth + 1)})"


@pytest.mark.parametrize("seed", range(300, 330))
def test_fuzz_displacement_bound_is_sound(seed):
    from mathmap_tpu.parallel.bounds import infer_displacement_bound
    from mathmap_tpu.runtime.render import coordinate_grids
    from mathmap_tpu.runtime.tracer import Evaluator, RenderContext

    g = _DispGen(seed)
    dx_e, dy_e = g.scalar(), g.scalar()
    src = f"d = xy:[{dx_e}, {dy_e}]; origVal(xy + d)"
    f = mm.compile(src)
    w, h = 24, 16
    bound = infer_displacement_bound(f.filters, f.fdef, w, h, None)
    if bound is None:
        return  # refusing to bound is always sound

    # empirical max |displacement| straight off the oracle evaluator
    # (unclipped — a render would clamp the probe to [0,1])
    probe = mm.compile(f"filter p () xy:[{dx_e}, {dy_e}] end")
    max_dx = max_dy = 0.0
    for t in (0.0, 0.33, 0.77, 1.0):
        ctx = RenderContext(be=np, width=w, height=h,
                            opts=mm.RenderOptions(), filters=probe.filters,
                            is_jax=False, t=np.float32(t))
        x, y = coordinate_grids(ctx)
        ev = Evaluator(ctx, x, y, {})
        v = ev.eval(probe.fdef.body)
        max_dx = max(max_dx, float(np.abs(np.asarray(v.arrays[0])).max()))
        max_dy = max(max_dy, float(np.abs(np.asarray(v.arrays[1])).max()))
    dy_b, dx_b = bound
    assert dx_b + 1e-3 >= max_dx, (src, bound, max_dx)
    assert dy_b + 1e-3 >= max_dy, (src, bound, max_dy)


@pytest.mark.parametrize("seed", range(400, 420))
def test_fuzz_tiled_auto_halo_end_to_end_parity(seed):
    """End-to-end guard for the WHOLE halo='auto' chain (bound inference →
    ppermute exchange → tile assembly): a random bounded-displacement warp
    rendered input-sharded must match the replicated-input render exactly.
    The 30-seed soundness fuzz above checks the bound DOMINATES; this one
    checks the render built on that bound is RIGHT — an exchange or
    assembly bug would pass the bound check and fail here. A refusal to
    bound (inference returns None → MMError) is a sound outcome and
    skips."""
    g = _DispGen(seed)
    # /6: keep |d| well under the 4-row tile height so auto halos fit
    dx_e, dy_e = f"({g.scalar()}) / 6", f"({g.scalar()}) / 6"
    edge = ["color", "wrap", "reflect"][seed % 3]
    src = f"origVal(xy + xy:[{dx_e}, {dy_e}])"
    opts = mm.RenderOptions(edge_x=edge, edge_y=edge)
    img = _image(seed)
    f = mm.compile(src)
    t = float(np.random.RandomState(seed).rand())
    want = np.asarray(f.render(img, width=W, height=H, t=t, options=opts))
    try:
        got = f.render_tiled(img, halo="auto", mesh=make_mesh(1, 8, 1),
                             width=W, height=H, options=opts, t=t)
    except mm.MMError as e:
        pytest.skip(f"sound refusal: {e}")
    np.testing.assert_allclose(np.asarray(got), want, atol=1e-6,
                               err_msg=src)


# ---------------------------------------------------------------------------
# Tiled (input-sharded) renders vs the unsharded render: the gather samples
# the halo-extended local block with globally edge-mapped, then localized,
# tap indices. Parity is pinned against the unsharded render of the same
# options at rounding scale (the block coordinates are rebased).
# ---------------------------------------------------------------------------

PH, PW = 64, 512  # 8-row tiles on the 8-device row mesh


def _pimage(seed=21):
    img = np.random.RandomState(seed).rand(PH, PW, 4).astype(np.float32)
    img[..., 3] = 1.0
    return img


def _ktiled(src, img, halo, opts, mesh_shape=(1, 8, 1), t=0.0):
    f = mm.compile(src)
    mesh = make_mesh(*mesh_shape)
    r = TiledRenderer(mesh, f.filters, f.fdef, PW, PH, opts, halo)
    return np.asarray(r(img, t=t))


def _gather_want(src, img, opts, t=0.0):
    return np.asarray(mm.compile(src).render(img, width=PW, height=PH, t=t,
                                             options=opts))


def test_tiled_wave_matches_unsharded():
    """Bounded wave displacement, row mesh: the gather samples the
    halo-extended local block with localized tap indices."""
    img = _pimage()
    src = "origVal(xy + xy:[3 * sin(y / 9), 2 * sin(x / 7 + t)])"
    opts = mm.RenderOptions()
    got = _ktiled(src, img, halo=5, opts=opts, t=0.37)
    want = _gather_want(src, img, opts, t=0.37)
    np.testing.assert_allclose(got, want, atol=5e-5)


def test_tiled_wrap_seam_both_axes():
    """edge wrap on both axes: seam samples land on ring-wrapped halo
    content via the mod-global localization."""
    img = _pimage(22)
    src = "origVal(xy + xy:[0, 3])"  # top rows wrap to the bottom
    opts = mm.RenderOptions(edge_x="wrap", edge_y="wrap")
    got = _ktiled(src, img, halo=5, opts=opts)
    want = _gather_want(src, img, opts)
    np.testing.assert_allclose(got, want, atol=5e-5)


def test_tiled_reflect_edge_wave():
    """edge reflect: global-edge taps mirror GLOBALLY before they are
    localized, so the ring-wrapped halo of a global-edge device is never
    read."""
    img = _pimage(23)
    src = "origVal(xy + xy:[0, 2 * sin(x / 5)])"
    opts = mm.RenderOptions(edge_y="reflect")
    got = _ktiled(src, img, halo=4, opts=opts)
    want = _gather_want(src, img, opts)
    np.testing.assert_allclose(got, want, atol=5e-5)


def test_tiled_color_edge_nondefault_color():
    """edge color with a non-default color: out-of-image taps take the
    edge color, never halo content."""
    img = _pimage(24)
    src = "origVal(xy + xy:[0, 3])"
    opts = mm.RenderOptions(edge_color=(0.2, 0.4, 0.6, 1.0))
    got = _ktiled(src, img, halo=4, opts=opts)
    want = _gather_want(src, img, opts)
    np.testing.assert_allclose(got, want, atol=5e-5)


def test_tiled_column_sharded_wrap_both_axes():
    """2x4 mesh (rows AND columns sharded), wrap on x: the column axis
    localizes mod-global too."""
    img = _pimage(25)
    src = "origVal(xy + xy:[4 * sin(y / 6), 2 * sin(x / 8)])"
    opts = mm.RenderOptions(edge_x="wrap", edge_y="wrap")
    got = _ktiled(src, img, halo=(4, 6), opts=opts,
                        mesh_shape=(1, 2, 4))
    want = _gather_want(src, img, opts)
    np.testing.assert_allclose(got, want, atol=5e-5)


def test_tiled_bicubic_wave():
    img = _pimage(26)
    src = "origVal(xy + xy:[1.5 * sin(y / 7), 1.5 * cos(x / 9)])"
    opts = mm.RenderOptions(interpolation="bicubic")
    got = _ktiled(src, img, halo=5, opts=opts)
    want = _gather_want(src, img, opts)
    np.testing.assert_allclose(got, want, atol=5e-5)


def test_tiled_violation_raises_on_kernel_scale_frame():
    """check=True contract checking: the violation hook sees every tap."""
    img = _pimage(27)
    src = "origVal(xy + xy:[0, 6])"  # shift 6 > halo 2
    opts = mm.RenderOptions()
    f = mm.compile(src)
    r = TiledRenderer(make_mesh(1, 8, 1), f.filters, f.fdef, PW, PH, opts, 2)
    with pytest.raises(mm.MMError):
        r(img)


def test_tiled_mixed_warp_matches_unsharded():
    """Mixed-warp frames: displacement varies strongly across tiles."""
    img = _pimage(28)
    src = "origVal(xy + xy:[3 * sin(y / 9) * sin(x / 40), 2 * sin(x / 7)])"
    opts = mm.RenderOptions()
    got = _ktiled(src, img, halo=5, opts=opts)
    want = _gather_want(src, img, opts)
    np.testing.assert_allclose(got, want, atol=5e-5)


@pytest.mark.parametrize("seed", range(430, 436))
def test_fuzz_tiled_parity(seed):
    """Random bounded-displacement warps through the tiled route: parity
    vs the unsharded render across edge modes and mesh shapes. Catches
    localization bugs the hand-written cases above miss."""
    g = _DispGen(seed)
    dx_e = f"clamp(({g.scalar()}) / 4, -4, 4)"
    dy_e = f"clamp(({g.scalar()}) / 4, -4, 4)"
    edge = ["color", "wrap", "reflect"][seed % 3]
    mesh_shape = (1, 8, 1) if seed % 2 else (1, 2, 4)
    src = f"origVal(xy + xy:[{dx_e}, {dy_e}])"
    opts = mm.RenderOptions(edge_x=edge, edge_y=edge)
    img = _pimage(seed)
    t = float(np.random.RandomState(seed).rand())
    got = _ktiled(src, img, halo=7, opts=opts, mesh_shape=mesh_shape,
                        t=t)
    want = _gather_want(src, img, opts, t=t)
    np.testing.assert_allclose(got, want, atol=5e-5, err_msg=src)


def test_tiled_auto_halo_wave():
    """halo='auto' (affine-interval bound inference) on a wave warp: the
    margin covers the interpolation taps."""
    img = _pimage(31)
    src = "origVal(xy + xy:[3 * sin(y / 9), 2 * sin(x / 7)])"
    opts = mm.RenderOptions()
    f = mm.compile(src)
    got = np.asarray(f.render_tiled(img, halo="auto", mesh=make_mesh(1, 8, 1),
                                    width=PW, height=PH, options=opts))
    want = _gather_want(src, img, opts)
    np.testing.assert_allclose(got, want, atol=5e-5)


def test_tiled_nearest_mixed_edges():
    """nearest interpolation + differing per-axis edge modes through the
    tiled route (wrap rows, reflect cols on a 2x4 mesh)."""
    img = _pimage(32)
    src = "origVal(xy + xy:[2 * sin(y / 6), 3 * cos(x / 8)])"
    opts = mm.RenderOptions(interpolation="nearest",
                            edge_x="reflect", edge_y="wrap")
    got = _ktiled(src, img, halo=(5, 6), opts=opts,
                        mesh_shape=(1, 2, 4))
    want = _gather_want(src, img, opts)
    np.testing.assert_allclose(got, want, atol=5e-5)


# -- 1-device-axis localization regression ---------------------------------
# On a 1-device axis ext = global + 2*halo > global: make_gather's original
# mod-global localization wrapped in-contract bottom-edge taps onto the
# LEAD halo — accidentally correct while halos held ring-wrap content,
# silently mirrored once _paint_edge_halo rewrites global-edge halos for
# color/reflect. Reads must localize by plain shift +/- one period.



@pytest.mark.parametrize("check", [True, False])
@pytest.mark.parametrize("edges", [("wrap", "reflect"), ("reflect", "reflect"),
                                   ("color", "color"), ("wrap", "wrap")])
def test_tiled_one_device_axis_bottom_edge(check, edges):
    """ny=1 row axis still carries the interpolation-margin halo; bottom
    rows displaced past the global edge must read CONTENT rows, not the
    (possibly repainted) lead halo."""
    import jax

    mesh = make_mesh(1, 1, 1, devices=jax.devices()[:1])
    ex, ey = edges
    img = _pimage(40)
    src = "origVal(xy + xy:[6 * sin(y / 19), 5 * cos(x / 23 + t)])"
    opts = mm.RenderOptions(edge_x=ex, edge_y=ey)
    f = mm.compile(src)
    r = TiledRenderer(mesh, f.filters, f.fdef, PW, PH, opts, 8)
    got = np.asarray(r(img, t=0.3))
    want = _gather_want(src, img, opts, t=0.3)
    np.testing.assert_allclose(got, want, atol=5e-5, err_msg=f"{check} {edges}")


# -- review findings: thin halos, check=False clamp semantics ---------------

@pytest.mark.parametrize("interp,halo", [("nearest", 0), ("bilinear", 0),
                                         ("bilinear", 1), ("bicubic", 2)])
def test_tiled_thin_halo_wrap_stays_exact(interp, halo):
    """A halo thinner than the interpolation margin on a 1-device axis:
    wrap taps edge-map GLOBALLY before they are localized, so the render
    stays exact (review finding on an earlier route: halo=0 nearest/wrap
    gave max err 0.96 on the boundary row)."""
    import jax

    img = _pimage(50)
    src = "origVal(xy + xy:[0, 0.4 * sin(x / 7)])"
    opts = mm.RenderOptions(interpolation=interp, edge_y="wrap",
                            edge_x="wrap")
    f = mm.compile(src)
    mesh = make_mesh(1, 1, 1, devices=jax.devices()[:1])
    r = TiledRenderer(mesh, f.filters, f.fdef, PW, PH, opts, halo)
    got = np.asarray(r(img))
    want = _gather_want(src, img, opts)
    np.testing.assert_allclose(got, want, atol=5e-5)


def test_tiled_check_false_out_of_contract_is_clamped():
    """check=False + a displacement far past the halo: reads clamp into
    the block and return in-gamut content, never out-of-block reads."""
    img = _pimage(51)
    f = mm.compile("origVal(xy + xy:[0, 40])")
    opts = mm.RenderOptions()
    r = TiledRenderer(make_mesh(1, 8, 1), f.filters, f.fdef, PW, PH, opts,
                      4, check=False)
    got = np.asarray(r(img))
    assert np.isfinite(got).all()
    # clamped reads return REAL block content: within the image's range
    assert got.min() >= float(img.min()) - 1e-3
    assert got.max() <= float(img.max()) + 1e-3


def test_gather_check_false_below_block_clamps_to_near_edge():
    """check=False below-block violating taps must clamp to the nearest
    block row, NOT the lead halo (review finding: the first localize
    rewrite sent shift in [ext, n) negative, landing violations on the
    lead halo's content)."""
    img = _pimage(52)
    f = mm.compile("origVal(xy + xy:[0, -12])")
    opts = mm.RenderOptions(edge_y="color",
                            edge_color=(0.9, 0.1, 0.5, 1.0))
    r = TiledRenderer(make_mesh(1, 8, 1), f.filters, f.fdef, PW, PH, opts,
                      4, check=False)
    got = np.asarray(r(img))
    # device 0's top rows sample 12 rows below — past its ext bottom; the
    # clamp must return image content, never the magenta edge color
    top = got[:8]
    assert not np.any(np.all(np.isclose(top, [0.9, 0.1, 0.5, 1.0],
                                        atol=1e-3), axis=-1))


def test_tiled_sampling_inside_loop_wave():
    """Loop-body samples on the tiled route: the violation hook's own
    loop_depth gate keeps the traced excess out of the lax.while carry."""
    img = _pimage(60)
    src = ("s = 0; i = 0; while i < 3 do "
           "s = s + red(origVal(xy + xy:[0, i])); i = i + 1 end; "
           "grayColor(s / 3)")
    opts = mm.RenderOptions()
    got = _ktiled(src, img, halo=6, opts=opts)
    want = _gather_want(src, img, opts)
    np.testing.assert_allclose(got, want, atol=5e-5)


# -- multi-input tiled rendering --------------------------------------------

def test_tiled_multi_input_matches():
    """Two-image composition with every input sharded + halo-exchanged:
    matches the replicated-input render exactly on the gather path."""
    a, b = _pimage(70), _pimage(71)
    src = ("filter blend2 (image p, image q) "
           "p(xy + xy:[0, 2*sin(x/7)]) * 0.6 + "
           "q(xy + xy:[3*sin(y/9), 0]) * 0.4 end")
    f = mm.compile(src)
    got = f.render_tiled(a, b, halo="auto", mesh=make_mesh(1, 8, 1),
                         width=PW, height=PH)
    want = f.render(a, b, width=PW, height=PH)
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


def test_tiled_multi_input_column_mesh():
    """Multi-input tiled on a 2x4 mesh, both inputs displaced."""
    a, b = _pimage(72), _pimage(73)
    src = ("filter blend2 (image p, image q) "
           "p(xy + xy:[2*sin(y/6), 2*sin(x/7)]) * 0.5 + "
           "q(xy - xy:[2*cos(y/8), 1]) * 0.5 end")
    f = mm.compile(src)
    opts = mm.RenderOptions()
    got = f.render_tiled(a, b, halo=(5, 6), mesh=make_mesh(1, 2, 4),
                         width=PW, height=PH, options=opts)
    want = f.render(a, b, width=PW, height=PH,
                    options=mm.RenderOptions())
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=5e-5)


def test_tiled_multi_input_geometry_mismatch_raises():
    a = _pimage(74)
    b = np.zeros((PH // 2, PW, 4), np.float32)
    f = mm.compile("filter g (image p, image q) p(xy) + q(xy) end")
    with pytest.raises(ValueError, match="share the output geometry"):
        f.render_tiled(a, b, halo=2, mesh=make_mesh(1, 8, 1),
                       width=PW, height=PH)


def test_tiled_params_resolved():
    """render_tiled resolves raw param VALUES into uservals (previously it
    had no params path at all); unknown names raise eagerly."""
    img = _pimage(80)
    f = mm.compile_file("filters/Distorts/ripple.mm")
    got = f.render_tiled(img, halo=8, mesh=make_mesh(1, 8, 1),
                         width=PW, height=PH, params={"amplitude": 3.0})
    want = f.render(img, width=PW, height=PH, params={"amplitude": 3.0})
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))
    with pytest.raises(Exception, match="nope"):
        f.render_tiled(img, halo=8, mesh=make_mesh(1, 8, 1),
                       width=PW, height=PH, params={"nope": 1.0})


def test_tiled_composition_two_inputs():
    """A 2-input composer composition (.mmc) renders input-sharded: both
    source drawables halo-exchanged, displacement bound inferred across
    the whole composite graph."""
    from mathmap_tpu.expression_db import default_db

    f = default_db().compile("dual_overlay")
    a, b = _pimage(81), _pimage(82)
    # explicit halo: composite-graph param baking (amplitude=8 inside the
    # pond node) is opaque to the affine-interval bound walker
    got = f.render_tiled(a, b, halo=12, mesh=make_mesh(1, 2, 4),
                         width=PW, height=PH)
    want = f.render(a, b, width=PW, height=PH)
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


def test_tiled_animated_scalar_frame():
    """Animated (T, PH, PW, 4) stacks on the tiled route: a scalar frame
    selector frame-selects the sharded block up front, so the gather runs
    on the 3-D block exactly as for a plain tiled input. Parity vs the
    unsharded render at frame 1."""
    stack = np.stack([_pimage(31), _pimage(32)])
    src = "origVal(xy + xy:[3 * sin(y / 9), 2 * sin(x / 7)])"
    f = mm.compile(src)
    mesh = make_mesh(1, 8, 1)
    opts = mm.RenderOptions()
    r = TiledRenderer(mesh, f.filters, f.fdef, PW, PH, opts, 5)
    got = np.asarray(r(stack, frame=1.0))
    import dataclasses

    want = np.asarray(f.render(stack, width=PW, height=PH, frame=1.0,
                               options=opts))
    np.testing.assert_allclose(got, want, atol=5e-5)
    # frame 0 differs from frame 1 (the selector is honored, not ignored)
    got0 = np.asarray(r(stack, frame=0.0))
    assert np.abs(got0 - got).max() > 1e-3


def test_tiled_single_frame_stack():
    """(1, PH, PW, 4) stacks (single-frame GIFs stay 4-D) render like
    the 3-D image on the tiled route."""
    stack = _pimage(33)[None]
    src = "origVal(xy + xy:[0, 2 * sin(x / 7)])"
    f = mm.compile(src)
    mesh = make_mesh(1, 8, 1)
    opts = mm.RenderOptions()
    r = TiledRenderer(mesh, f.filters, f.fdef, PW, PH, opts, 4)
    got = np.asarray(r(stack))
    import dataclasses

    want = np.asarray(f.render(stack, width=PW, height=PH, options=opts))
    np.testing.assert_allclose(got, want, atol=5e-5)


def test_tiled_uint8_input_normalizes_in_trace():
    """uint8 inputs ride the tiled path as u8 (4x smaller upload) and
    normalize /255 in-trace per block — equal to pre-converted float
    inputs to f32 rounding (the /255 itself is exact; XLA may fuse it
    into downstream arithmetic at 1-ulp differences), plain and
    animated."""
    rng = np.random.RandomState(44)
    u8 = (rng.rand(64, 48, 4) * 255).astype(np.uint8)
    f = mm.compile("filter f (image in) in(xy + xy:[2, -1]) end")
    opts = mm.RenderOptions(interpolation="bilinear", edge_x="wrap",
                            edge_y="reflect")
    a = np.asarray(f.render_tiled(u8, width=48, height=64, options=opts))
    b = np.asarray(f.render_tiled(u8.astype(np.float32) / np.float32(255.0),
                                  width=48, height=64, options=opts))
    np.testing.assert_allclose(a, b, atol=1e-6)
    c = np.asarray(f.render(u8, width=48, height=64, options=opts))
    np.testing.assert_allclose(a, c, atol=1e-6)
    # animated u8 stack
    stack = (rng.rand(2, 64, 48, 4) * 255).astype(np.uint8)
    a = np.asarray(f.render_tiled(stack, width=48, height=64, frame=1.0,
                                  options=opts))
    c = np.asarray(f.render(stack, width=48, height=64, frame=1.0,
                            options=opts))
    np.testing.assert_allclose(a, c, atol=1e-6)


# ---------------------------------------------------------------------------
# region (GIMP selection) × input-sharded tiling (VERDICT r4 item 7): the
# sharded-drawable workload — apply a filter to a selection of a canvas too
# large to replicate. Output is the FULL canvas: the selection rendered in
# place, every other pixel passed through from input 0 unchanged.
# ---------------------------------------------------------------------------


def _region_tiled(src, img, region, halo=4, t=0.0, opts_kw=None,
                  mesh_shape=(1, 8, 1), w=W, h=H):
    f = mm.compile(src)
    mesh = make_mesh(*mesh_shape)
    opts = mm.RenderOptions(region=region, **(opts_kw or {}))
    r = TiledRenderer(mesh, f.filters, f.fdef, w, h, opts, halo)
    return np.asarray(r(img, t=t))


@pytest.mark.parametrize("region", [
    (3, 5, 9, 11),    # interior, spans several 4-row shards
    (0, 0, 16, 4),    # one device's rows exactly
    (2, 29, 5, 3),    # bottom edge, partial overlap on the last shard
    (0, 0, 16, 32),   # full canvas
])
def test_region_tiled_matches_full_tiled_crop(region):
    """Inside the region: the full tiled render's crop (same path, same
    halo machinery). Outside: input 0, bitwise."""
    img = _image(17)
    src = "origVal(xy + xy:[2 * sin(y / 5), 2 * sin(x / 3)])"
    got = _region_tiled(src, img, region)
    f = mm.compile(src)
    full = np.asarray(f.render_tiled(img, halo=4, mesh=make_mesh(1, 8, 1),
                                     width=W, height=H))
    x, y, w, h = region
    np.testing.assert_allclose(got[y:y + h, x:x + w],
                               full[y:y + h, x:x + w], atol=1e-6)
    mask = np.zeros((H, W, 1), bool)
    mask[y:y + h, x:x + w] = True
    np.testing.assert_array_equal(np.where(mask, img, got), img)


def test_region_tiled_matches_single_chip_region_crop():
    """The tiled region's selection content == the single-chip region
    render (which returns the crop)."""
    img = _image(18)
    region = (1, 6, 13, 17)
    src = "origVal(xy + xy:[0, 2 * sin(x / 3 + t)])"
    got = _region_tiled(src, img, region, t=0.37)
    f = mm.compile(src)
    crop = np.asarray(f.render(
        img, width=W, height=H, t=0.37,
        options=mm.RenderOptions(region=region)))
    x, y, w, h = region
    np.testing.assert_allclose(got[y:y + h, x:x + w], crop, atol=1e-6)


def test_region_tiled_column_sharded():
    img = _image(19)
    region = (5, 7, 8, 18)
    src = "origVal(xy + xy:[2 * sin(y / 4), 2 * sin(x / 5)])"
    got = _region_tiled(src, img, region, halo=(3, 3),
                        mesh_shape=(1, 2, 4))
    f = mm.compile(src)
    full = np.asarray(f.render_tiled(img, halo=(3, 3),
                                     mesh=make_mesh(1, 2, 4),
                                     width=W, height=H))
    x, y, w, h = region
    np.testing.assert_allclose(got[y:y + h, x:x + w],
                               full[y:y + h, x:x + w], atol=1e-6)
    mask = np.zeros((H, W, 1), bool)
    mask[y:y + h, x:x + w] = True
    np.testing.assert_array_equal(np.where(mask, img, got), img)


def test_region_tiled_u8_io_passthrough_bitwise():
    """u8 drawable in, u8 out: unselected pixels are the INPUT BYTES
    (bitwise — the in-place drawable contract), selection matches the
    full u8 tiled render's crop."""
    rng = np.random.RandomState(23)
    u8 = (rng.rand(H, W, 4) * 255).astype(np.uint8)
    region = (4, 9, 7, 10)
    src = "origVal(xy + xy:[0, 2 * sin(x / 3)])"
    got = _region_tiled(src, u8, region,
                        opts_kw=dict(output_dtype="uint8"))
    assert got.dtype == np.uint8
    f = mm.compile(src)
    full = np.asarray(f.render_tiled(
        u8, halo=4, mesh=make_mesh(1, 8, 1), width=W, height=H,
        options=mm.RenderOptions(output_dtype="uint8")))
    x, y, w, h = region
    np.testing.assert_array_equal(got[y:y + h, x:x + w],
                                  full[y:y + h, x:x + w])
    mask = np.zeros((H, W, 1), bool)
    mask[y:y + h, x:x + w] = True
    np.testing.assert_array_equal(np.where(mask, u8, got), u8)


def test_region_tiled_animated_background_is_current_frame():
    """Animated drawable: the pass-through background is the CURRENT
    frame (same round+clamp rule as origVal's current-frame sampling)."""
    rng = np.random.RandomState(29)
    stack = rng.rand(3, H, W, 4).astype(np.float32)
    region = (2, 4, 6, 8)
    src = "origVal(xy + xy:[0, 1])"
    got = _region_tiled(src, stack, region, halo=3, t=0.0)
    # frame=0.0 -> frame 0 background
    x, y, w, h = region
    mask = np.zeros((H, W, 1), bool)
    mask[y:y + h, x:x + w] = True
    np.testing.assert_array_equal(np.where(mask, stack[0], got), stack[0])
    f = mm.compile(src)
    mesh = make_mesh(1, 8, 1)
    r = TiledRenderer(mesh, f.filters, f.fdef, W, H,
                      mm.RenderOptions(region=region), 3)
    got2 = np.asarray(r(stack, frame=2.0))
    np.testing.assert_array_equal(np.where(mask, stack[2], got2), stack[2])


def test_region_tiled_out_of_bounds_raises():
    img = _image(31)
    with pytest.raises(ValueError, match="exceeds"):
        _region_tiled("origVal(xy)", img, (10, 0, 10, 4), halo=1)


def test_region_tiled_supersample_grid():
    """supersample (grid scheme) composes with region x tiled: selection
    == the single-chip supersampled region crop, pass-through bitwise.
    (corners scheme stays rejected by TiledRenderer as before.)"""
    img = _image(37)
    region = (3, 5, 9, 11)
    src = "origVal(xy + xy:[0, 2 * sin(x / 3)])"
    got = _region_tiled(src, img, region, opts_kw=dict(supersample=2))
    f = mm.compile(src)
    crop = np.asarray(f.render(
        img, width=W, height=H,
        options=mm.RenderOptions(region=region, supersample=2)))
    x, y, w, h = region
    np.testing.assert_allclose(got[y:y + h, x:x + w], crop, atol=1e-6)
    mask = np.zeros((H, W, 1), bool)
    mask[y:y + h, x:x + w] = True
    np.testing.assert_array_equal(np.where(mask, img, got), img)


def test_region_tiled_thin_halo_is_exact():
    """A region render on the tiled route with a halo thinner than the
    bicubic margin under reflect edges: taps mirror globally before they
    are localized, so the selection is float-exact vs the single-chip
    crop (review r5 pinned this for an earlier route)."""
    himg = np.random.RandomState(41).rand(64, W, 4).astype(np.float32)
    himg[..., 3] = 1.0
    region = (0, 61, W, 3)
    src = "origVal(xy + xy:[0, 0.8])"
    got = _region_tiled(src, himg, region, halo=1, h=64,
                        opts_kw=dict(interpolation="bicubic",
                                     edge_y="reflect"))
    f = mm.compile(src)
    crop = np.asarray(f.render(
        himg, width=W, height=64,
        options=mm.RenderOptions(region=region, interpolation="bicubic",
                                 edge_y="reflect")))
    x, y, w, h = region
    np.testing.assert_allclose(got[y:y + h, x:x + w], crop, atol=1e-6)
