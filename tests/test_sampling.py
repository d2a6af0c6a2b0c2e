"""Sampling unit tests: interpolation modes and edge behaviors vs hand-rolled
NumPy references (SURVEY.md §4 item 1; origVal is THE hot path §3.6)."""

import numpy as np
import pytest

import mathmap_tpu as mm

H, W = 10, 12


def _image(seed=3):
    img = np.random.RandomState(seed).rand(H, W, 4).astype(np.float32)
    img[..., 3] = 1.0
    return img


def test_identity_sample_nearest():
    img = _image()
    f = mm.compile("origVal(xy)")
    out = f.render(img, interpret=True, options=mm.RenderOptions(interpolation="nearest"))
    np.testing.assert_allclose(out, img, atol=1e-6)


def test_identity_sample_bilinear_exact_at_centers():
    img = _image()
    f = mm.compile("origVal(xy)")
    out = f.render(img, interpret=True, options=mm.RenderOptions(interpolation="bilinear"))
    np.testing.assert_allclose(out, img, atol=1e-6)


def test_identity_sample_bicubic_exact_at_centers():
    # Catmull-Rom interpolates the sample values at integer offsets
    img = _image()
    f = mm.compile("origVal(xy)")
    out = f.render(
        img, interpret=True,
        options=mm.RenderOptions(interpolation="bicubic", edge_x="wrap", edge_y="wrap"),
    )
    np.testing.assert_allclose(out, img, atol=1e-5)


def test_half_pixel_shift_bilinear_averages():
    img = _image()
    # shift by exactly one half pixel in x: bilinear = average of neighbors
    f = mm.compile("origVal(xy + xy:[0.5, 0])")
    out = f.render(
        img, interpret=True,
        options=mm.RenderOptions(interpolation="bilinear", edge_x="wrap", edge_y="wrap"),
    )
    expected = 0.5 * (img + np.roll(img, -1, axis=1))
    np.testing.assert_allclose(out, np.clip(expected, 0, 1), atol=1e-6)


def test_integer_shift_matches_roll_wrap():
    img = _image()
    f = mm.compile("origVal(xy + xy:[3, 0])")
    out = f.render(
        img, interpret=True,
        options=mm.RenderOptions(interpolation="nearest", edge_x="wrap", edge_y="wrap"),
    )
    np.testing.assert_allclose(out, np.roll(img, -3, axis=1), atol=1e-6)


def test_integer_shift_y_up():
    # +y in world space is up = smaller row index
    img = _image()
    f = mm.compile("origVal(xy + xy:[0, 1])")
    out = f.render(
        img, interpret=True,
        options=mm.RenderOptions(interpolation="nearest", edge_y="wrap"),
    )
    np.testing.assert_allclose(out, np.roll(img, 1, axis=0), atol=1e-6)


def test_edge_color_outside():
    img = _image()
    f = mm.compile("origVal(xy + xy:[100, 0])")  # fully outside
    opts = mm.RenderOptions(interpolation="nearest", edge_x="color", edge_color=(1, 0, 0, 1))
    out = f.render(img, interpret=True, options=opts)
    np.testing.assert_allclose(out, np.broadcast_to([1, 0, 0, 1], (H, W, 4)), atol=1e-6)


def test_edge_reflect():
    img = _image()
    f = mm.compile("origVal(xy + xy:[" + str(W) + ", 0])")  # shift by exactly W
    opts = mm.RenderOptions(interpolation="nearest", edge_x="reflect")
    out = f.render(img, interpret=True, options=opts)
    np.testing.assert_allclose(out, img[:, ::-1], atol=1e-6)


def test_edge_wrap_x_shift_full_period():
    img = _image()
    f = mm.compile("origVal(xy + xy:[" + str(W) + ", 0])")
    opts = mm.RenderOptions(interpolation="nearest", edge_x="wrap")
    out = f.render(img, interpret=True, options=opts)
    np.testing.assert_allclose(out, img, atol=1e-6)


def test_independent_edge_behaviors_per_axis():
    img = _image()
    f = mm.compile("origVal(xy + xy:[" + str(W) + ", " + str(-H) + "])")
    opts = mm.RenderOptions(interpolation="nearest", edge_x="wrap", edge_y="color",
                            edge_color=(0, 1, 0, 1))
    out = f.render(img, interpret=True, options=opts)
    np.testing.assert_allclose(out, np.broadcast_to([0, 1, 0, 1], (H, W, 4)), atol=1e-6)


def test_bicubic_weights_sum_to_one():
    from mathmap_tpu.runtime.sampling import _catmull_rom_weights

    f = np.linspace(0, 0.999, 37, dtype=np.float64)
    w = _catmull_rom_weights(np, f)
    np.testing.assert_allclose(w[0] + w[1] + w[2] + w[3], np.ones_like(f), atol=1e-12)


def test_multi_image_sampling_uses_own_pixels():
    a = np.zeros((H, W, 4), np.float32)
    b = np.ones((H, W, 4), np.float32)
    f = mm.compile("filter f (image p, image q) q(xy) end")
    out = f.render(a, b, interpret=True, options=mm.RenderOptions(interpolation="nearest"))
    np.testing.assert_allclose(out, b, atol=1e-6)


#: jit vs oracle through a transcendental warp (atan2/sin/pow): XLA's and
#: NumPy's implementations differ in the last bits, and the warp carries
#: that coordinate difference into the sampled value (the 'f32' class of
#: chip_smoke.py and selftest on a GPU)
XLA_VS_NUMPY = 2e-4


def _jit_vs_oracle(f, *inputs, atol=5e-5, **kw):
    """Render on the jit path (XLA gather sampler) and with the NumPy
    oracle; assert they agree. Returns the jit render."""
    a = np.asarray(f.render(*inputs, **kw))
    b = np.asarray(f.render(*inputs, interpret=True, **kw))
    np.testing.assert_allclose(a, b, atol=atol)
    return a


@pytest.mark.parametrize("interp", ["nearest", "bilinear", "bicubic"])
@pytest.mark.parametrize("edges", [("color", "color"), ("wrap", "reflect")])
def test_sampler_matrix_matches_oracle(interp, edges):
    """The gather sampler vs the oracle across interpolations and edge
    behaviors."""
    img = _image(7)
    f = mm.compile("origVal(toXY(ra:[r * 0.8, a + 0.3]))")
    ex, ey = edges
    _jit_vs_oracle(f, img, atol=2e-5, options=mm.RenderOptions(
        interpolation=interp, edge_x=ex, edge_y=ey))


def test_unbounded_displacement_matches_oracle():
    """A quadratic blow-up warp samples far outside the image everywhere
    but the center: the edge mapping must hold at any distance."""
    img = _image(8)
    f = mm.compile("origVal(xy * xy)")
    _jit_vs_oracle(f, img, atol=2e-5)


@pytest.mark.parametrize("hw", [(13, 37), (9, 130), (31, 257)])
def test_sampler_odd_sizes(hw):
    """Odd, non-power-of-two canvases flatten/index correctly."""
    h, w = hw
    img = np.random.RandomState(1).rand(h, w, 4).astype(np.float32)
    f = mm.compile("origVal(toXY(ra:[r * 0.9, a + 0.2]))")
    _jit_vs_oracle(f, img, atol=XLA_VS_NUMPY)


def test_lut_application_matches_oracle():
    """Gradient and curve application (take-lerp LUTs) on the jit path vs
    the oracle."""
    src = "filter g (gradient grad) grad((x + X) / W) end"
    f = mm.compile(src)
    _jit_vs_oracle(f, np.zeros((24, 40, 4), np.float32), atol=2e-5)
    csrc = "filter c (curve cv) grayColor(cv((x + X) / W)) end"
    fc = mm.compile(csrc)
    _jit_vs_oracle(fc, np.zeros((24, 40, 4), np.float32), atol=2e-5)


def test_device_resident_inputs_match_host_inputs():
    """Device arrays pass through the renderer's staging untouched and
    render the same frame as the host array."""
    import jax.numpy as jnp

    img = np.random.RandomState(1).rand(16, 24, 4).astype(np.float32)
    f = mm.compile("origVal(xy + xy:[0.3, -0.2])")
    r = f._renderer(24, 16, mm.RenderOptions(), 1)
    dimg = jnp.asarray(img)
    a = r([dimg], {}, t=0.0)
    b = r([dimg], {}, t=0.0)
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    c = r([img], {}, t=0.0)
    np.testing.assert_allclose(np.asarray(a), np.asarray(c), atol=1e-6)


@pytest.mark.parametrize("path", ["filters/Distorts/twirl.mm",
                                  "filters/Distorts/fisheye.mm"])
def test_mixed_warp_filters_match_oracle(path):
    """Mixed-warp frames (strong rotation at the center, identity at the
    rim) on a non-square canvas."""
    img = np.random.RandomState(7).rand(96, 160, 4).astype(np.float32)
    f = mm.compile_file(path)
    _jit_vs_oracle(f, img, width=160, height=96, t=0.3)


def test_mixed_warp_interpolations_match_oracle():
    img = np.random.RandomState(11).rand(96, 160, 4).astype(np.float32)
    f = mm.compile_file("filters/Distorts/twirl.mm")
    for interp in ("nearest", "bilinear", "bicubic"):
        _jit_vs_oracle(f, img, width=160, height=96, t=0.3,
                       options=mm.RenderOptions(interpolation=interp))


def test_wide_canvas_warp_matches_oracle():
    """A warp whose x-displacement varies along a wide row (512 px)."""
    img = np.random.RandomState(3).rand(128, 512, 4).astype(np.float32)
    f = mm.compile_file("filters/Distorts/twirl.mm")
    _jit_vs_oracle(f, img, width=512, height=128, t=0.2, atol=XLA_VS_NUMPY)


def test_wide_canvas_nearest_wrap_matches_oracle():
    img = np.random.RandomState(9).rand(128, 512, 4).astype(np.float32)
    f = mm.compile_file("filters/Distorts/twirl.mm")
    _jit_vs_oracle(f, img, width=512, height=128, t=0.2, atol=XLA_VS_NUMPY,
                   options=mm.RenderOptions(edge_x="wrap", edge_y="wrap"))


def test_animated_t_ripple_matches_oracle():
    img = np.random.RandomState(2).rand(64, 320, 4).astype(np.float32)
    f = mm.compile_file("filters/Distorts/ripple.mm")
    _jit_vs_oracle(f, img, width=320, height=64, t=0.3)


def test_rand_warp_matches_oracle():
    """rand() draws the same per-pixel stream on both backends: the jit
    path builds the global pixel index from 2-D iotas, the oracle from
    aranges — a mistake would shuffle the noise field, not just perturb
    values."""
    img = np.random.RandomState(4).rand(96, 320, 4).astype(np.float32)
    src = "filter rnoise (image in)\n  in(xy + xy:[rand(-3, 3), rand(-3, 3)])\nend"
    f = mm.compile(src)
    _jit_vs_oracle(f, img, width=320, height=96, t=0.0)


def test_supersample_twirl_matches_oracle_loop():
    """The s×s supersampling loop on the jit path vs the oracle's."""
    img = np.random.RandomState(8).rand(48, 320, 4).astype(np.float32)
    f = mm.compile_file("filters/Distorts/twirl.mm")
    _jit_vs_oracle(f, img, width=320, height=48, t=0.3, atol=1e-4,
                   options=mm.RenderOptions(supersample=2))


def test_rand_in_loop_kernel_matches_lax_loop(while_kernel_interpret):
    """rand() inside the per-pixel loop kernel: each program's sub-context
    offsets must reach the global pixel ids (regression class: local block
    iotas read as global ids give a block-repeating noise field)."""
    src = ("filter rwb (image in)\n"
           "  i = 0; s = 0;\n"
           "  while i < 3 do s = s + rand(0, 0.2); i = i + 1 end;\n"
           "  in(xy + xy:[s, s])\nend")
    img = np.random.RandomState(12).rand(64, 512, 4).astype(np.float32)
    f = mm.compile(src)
    a = f.render(img, width=512, height=64,
                 options=mm.RenderOptions(pallas_while="on",
                                          while_static_unroll=0))
    b = f.render(img, width=512, height=64,
                 options=mm.RenderOptions(pallas_while="off",
                                          while_static_unroll=0))
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=5e-5)


def test_rand_filter_supersample_keeps_sequential_stream():
    """rand() draws once per subsample evaluation: jit + supersample must
    still match the oracle exactly."""
    src = ("filter rss (image in)\n"
           "  grayColor(clamp(gray(in(xy)) * 0.5 + rand(0, 0.5), 0, 1))\nend")
    img = np.random.RandomState(9).rand(32, 96, 4).astype(np.float32)
    f = mm.compile(src)
    _jit_vs_oracle(f, img, width=96, height=32, atol=1e-4,
                   options=mm.RenderOptions(supersample=2))


def test_supersample_ripple_matches_oracle():
    img = np.random.RandomState(6).rand(64, 320, 4).astype(np.float32)
    f = mm.compile_file("filters/Distorts/ripple.mm")
    _jit_vs_oracle(f, img, width=320, height=64, t=0.4,
                   options=mm.RenderOptions(supersample=2))


@pytest.mark.parametrize("interp", ["bilinear", "bicubic"])
def test_spiral_warp_matches_oracle(interp):
    """Extreme differential warps (spiral class): neighbouring pixels
    sample far-apart source rows."""
    img = np.random.RandomState(3).rand(160, 160, 4).astype(np.float32)
    f = mm.compile_file("filters/Distorts/spiral_warp.mm")
    # bicubic: Catmull-Rom's negative lobes give sum|w| up to 1.125 per
    # axis, so a coordinate difference moves the value up to 1.27x more
    tol = XLA_VS_NUMPY * (1.27 if interp == "bicubic" else 1.0)
    _jit_vs_oracle(f, img, width=160, height=160, t=0.3, atol=tol,
                   params={"twist": 3.0},
                   options=mm.RenderOptions(interpolation=interp))


@pytest.mark.parametrize("edge", ["wrap", "reflect"])
def test_tiny_image_edge_behaviors(edge):
    """Images smaller than an interpolation footprint: wrap/reflect index
    arithmetic handles any size >= 1."""
    img = np.random.RandomState(21).rand(4, 6, 4).astype(np.float32)
    f = mm.compile("origVal(xy * 2)")
    _jit_vs_oracle(f, img, width=6, height=4,
                   options=mm.RenderOptions(edge_x=edge, edge_y=edge))


def test_nan_coords_propagate_like_oracle():
    """NaN source coordinates: finite-coord pixels match the oracle, and
    NaN-coord pixels propagate NaN under bilinear weighting exactly where
    the oracle does (an int-cast of NaN has no defined value, so only the
    NaN-ness is the spec)."""
    img = np.random.RandomState(22).rand(32, 128, 4).astype(np.float32)
    # sqrt of a negative band -> NaN coords on the lower half
    src = "filter nanwarp (image in)\n  in(xy:[x + sqrt(y), y])\nend"
    f = mm.compile(src)
    a = np.asarray(f.render(img, width=128, height=32))
    b = np.asarray(f.render(img, width=128, height=32, interpret=True))
    nan_a = np.isnan(a).any(axis=-1)
    nan_b = np.isnan(b).any(axis=-1)
    np.testing.assert_array_equal(nan_a, nan_b)
    assert nan_b.any()  # the warp really produced a NaN band
    finite = ~nan_b
    np.testing.assert_allclose(a[finite], b[finite], atol=5e-5)


def test_anisotropic_warp_matches_oracle():
    """x-magnification only (strip x-span 3x the y-span)."""
    img = np.random.RandomState(11).rand(128, 256, 4).astype(np.float32)
    f = mm.compile("filter aniso (image in)\n  in(xy * xy:[3,1])\nend")
    _jit_vs_oracle(f, img, width=256, height=128, atol=1e-4)


def test_strong_twirl_matches_oracle():
    img = np.random.RandomState(5).rand(96, 160, 4).astype(np.float32)
    f = mm.compile_file("filters/Distorts/twirl.mm")
    _jit_vs_oracle(f, img, width=160, height=96, t=0.9)


@pytest.mark.parametrize("band", [0.05, 0.3, 0.8])
def test_singular_band_matches_oracle(band):
    """A horizontal band of the output warps with a huge magnification
    under wrap edges (source span ~ the whole image), the rest is the
    identity: both must be exact against the oracle at every band
    width."""
    img = np.random.RandomState(17).rand(128, 256, 4).astype(np.float32)
    frac = 1.0 - band
    src = f"filter cliff (image in)\n  in(if abs(y) > Y * {frac} then xy * 9999 else xy end)\nend"
    f = mm.compile(src)
    _jit_vs_oracle(f, img, width=256, height=130,
                   options=mm.RenderOptions(edge_x="wrap", edge_y="wrap"))


@pytest.mark.parametrize("path", ["filters/Distorts/polar_invert.mm",
                                  "filters/Distorts/inside_out.mm"])
def test_singular_warp_matches_oracle(path):
    """Polar-inversion-class warps: a singularity at the center."""
    img = np.random.RandomState(15).rand(128, 512, 4).astype(np.float32)
    f = mm.compile_file(path)
    _jit_vs_oracle(f, img, width=512, height=128, t=0.2, atol=XLA_VS_NUMPY)


def test_renderer_lower_exposes_program():
    """JitRenderer.lower returns the lowered single-frame program without
    running it (chip_smoke.py reads the compiled text through it)."""
    img = np.random.RandomState(2).rand(16, 24, 4).astype(np.float32)
    f = mm.compile("origVal(xy)")
    r = f._renderer(24, 16, mm.RenderOptions(), 1)
    text = r.lower([img], {}, t=0.1).as_text()
    assert "gather" in text


# ---------------------------------------------------------------------------
# Corner-grid + center supersampling (supersample_scheme='corners')
# ---------------------------------------------------------------------------

_WARP_SRC = "filter w (image in) in(xy + [sin(y/7)*3, cos(x/9)*2]) end"


def _corners_opts(**kw):
    return mm.RenderOptions(supersample=2, supersample_scheme="corners", **kw)


def test_corners_constant_filter_is_exact():
    """Averaging 5 samples of a constant is the constant — the combine's
    1/5 weights must sum to one exactly."""
    f = mm.compile_source("filter c () rgbColor(0.25, 0.5, 0.75) end")
    out = f.render(width=20, height=12, options=_corners_opts())
    assert np.allclose(out[..., :3], [0.25, 0.5, 0.75], atol=1e-6)


def test_corners_linear_gradient_matches_unsampled():
    """A filter LINEAR in pixel coordinates is invariant under any
    unbiased symmetric AA scheme: the 5-point quincunx mean at the pixel
    center equals the center sample. Pins the corner positions at exactly
    (+-0.5, +-0.5) — an offset bias would shift the ramp."""
    src = "filter g () rgba:[(x + X) / W, (Y - y) / H, 0.5, 1] end"
    f = mm.compile_source(src)
    aa = f.render(width=24, height=16, options=_corners_opts())
    plain = f.render(width=24, height=16)
    np.testing.assert_allclose(aa, plain, atol=1e-6)


def test_corners_jit_matches_oracle():
    img = _image(7)
    f = mm.compile_source(_WARP_SRC)
    jit = f.render(img, options=_corners_opts())
    ora = f.render(img, options=_corners_opts(), interpret=True)
    np.testing.assert_allclose(np.asarray(jit), ora, atol=1e-5)


def test_corners_extended_grid_matches_oracle():
    """The corner evaluation grows its own (H+1, W+1) grid; jit and oracle
    must agree on a second image."""
    img = _image(8)
    f = mm.compile_source(_WARP_SRC)
    _jit_vs_oracle(f, img, atol=2e-4, options=_corners_opts())


def test_corners_rand_filter_jit_matches_oracle():
    """The two sequential evaluations must draw DISTINCT rand() streams
    threaded through the shared context (counter copy-back), identically
    in both backends."""
    img = _image(9)
    src = ("filter r (image in) "
           "in(xy) * 0.5 + rand(0, 1) * 0.5 * [1, 1, 1, 0] + [0,0,0,0.0] end")
    f = mm.compile_source(src)
    jit = f.render(img, options=_corners_opts())
    ora = f.render(img, options=_corners_opts(), interpret=True)
    np.testing.assert_allclose(np.asarray(jit), ora, atol=1e-6)


def test_corners_sharded_matches_unsharded():
    img = np.random.RandomState(10).rand(32, 48, 4).astype(np.float32)
    img[..., 3] = 1.0
    f = mm.compile_source(_WARP_SRC)
    sh = f.render_sharded(img, options=_corners_opts())
    un = f.render(img, options=_corners_opts())
    np.testing.assert_allclose(np.asarray(sh), np.asarray(un), atol=1e-6)


def test_corners_tiled_renderer_raises():
    img = _image(11)
    f = mm.compile_source(_WARP_SRC)
    with pytest.raises(ValueError, match="corners"):
        f.render_tiled(img, options=_corners_opts())


def test_corners_differs_from_grid_on_high_frequency():
    """Sanity: the two schemes are genuinely different sample placements
    (a regression to one shared code path would silently equalize them)."""
    img = _image(12)
    f = mm.compile_source(_WARP_SRC)
    c = f.render(img, options=_corners_opts())
    g = f.render(img, options=mm.RenderOptions(supersample=2))
    assert float(np.max(np.abs(np.asarray(c) - np.asarray(g)))) > 1e-3


def test_supersample_scheme_validation():
    with pytest.raises(ValueError, match="supersample_scheme"):
        mm.RenderOptions(supersample_scheme="hexagonal")
