"""Language-feature tests: control flow, assignment, closures, uservals
(SURVEY.md §4 items 1-2)."""

import numpy as np
import pytest

import mathmap_tpu as mm
from mathmap_tpu.utils.errors import MMNameError, MMTypeError

H, W = 6, 8
BLANK = np.zeros((H, W, 4), np.float32)


def gray(src, interpret=True, **kw):
    f = mm.compile(src)
    return f.render(BLANK, interpret=interpret, **kw)[..., 0]


def grids():
    xs = np.arange(W, dtype=np.float32) + 0.5 - W / 2
    ys = H / 2 - (np.arange(H, dtype=np.float32) + 0.5)
    return np.broadcast_to(xs[None, :], (H, W)), np.broadcast_to(ys[:, None], (H, W))


X, Y = grids()


def test_sequence_and_assignment():
    out = gray("v = 2; w = v * 3; grayColor(w / 8)")
    np.testing.assert_allclose(out, np.full((H, W), 0.75))


def test_sub_assignment_static():
    out = gray("v = [1, 2, 3]; v[1] = 0.5; grayColor(v[1])")
    np.testing.assert_allclose(out, np.full((H, W), 0.5))


def test_sub_assignment_dynamic_index():
    out = gray("v = [0.1, 0.2, 0.3]; i = 1 + (x > 100); v[i] = 0.9; grayColor(v[1])")
    np.testing.assert_allclose(out, np.full((H, W), 0.9))


def test_dynamic_subscript():
    out = gray("v = [0.1, 0.5, 0.9]; i = (x >= 0) + (x >= 2); grayColor(v[i])")
    expected = np.where(X >= 2, 0.9, np.where(X >= 0, 0.5, 0.1)).astype(np.float32)
    np.testing.assert_allclose(out, expected)


def test_if_merges_assignments():
    out = gray("if x >= 0 then v = 0.75 else v = 0.25 end; grayColor(v)")
    expected = np.where(X >= 0, 0.75, 0.25).astype(np.float32)
    np.testing.assert_allclose(out, expected)


def test_if_as_expression():
    out = gray("grayColor(if x >= 0 then 0.75 else 0.25 end)")
    expected = np.where(X >= 0, 0.75, 0.25).astype(np.float32)
    np.testing.assert_allclose(out, expected)


def test_if_without_else_keeps_prior_value():
    out = gray("v = 0.25; if x >= 0 then v = 0.75 end; grayColor(v)")
    expected = np.where(X >= 0, 0.75, 0.25).astype(np.float32)
    np.testing.assert_allclose(out, expected)


def test_while_uniform_loop():
    out = gray("i = 0; s = 0; while i < 4 do s = s + 0.125; i = i + 1 end; grayColor(s)")
    np.testing.assert_allclose(out, np.full((H, W), 0.5))


def test_while_divergent_trip_counts():
    # per-pixel trip counts differ (the Mandelbrot-shaped case, SURVEY §7
    # hard part 1)
    src = "n = 0; v = abs(x); while v > 1 do v = v / 2; n = n + 1 end; grayColor(n / 4)"
    out = gray(src)
    expected = np.zeros((H, W), np.float32)
    v = np.abs(X).copy()
    while (v > 1).any():
        m = v > 1
        v = np.where(m, v / 2, v)
        expected = np.where(m, expected + 0.25, expected)
    np.testing.assert_allclose(out, expected)


def test_do_while_runs_body_once():
    out = gray("i = 5; s = 0; do s = s + 0.5 while i < 0 end; grayColor(s)")
    np.testing.assert_allclose(out, np.full((H, W), 0.5))


def test_while_var_widens_to_tuple():
    src = "z = 0; i = 0; while i < 3 do z = z + ri:[0.1, 0.2]; i = i + 1 end; grayColor(z[1])"
    out = gray(src)
    np.testing.assert_allclose(out, np.full((H, W), 0.6), rtol=1e-5)


def test_loop_safety_cap():
    out = gray(
        "i = 0; while 1 == 1 do i = i + 1 end; grayColor(i / 16)",
        options=mm.RenderOptions(max_loop_iters=8),
    )
    np.testing.assert_allclose(out, np.full((H, W), 0.5))


def test_filter_as_function_closure():
    src = (
        "filter half (image in)\n"
        "  p = in(xy); rgbaColor(red(p)/2, green(p)/2, blue(p)/2, alpha(p))\n"
        "end\n"
        "filter main (image in)\n"
        "  half(in)(xy)\n"
        "end"
    )
    f = mm.compile(src)
    img = np.full((H, W, 4), 0.8, np.float32)
    out = f.render(img, interpret=True)
    np.testing.assert_allclose(out[..., 0], np.full((H, W), 0.4), rtol=1e-6)


def test_filter_image_result_auto_sampled():
    src = (
        "filter ident (image in) in(xy) end\n"
        "filter main (image in) ident(in) end"
    )
    f = mm.compile(src)
    img = np.random.RandomState(0).rand(H, W, 4).astype(np.float32)
    out = f.render(img, interpret=True, options=mm.RenderOptions(interpolation="nearest"))
    np.testing.assert_allclose(out, np.clip(img, 0, 1), atol=1e-6)


def test_closure_captures_uservals():
    src = (
        "filter scaled (image in, float k: 0-2 (0.5))\n"
        "  p = in(xy); rgbaColor(red(p)*k, green(p)*k, blue(p)*k, alpha(p))\n"
        "end\n"
        "filter main (image in)\n"
        "  scaled(in, 0.25)(xy)\n"
        "end"
    )
    f = mm.compile(src)
    img = np.full((H, W, 4), 1.0, np.float32)
    out = f.render(img, interpret=True)
    np.testing.assert_allclose(out[..., 0], np.full((H, W), 0.25), rtol=1e-6)


def test_userval_defaults_and_override():
    src = "filter f (float k: 0-1 (0.5)) grayColor(k) end"
    f = mm.compile(src)
    out = f.render(width=W, height=H, interpret=True)
    np.testing.assert_allclose(out[..., 0], np.full((H, W), 0.5))
    out2 = f.render(width=W, height=H, interpret=True, params={"k": 0.75})
    np.testing.assert_allclose(out2[..., 0], np.full((H, W), 0.75))
    # range clamping
    out3 = f.render(width=W, height=H, interpret=True, params={"k": 7})
    np.testing.assert_allclose(out3[..., 0], np.full((H, W), 1.0))


def test_int_userval_rounds():
    src = "filter f (int n: 0-10 (3)) grayColor(n / 10) end"
    f = mm.compile(src)
    out = f.render(width=W, height=H, interpret=True, params={"n": 6.7})
    np.testing.assert_allclose(out[..., 0], np.full((H, W), 0.7))


def test_color_userval():
    src = "filter f (color c) c end"
    f = mm.compile(src)
    out = f.render(width=W, height=H, interpret=True, params={"c": (0.2, 0.4, 0.6, 0.8)})
    np.testing.assert_allclose(out[0, 0], [0.2, 0.4, 0.6, 0.8], rtol=1e-6)


def test_curve_userval():
    src = "filter f (curve c) grayColor(c(x / 8 + 0.5)) end"
    f = mm.compile(src)
    out = f.render(width=W, height=H, interpret=True, params={"c": lambda v: v**2})
    expected = np.clip((X / 8 + 0.5) ** 2, 0, 1)
    np.testing.assert_allclose(out[..., 0], expected, atol=2e-3)  # LUT resolution


def test_gradient_userval():
    src = "filter f (gradient g) g(x / 8 + 0.5) end"
    f = mm.compile(src)
    lut = np.stack(
        [np.linspace(0, 1, 256), np.zeros(256), np.ones(256), np.ones(256)], axis=1
    )
    out = f.render(width=W, height=H, interpret=True, params={"g": lut})
    expected = np.clip(X / 8 + 0.5, 0, 1)
    np.testing.assert_allclose(out[..., 0], expected, atol=5e-3)
    np.testing.assert_allclose(out[..., 2], np.ones((H, W)))


def test_two_input_compositing():
    src = "filter blend2 (image a, image b) lerp(0.5, a(xy), b(xy)) end"
    f = mm.compile(src)
    a = np.zeros((H, W, 4), np.float32)
    b = np.ones((H, W, 4), np.float32)
    out = f.render(a, b, interpret=True, options=mm.RenderOptions(interpolation="nearest"))
    np.testing.assert_allclose(out, np.full((H, W, 4), 0.5))


def test_cast_scalar_widens():
    out = gray("z = ri:0; grayColor(z[0] + z[1] + 0.5)")
    np.testing.assert_allclose(out, np.full((H, W), 0.5))


def test_cast_length_mismatch_raises():
    with pytest.raises(MMTypeError):
        gray("v = ri:[1,2,3]; grayColor(v[0])")


def test_unknown_variable_raises():
    with pytest.raises(MMNameError):
        gray("grayColor(nosuchvar)")


def test_unknown_function_raises():
    with pytest.raises(MMNameError):
        gray("grayColor(nosuchfn(1))")


def test_filter_wrong_result_type_raises():
    with pytest.raises(MMTypeError):
        gray("x + y")  # length-1 result is not a color


def test_t_and_frame_internals():
    src = "grayColor(t)"
    f = mm.compile(src)
    out = f.render(BLANK, interpret=True, t=0.25)
    np.testing.assert_allclose(out[..., 0], np.full((H, W), 0.25))


def test_supersampling_smooths_edges():
    src = "grayColor(if x >= 0.4 then 1 else 0 end)"
    f = mm.compile(src)
    hard = f.render(BLANK, interpret=True)[..., 0]
    soft = f.render(BLANK, interpret=True, options=mm.RenderOptions(supersample=2))[..., 0]
    assert set(np.unique(hard)) <= {0.0, 1.0}
    # the supersampled column containing the threshold is fractional
    assert ((soft > 0) & (soft < 1)).any()


def test_render_animation_batched_matches_loop():
    src = "grayColor(0.5 + 0.4 * sin(x / 3 + t * 2 * pi))"
    f = mm.compile(src)
    batched = f.render_animation(BLANK, num_frames=4)
    looped = np.stack(list(f.render_frames(BLANK, num_frames=4)), axis=0)
    assert batched.shape == (4, H, W, 4)
    np.testing.assert_allclose(batched, looped, atol=1e-6)


def test_render_batch_matches_per_frame_renders():
    """render_batch: N independent (input, t) jobs in one device program
    must match N per-frame render() calls (VERDICT r2 item 2 — the batched
    small-render entry that amortizes the dispatch floor)."""
    src = "origVal(xy) * grayColor(0.5 + 0.5 * sin(t * 2 * pi))"
    f = mm.compile(src)
    rng = np.random.RandomState(7)
    imgs = rng.rand(3, H, W, 4).astype(np.float32)
    ts = np.array([0.0, 0.3, 0.8], np.float32)
    batched = f.render_batch(imgs, ts=ts)
    assert batched.shape == (3, H, W, 4)
    for i in range(3):
        single = f.render(imgs[i], t=float(ts[i]))
        np.testing.assert_allclose(batched[i], single, atol=1e-6)


def test_render_batch_sampling_filter_matches():
    """Batched jobs through a sampling filter (bicubic, wrap edges) with
    per-job inputs and list-of-frames input form."""
    f = mm.compile_file("filters/Distorts/twirl.mm")
    rng = np.random.RandomState(8)
    frames = [rng.rand(H, W, 4).astype(np.float32) for _ in range(2)]
    opts = mm.RenderOptions(interpolation="bicubic", edge_x="wrap",
                            edge_y="wrap")
    out = f.render_batch(frames, ts=[0.2, 0.6], options=opts)
    for i, t in enumerate((0.2, 0.6)):
        single = f.render(frames[i], t=t, options=opts)
        np.testing.assert_allclose(out[i], single, atol=1e-6)


def test_render_animation_nonperiodic_reaches_t1():
    src = "grayColor(t)"
    f = mm.compile(src)
    frames = f.render_animation(BLANK, num_frames=3,
                                options=mm.RenderOptions(periodic=False))
    np.testing.assert_allclose(frames[-1][..., 0], np.ones((H, W)))
    np.testing.assert_allclose(frames[0][..., 0], np.zeros((H, W)))


def test_recursive_filter_bounded():
    src = "filter rec (image in) rec(in)(xy) end"
    f = mm.compile(src)
    with pytest.raises(mm.MMRuntimeError):
        f.render(BLANK, interpret=True)


def test_rand_in_while_draws_fresh_each_iteration():
    # sum of 4 independent draws has higher variance structure than 4x one
    # draw; more directly: the jit path must match the oracle (which draws
    # per iteration)
    src = ("s = 0; i = 0; while i < 4 do s = s + rand(0, 1); i = i + 1 end;"
           "grayColor(s / 4)")
    f = mm.compile(src)
    o = f.render(BLANK, interpret=True)
    j = f.render(BLANK)
    np.testing.assert_allclose(j, o, atol=1e-6)
    # and the draws are actually different across iterations: s/4 of 4
    # identical draws would reproduce a single rand field exactly
    single = mm.compile("grayColor(rand(0, 1))").render(BLANK, interpret=True)
    assert np.abs(o - single).max() > 0.05


@pytest.mark.parametrize("iters", [5, 11])
def test_rand_in_while_parity_beyond_unroll(iters):
    """Parity must hold at trip counts that are not multiples of (and exceed)
    the jit path's K=4 unroll — the oracle's eager counter stream previously
    diverged from the baked trace constants there (ADVICE r1 high)."""
    src = (f"s = 0; i = 0; while i < {iters} do s = s + rand(0, 1); i = i + 1 end;"
           f"grayColor(s / {iters})")
    f = mm.compile(src)
    o = f.render(BLANK, interpret=True)
    j = f.render(BLANK)
    np.testing.assert_allclose(j, o, atol=1e-6)


def test_rand_after_data_dependent_loop_parity():
    """rand() AFTER a loop whose trip count is data-dependent (varies per
    pixel) must agree between jit and oracle: the counter is restored to the
    loop-entry state on both backends."""
    src = ("i = 0; while i < 3 + (x > 0) * 4 do i = i + rand(0.5, 1.5) end;"
           "grayColor(rand(0, 1))")
    f = mm.compile(src)
    o = f.render(BLANK, interpret=True)
    j = f.render(BLANK)
    np.testing.assert_allclose(j, o, atol=1e-6)


def test_rand_in_nested_while_parity():
    src = ("s = 0; i = 0;"
           "while i < 5 do"
           "  k = 0; while k < 3 do s = s + rand(0, 1); k = k + 1 end;"
           "  i = i + 1 "
           "end;"
           "grayColor(s / 15)")
    f = mm.compile(src)
    o = f.render(BLANK, interpret=True)
    j = f.render(BLANK)
    np.testing.assert_allclose(j, o, atol=1e-6)
    # inner draws must differ across outer iterations (outer salt mixed in):
    # otherwise s/15 == (sum of 3 draws)/3 exactly
    inner = mm.compile(
        "s = 0; k = 0; while k < 3 do s = s + rand(0, 1); k = k + 1 end;"
        "grayColor(s / 3)"
    ).render(BLANK, interpret=True)
    assert np.abs(o - inner).max() > 0.02


def test_rand_in_filter_called_from_loop_parity():
    """rand() inside an inlined filter called from a loop body inherits the
    iteration salt (fresh per iteration, identical across backends)."""
    src = ("filter noisy (image in) grayColor(rand(0, 1)) end "
           "filter main (image in) "
           "s = 0; i = 0;"
           "while i < 6 do s = s + red(noisy(in)(xy)); i = i + 1 end;"
           "grayColor(s / 6) end")
    f = mm.compile(src)
    o = f.render(BLANK, interpret=True)
    j = f.render(BLANK)
    np.testing.assert_allclose(j, o, atol=1e-6)
    single = mm.compile("grayColor(rand(0, 1))").render(BLANK, interpret=True)
    assert np.abs(o - single).max() > 0.05


def test_while_cond_assignments_persist():
    """Assignments in the condition sequence execute sequentially and are
    visible to the body and after the loop (the reference evaluates the
    cond statements per check; ADVICE r1 low finding)."""
    src = ("i = 0; n = 0; while n = n + 1; i < 3 do i = i + 1 end;"
           "grayColor(n / 4)")
    # n increments once per cond evaluation: 4 checks for 3 iterations
    out = gray(src)
    np.testing.assert_allclose(out, np.full((H, W), 1.0))
    out_jit = gray(src, interpret=False)
    np.testing.assert_allclose(out_jit, out, atol=1e-6)


def test_origval_xy_variants():
    img = np.random.RandomState(2).rand(H, W, 4).astype(np.float32)
    opts = mm.RenderOptions(interpolation="nearest")
    a = mm.compile("origVal(xy)").render(img, interpret=True, options=opts)
    b = mm.compile("origValXY(x, y)").render(img, interpret=True, options=opts)
    c = mm.compile("origValXY(x, y, 0)").render(img, interpret=True, options=opts)
    np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(a, c)


def test_image_param_via_params_dict():
    """An image userval bound through params= instead of a positional input."""
    src = "filter f (image main_img, image aux) aux(xy) end"
    f = mm.compile(src)
    a = np.zeros((H, W, 4), np.float32)
    b = np.full((H, W, 4), 0.75, np.float32)
    out = f.render(a, interpret=True, params={"aux": b},
                   options=mm.RenderOptions(interpolation="nearest"))
    np.testing.assert_allclose(out, b, atol=1e-6)


def test_origval_image_builtin():
    src = "filter f (image p, image q) origValImage(q, xy) end"
    f = mm.compile(src)
    a = np.zeros((H, W, 4), np.float32)
    b = np.full((H, W, 4), 0.25, np.float32)
    out = f.render(a, b, interpret=True,
                   options=mm.RenderOptions(interpolation="nearest"))
    np.testing.assert_allclose(out, b, atol=1e-6)


def test_render_animation_chunked(monkeypatch):
    """Frame sweeps larger than the HBM budget split into chunks that
    concatenate to the same result."""
    import mathmap_tpu.api as api

    src = "grayColor(t)"
    f = mm.compile(src)
    full = f.render_animation(BLANK, num_frames=6)
    # force chunking by shrinking the budget
    orig = api.Filter.render_animation

    f2 = mm.compile(src)
    frames = []
    # simulate small-chunk behavior by calling with a monkeypatched budget:
    # easiest — verify equality between 6-frame sweep and two 3-frame sweeps
    t6 = np.arange(6, dtype=np.float32) / 6
    r3 = f2._renderer(W, H, mm.RenderOptions(), 3)
    a = np.asarray(r3.render_all_frames([np.asarray(BLANK)], {}, t6[:3]))
    b = np.asarray(r3.render_all_frames([np.asarray(BLANK)], {}, t6[3:]))
    np.testing.assert_allclose(np.concatenate([a, b]), full, atol=1e-6)


def test_render_all_frames_frame_offset():
    src = "grayColor(frame / 8)"
    f = mm.compile(src)
    r = f._renderer(W, H, mm.RenderOptions(), 2)
    ts = np.zeros(2, np.float32)
    chunk2 = np.asarray(r.render_all_frames([np.asarray(BLANK)], {}, ts, frame0=4.0))
    np.testing.assert_allclose(chunk2[0][..., 0], np.full((H, W), 0.5))
    np.testing.assert_allclose(chunk2[1][..., 0], np.full((H, W), 5 / 8))


def test_sequential_loops_draw_different_rand():
    """Two sequential while loops must draw decorrelated rand() streams
    (r2 review finding: both reset to the same counter base) — and still
    match the oracle."""
    src = ("s = 0; i = 0; while i < 5 do s = s + rand(0, 1); i = i + 1 end;"
           "u = 0; j = 0; while j < 5 do u = u + rand(0, 1); j = j + 1 end;"
           "grayColor(abs(s - u) / 5)")
    f = mm.compile(src)
    o = f.render(BLANK, interpret=True)
    j = f.render(BLANK)
    np.testing.assert_allclose(j, o, atol=1e-6)
    assert float(np.abs(np.asarray(o)[..., 0]).max()) > 0.01  # not identical


def test_max_loop_iters_cap_exact_parity():
    """The jit unroll must stop EXACTLY at max_loop_iters like the oracle
    (r2 review finding: K=4 overshoot when the cap isn't a multiple of 4)."""
    src = "i = 0; while i < 1000 do i = i + 1 end; grayColor(i / 16)"
    f = mm.compile(src)
    opts = mm.RenderOptions(max_loop_iters=10)
    o = f.render(BLANK, interpret=True, options=opts)
    j = f.render(BLANK, options=opts)
    np.testing.assert_allclose(o[..., 0], np.full((H, W), 10 / 16), atol=1e-6)
    np.testing.assert_allclose(j, o, atol=1e-6)


def test_pallas_while_safe_calls_mosaic_probed():
    """SAFE_CALLS as the Triton route lowers it (tests/test_while_kernel.py
    cross-lowers every name): the inverse trig/hyperbolic family that the
    kernel's earlier route rejected is in; round (no Pallas GPU lowering),
    table-based noise and the specials nobody measured in the kernel are
    out."""
    from mathmap_tpu.pallas_kernels.while_kernel import SAFE_CALLS

    for bad in ("round", "noise", "gamma", "jac_sn", "ellK", "ellE",
                "lgamma", "beta", "origVal", "gaussian_blur", "solve"):
        assert bad not in SAFE_CALLS, bad
    for good in ("tanh", "tan", "exp2", "log10", "asin", "acos", "atan",
                 "atan2", "sinh", "cosh", "asinh", "acosh", "atanh", "toRA",
                 "arg"):
        assert good in SAFE_CALLS, good


def test_pallas_while_engine_excludes_atan2_body(while_kernel_interpret):
    """An atan2 body IS kernel-eligible on the Triton route; a body calling
    round() is NOT (no Pallas GPU lowering) and renders via the XLA loop.
    Both match the lax loop."""
    WK = while_kernel_interpret
    launches = []
    orig = WK.launch

    def counting(*a, **kw):
        launches.append(1)
        return orig(*a, **kw)

    # `x * 0` keeps the condition DYNAMIC (x carries no trace-time const)
    # so the static unroll doesn't swallow the loop before the engine
    src_ok = ("i = 0; acc = 0;"
              "while i + x * 0 < 4 do acc = acc + atan2(y, x + 10 + i); i = i + 1 end;"
              "grayColor(acc / 8)")
    src_bad = ("i = 0; acc = 0;"
               "while i + x * 0 < 4 do acc = acc + round(x / 7 + i); i = i + 1 end;"
               "grayColor(acc / 8)")
    opts = mm.RenderOptions(pallas_while="on")
    WK.launch = counting
    try:
        f = mm.compile(src_ok)
        a = f.render(BLANK, width=256, height=8, options=opts)
        assert launches, "atan2 body should engage the loop kernel"
        launches.clear()
        f2 = mm.compile(src_bad)
        b = f2.render(BLANK, width=256, height=8, options=opts)
        assert not launches, "round body must NOT engage the kernel"
    finally:
        WK.launch = orig
    a_off = f.render(BLANK, width=256, height=8,
                     options=mm.RenderOptions(pallas_while="off"))
    np.testing.assert_allclose(a, a_off, atol=1e-6)
    b_off = f2.render(BLANK, width=256, height=8,
                      options=mm.RenderOptions(pallas_while="off"))
    np.testing.assert_allclose(b, b_off, atol=1e-6)


def test_pallas_while_engine_matches_oracle(while_kernel_interpret):
    """The per-pixel loop kernel (pallas_kernels/while_kernel, forced via
    pallas_while='on', interpret mode on CPU) must match
    the oracle exactly — including the max_iters cap, cond assignments,
    and values computed before the loop (kernel dependencies)."""
    h, w = 16, 256
    img = np.zeros((h, w, 4), np.float32)
    src = ("c = x / W + y / H;"
           "z = 0; i = 0; n = 0;"
           "while n = n + 1; z < 4 + c && i < 37 do"
           "  z = z + 0.2 + 0.1 * sin(c * 9 + i); i = i + 1 "
           "end;"
           "grayColor(clamp(z / 8 + i / 100 + n / 1000, 0, 1))")
    f = mm.compile(src)
    o = f.render(img, width=w, height=h, interpret=True)
    opts = mm.RenderOptions(pallas_while="on")
    j = f.render(img, width=w, height=h, options=opts)
    np.testing.assert_allclose(j, o, atol=1e-5)
    # the cap applies exactly
    opts2 = mm.RenderOptions(pallas_while="on", max_loop_iters=9)
    o2 = f.render(img, width=w, height=h, interpret=True,
                  options=mm.RenderOptions(max_loop_iters=9))
    j2 = f.render(img, width=w, height=h, options=opts2)
    np.testing.assert_allclose(j2, o2, atol=1e-5)


def test_pallas_while_engine_mandelbrot_parity(while_kernel_interpret):
    h, w = 16, 256
    src = ("c = ri:[x / X * 2.4 - 0.5, y / X * 2.4];"
           "z = ri:[0, 0]; iter = 0;"
           "while z[0]*z[0] + z[1]*z[1] < 4 && iter < 48 do"
           "  z = z * z + c; iter = iter + 1 "
           "end;"
           "grayColor(iter / 48)")
    f = mm.compile(src)
    img = np.zeros((h, w, 4), np.float32)
    o = f.render(img, width=w, height=h, interpret=True)
    j = f.render(img, width=w, height=h,
                 options=mm.RenderOptions(pallas_while="on"))
    np.testing.assert_allclose(j, o, atol=1e-6)


def test_pallas_while_engine_scalar_param_dep(while_kernel_interpret):
    """A traced scalar userval read by the loop (mandelbrot's maxiter)
    reaches the kernel as a (1,1) scalar input."""
    h, w = 16, 256
    src = ("filter f (float lim: 1-64 (20), float stepv: 0.01-1 (0.3))"
           "  z = 0; i = 0;"
           "  while z < lim && i < 100 do z = z + stepv; i = i + 1 end;"
           "  grayColor(clamp(i / 100, 0, 1)) end")
    f = mm.compile(src)
    img = np.zeros((h, w, 4), np.float32)
    params = {"lim": 13.0, "stepv": 0.25}
    o = f.render(img, width=w, height=h, interpret=True, params=params)
    j = f.render(img, width=w, height=h, params=params,
                 options=mm.RenderOptions(pallas_while="on"))
    np.testing.assert_allclose(j, o, atol=1e-6)


def test_pallas_while_engine_rand_and_odd_size(while_kernel_interpret):
    """rand() inside the loop kernel (2-D iota index grid) and a
    non-block-aligned grid (padded edge blocks) both match the oracle."""
    h, w = 13, 100  # not multiples of the kernel block
    img = np.zeros((h, w, 4), np.float32)
    src = ("s = 0; i = 0;"          # x*0: keep the cond dynamic (engine path)
           "while i + x * 0 < 6 do s = s + rand(0, 1); i = i + 1 end;"
           "grayColor(s / 6)")
    f = mm.compile(src)
    o = f.render(img, width=w, height=h, interpret=True)
    j = f.render(img, width=w, height=h,
                 options=mm.RenderOptions(pallas_while="on"))
    np.testing.assert_allclose(j, o, atol=1e-6)


# ----------------------------------------------------------------------
# static-trip-count while unroll (trace-time const folding)
# ----------------------------------------------------------------------
class _WhileSpy:
    """Counts jax.lax.while_loop entries during a render."""

    def __enter__(self):
        import jax

        self._orig = jax.lax.while_loop
        self.calls = 0

        def spy(*a, **k):
            self.calls += 1
            return self._orig(*a, **k)

        jax.lax.while_loop = spy
        return self

    def __exit__(self, *exc):
        import jax

        jax.lax.while_loop = self._orig
        return False


def test_static_unroll_elides_while_loop():
    """A literal-driven counter folds at trace time: the loop is unrolled
    into straight-line code — no lax.while_loop in the program — and the
    result matches the oracle exactly."""
    src = ("s = 0; i = 0; while i < 9 do "
           "s = s + sin(i + x * 0.1) * 0.1; i = i + 1 end; "
           "grayColor(s * 0.3 + 0.5)")
    f = mm.compile(src)
    o = f.render(BLANK, interpret=True)
    with _WhileSpy() as spy:
        j = f.render(BLANK)
    assert spy.calls == 0
    np.testing.assert_allclose(j, o, atol=1e-6)


def test_static_unroll_nested_loops():
    """voronoi-style nested literal loops: both levels unroll."""
    src = ("acc = 0; j = -1; while j <= 1 do "
           "  i = -1; while i <= 1 do "
           "    acc = acc + noise([x * 0.1 + i, y * 0.1 + j, 0.5]); "
           "    i = i + 1 end; "
           "  j = j + 1 end; "
           "grayColor(acc / 9 + 0.5)")
    f = mm.compile(src)
    o = f.render(BLANK, interpret=True)
    with _WhileSpy() as spy:
        j = f.render(BLANK)
    assert spy.calls == 0
    np.testing.assert_allclose(j, o, atol=1e-6)


def test_dynamic_cond_keeps_while_loop():
    """A pixel-dependent condition must NOT unroll."""
    src = ("v = abs(x) + 1; n = 0; while v > 1 do "
           "v = v / 2; n = n + 1 end; grayColor(n / 4)")
    f = mm.compile(src)
    o = f.render(BLANK, interpret=True)
    with _WhileSpy() as spy:
        j = f.render(BLANK)
    assert spy.calls >= 1
    np.testing.assert_allclose(j, o, atol=1e-6)


def test_static_unroll_budget_bails_to_lax():
    """A 200-iteration literal counter exceeds the unroll budget and takes
    the masked lax path — still exact."""
    src = ("s = 0; i = 0; while i < 200 do "
           "s = s + 0.005; i = i + 1 end; grayColor(s)")
    f = mm.compile(src)
    o = f.render(BLANK, interpret=True)
    with _WhileSpy() as spy:
        j = f.render(BLANK)
    assert spy.calls >= 1
    np.testing.assert_allclose(j, o, atol=1e-5)
    np.testing.assert_allclose(np.asarray(j)[..., 0], 1.0, atol=1e-4)


def test_static_unroll_rand_stream_matches_oracle():
    """rand() inside an unrolled loop draws the same per-iteration stream
    as the oracle (salted by the host-side iteration index)."""
    src = ("s = 0; i = 0; while i < 5 do "
           "s = s + rand(0, 1); i = i + 1 end; grayColor(s / 5)")
    f = mm.compile(src)
    o = f.render(BLANK, interpret=True)
    with _WhileSpy() as spy:
        j = f.render(BLANK)
    assert spy.calls == 0
    np.testing.assert_allclose(j, o, atol=1e-6)


def test_do_while_literal_cond_still_exact():
    """post-loop (do-while) strips the const carry; parity retained."""
    src = ("i = 0; s = 0; do s = s + 0.25; i = i + 1 while i < 3 end; "
           "grayColor(s)")
    f = mm.compile(src)
    o = f.render(BLANK, interpret=True)
    j = f.render(BLANK)
    np.testing.assert_allclose(j, o, atol=1e-6)


def test_static_unroll_cond_sequence_assignments():
    """Assignments in the condition statement-sequence execute once per
    check and persist — preserved under the static unroll."""
    src = ("s = 0; i = 0; while k = i * 2; i < 4 do "
           "s = s + k; i = i + 1 end; grayColor((s + k) / 20)")
    f = mm.compile(src)
    o = f.render(BLANK, interpret=True)
    with _WhileSpy() as spy:
        j = f.render(BLANK)
    assert spy.calls == 0
    np.testing.assert_allclose(j, o, atol=1e-6)


def test_default_int_param_bakes_and_unrolls():
    """An UNPASSED int param is a trace-time constant of that program
    (the jit cache's static kinds spec records which params were passed),
    so a default-driven loop bound unrolls; passing the param explicitly
    keeps it traced and the loop dynamic. Both match the oracle."""
    src = ("filter f (int n: 1-8 (3)) "
           "s = 0; i = 0; while i < n do s = s + 0.125; i = i + 1 end; "
           "grayColor(s) end")
    f = mm.compile(src)
    o = f.render(BLANK, interpret=True)
    with _WhileSpy() as spy:
        j = f.render(BLANK)
    assert spy.calls == 0, "default-valued bound must bake + unroll"
    np.testing.assert_allclose(j, o, atol=1e-6)

    o2 = f.render(BLANK, interpret=True, params={"n": 5})
    with _WhileSpy() as spy:
        j2 = f.render(BLANK, params={"n": 5})
    assert spy.calls >= 1, "explicitly-passed bound must stay traced"
    np.testing.assert_allclose(j2, o2, atol=1e-6)
    np.testing.assert_allclose(np.asarray(j2)[..., 0], 0.625, atol=1e-6)


def test_static_params_bakes_explicit_value():
    """opts.static_params bakes a PASSED value into the program (the
    reference's cgen.c recompile-on-change behavior, opt-in): the loop
    unrolls and each distinct value compiles its own correct program."""
    src = ("filter f (int n: 1-8 (3)) "
           "s = 0; i = 0; while i < n do s = s + 0.125; i = i + 1 end; "
           "grayColor(s) end")
    f = mm.compile(src)
    so = mm.RenderOptions(static_params=("n",))
    for n, want in ((2, 0.25), (6, 0.75)):
        o = f.render(BLANK, interpret=True, params={"n": n}, options=so)
        with _WhileSpy() as spy:
            j = f.render(BLANK, params={"n": n}, options=so)
        assert spy.calls == 0
        np.testing.assert_allclose(j, o, atol=1e-6)
        np.testing.assert_allclose(np.asarray(j)[..., 0], want, atol=1e-6)


def test_static_params_validation():
    with pytest.raises(ValueError):
        mm.RenderOptions(static_params="n")  # must be a tuple


def test_pallas_while_on_overrides_static_unroll(while_kernel_interpret):
    """pallas_while='on' is documented as FORCING the loop kernel — it
    must win over the static unroll even for foldable conditions."""
    WK = while_kernel_interpret

    launches = []
    orig = WK.launch
    WK.launch = lambda *a, **k: (launches.append(1), orig(*a, **k))[1]
    try:
        img = np.zeros((8, 256, 4), np.float32)
        src = ("i = 0; s = 0; while i < 4 do s = s + 0.125 * (x / W); "
               "i = i + 1 end; grayColor(s + 0.5)")
        f = mm.compile(src)
        j = f.render(img, width=256, height=8,
                     options=mm.RenderOptions(pallas_while="on"))
    finally:
        WK.launch = orig
    assert launches, "engine must be launched when forced"
    o = f.render(img, width=256, height=8, interpret=True)
    np.testing.assert_allclose(j, o, atol=1e-6)


def test_while_static_unroll_option_disables():
    src = "i = 0; s = 0; while i < 3 do s = s + 0.2; i = i + 1 end; grayColor(s)"
    f = mm.compile(src)
    o = f.render(BLANK, interpret=True)
    with _WhileSpy() as spy:
        j = f.render(BLANK, options=mm.RenderOptions(while_static_unroll=0))
    assert spy.calls >= 1
    np.testing.assert_allclose(j, o, atol=1e-6)


def test_static_params_unknown_and_opaque_rejected():
    src = "filter g (int n: 1-8 (3), curve c) grayColor(c(n / 8)) end"
    f = mm.compile(src)
    img = np.zeros((8, 8, 4), np.float32)
    with pytest.raises(ValueError, match="not declared"):
        f.render(img, width=8, height=8,
                 options=mm.RenderOptions(static_params=("nope",)))
    with pytest.raises(ValueError, match="opaque"):
        f.render(img, width=8, height=8,
                 options=mm.RenderOptions(static_params=("c",)))


def test_static_unroll_cond_seq_length_change_const_alignment():
    """A cond-sequence assignment that narrows a carried tuple variable to
    a scalar must not misalign the const side-channel (the per-variable
    slot count is fixed at the probed length): regression for a confirmed
    wrong-pixels bug where `i`'s const read `s`'s slot and the unroll
    stopped after one iteration (jit 0.25 vs oracle 0.75)."""
    src = ("a = xy; i = 3; s = 0; while a = 0; i > 0 do "
           "a = a + xy * 0 + 1; s = s + 1; i = i - 1 end; grayColor(s / 4)")
    f = mm.compile(src)
    o = f.render(BLANK, interpret=True)
    j = f.render(BLANK)
    np.testing.assert_allclose(j, o, atol=1e-6)
    np.testing.assert_allclose(np.asarray(j)[..., 0], 0.75, atol=1e-6)


# round-3 _CONST_FOLD_OPS extension (scan_loops fold-miss closure): every
# newly whitelisted builtin drives a literal loop bound through the const
# mirror; the loop must UNROLL (no lax.while_loop) and match the oracle.
_FOLD_EXT_BOUNDS = [
    ("sin", "floor(sin(1) * 5) + 1"),            # 5
    ("cos", "floor(cos(1) * 5) + 2"),            # 4
    ("tan", "floor(tan(1) * 2) + 1"),            # 4
    ("asin", "floor(asin(0.5) * 4) + 1"),        # 3
    ("acos", "floor(acos(0.5) * 2) + 1"),        # 3
    ("atan", "floor(atan(1) * 4) + 2"),          # 5
    ("atan2", "floor(atan2(1, 1) * 4) + 1"),     # 4
    ("sinh", "floor(sinh(1) * 2) + 1"),          # 3
    ("cosh", "floor(cosh(1) * 2) + 1"),          # 4
    ("tanh", "floor(tanh(1) * 4) + 1"),          # 4
    ("asinh", "floor(asinh(1) * 4) + 1"),        # 4
    ("acosh", "floor(acosh(2) * 3) + 1"),        # 4
    ("atanh", "floor(atanh(0.5) * 5) + 1"),      # 3
    ("exp2", "floor(exp2(2)) + 1"),              # 5
    ("log2", "floor(log2(8)) + 1"),              # 4
    ("log10", "floor(log10(100)) + 1"),          # 3
    ("deg2rad", "floor(deg2rad(180) * 2) + 0"),  # 6
    ("rad2deg", "floor(rad2deg(0.1)) + 0"),      # 5
    ("hypot", "floor(hypot(3, 4)) + 0"),         # 5
    ("lerp", "floor(lerp(0.5, 2, 8)) + 0"),      # 5
    ("smoothstep", "floor(smoothstep(0, 1, 0.5) * 8) + 0"),  # 4
    ("inintv", "inintv(0.5, 0, 1) * 3 + 1"),     # 4
    ("conj", "floor(conj(ri:[3.2, 1])[0]) + 1"),   # 4
    ("rgbaColor", "floor(rgbaColor(0.5, 1, 0, 1)[0] * 6) + 1"),  # 4
    ("rgbColor", "floor(rgbColor(0.5, 1, 0)[1] * 3) + 1"),       # 4
    ("grayColor", "floor(grayColor(0.5)[0] * 6) + 1"),           # 4
    ("grayaColor", "floor(grayaColor(0.5, 1)[3] * 3) + 1"),      # 4
    ("gray", "floor(gray(rgbaColor(1, 1, 1, 1)) * 3) + 1"),      # 4
]


@pytest.mark.parametrize("opname,bound", _FOLD_EXT_BOUNDS,
                         ids=[b[0] for b in _FOLD_EXT_BOUNDS])
def test_const_fold_extension_unrolls_loop_bound(opname, bound):
    src = (f"n = {bound}; s = 0; i = 0; while i < n do "
           "s = s + 1; i = i + 1 end; grayColor(s / 8)")
    f = mm.compile(src)
    o = f.render(BLANK, interpret=True)
    with _WhileSpy() as spy:
        j = f.render(BLANK)
    assert spy.calls == 0, f"{opname}-derived bound must fold + unroll"
    np.testing.assert_allclose(j, o, atol=1e-6)


def test_unknown_param_name_raises():
    """A typo'd param name must raise, not silently render defaults —
    identically on the jit and oracle paths (review r3 finding)."""
    src = "filter f (float strength: 0-4 (1)) grayColor(strength / 4) end"
    f = mm.compile(src)
    with pytest.raises(ValueError, match="unknown param"):
        f.render(BLANK, params={"Strength": 2.0})
    with pytest.raises(ValueError, match="unknown param"):
        f.render(BLANK, params={"strengt": 2.0}, interpret=True)
    ok = f.render(BLANK, params={"strength": 2.0})
    np.testing.assert_allclose(np.asarray(ok)[..., 0], 0.5, atol=1e-6)


def test_curve_userval_shape_validation():
    src = "filter f (curve c) grayColor(c(x / W + 0.5)) end"
    f = mm.compile(src)
    from mathmap_tpu.utils.errors import MMTypeError

    with pytest.raises(MMTypeError, match="1-D LUT"):
        f.render(BLANK, params={"c": 0.5})
    with pytest.raises(MMTypeError, match="1-D LUT"):
        f.render(BLANK, params={"c": np.ones((4, 4), np.float32)})
    out = f.render(BLANK, params={"c": np.linspace(0, 1, 17,
                                                   dtype=np.float32)})
    assert np.isfinite(np.asarray(out)).all()


def test_image_userval_accepts_animated_stack():
    """(T,H,W,4) image uservals are animated drawables, same as
    positional inputs (review r3 finding: was rejected by ndim check)."""
    src = ("filter f (image a) a(xy) end")
    f = mm.compile(src)
    stack = np.stack([np.full((H, W, 4), v, np.float32)
                      for v in (0.25, 0.75)])
    out = f.render(params={"a": stack}, width=W, height=H, frame=1.0)
    np.testing.assert_allclose(np.asarray(out)[..., 0], 0.75, atol=1e-6)


# -- review r3: internal-variable shadowing semantics -----------------

def test_branch_assignment_to_internal_merges_against_internal():
    """`if x > 0 then y = -y end; abs(y)` must read the COORDINATE on the
    untaken branch (regression: merged against zero on both backends)."""
    f = mm.compile("if x > 0 then y = -y end; grayColor(abs(y) / 4)")
    o = np.asarray(f.render(BLANK, interpret=True))[..., 0]
    j = np.asarray(f.render(BLANK))[..., 0]
    ys = np.abs(H / 2 - (np.arange(H) + 0.5))[:, None] / 4
    np.testing.assert_allclose(o, np.broadcast_to(ys, (H, W)), atol=1e-6)
    np.testing.assert_allclose(j, o, atol=1e-6)


def test_loop_reassigning_internal_reads_internal_first():
    """A loop body reassigning y must see the coordinate on its first
    read, not a zero seed (regression)."""
    src = ("i = 0; s = 0; while i < 2 do y = y * 0.5; s = s + y; "
           "i = i + 1 end; grayColor(abs(s) / 4)")
    f = mm.compile(src)
    o = np.asarray(f.render(BLANK, interpret=True))[..., 0]
    j = np.asarray(f.render(BLANK))[..., 0]
    want = np.abs(0.75 * (H / 2 - (np.arange(H) + 0.5)))[:, None] / 4
    np.testing.assert_allclose(o, np.broadcast_to(want, (H, W)), atol=1e-6)
    np.testing.assert_allclose(j, o, atol=1e-6)


def test_loop_var_repurposing_tuple_internal_name():
    """A scalar counter named `I` (the length-2 imaginary-unit internal)
    is write-before-read — must still work with a zero seed."""
    out = gray("j = 0; s = 0; while j < 2 do I = 0.25; s = s + I; "
               "j = j + 1 end; grayColor(s)", interpret=False)
    np.testing.assert_allclose(out, np.full((H, W), 0.5), atol=1e-6)


def test_do_while_cond_sees_body_grown_tuple():
    """do-while probes body-then-cond: a cond subscripting a tuple the
    body grows must not raise (regression: spurious MMTypeError)."""
    src = ("i = 0; do v = xy:[i, 2]; i = i + 1 while v[1] > i end; "
           "grayColor(i / 4)")
    f = mm.compile(src)
    o = np.asarray(f.render(BLANK, interpret=True))[..., 0]
    j = np.asarray(f.render(BLANK))[..., 0]
    np.testing.assert_allclose(o, 0.5, atol=1e-6)
    np.testing.assert_allclose(j, o, atol=1e-6)


def test_opaque_loop_variable_clear_error():
    src = ("filter f (gradient g) i = 0; while i < 2 do h = g; "
           "i = i + 1 end; grayColor(i / 2) end")
    f = mm.compile(src)
    lut = np.ones((8, 4), np.float32)
    for kw in ({"interpret": True}, {}):
        with pytest.raises(MMTypeError, match="loop variable"):
            f.render(BLANK, params={"g": lut}, **kw)


def test_wk_engine_rejects_unshadowed_angle_internal(while_kernel_interpret):
    """A body reading the internal `a` (atan2-backed) runs IN the loop
    kernel on the Triton route, shadowed or not, and matches the oracle
    (the kernel's earlier route could not lower atan2 and had to keep
    such bodies off it)."""
    WK = while_kernel_interpret

    img = np.random.RandomState(0).rand(8, 256, 4).astype(np.float32)
    opts = mm.RenderOptions(pallas_while="on")
    launches = []
    orig = WK.launch

    def spy(*a, **k):
        launches.append(1)
        return orig(*a, **k)

    WK.launch = spy
    try:
        f = mm.compile("s = 0; i = 0; while i + x * 0 < 4 do "
                       "s = s + sin(a + i); i = i + 1 end; "
                       "grayColor(s / 8 + 0.5)")
        j = f.render(img, width=256, height=8, options=opts)
        assert launches == [1], "unshadowed `a` runs in the kernel"
        o = f.render(img, width=256, height=8, interpret=True)
        np.testing.assert_allclose(np.asarray(j), np.asarray(o), atol=1e-5)
        # shadowed (pre-loop assignment): in the kernel as well
        f2 = mm.compile("s = 0; i = 0; a = 0.3; while i + x * 0 < 4 do "
                        "s = s + sin(a + i); i = i + 1 end; "
                        "grayColor(s / 8 + 0.5)")
        j2 = f2.render(img, width=256, height=8, options=opts)
        assert launches == [1, 1], "shadowed `a` runs in the kernel"
        o2 = f2.render(img, width=256, height=8, interpret=True)
        np.testing.assert_allclose(np.asarray(j2), np.asarray(o2), atol=1e-5)
    finally:
        WK.launch = orig


def test_wk_engine_not_confused_by_opaque_shadowing_builtin(
        while_kernel_interpret):
    """A curve param named `sin` shadows the builtin; the kernel (which
    cannot apply curves) must decline, keeping jit == oracle."""
    img = np.random.RandomState(0).rand(8, 256, 4).astype(np.float32)
    opts = mm.RenderOptions(pallas_while="on")
    src = ("filter g (curve sin) s = 0; i = 0; "
           "while i + x * 0 < 3 do s = s + sin(0.3); i = i + 1 end; "
           "grayColor(s / 3) end")
    f = mm.compile(src)
    curve = np.full(16, 0.9, np.float32)  # constant 0.9 != builtin sin(0.3)
    j = f.render(img, width=256, height=8, options=opts,
                 params={"sin": curve})
    o = f.render(img, width=256, height=8, interpret=True,
                 params={"sin": curve})
    np.testing.assert_allclose(np.asarray(j), np.asarray(o), atol=1e-5)
    np.testing.assert_allclose(np.asarray(j)[..., 0], 0.9, atol=1e-3)


def test_pallas_while_on_forces_engine_regardless_of_sampler(
        while_kernel_interpret):
    """'on' forces the kernel whatever the other options say (here a
    non-default interpolation and edge mode)."""
    WK = while_kernel_interpret

    img = np.random.RandomState(0).rand(8, 256, 4).astype(np.float32)
    launches = []
    orig = WK.launch

    def spy(*a, **k):
        launches.append(1)
        return orig(*a, **k)

    WK.launch = spy
    try:
        f = mm.compile("s = 0; i = 0; while i + x * 0 < 4 do s = s + 0.1; "
                       "i = i + 1 end; grayColor(s)")
        j = f.render(img, width=256, height=8,
                     options=mm.RenderOptions(interpolation="nearest",
                                              edge_x="wrap",
                                              pallas_while="on"))
        assert launches, "'on' must force the engine (docs contract)"
        o = f.render(img, width=256, height=8, interpret=True)
        np.testing.assert_allclose(np.asarray(j), np.asarray(o), atol=1e-6)
    finally:
        WK.launch = orig


# ---------------------------------------------------------------------------
# review r5: internal-variable shadowing and dynamic-index l-value semantics
# ---------------------------------------------------------------------------


def _both(src):
    f = mm.compile(src)
    o = np.asarray(f.render(BLANK, interpret=True))[..., 0]
    j = np.asarray(f.render(BLANK))[..., 0]
    np.testing.assert_allclose(o, j, atol=1e-5)
    return o


def test_if_branch_shadowing_internal_reads_internal_on_untaken():
    """`if c then y = xy end`: on untaken pixels a read of y sees the
    INTERNAL y coordinate (broadcast to the branch value's length), not
    zeros (review r5 — the exact-length guard zero-filled)."""
    out = _both("filter f (image in) if x > 99 then y = xy end; "
                "grayColor(clamp(y[0] / Y * 0.25 + 0.5, 0, 1)) end")
    want = np.clip(Y / (H / 2) * 0.25 + 0.5, 0, 1)
    np.testing.assert_allclose(out, want, atol=1e-5)


def test_while_read_internal_before_shadowing_write():
    """A loop that reads `y[0]` before assigning `y = xy` sees the
    internal y coordinate on the first iteration, widened to the carried
    length (review r5 — zero-seeded before)."""
    out = _both("filter f (image in) q = 0; c = 0; while c < 1 do "
                "q = y[0]; y = xy; c = c + 1 end; "
                "grayColor(clamp(q / Y * 0.25 + 0.5, 0, 1)) end")
    want = np.clip(Y / (H / 2) * 0.25 + 0.5, 0, 1)
    np.testing.assert_allclose(out, want, atol=1e-5)


def test_dynamic_subassign_mirrors_subscript_floor_clamp():
    """l-value and r-value dynamic indices name the SAME component:
    v[1.7] writes where v[1.7] reads (floor/clamp), incl. out-of-range
    (review r5 — exact equality dropped fractional writes)."""
    out = _both("filter f (image in) v = xy:[1, 2]; jj = x - x + 1.7; "
                "v[jj] = 5; grayColor(v[jj] / 5) end")
    np.testing.assert_allclose(out, 1.0, atol=1e-5)
    out = _both("filter f (image in) v = xy:[1, 2]; jj = x - x - 3; "
                "v[jj] = 5; grayColor(v[jj] / 5) end")  # clamps to 0
    np.testing.assert_allclose(out, 1.0, atol=1e-5)


def test_do_while_prepass_widens_length_1_assignment():
    """do-while pre-pass routes through repack: a body that momentarily
    leaves a 2-tuple carry at length 1 widens instead of misaligning the
    flat carry (review r5 — raw pack emitted the wrong slot count)."""
    out = _both("filter f (image in) v = xy:[1, 2]; c = 0; do v = 3; "
                "v = v + xy:[0, 1]; c = c + 1 while c < 2 end; "
                "grayColor(v[1] / 5) end")
    np.testing.assert_allclose(out, 0.8, atol=1e-5)  # [3, 4][1] / 5
