"""Animated ((T, H, W, 4)) input drawables: frame-indexed origVal sampling.

Reference: origValXY(x, y[, frame]) samples frame-indexed input drawables
(SURVEY.md §2.1 origVal row [unverified — mount empty]; VERDICT r2 missing
item 2). Semantics built here: indices round to nearest and clamp to
[0, T-1]; origVal/in(xy) on an animated input samples the invocation's
CURRENT frame (animation in -> animation out)."""

import numpy as np
import pytest

import mathmap_tpu as mm

H, W, T = 16, 64, 3


def _anim(seed=0):
    stack = np.random.RandomState(seed).rand(T, H, W, 4).astype(np.float32)
    stack[..., 3] = 1.0
    return stack


def test_current_frame_sampling_identity():
    """origVal(xy) on an animated input returns the current frame."""
    stack = _anim()
    f = mm.compile("origVal(xy)")
    for fr in range(T):
        out = f.render(stack, frame=float(fr),
                       options=mm.RenderOptions(interpolation="nearest"))
        np.testing.assert_allclose(out, stack[fr], atol=1e-6)


def test_explicit_frame_index_and_clamp():
    stack = _anim(1)
    f = mm.compile("origValXY(x, y, 1)")
    out = f.render(stack, options=mm.RenderOptions(interpolation="nearest"))
    np.testing.assert_allclose(out, stack[1], atol=1e-6)
    # out-of-range indices clamp (reference behavior [unverified])
    f2 = mm.compile("origValXY(x, y, 99)")
    out2 = f2.render(stack, options=mm.RenderOptions(interpolation="nearest"))
    np.testing.assert_allclose(out2, stack[T - 1], atol=1e-6)


def test_per_pixel_frame_index_gather_path():
    """A per-pixel frame expression routes through the gather path."""
    stack = _anim(2)
    f = mm.compile("origValXY(x, y, if x >= 0 then 2 else 0 end)")
    out = f.render(stack, options=mm.RenderOptions(interpolation="nearest"))
    xs = np.arange(W) + 0.5 - W / 2
    right = xs >= 0
    np.testing.assert_allclose(out[:, right], stack[2][:, right], atol=1e-6)
    np.testing.assert_allclose(out[:, ~right], stack[0][:, ~right], atol=1e-6)


def test_oracle_parity_animated_warp():
    """jit vs NumPy oracle on a warp over an animated input (current-frame
    plus explicit-frame sampling mixed)."""
    stack = _anim(3)
    src = "0.5 * origVal(xy * 0.8) + 0.5 * origValXY(x * 0.9, y, 0)"
    f = mm.compile(src)
    opts = mm.RenderOptions(interpolation="bilinear", edge_x="wrap",
                            edge_y="reflect")
    a = f.render(stack, frame=2.0, options=opts)
    b = f.render(stack, frame=2.0, options=opts, interpret=True)
    np.testing.assert_allclose(a, b, atol=2e-5)


def test_animation_in_animation_out():
    """render_animation over an animated input: frame f samples input
    frame f (num_frames == T, identity filter)."""
    stack = _anim(4)
    f = mm.compile("origVal(xy)")
    out = f.render_animation(stack, num_frames=T,
                             options=mm.RenderOptions(interpolation="nearest"))
    np.testing.assert_allclose(out, stack, atol=1e-6)


def test_animated_pallas_matches_gather():
    """A twirl over frame 1 of an animated input: the jit two-axis gather
    (frame, pixel) matches the oracle."""
    stack = np.random.RandomState(5).rand(2, 64, 256, 4).astype(np.float32)
    f = mm.compile_file("filters/Distorts/twirl.mm")
    a = f.render(stack, frame=1.0)
    b = f.render(stack, frame=1.0, interpret=True)
    np.testing.assert_allclose(a, b, atol=2e-4)


def test_single_frame_stack_pallas_path():
    """(1, H, W, 4) stacks (single-frame GIFs stay 4-D by design) sample
    like the 3-D image (review r3 finding: the non-animated branch once
    skipped the frame-select)."""
    stack = np.random.RandomState(6).rand(1, 32, 64, 4).astype(np.float32)
    f = mm.compile("origVal(xy)")
    out = f.render(stack, options=mm.RenderOptions(interpolation="nearest"))
    np.testing.assert_allclose(out, stack[0], atol=1e-5)


def test_render_batch_input_validation():
    """render_batch: a lone (H,W,C) frame and a ts/batch length mismatch
    raise clear ValueErrors instead of rendering garbage jobs / failing
    deep inside lax.map."""
    import pytest as _pytest

    f = mm.compile("origVal(xy)")
    frame = np.zeros((16, 16, 4), np.float32)
    with _pytest.raises(ValueError, match="leading batch axis"):
        f.render_batch(frame)
    with _pytest.raises(ValueError, match="ts for a batch"):
        f.render_batch(np.stack([frame] * 3), ts=[0.1, 0.2])


def test_cli_reads_animated_gif(tmp_path):
    """CLI: a multi-frame GIF input becomes an animated input stack."""
    from PIL import Image

    frames = [Image.fromarray(
        np.full((8, 8, 4), 40 + 170 * i, np.uint8), "RGBA").convert("P")
        for i in range(2)]
    gif = tmp_path / "in.gif"
    frames[0].save(gif, save_all=True, append_images=frames[1:],
                   duration=100, loop=0)
    out = tmp_path / "out.png"
    from mathmap_tpu.cli import main as cli_main

    rc = cli_main(["origValXY(x, y, 1)", str(gif), str(out),
                   "--interpolation", "nearest"])
    assert rc == 0
    got = np.asarray(Image.open(out).convert("RGBA"))
    assert abs(int(got[0, 0, 0]) - 210) <= 30  # frame 1, not frame 0


def test_render_sharded_animated_matches_render():
    """render_sharded replicates animated stacks per device; output must
    equal the unsharded render frame for frame (current-frame semantics)."""
    stack = _anim(3)
    f = mm.compile("filter f (image in) in(xy) end")
    opts = mm.RenderOptions(interpolation="nearest")
    for fr in (0.0, 2.0):
        ref = f.render(stack, width=W, height=H, frame=fr, options=opts)
        out = f.render_sharded(stack, width=W, height=H, frame=fr,
                               options=opts)
        np.testing.assert_allclose(out, ref, atol=1e-6)


def test_render_tiled_animated_matches_render():
    """Animated stacks under the tiled (input-sharded) path: every frame
    shards identically; current-frame, explicit-scalar, and per-pixel
    frame selection all match the unsharded render."""
    stack = _anim(7)
    opts = mm.RenderOptions(interpolation="nearest")
    f = mm.compile("filter f (image in) in(xy) end")
    for fr in (0.0, 2.0):
        ref = f.render(stack, width=W, height=H, frame=fr, options=opts)
        out = f.render_tiled(stack, width=W, height=H, frame=fr,
                             options=opts)
        np.testing.assert_allclose(out, ref, atol=1e-6)
    f2 = mm.compile("origValXY(x, y, 1)")
    np.testing.assert_allclose(
        f2.render_tiled(stack, width=W, height=H, options=opts),
        f2.render(stack, width=W, height=H, options=opts), atol=1e-6)
    f3 = mm.compile("origValXY(x, y, if x >= 0 then 2 else 0 end)")
    np.testing.assert_allclose(
        f3.render_tiled(stack, width=W, height=H, options=opts),
        f3.render(stack, width=W, height=H, options=opts), atol=1e-6)


def test_render_tiled_animated_warp_and_edges():
    """Warped sampling over an animated tiled input exercises the halo
    exchange + edge painting on the 4-D stack (wrap/reflect and color)."""
    T2, H2 = 3, 64
    stack = np.random.RandomState(8).rand(T2, H2, W, 4).astype(np.float32)
    f = mm.compile("filter f (image in) in(xy + xy:[2, -3]) end")
    for opts in (
        mm.RenderOptions(interpolation="bilinear", edge_x="wrap",
                         edge_y="reflect"),
        mm.RenderOptions(interpolation="bilinear", edge_x="color",
                         edge_y="color", edge_color=(1.0, 0.0, 0.0, 1.0)),
    ):
        ref = f.render(stack, width=W, height=H2, frame=2.0, options=opts)
        out = f.render_tiled(stack, width=W, height=H2, frame=2.0,
                             options=opts)
        np.testing.assert_allclose(out, ref, atol=1e-6)


def test_render_tiled_animated_violation_check():
    """The bounded-displacement contract still raises on animated inputs."""
    T2, H2 = 2, 64
    stack = np.random.RandomState(9).rand(T2, H2, W, 4).astype(np.float32)
    f = mm.compile("filter f (image in) in(xy * 3) end")
    with pytest.raises(mm.MMError):
        f.render_tiled(stack, width=W, height=H2, halo=2)


def test_uint8_image_userval_normalizes():
    """A uint8 array bound to an image PARAM must normalize /255 exactly
    like a positional input (review r3: it rendered 0-255 values)."""
    f32 = _anim(5)[0]
    u8 = (np.clip(f32, 0, 1) * 255 + 0.5).astype(np.uint8)
    f = mm.compile("filter f (image img) img(xy) end")
    opts = mm.RenderOptions(interpolation="nearest")
    a = f.render(width=W, height=H, params={"img": u8}, options=opts)
    b = f.render(width=W, height=H, params={"img": u8.astype(np.float32) / 255.0},
                 options=opts)
    np.testing.assert_allclose(a, b, atol=1e-6)
    assert a.max() <= 1.0


def test_render_sharded_frame_sweep_animated():
    """Sharded multi-frame sweep over an animated input: output frame i
    samples input frame i (current-frame indexing inside mesh tiles under
    the 'f' axis sweep)."""
    stack = _anim(11)
    f = mm.compile("filter f (image in) in(xy) end")
    opts = mm.RenderOptions(interpolation="nearest")
    out = f.render_sharded(stack, num_frames=T, width=W, height=H,
                           options=opts)
    ref = np.stack([
        np.asarray(f.render(stack, width=W, height=H, frame=float(i),
                            options=opts)) for i in range(T)])
    np.testing.assert_allclose(out, ref, atol=1e-6)
