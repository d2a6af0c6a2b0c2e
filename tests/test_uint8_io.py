"""uint8 device-side I/O: RenderOptions(output_dtype='uint8') packs the
8-bit output INSIDE the render program (runtime/render.pack_uint8), and
uint8 (…, H, W, 4) inputs normalize in-trace (runtime/render.float_inputs)
— both bit-identical to the host helpers (imgio.to_uint8 / to_float_rgba),
so the serving path can ship 4× fewer bytes each way.

Reference analog: the 8-bit pack at the end of the render loop in
mathmap_common.c [unverified — mount empty, SURVEY.md §0]; the device-side
placement is this system's own design (host<->device transfer has no C
analog).
"""

import numpy as np
import pytest

import mathmap_tpu as mm
from mathmap_tpu.imgio.images import to_float_rgba, to_uint8

H, W = 24, 32

_WARP = "filter w (image in) in(xy + [sin(y/5)*2, cos(x/7)*2]) end"


def _img_f32(seed=3, h=H, w=W):
    img = np.random.RandomState(seed).rand(h, w, 4).astype(np.float32)
    img[..., 3] = 1.0
    return img


def _img_u8(seed=3, h=H, w=W):
    return np.random.RandomState(seed).randint(
        0, 256, size=(h, w, 4), dtype=np.uint8)


def test_output_dtype_validation():
    with pytest.raises(ValueError, match="output_dtype"):
        mm.RenderOptions(output_dtype="float16")


def test_pack_matches_host_pack_bitwise():
    """Device pack == imgio.to_uint8 of the float render, bit for bit
    (same floats in, same clip·255+0.5 floor rule)."""
    f = mm.compile_source(_WARP)
    img = _img_f32()
    f32 = f.render(img)
    u8 = f.render(img, options=mm.RenderOptions(output_dtype="uint8"))
    assert u8.dtype == np.uint8
    np.testing.assert_array_equal(u8, to_uint8(f32))


def test_pack_formula_ties_and_bounds():
    """pack_uint8 vs native.f32_to_u8 on crafted values: exact k/255
    sample points (ties under the +0.5 rule), out-of-range values, 0, 1."""
    import jax.numpy as jnp

    from mathmap_tpu.runtime.render import pack_uint8

    vals = np.concatenate([
        np.arange(256, dtype=np.float32) / 255.0,          # exact levels
        np.float32([-.5, -1e-6, 0.0, 1.0, 1.0 + 1e-6, 2.0]),
        (np.arange(255, dtype=np.float32) + 0.5) / 255.0,  # midpoints
        np.random.RandomState(0).rand(512).astype(np.float32),
    ])
    dev = np.asarray(pack_uint8(jnp, jnp.asarray(vals)))
    host = to_uint8(vals)
    np.testing.assert_array_equal(dev, host)
    # numpy-backend pack (the oracle's) agrees too
    np.testing.assert_array_equal(pack_uint8(np, vals), host)


def test_u8_input_matches_host_converted_f32_bitwise():
    """A uint8 input renders bit-identically to its to_float_rgba twin —
    the in-trace /255 is the same operation."""
    f = mm.compile_source(_WARP)
    raw = _img_u8()
    a = f.render(raw)
    b = f.render(to_float_rgba(raw))
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_u8_in_u8_out_jit_matches_oracle():
    f = mm.compile_source(_WARP)
    raw = _img_u8(5)
    opts = mm.RenderOptions(output_dtype="uint8")
    jit = f.render(raw, options=opts)
    ora = f.render(raw, options=opts, interpret=True)
    assert jit.dtype == ora.dtype == np.uint8
    # jit and oracle floats agree to ~1e-5; after packing that is at most
    # one 8-bit count on round boundaries
    diff = np.abs(jit.astype(np.int16) - ora.astype(np.int16))
    assert diff.max() <= 1


def test_u8_output_jit_matches_oracle_float_input():
    f = mm.compile_source(_WARP)
    img = _img_f32(7, 64, 96)
    opts = mm.RenderOptions(output_dtype="uint8")
    a = f.render(img, options=opts)
    b = f.render(img, options=opts, interpret=True)
    diff = np.abs(a.astype(np.int16) - b.astype(np.int16))
    assert diff.max() <= 1


def test_animated_u8_input_matches_f32():
    src = "filter a (image in) origValXY(x, y, 1) end"
    f = mm.compile_source(src)
    anim = np.random.RandomState(9).randint(
        0, 256, size=(3, H, W, 4), dtype=np.uint8)
    a = f.render(anim, options=mm.RenderOptions(interpolation="nearest"))
    b = f.render(np.stack([to_float_rgba(fr) for fr in anim]),
                 options=mm.RenderOptions(interpolation="nearest"))
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_render_batch_device_stack_passes_through():
    """A device-resident (N, H, W, 4) stack must reach the renderer
    without a host round-trip (api conv passthrough) and render exactly
    like per-frame calls."""
    import jax
    import jax.numpy as jnp

    f = mm.compile_source(_WARP)
    frames = np.stack([_img_f32(s) for s in range(4)])
    dev = jax.device_put(jnp.asarray(frames))
    outs = f.render_batch(dev, ts=[0.0] * 4, frames=[0.0] * 4)
    for i in range(4):
        one = f.render(frames[i])
        np.testing.assert_allclose(outs[i], one, atol=1e-6)


def test_render_batch_u8_stack_and_u8_out():
    f = mm.compile_source(_WARP)
    raw = np.random.RandomState(11).randint(
        0, 256, size=(3, H, W, 4), dtype=np.uint8)
    opts = mm.RenderOptions(output_dtype="uint8")
    outs = f.render_batch(raw, ts=[0.0] * 3, frames=[0.0] * 3, options=opts)
    assert outs.dtype == np.uint8
    for i in range(3):
        one = f.render(raw[i], options=opts)
        np.testing.assert_array_equal(outs[i], one)


def test_sharded_u8_output_matches_unsharded():
    img = _img_f32(13, 32, 48)
    f = mm.compile_source(_WARP)
    opts = mm.RenderOptions(output_dtype="uint8")
    sh = f.render_sharded(img, options=opts)
    un = f.render(img, options=opts)
    assert sh.dtype == np.uint8
    np.testing.assert_array_equal(np.asarray(sh), np.asarray(un))


def test_tiled_u8_output_matches_plain():
    img = _img_f32(17, 32, 48)
    f = mm.compile_source(_WARP)
    opts = mm.RenderOptions(output_dtype="uint8")
    ti = f.render_tiled(img, options=opts)
    un = f.render(img, options=opts)
    assert ti.dtype == np.uint8
    np.testing.assert_array_equal(np.asarray(ti), np.asarray(un))


def test_corners_supersample_u8():
    f = mm.compile_source(_WARP)
    img = _img_f32(19)
    opts = mm.RenderOptions(supersample=2, supersample_scheme="corners",
                            output_dtype="uint8")
    u8 = f.render(img, options=opts)
    f32 = f.render(img, options=mm.RenderOptions(
        supersample=2, supersample_scheme="corners"))
    np.testing.assert_array_equal(u8, to_uint8(f32))


def test_to_uint8_passthrough_and_read_animation_u8(tmp_path):
    raw = _img_u8(23)
    assert to_uint8(raw) is raw
    # GIF round-trip keeps uint8 under as_uint8=True
    from PIL import Image

    from mathmap_tpu.imgio.images import read_animation

    p = tmp_path / "a.gif"
    Image.fromarray(raw).save(p)
    stack = read_animation(str(p), as_uint8=True)
    assert stack.dtype == np.uint8 and stack.shape == (1, H, W, 4)


# ---------------------------------------------------------------------------
# u8 inputs on every sampling route: normalized /255 in-trace, then sampled
# like float images.
# ---------------------------------------------------------------------------

def test_exact_u8_round_recovers_all_values():
    """round(f32(u/255)*255) == u for every u8 value: the in-trace /255
    loses nothing a u8 output pack could need."""
    u = np.arange(256, dtype=np.uint8)
    v = u.astype(np.float32) / np.float32(255.0)
    np.testing.assert_array_equal(np.round(v * np.float32(255.0)),
                                  u.astype(np.float32))


@pytest.mark.parametrize("out_dtype", ["float32", "uint8"])
@pytest.mark.parametrize("interp", ["nearest", "bilinear", "bicubic"])
def test_u8_input_matches_oracle(out_dtype, interp):
    """u8 input through the gather sampler matches the oracle at every
    interpolation with wrap/reflect edges, float or u8 out."""
    f = mm.compile_source(
        "filter tw (image in) in(xy + [sin(y/3)*4, cos(x/5)*4]) end")
    img = _img_u8(7, 64, 96)
    opts = mm.RenderOptions(interpolation=interp, edge_x="wrap",
                            edge_y="reflect", output_dtype=out_dtype)
    out = np.asarray(f.render(img, options=opts)).astype(np.float32)
    ora = np.asarray(f.render(img, options=opts, interpret=True)
                     ).astype(np.float32)
    lim = 1.0 if out_dtype == "uint8" else 2e-4  # one 8-bit count
    assert np.abs(out - ora).max() <= lim


def test_u8_color_edge_matches_oracle():
    """'color' edges with an on-grid edge_color match the oracle on u8
    input."""
    f = mm.compile_source("filter z (image in) in(xy*1.4 - [8, 8]) end")
    img = _img_u8(11, 48, 64)
    opts = mm.RenderOptions(edge_x="color", edge_y="color",
                            edge_color=(0.0, 128.0 / 255.0, 1.0, 1.0))
    out = np.asarray(f.render(img, options=opts))
    ora = np.asarray(f.render(img, options=opts, interpret=True))
    assert np.abs(out - ora).max() < 2e-4


def test_u8_offgrid_color_edge_matches_oracle():
    """An OFF-grid edge_color is substituted unquantized on u8 input."""
    f = mm.compile_source("filter z (image in) in(xy*1.4 - [8, 8]) end")
    img = _img_u8(11, 48, 64)
    opts = mm.RenderOptions(edge_x="color", edge_y="color",
                            edge_color=(0.1234, 0.0, 0.5, 1.0))
    out = np.asarray(f.render(img, options=opts))
    ora = np.asarray(f.render(img, options=opts, interpret=True))
    assert np.abs(out - ora).max() < 2e-4


def test_u8_device_input_matches_oracle():
    """A device-resident u8 input passes the renderer's staging untouched
    (no host round-trip) and normalizes in-trace like a host u8 array."""
    import jax.numpy as jnp

    f = mm.compile_source(
        "filter tw (image in) in(xy + [sin(y/3)*4, cos(x/5)*4]) end")
    img = _img_u8(5, 64, 96)
    dev = jnp.asarray(img)
    out = np.asarray(f.render(dev))
    ora = np.asarray(f.render(img, interpret=True))
    assert np.abs(out - ora).max() < 2e-4


def test_exact_u8_image_userval_param():
    """u8 image PARAMS (uservals) normalize /255 on conversion and ride
    the jit boundary as plain 'image' kinds, u8 or float alike."""
    from mathmap_tpu.runtime.render import RenderContext, _userval_pytree

    src = ("filter m (image in, image other)\n"
           "  other(xy + [sin(y/4)*3, 0])\nend")
    f = mm.compile_source(src)
    base = _img_u8(2, 48, 64)
    other = _img_u8(9, 48, 64)

    import jax.numpy as jnp

    ctx = RenderContext(be=jnp, width=64, height=48,
                        opts=mm.RenderOptions(), inputs=[],
                        filters=f.filters, is_jax=True)
    _, kinds = _userval_pytree(ctx, f.fdef, {"other": other})
    assert dict(kinds)["other"] == "image"
    _, kinds_f = _userval_pytree(
        ctx, f.fdef, {"other": other.astype(np.float32) / 255.0})
    assert dict(kinds_f)["other"] == "image"

    out = np.asarray(f.render(base, params={"other": other}))
    ora = np.asarray(f.render(base, params={"other": other},
                              interpret=True))
    assert np.abs(out - ora).max() < 2e-4


def test_sweep_unroll_option():
    """RenderOptions.sweep_unroll: validation, auto gating by frame size,
    and bitwise parity of every unroll factor with per-frame renders
    (the chunk pad path included: 7 frames at unroll 3/8)."""
    from mathmap_tpu.runtime.render import sweep_unroll_for

    o = mm.RenderOptions()
    # auto = flat map everywhere: the product-path A/B had lax.map
    # winning at both 1080p and 4K (see render.sweep_unroll_for)
    assert sweep_unroll_for(o, 3840, 2160) == 1
    assert sweep_unroll_for(o, 1920, 1080) == 1
    assert sweep_unroll_for(mm.RenderOptions(sweep_unroll=4), 8, 8) == 4
    with pytest.raises(ValueError, match="sweep_unroll"):
        mm.RenderOptions(sweep_unroll=0)
    with pytest.raises(ValueError, match="sweep_unroll"):
        mm.RenderOptions(sweep_unroll="always")

    f = mm.compile_source(
        "filter r (image in, float amp: 0-10 (2))\n"
        "  in(xy + [sin(y/6 + t*6)*amp, 0])\nend")
    img = _img_f32(0, 40, 64)
    for u in ("auto", 1, 3, 8):
        opts = mm.RenderOptions(sweep_unroll=u)
        anim = np.asarray(f.render_animation(img, num_frames=7,
                                             options=opts))
        per = np.stack([np.asarray(f.render(img, t=i / 7, frame=i,
                                            options=opts))
                        for i in range(7)])
        np.testing.assert_array_equal(anim, per)


def test_sharded_u8_input_matches_unsharded_bitwise():
    """u8 INPUTS through render_sharded take the same in-trace /255 as
    unsharded renders — output must match BITWISE, float or u8 out
    (before this, the sharded path pre-converted u8 on the host)."""
    img = _img_u8(21, 32, 48)
    f = mm.compile_source(_WARP)
    for out_dtype in ("float32", "uint8"):
        opts = mm.RenderOptions(output_dtype=out_dtype)
        sh = np.asarray(f.render_sharded(img, options=opts))
        un = np.asarray(f.render(img, options=opts))
        np.testing.assert_array_equal(sh, un)


def test_tiled_u8_input_exact_path_engages():
    """u8 INPUTS through render_tiled normalize /255 per block. Bitwise
    equality with the plain renderer is NOT the bar here (unlike
    render_sharded): the tiled path re-bases coordinates per block, which
    moves f32 weight arithmetic by ~1e-5. The identity render reproduces
    the u8 input exactly, and a warp stays within 1e-4 of the plain
    renderer, wrap or on-grid color edges."""
    img = _img_u8(29, 32, 48)
    ident = mm.compile_source("filter i (image in) in(xy) end")
    ti = np.asarray(ident.render_tiled(img, width=48, height=32))
    assert np.abs(ti - img.astype(np.float32) / 255.0).max() < 1e-6
    f = mm.compile_source(_WARP)
    for ex, ey in (("wrap", "wrap"), ("color", "color")):
        o = mm.RenderOptions(edge_x=ex, edge_y=ey,
                             edge_color=(0.0, 128 / 255.0, 1.0, 1.0))
        ti = np.asarray(f.render_tiled(img, options=o))
        un = np.asarray(f.render(img, options=o))
        np.testing.assert_allclose(ti, un, atol=1e-4)
