"""Shared inputs for render_batch (mm.shared): one image every job
samples — the param-animation workload (N param/t values over one image).

A shared input is uploaded once and re-interleaved with each job's own
inputs inside the job loop (render.run_jobs/_merge_shared); output must be
BITWISE identical to the broadcast-stacked form.

Reference analog: the param-animation render loop over one prepared
drawable in mathmap_common.c [unverified — mount empty, SURVEY.md §0].
"""

import numpy as np
import pytest

import mathmap_tpu as mm

H, W = 36, 48


def _u8(seed=1, shape=(H, W, 4)):
    return (np.random.RandomState(seed).rand(*shape) * 255).astype(np.uint8)


_TS = (np.arange(5, dtype=np.float32) + 0.37) / 5
_PLIST = [{"angle": 3.0 + 0.05 * i} for i in range(5)]


@pytest.mark.parametrize("interp", ["bilinear", "bicubic"])
def test_shared_matches_stacked_bitwise_pallas(interp):
    """shared == broadcast-stacked, bitwise, u8 and f32 inputs, per-job
    params, at two interpolations."""
    f = mm.compile_file("filters/Distorts/twirl.mm")
    img = _u8()
    opts = mm.RenderOptions(interpolation=interp)
    for inp in (img, img.astype(np.float32) / np.float32(255.0)):
        stack = np.broadcast_to(inp, (5,) + inp.shape)
        a = f.render_batch(stack.copy(), ts=_TS, params=_PLIST,
                           width=W, height=H, options=opts)
        b = f.render_batch(mm.shared(inp), ts=_TS, params=_PLIST,
                           width=W, height=H, options=opts)
        np.testing.assert_array_equal(a, b)


def test_shared_dict_params_and_u8_output():
    f = mm.compile_file("filters/Distorts/twirl.mm")
    img = _u8(2)
    stack = np.broadcast_to(img, (5,) + img.shape)
    for odt in ("float32", "uint8"):
        opts = mm.RenderOptions(output_dtype=odt)
        a = f.render_batch(stack.copy(), ts=_TS, params={"angle": 2.0},
                           width=W, height=H, options=opts)
        b = f.render_batch(mm.shared(img), ts=_TS, params={"angle": 2.0},
                           width=W, height=H, options=opts)
        assert a.dtype == np.dtype(odt)
        np.testing.assert_array_equal(a, b)


def test_mixed_shared_and_per_job_inputs():
    """A two-input filter with one shared and one per-job input keeps
    position order and matches the fully-stacked form bitwise."""
    f = mm.compile_source(
        "filter m (image a, image b) (a(xy) + b(xy))/2 end")
    base = _u8(3).astype(np.float32) / np.float32(255.0)
    other = np.stack([np.random.RandomState(10 + i).rand(H, W, 4)
                      .astype(np.float32) for i in range(5)])
    a = f.render_batch(np.broadcast_to(base, (5,) + base.shape).copy(),
                       other, ts=_TS, width=W, height=H)
    b = f.render_batch(mm.shared(base), other, ts=_TS, width=W, height=H)
    np.testing.assert_array_equal(a, b)


def test_animated_shared_stack_matches_per_frame():
    """A shared (T, H, W, 4) ANIMATED stack with per-job frame selection
    (a rank-5 job stack was never a supported form — shared is the only
    batched entry for animated inputs)."""
    f = mm.compile_source("filter s (image in) in(xy) end")
    anim = _u8(4, (3, H, W, 4))
    fr = np.float32([0, 1, 2, 1, 0])
    opts = mm.RenderOptions(interpolation="bicubic")
    b = f.render_batch(mm.shared(anim), ts=np.zeros(5, np.float32),
                       frames=fr, width=W, height=H, options=opts)
    per = np.stack([np.asarray(f.render(anim, frame=float(fr[i]), t=0.0,
                                        width=W, height=H, options=opts))
                    for i in range(5)])
    np.testing.assert_array_equal(b, per)


def test_all_shared_batch_size_from_ts_or_params():
    f = mm.compile_file("filters/Distorts/twirl.mm")
    img = _u8(5)
    out = f.render_batch(mm.shared(img), ts=_TS, width=W, height=H)
    assert out.shape == (5, H, W, 4)
    out = f.render_batch(mm.shared(img), params=_PLIST, width=W, height=H)
    assert out.shape == (5, H, W, 4)


def test_unwrapped_lone_frame_still_raises():
    """The lone-(H,W,C) guard stays: without mm.shared a single frame is
    still rejected (it would silently iterate over rows)."""
    f = mm.compile_file("filters/Distorts/twirl.mm")
    with pytest.raises(ValueError, match="leading batch axis"):
        f.render_batch(_u8(6), ts=_TS, width=W, height=H)


def test_shared_prepad_actually_hoists():
    """_merge_shared re-interleaves shared and per-job inputs in their
    original positions (a shuffled order would bind images to the wrong
    params)."""
    from mathmap_tpu.runtime.render import _merge_shared

    assert _merge_shared((True, False), ["IMG"], ["JOB"]) == ["IMG", "JOB"]
    assert _merge_shared((False, True), ["IMG"], ["JOB"]) == ["JOB", "IMG"]
    assert _merge_shared((False,), [], ["JOB"]) == ["JOB"]


def test_batch_leading_dim_mismatch_is_readable(input_like=None):
    """Per-job inputs and explicit frames whose leading dim mismatches
    the ts batch size raise a clear ValueError at the API boundary, not
    an opaque lax.map leading-axis trace error (review r5)."""
    f = mm.compile_file("filters/Distorts/twirl.mm")
    stack3 = np.random.RandomState(3).rand(3, H, W, 4).astype(np.float32)
    with pytest.raises(ValueError, match="4 ts for a batch of 3"):
        f.render_batch(stack3, ts=[0.0, 0.1, 0.2, 0.3],
                       width=W, height=H)
    # the renderer-level guard (serve/direct-renderer callers bypass the
    # api check): per-job leading dim vs the jobs count
    rend = f._renderer(W, H, mm.RenderOptions(), 1)
    with pytest.raises(ValueError, match="leading dim 3 for a batch of 4"):
        rend.render_batch([stack3], [{}] * 4,
                          np.asarray([0.0, 0.1, 0.2, 0.3], np.float32))
    with pytest.raises(ValueError, match="2 frames for a batch of 3"):
        f.render_batch(stack3, ts=[0.0, 0.1, 0.2], frames=[0.0, 1.0],
                       width=W, height=H)


def test_uses_sampling_sees_aliased_image():
    """`q = in; q(xy)` samples through a local alias (review r5): jit and
    oracle agree, and the batched form equals the lone render."""
    f = mm.compile("filter f (image in) q = in; q(xy) end")
    stack = np.random.RandomState(3).rand(2, 16, 16, 4).astype(np.float32)
    batched = f.render_batch(stack, ts=[0.0, 0.0], frames=[0.0, 0.0])
    np.testing.assert_array_equal(batched[1],
                                  f.render(stack[1], width=16, height=16))
    # aliased render correct vs oracle
    img = np.random.RandomState(2).rand(16, 16, 4).astype(np.float32)
    a = np.asarray(f.render(img, width=16, height=16))
    b = np.asarray(f.render(img, width=16, height=16, interpret=True))
    np.testing.assert_allclose(a, b, atol=1e-5)
