"""Region (selection) renders: options.region = (x, y, w, h) evaluates only
the sub-rectangle with FULL-canvas coordinate semantics — the analog of the
reference GIMP plugin applying the filter to the drawable's selection bounds
(`mathmap.c` sel_x1/sel_y1..sel_x2/sel_y2 [unverified — mount empty,
SURVEY.md §0]). The spec: a region render is BITWISE the full render's crop
on every single-chip path (the grid values are identical — arange+offset vs
the sliced full arange — and inputs stay full-canvas)."""

import numpy as np
import pytest

import mathmap_tpu as mm
from mathmap_tpu.runtime.options import RenderOptions

REG = (33, 7, 130, 41)  # deliberately unaligned origin and size

WARP = ("filter warp (image in) "
        "in(xy + xy:[0.1*sin(y*3), 0.1*cos(x*3)]) end")
POINTWISE = "filter g () rgbaColor(x/W+0.5, y/H+0.5, t, 1) end"


@pytest.fixture(scope="module")
def img():
    rng = np.random.default_rng(7)
    a = rng.random((64, 256, 4)).astype(np.float32)
    a[..., 3] = 1.0
    return a


def crop(full):
    x, y, w, h = REG
    return full[y:y + h, x:x + w]


def test_region_pointwise_bitwise():
    f = mm.compile_source(POINTWISE)
    full = f.render(width=256, height=64, t=0.25)
    reg = f.render(width=256, height=64, t=0.25,
                   options=RenderOptions(region=REG))
    assert reg.shape == (41, 130, 4)
    assert np.array_equal(crop(full), reg)


def test_region_oracle_bitwise(img):
    f = mm.compile_source(WARP)
    full = f.render(img, interpret=True)
    reg = f.render(img, interpret=True, options=RenderOptions(region=REG))
    assert reg.shape == (41, 130, 4)
    assert np.array_equal(crop(full), reg)


@pytest.mark.parametrize("interp", ["bilinear", "bicubic"])
def test_region_pallas_sampler_bitwise(img, interp):
    # the region is a grid_shape tile at a global origin — the same
    # fields the shard_map tiles use
    f = mm.compile_source(WARP)
    opts = dict(interpolation=interp)
    full = f.render(img, options=RenderOptions(**opts))
    reg = f.render(img, options=RenderOptions(region=REG, **opts))
    assert np.array_equal(crop(full), reg)


def test_region_rand_keeps_global_pixel_identity():
    f = mm.compile_source("filter n () grayColor(rand(0,1)) end")
    full = f.render(width=256, height=64)
    reg = f.render(width=256, height=64, options=RenderOptions(region=REG))
    assert np.array_equal(crop(full), reg)


def test_region_while_loop_bitwise():
    src = """filter mand ()
      cx = x/W*3 - 0.5; cy = y/H*3;
      zx = 0.0; zy = 0.0; i = 0;
      while zx*zx + zy*zy < 4 && i < 30 do
        nx = zx*zx - zy*zy + cx; zy = 2*zx*zy + cy; zx = nx;
        i = i + 1
      end;
      grayColor(i / 30)
    end"""
    f = mm.compile_source(src)
    full = f.render(width=256, height=64)
    reg = f.render(width=256, height=64, options=RenderOptions(region=REG))
    assert np.array_equal(crop(full), reg)


def test_region_supersample_corners_bitwise():
    f = mm.compile_source(POINTWISE)
    o = dict(supersample=2, supersample_scheme="corners")
    full = f.render(width=256, height=64, options=RenderOptions(**o))
    reg = f.render(width=256, height=64,
                   options=RenderOptions(region=REG, **o))
    assert np.array_equal(crop(full), reg)


def test_region_animation_sweep(img):
    f = mm.compile_source(WARP)
    o = RenderOptions(region=REG)
    frames = f.render_animation(img, num_frames=3, options=o)
    assert frames.shape == (3, 41, 130, 4)
    assert np.array_equal(frames[0], f.render(img, t=0.0, options=o))


def test_region_u8_output(img):
    f = mm.compile_source(WARP)
    full = f.render(img, options=RenderOptions(output_dtype="uint8"))
    reg = f.render(img, options=RenderOptions(output_dtype="uint8",
                                              region=REG))
    assert reg.dtype == np.uint8
    assert np.array_equal(crop(full), reg)


def test_region_validation():
    with pytest.raises(ValueError):
        RenderOptions(region=(0, 0, 0, 4))
    with pytest.raises(ValueError):
        RenderOptions(region=(-1, 0, 4, 4))
    with pytest.raises(ValueError):
        RenderOptions(region=(1, 2, 3))
    f = mm.compile_source(POINTWISE)
    with pytest.raises(ValueError, match="exceeds"):
        f.render(width=32, height=32,
                 options=RenderOptions(region=(30, 0, 10, 4)))


def test_region_rejected_by_sharded_accepted_by_tiled(img):
    """render_sharded still rejects region (an output-sharded region IS
    a tile) with guidance pointing at the two supported routes;
    render_tiled ACCEPTS it since r5 (the sharded-drawable in-place
    semantics — full coverage in tests/test_halo.py)."""
    f = mm.compile_source(WARP)
    with pytest.raises(ValueError, match="render_tiled"):
        f.render_sharded(img, options=RenderOptions(region=REG))
    out = np.asarray(f.render_tiled(img, options=RenderOptions(region=REG),
                                    halo=8))
    assert out.shape == img.shape  # FULL canvas, selection in place
    x, y, w, h = REG
    mask = np.zeros(img.shape[:2] + (1,), bool)
    mask[y:y + h, x:x + w] = True
    np.testing.assert_array_equal(np.where(mask, img, out), img)


def test_region_artifact_roundtrip(img, tmp_path):
    """AOT .mmxa artifacts compose with region: the exported program bakes
    the region grid and renders the crop bit-identically to the live
    renderer (generators/artifact.py — the cgen/dlopen shipping analog)."""
    from mathmap_tpu.generators.artifact import export_artifact, load_artifact

    f = mm.compile_source(WARP)
    o = RenderOptions(region=REG)
    p = str(tmp_path / "r.mmxa")
    export_artifact(f, p, 256, 64, options=o)
    art = load_artifact(p)
    out = np.asarray(art.render(img))
    assert out.shape == (41, 130, 4)
    assert np.array_equal(out, f.render(img, options=o))
