"""Multi-device sharding tests on the virtual 8-device CPU mesh
(SURVEY.md §4 item 4): sharded output must equal unsharded bitwise."""

import os

import numpy as np
import pytest

import mathmap_tpu as mm
from mathmap_tpu.parallel.mesh import make_mesh
from mathmap_tpu.parallel.shard import ShardedRenderer

H, W = 16, 32


def _image(seed=5):
    img = np.random.RandomState(seed).rand(H, W, 4).astype(np.float32)
    img[..., 3] = 1.0
    return img


def _unsharded(f, inputs, **kw):
    return f.render(*inputs, width=W, height=H, **kw)


@pytest.mark.parametrize(
    "src,n_inputs",
    [
        ("grayColor(0.5 + 0.5 * sin(r - a + t * 2 * pi))", 0),
        ("origVal(toXY(ra:[r * 0.7, a + 0.4]))", 1),
        ("grayColor(rand(0, 1))", 0),
        (
            "z = ri:[x/X, y/Y]; c = ri:[-0.4, 0.6]; i = 0;"
            "while z[0]*z[0] + z[1]*z[1] < 4 && i < 20 do z = z*z + c; i = i + 1 end;"
            "grayColor(i / 20)",
            0,
        ),
    ],
)
@pytest.mark.parametrize("mesh_shape", [(1, 8, 1), (1, 4, 2), (1, 2, 4)])
def test_grid_sharded_matches_unsharded(src, n_inputs, mesh_shape):
    f = mm.compile(src)
    inputs = [_image(seed=i) for i in range(n_inputs)] or [_image()]
    expected = _unsharded(f, inputs, t=0.25)
    mesh = make_mesh(*mesh_shape)
    r = ShardedRenderer(mesh, f.filters, f.fdef, W, H, mm.RenderOptions(), 1)
    got = np.asarray(r(inputs, t=0.25))
    np.testing.assert_array_equal(got, expected)


def test_frame_sharded_matches_unsharded():
    f = mm.compile("grayColor(0.5 + 0.5 * sin(x / 4 + t * 2 * pi))")
    inputs = [_image()]
    num_frames = 8
    ts = np.arange(num_frames, dtype=np.float32) / num_frames
    expected = np.stack(
        [_unsharded(f, inputs, t=float(t)) for t in ts], axis=0
    )
    mesh = make_mesh(4, 2, 1)
    r = ShardedRenderer(mesh, f.filters, f.fdef, W, H, mm.RenderOptions(), num_frames)
    got = np.asarray(r(inputs, ts=ts))
    assert got.shape == (num_frames, H, W, 4)
    np.testing.assert_allclose(got, expected, atol=1e-5)


def test_full_3d_mesh():
    f = mm.compile_file("filters/Distorts/ripple.mm")
    inputs = [_image()]
    mesh = make_mesh(2, 2, 2)
    num_frames = 4
    # offset t so no sample coordinate lands exactly on a texel boundary
    # (floor() is unstable there across differently-fused XLA programs —
    # see runtime/sampling.py docstring)
    ts = (np.arange(num_frames, dtype=np.float32) + 0.37) / num_frames
    r = ShardedRenderer(mesh, f.filters, f.fdef, W, H, mm.RenderOptions(), num_frames)
    got = np.asarray(r(inputs, ts=ts))
    expected = np.stack([_unsharded(f, inputs, t=float(t)) for t in ts], axis=0)
    np.testing.assert_allclose(got, expected, atol=1e-5)


def test_mesh_validation():
    with pytest.raises(ValueError):
        make_mesh(3, 3, 1)  # 9 != 8 devices


def test_filter_render_sharded_api():
    f = mm.compile("grayColor(0.5 + 0.4 * sin(x / 3 + t * 2 * pi))")
    img = _image()
    mesh = make_mesh(1, 8, 1)
    got = f.render_sharded(img, mesh=mesh, width=W, height=H)
    want = f.render(img, width=W, height=H)
    np.testing.assert_array_equal(got, want)
    frames = f.render_sharded(img, mesh=make_mesh(4, 2, 1), num_frames=8,
                              width=W, height=H)
    assert frames.shape == (8, H, W, 4)


def test_render_sharded_with_params():
    f = mm.compile_file("filters/Distorts/twirl.mm")
    img = _image()
    mesh = make_mesh(1, 8, 1)
    got = f.render_sharded(img, mesh=mesh, width=W, height=H, params={"angle": 6.0})
    want = f.render(img, width=W, height=H, params={"angle": 6.0})
    np.testing.assert_array_equal(got, want)
    # different params actually change the output
    other = f.render_sharded(img, mesh=mesh, width=W, height=H, params={"angle": 1.0})
    assert np.abs(got - other).max() > 0.01


def _anim_stack(t_frames=3, seed=7):
    stack = np.random.RandomState(seed).rand(t_frames, H, W, 4).astype(np.float32)
    stack[..., 3] = 1.0
    return stack


@pytest.mark.parametrize("mesh_shape", [(1, 8, 1), (1, 2, 4)])
def test_grid_sharded_animated_input(mesh_shape):
    """Animated (T,H,W,4) inputs replicate per device; frame-indexed
    origValXY sampling inside a shard_map tile is bitwise-identical to the
    unsharded render (current-frame default + explicit index mixed)."""
    f = mm.compile("0.5 * origVal(xy * 0.9) + 0.5 * origValXY(x, y, 1)")
    stack = _anim_stack()
    want = f.render(stack, width=W, height=H)
    got = f.render_sharded(stack, mesh=make_mesh(*mesh_shape), width=W, height=H)
    np.testing.assert_array_equal(got, want)


def test_frame_sharded_animated_input():
    """Animation in -> animation out across the 'f' mesh axis: each output
    frame samples its OWN input frame (current-frame semantics) on whichever
    device renders it."""
    f = mm.compile("origVal(xy)")
    stack = _anim_stack(t_frames=8, seed=9)
    num_frames = 8
    opts = mm.RenderOptions(interpolation="nearest")
    want = f.render_animation(stack, num_frames=num_frames, width=W, height=H,
                              options=opts)
    got = f.render_sharded(stack, mesh=make_mesh(4, 2, 1),
                           num_frames=num_frames, width=W, height=H,
                           options=opts)
    assert got.shape == (num_frames, H, W, 4)
    np.testing.assert_array_equal(got, want)
    # identity warp + nearest + current-frame: frame k IS input frame k
    np.testing.assert_allclose(got, stack, atol=1e-6)


def test_pallas_sampler_under_shard_map():
    """Bicubic gather sampling composes with mesh sharding: every tile
    samples the replicated input with global coordinates, bitwise equal
    to the unsharded render."""
    img = _image()
    f = mm.compile("origVal(toXY(ra:[r * 0.7, a + 0.4]))")
    opts = mm.RenderOptions(interpolation="bicubic")
    ref = f.render(img, width=W, height=H, options=opts)
    mesh = make_mesh(1, 8, 1)
    r = ShardedRenderer(mesh, f.filters, f.fdef, W, H, opts, 1)
    got = np.asarray(r([img]))
    np.testing.assert_array_equal(got, ref)


def test_base_layout_per_tile_sharded_matches_unsharded():
    """The flagship twirl on a kernel-scale frame runs INSIDE shard_map
    tiles on a row mesh, bitwise identical to the unsharded render."""
    h, w = 64, 512
    img = np.random.RandomState(9).rand(h, w, 4).astype(np.float32)
    f = mm.compile_file("filters/Distorts/twirl.mm")
    opts = mm.RenderOptions()
    want = f.render(img, width=w, height=h, t=0.8, options=opts)
    mesh = make_mesh(1, 8, 1)
    r = ShardedRenderer(mesh, f.filters, f.fdef, w, h, opts, 1)
    got = np.asarray(r([img], t=0.8))
    np.testing.assert_array_equal(got, want)


def test_base_layout_column_sharded_matches_gather():
    """Column-sharded mesh tiles (2x4): fisheye matches the unsharded
    render (XLA may vectorize a 128-wide tile's transcendentals
    differently from the 512-wide frame, so not bitwise)."""
    h, w = 32, 512
    img = np.random.RandomState(10).rand(h, w, 4).astype(np.float32)
    f = mm.compile_file("filters/Distorts/fisheye.mm")
    opts = mm.RenderOptions()
    mesh = make_mesh(1, 2, 4)
    r = ShardedRenderer(mesh, f.filters, f.fdef, w, h, opts, 1)
    got = np.asarray(r([img]))
    want = f.render(img, width=w, height=h, options=opts)
    np.testing.assert_allclose(got, want, atol=5e-5)


def test_base_layout_sharded_rand_bitwise():
    """rand() in a mesh tile decodes GLOBAL pixel ids from the tile's
    row/col offsets, so sharded == unsharded bitwise for a filter that
    also samples."""
    src = "origVal(xy) * grayColor(0.5 + rand(0, 0.5))"
    f = mm.compile(src)
    img = _image(11)
    opts = mm.RenderOptions()
    want = f.render(img, width=W, height=H, options=opts)
    mesh = make_mesh(1, 8, 1)
    r = ShardedRenderer(mesh, f.filters, f.fdef, W, H, opts, 1)
    got = np.asarray(r([img]))
    np.testing.assert_array_equal(got, want)


def test_base_layout_sharded_subset_patch():
    """A strong twirl (t=0.9) on a 4x2 mesh: tiles sample far outside
    their own region (inputs are replicated) and match the unsharded
    render."""
    h, w = 32, 256
    img = np.random.RandomState(12).rand(h, w, 4).astype(np.float32)
    f = mm.compile_file("filters/Distorts/twirl.mm")
    opts = mm.RenderOptions()
    mesh = make_mesh(1, 4, 2)
    r = ShardedRenderer(mesh, f.filters, f.fdef, w, h, opts, 1)
    got = np.asarray(r([img], t=0.9))
    want = f.render(img, width=w, height=h, t=0.9, options=opts)
    np.testing.assert_allclose(got, want, atol=5e-5)


def test_dryrun_multichip_self_bootstraps():
    """Driver-faithful check (VERDICT r1 item 1): dryrun_multichip must
    bootstrap its own virtual 8-device CPU mesh in a fresh process with NO
    platform forcing from the caller."""
    import subprocess
    import sys

    env = {k: v for k, v in os.environ.items()
           if k not in ("JAX_PLATFORMS", "XLA_FLAGS")}
    proc = subprocess.run(
        [sys.executable, "-c",
         "import __graft_entry__ as g; g.dryrun_multichip(8); print('OK')"],
        cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        env=env, capture_output=True, text=True, timeout=600,
    )
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "OK" in proc.stdout


def test_distributed_single_process_smoke():
    """Exercise the jax.distributed wiring single-process (VERDICT r1 weak
    #8): initialize with an explicit 1-process coordinator, check
    is_multihost(), and split a sharded array into addressable shards.
    Runs in a subprocess so the distributed service doesn't leak into the
    test session."""
    import subprocess
    import sys

    code = """
import os
os.environ['XLA_FLAGS'] = '--xla_force_host_platform_device_count=8'
import jax; jax.config.update('jax_platforms', 'cpu')
from mathmap_tpu.parallel import distributed
distributed.initialize('localhost:12392', num_processes=1, process_id=0)
distributed.initialize('localhost:12392', num_processes=1, process_id=0)  # idempotent
assert distributed.is_multihost() is False
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P
from mathmap_tpu.parallel.mesh import make_mesh
mesh = make_mesh(1, 8, 1)
arr = jax.device_put(jnp.arange(64.0).reshape(8, 8), NamedSharding(mesh, P('y')))
shards = distributed.local_slice_of(arr)
assert len(shards) == 8 and shards[0].shape == (1, 8)
print('OK')
"""
    env = {k: v for k, v in os.environ.items()
           if k not in ("JAX_PLATFORMS", "XLA_FLAGS")}
    proc = subprocess.run(
        [sys.executable, "-c", code],
        cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        env=env, capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "OK" in proc.stdout


def test_render_sharded_static_unroll_loop():
    """A statically-unrolled loop (literal counter, noise in the body)
    inside shard_map tiles: row-sharded output must equal unsharded
    bitwise (const folding is host-side and mesh-independent)."""
    f = mm.compile(
        "s = 0; i = 0; while i < 5 do "
        "s = s + noise([x / 9 + i, y / 9, 0.3]); i = i + 1 end; "
        "grayColor(clamp(s / 5 + 0.5, 0, 1))")
    img = _image()
    got = f.render_sharded(img, mesh=make_mesh(1, 8, 1), width=W, height=H)
    want = f.render(img, width=W, height=H)
    np.testing.assert_array_equal(got, want)


def test_render_sharded_frame_param():
    """render_sharded forwards frame (review r3: it was hardcoded 0.0, so
    a sharded render of frame k of an animated input sampled frame 0)."""
    img0 = np.full((16, 16, 4), 0.25, np.float32)
    img1 = np.full((16, 16, 4), 0.75, np.float32)
    stack = np.stack([img0, img1])
    f = mm.compile("origVal(xy)")
    opts = mm.RenderOptions(interpolation="nearest")
    out = f.render_sharded(stack, frame=1.0, options=opts)
    np.testing.assert_allclose(np.asarray(out)[..., 0], 0.75, atol=1e-6)
    ref = f.render(stack, frame=1.0, options=opts)
    np.testing.assert_allclose(np.asarray(out), np.asarray(ref), atol=1e-6)


def test_while_engine_under_shard_map_grid_layout(while_kernel_interpret):
    """The per-pixel loop kernel runs INSIDE mesh tiles (traced tile
    offsets ride (1, 1) scalar inputs into the kernel): a generative
    fractal loop, forced onto the kernel on both sides, must be bitwise
    identical sharded vs unsharded."""
    src = ("z = ri:[x/X, y/Y]; c = ri:[-0.4, 0.6]; i = 0;"
           "while z[0]*z[0] + z[1]*z[1] < 4 && i < 20 do "
           "z = z*z + c; i = i + 1 end; grayColor(i / 20)")
    from mathmap_tpu.runtime import tracer as T

    f = mm.compile(src)
    opts = mm.RenderOptions(pallas_while="on")
    img = _image()
    want = np.asarray(f.render(img, width=W, height=H, t=0.25,
                               options=opts))
    for mesh_shape in ((1, 8, 1), (1, 2, 4)):
        mesh = make_mesh(*mesh_shape)
        T.TRACE_LOOP_PATHS.clear()
        r = ShardedRenderer(mesh, f.filters, f.fdef, W, H, opts, 1)
        got = np.asarray(r([img], t=0.25))
        assert ("wk" in {p for p, _ in T.TRACE_LOOP_PATHS}), \
            f"engine not taken sharded: {T.TRACE_LOOP_PATHS}"
        np.testing.assert_array_equal(got, want)
    # and the engine result agrees with the plain XLA loop semantics
    ref = np.asarray(f.render(img, width=W, height=H, t=0.25,
                              options=mm.RenderOptions(pallas_while="off")))
    np.testing.assert_allclose(want, ref, atol=1e-6)


def test_while_engine_sharded_base_layout_rand(while_kernel_interpret):
    """Loop kernel inside mesh tiles with rand() in the loop body of a
    sampling filter: the kernel must decode GLOBAL pixel ids from the
    traced tile origin (row/col offset scalar inputs), so sharded ==
    unsharded bitwise; a wrong origin would repeat the noise field per
    tile."""
    from mathmap_tpu.runtime import tracer as T

    src = ("v = 0; i = 0; while i < 3 do "
           "v = v + rand(0, 1); i = i + 1 end; "
           "origVal(xy) * grayColor(v / 3)")
    f = mm.compile(src)
    opts = mm.RenderOptions(pallas_while="on")
    img = _image(13)
    want = np.asarray(f.render(img, width=W, height=H, options=opts))
    mesh = make_mesh(1, 8, 1)
    T.TRACE_LOOP_PATHS.clear()
    r = ShardedRenderer(mesh, f.filters, f.fdef, W, H, opts, 1)
    got = np.asarray(r([img]))
    assert ("wk" in {p for p, _ in T.TRACE_LOOP_PATHS}), \
        f"engine not taken sharded: {T.TRACE_LOOP_PATHS}"
    np.testing.assert_array_equal(got, want)
