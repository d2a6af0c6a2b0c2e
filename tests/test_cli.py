"""CLI front-end tests (mathmap_cmdline.c analog) — subprocess, CPU backend."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

import mathmap_tpu as mm

ENV = {
    "PYTHONPATH": ".",
    "PATH": os.environ.get("PATH", "/usr/bin:/bin"),
    "HOME": os.environ.get("HOME", "/root"),
    "JAX_PLATFORMS": "cpu",
}


def run_cli(*args, timeout=300):
    return subprocess.run(
        [sys.executable, "-m", "mathmap_tpu", *args],
        capture_output=True, text=True, env=ENV, timeout=timeout,
    )


@pytest.fixture(scope="module")
def input_png(tmp_path_factory):
    path = tmp_path_factory.mktemp("cli") / "in.png"
    img = np.random.RandomState(0).rand(20, 24, 4).astype(np.float32)
    img[..., 3] = 1.0
    mm.write_image(str(path), img)
    return str(path)


def test_render_expression(input_png, tmp_path):
    out = tmp_path / "out.png"
    proc = run_cli("grayColor(gray(origVal(xy)))", input_png, str(out), "--interpret")
    assert proc.returncode == 0, proc.stderr[-1000:]
    img = mm.read_image(str(out))
    assert img.shape == (20, 24, 4)
    assert np.allclose(img[..., 0], img[..., 1])  # gray


def test_render_library_filter_with_param(input_png, tmp_path):
    out = tmp_path / "o.png"
    proc = run_cli("invert", input_png, str(out), "--interpret")
    assert proc.returncode == 0, proc.stderr[-1000:]
    inverted = mm.read_image(str(out))
    orig = mm.read_image(input_png)
    np.testing.assert_allclose(inverted[..., :3], 1 - orig[..., :3], atol=2 / 255)


def test_animation_frames_and_resume(input_png, tmp_path):
    out = tmp_path / "anim.png"
    proc = run_cli("filters/Distorts/wave.mm", input_png, str(out),
                   "--frames", "2", "--interpret" if False else "--frames", "2")
    # note: jit path on CPU; small image so compile is quick
    assert proc.returncode == 0, proc.stderr[-1000:]
    assert (tmp_path / "anim_0000.png").exists()
    assert (tmp_path / "anim_0001.png").exists()
    proc2 = run_cli("filters/Distorts/wave.mm", input_png, str(out),
                    "--frames", "2", "--resume", "-v")
    assert proc2.returncode == 0
    assert "0 frame(s)" in proc2.stderr


def test_list_flag():
    proc = run_cli("--list")
    assert proc.returncode == 0
    assert "Distorts/" in proc.stdout and "fisheye" in proc.stdout


def test_syntax_error_exit_code(input_png, tmp_path):
    proc = run_cli("grayColor(1 +", input_png, str(tmp_path / "x.png"))
    assert proc.returncode == 1
    assert "MMSyntaxError" in proc.stderr
    assert not (tmp_path / "x.png").exists()


def test_missing_output():
    proc = run_cli("grayColor(x)")
    assert proc.returncode != 0


def test_edge_and_interp_flags(input_png, tmp_path):
    out = tmp_path / "e.png"
    proc = run_cli("origVal(xy + xy:[30, 0])", input_png, str(out),
                   "--interpret", "--edge-x", "wrap", "--interpolation", "nearest")
    assert proc.returncode == 0, proc.stderr[-500:]
    wrapped = mm.read_image(str(out))
    orig = mm.read_image(input_png)
    expected = np.roll(orig, -30 % 24, axis=1)
    np.testing.assert_allclose(wrapped, np.roll(orig, -(30 % 24), axis=1), atol=2 / 255)


def test_two_input_blend_cli(input_png, tmp_path):
    second = tmp_path / "b.png"
    out = tmp_path / "blend.png"
    mm.write_image(str(second), np.ones((20, 24, 4), np.float32))
    proc = run_cli("blend", input_png, str(second), str(out),
                   "--param", "factor=0.5", "--interpret")
    assert proc.returncode == 0, proc.stderr[-800:]
    blended = mm.read_image(str(out))
    orig = mm.read_image(input_png)
    np.testing.assert_allclose(blended[..., :3], (orig[..., :3] + 1) / 2, atol=2 / 255)


def test_input_dir_batch_mode(tmp_path):
    """--input-dir: every image in a folder renders through render_batch
    (same-geometry groups, N per fenced dispatch), outputs named after the
    inputs as PNG; --resume skips existing outputs."""
    ind = tmp_path / "ins"
    outd = tmp_path / "outs"
    ind.mkdir()
    rng = np.random.RandomState(3)
    for i in range(3):
        mm.write_image(str(ind / f"img{i}.png"),
                       rng.rand(12, 16, 4).astype(np.float32))
    mm.write_image(str(ind / "wide.png"),
                   rng.rand(12, 32, 4).astype(np.float32))  # 2nd geometry
    proc = run_cli("filters/Colors/invert.mm", str(outd),
                   "--input-dir", str(ind), "--batch-size", "2", "-v")
    assert proc.returncode == 0, proc.stderr[-800:]
    outs = sorted(os.listdir(outd))
    assert outs == ["img0.png", "img1.png", "img2.png", "wide.png"]
    # values actually inverted
    from PIL import Image

    orig = np.asarray(Image.open(ind / "img1.png").convert("RGBA"))
    got = np.asarray(Image.open(outd / "img1.png").convert("RGBA"))
    assert np.abs(got[..., :3].astype(int) + orig[..., :3] - 255).max() <= 1
    # resume: second run writes nothing new (mtimes unchanged)
    m0 = {n: os.path.getmtime(outd / n) for n in outs}
    proc = run_cli("filters/Colors/invert.mm", str(outd),
                   "--input-dir", str(ind), "--resume")
    assert proc.returncode == 0, proc.stderr[-500:]
    assert {n: os.path.getmtime(outd / n) for n in outs} == m0


def test_input_dir_batch_renders_at_frame_zero(tmp_path):
    """Images in an --input-dir chunk must render at frame=0 like lone
    renders — NOT at their chunk position (regression: render_batch's
    default frames=arange is for t-sweeps; a frame-reading filter's
    output would have varied with --batch-size and chunk order)."""
    ind = tmp_path / "ins"
    outd = tmp_path / "outs"
    ind.mkdir()
    src = tmp_path / "framefilt.mm"
    src.write_text("filter framefilt (image in) "
                   "in(xy) * 0 + grayColor(0.25 + frame * 0.2) end\n")
    for i in range(3):
        mm.write_image(str(ind / f"img{i}.png"),
                       np.full((8, 8, 4), 0.5, np.float32))
    proc = run_cli(str(src), str(outd),
                   "--input-dir", str(ind), "--batch-size", "3")
    assert proc.returncode == 0, proc.stderr[-800:]
    from PIL import Image

    vals = [np.asarray(Image.open(outd / f"img{i}.png").convert("RGBA"))
            [..., 0] for i in range(3)]
    for i, v in enumerate(vals):
        assert np.abs(v.astype(int) - round(0.25 * 255)).max() <= 1, \
            f"img{i} rendered at frame != 0"


def test_unknown_param_rejected(tmp_path):
    proc = run_cli("twirl", input_png_path(tmp_path),
                   str(tmp_path / "o.png"), "--param", "raduis=5")
    assert proc.returncode != 0
    assert "unknown param" in (proc.stderr + proc.stdout)


def input_png_path(tmp_path):
    p = tmp_path / "in_up.png"
    mm.write_image(str(p), np.zeros((8, 8, 4), np.float32))
    return str(p)


def test_tiled_flag_matches_plain(input_png, tmp_path):
    """--tiled (input-sharded halo path) must reproduce the plain render
    bitwise at the uint8 output, params included."""
    a = tmp_path / "tiled.png"
    b = tmp_path / "plain.png"
    p1 = run_cli("filters/Distorts/ripple.mm", input_png, str(a),
                 "--tiled", "--halo", "auto", "--param", "amplitude=2")
    p2 = run_cli("filters/Distorts/ripple.mm", input_png, str(b),
                 "--param", "amplitude=2")
    assert p1.returncode == 0, p1.stderr
    assert p2.returncode == 0, p2.stderr
    np.testing.assert_array_equal(mm.read_image(str(a)),
                                  mm.read_image(str(b)))


def test_tiled_animation_frames(input_png, tmp_path):
    out = tmp_path / "anim.png"
    proc = run_cli("filters/Distorts/ripple.mm", input_png, str(out),
                   "--tiled", "--frames", "2")
    assert proc.returncode == 0, proc.stderr
    assert (tmp_path / "anim_0000.png").exists()
    assert (tmp_path / "anim_0001.png").exists()


def test_tiled_region_renders_selection_in_place(input_png, tmp_path):
    """--tiled --region: FULL-canvas output — the selection is the plain
    region render's crop, unselected pixels are the input bytes."""
    a = tmp_path / "treg.png"
    b = tmp_path / "plain.png"
    p1 = run_cli("filters/Distorts/ripple.mm", input_png, str(a),
                 "--tiled", "--halo", "auto", "--region", "3,4,10x8")
    p2 = run_cli("filters/Distorts/ripple.mm", input_png, str(b))
    assert p1.returncode == 0, p1.stderr
    assert p2.returncode == 0, p2.stderr
    got = mm.read_image(str(a))
    plain = mm.read_image(str(b))
    src = mm.read_image(input_png)
    assert got.shape == src.shape  # full canvas, not the crop
    np.testing.assert_array_equal(got[4:12, 3:13], plain[4:12, 3:13])
    mask = np.zeros(src.shape[:2] + (1,), bool)
    mask[4:12, 3:13] = True
    np.testing.assert_array_equal(np.where(mask, src, got), src)


def test_tiled_sharded_conflict(input_png, tmp_path):
    proc = run_cli("filters/Distorts/ripple.mm", input_png,
                   str(tmp_path / "x.png"), "--tiled", "--sharded")
    assert proc.returncode != 0
    assert "mutually exclusive" in proc.stderr


def test_tiled_bad_halo(input_png, tmp_path):
    proc = run_cli("filters/Distorts/ripple.mm", input_png,
                   str(tmp_path / "x.png"), "--tiled", "--halo", "zz")
    assert proc.returncode != 0
    assert "--halo expects" in proc.stderr


def test_cli_tiled_animated_gif_sweep(tmp_path):
    """--tiled with a multi-frame GIF input: sweep frame i samples input
    frame i (animation in -> animation out through the tiled path)."""
    import numpy as np
    from PIL import Image

    frames = [Image.fromarray(
        np.full((16, 16, 4), 40 + 170 * i, np.uint8), "RGBA").convert("P")
        for i in range(2)]
    gif = tmp_path / "in.gif"
    frames[0].save(gif, save_all=True, append_images=frames[1:],
                   duration=100, loop=0)
    out = tmp_path / "out.gif"
    from mathmap_tpu.cli import main as cli_main

    rc = cli_main(["origVal(xy)", str(gif), str(out), "--tiled",
                   "--frames", "2", "--interpolation", "nearest"])
    assert rc == 0
    img = Image.open(out)
    vals = []
    for i in range(2):
        img.seek(i)
        vals.append(int(np.asarray(img.convert("RGBA"))[0, 0, 0]))
    assert abs(vals[0] - 40) <= 30 and abs(vals[1] - 210) <= 30, vals


def test_cli_tiled_png_sequence_routes_tiled(tmp_path, monkeypatch):
    """--tiled --frames N with a PNG-sequence output must render through
    render_tiled (it previously fell through to the replicated
    render_frames path with no warning — review finding)."""
    import numpy as np
    from PIL import Image

    from mathmap_tpu.api import Filter
    from mathmap_tpu.cli import main as cli_main

    img = tmp_path / "in.png"
    Image.fromarray(np.full((16, 16, 4), 90, np.uint8), "RGBA").save(img)
    calls = {"tiled": 0}
    orig = Filter.render_tiled

    def counting(self, *a, **kw):
        calls["tiled"] += 1
        return orig(self, *a, **kw)

    monkeypatch.setattr(Filter, "render_tiled", counting)
    out = tmp_path / "out.png"
    rc = cli_main(["origVal(xy)", str(img), str(out), "--tiled",
                   "--frames", "2"])
    assert rc == 0
    assert calls["tiled"] == 2
    for i in range(2):
        assert (tmp_path / f"out_{i:04d}.png").exists()


def test_cli_selftest_runs_clean():
    """--selftest: the deployment acceptance sweep passes on this backend
    and exits 0."""
    from mathmap_tpu.cli import main as cli_main

    assert cli_main(["--selftest", "--size", "64x64"]) == 0


def test_export_and_render_artifact(input_png, tmp_path):
    """--export-artifact writes a .mmxa; rendering from it (no compiler
    path) matches the live CLI render bitwise at uint8."""
    art = tmp_path / "tw.mmxa"
    proc = run_cli("filters/Distorts/twirl.mm", "--export-artifact",
                   str(art), "--size", "24x20", "--param", "angle=3")
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert art.exists()
    out_a = tmp_path / "a.png"
    out_l = tmp_path / "l.png"
    proc = run_cli(str(art), input_png, str(out_a), "--param", "angle=5")
    assert proc.returncode == 0, proc.stderr[-2000:]
    proc = run_cli("filters/Distorts/twirl.mm", input_png, str(out_l),
                   "--size", "24x20", "--param", "angle=5")
    assert proc.returncode == 0, proc.stderr[-2000:]
    np.testing.assert_array_equal(mm.read_image(str(out_a)),
                                  mm.read_image(str(out_l)))


def test_artifact_animation_cli(tmp_path):
    art = tmp_path / "g.mmxa"
    proc = run_cli("filter g () grayColor(t) end", "--export-artifact",
                   str(art), "--size", "16x12", "--frames", "3")
    assert proc.returncode == 0, proc.stderr[-2000:]
    gif = tmp_path / "g.gif"
    proc = run_cli(str(art), str(gif), "--frames", "3")
    assert proc.returncode == 0, proc.stderr[-2000:]
    from PIL import Image

    assert Image.open(str(gif)).n_frames == 3
    # a frame-count mismatch is a clear error, not a wrong render
    proc = run_cli(str(art), str(tmp_path / "x.gif"), "--frames", "5")
    assert proc.returncode != 0
    assert "re-export" in proc.stderr


def test_artifact_cli_error_paths(tmp_path):
    """Missing .mmxa and export-from-artifact produce clean one-line
    errors, not tracebacks (review r3)."""
    proc = run_cli(str(tmp_path / "typo.mmxa"), "out.png")
    assert proc.returncode == 1
    assert "Traceback" not in proc.stderr
    proc = run_cli(str(tmp_path / "typo.mmxa"), "--export-artifact",
                   str(tmp_path / "new.mmxa"))
    assert proc.returncode != 0
    assert "Traceback" not in proc.stderr
    assert "cannot --export-artifact" in proc.stderr


def test_param_sweep_gif(input_png, tmp_path):
    """--param-sweep NAME=LO:HI renders --frames steps of a slider
    animation over ONE shared input in one device program."""
    gif = tmp_path / "sweep.gif"
    proc = run_cli("filters/Distorts/twirl.mm", input_png, str(gif),
                   "--param-sweep", "angle=1:5", "--frames", "4")
    assert proc.returncode == 0, proc.stderr[-1000:]
    from mathmap_tpu.imgio.images import read_animation

    frames = read_animation(str(gif), as_uint8=True)
    assert frames.shape[0] == 4


def test_param_sweep_sequence_matches_per_frame(input_png, tmp_path):
    """PNG-sequence form: step i equals a lone render at the swept value
    (t fixed at --t, frame internal = step index), byte-for-byte."""
    seq = tmp_path / "s.png"
    proc = run_cli("filters/Distorts/twirl.mm", input_png, str(seq),
                   "--param-sweep", "angle=1:5", "--frames", "3")
    assert proc.returncode == 0, proc.stderr[-1000:]
    f = mm.compile_file("filters/Distorts/twirl.mm")
    img = mm.read_image(input_png)
    from mathmap_tpu.imgio.images import to_uint8

    for i, v in enumerate((1.0, 3.0, 5.0)):
        got = (mm.read_image(str(tmp_path / f"s_{i:04d}.png")) * 255.0
               + 0.5).astype(np.uint8)
        want = to_uint8(np.asarray(f.render(img, t=0.0, frame=float(i),
                                            params={"angle": v})))
        np.testing.assert_array_equal(got, want)


def test_param_sweep_with_region(input_png, tmp_path):
    """--param-sweep composes with --region: each step is the lone
    region render at the swept value (selection crop output)."""
    seq = tmp_path / "sr.png"
    proc = run_cli("filters/Distorts/twirl.mm", input_png, str(seq),
                   "--param-sweep", "angle=1:5", "--frames", "3",
                   "--region", "3,4,10x8")
    assert proc.returncode == 0, proc.stderr[-1000:]
    f = mm.compile_file("filters/Distorts/twirl.mm")
    img = mm.read_image(input_png)
    from mathmap_tpu.imgio.images import to_uint8

    opts = mm.RenderOptions(region=(3, 4, 10, 8))
    for i, v in enumerate((1.0, 3.0, 5.0)):
        got = (mm.read_image(str(tmp_path / f"sr_{i:04d}.png")) * 255.0
               + 0.5).astype(np.uint8)
        assert got.shape[:2] == (8, 10)
        want = to_uint8(np.asarray(f.render(
            img, t=0.0, frame=float(i), params={"angle": v},
            options=opts)))
        np.testing.assert_array_equal(got, want)


def test_param_sweep_errors(input_png, tmp_path):
    out = tmp_path / "o.png"
    # unknown param
    proc = run_cli("filters/Distorts/twirl.mm", input_png, str(out),
                   "--param-sweep", "nosuch=0:1", "--frames", "3")
    assert proc.returncode != 0 and "no param" in proc.stderr
    # malformed spec
    proc = run_cli("filters/Distorts/twirl.mm", input_png, str(out),
                   "--param-sweep", "angle=3", "--frames", "3")
    assert proc.returncode != 0 and "NAME=LO:HI" in proc.stderr
    # needs steps
    proc = run_cli("filters/Distorts/twirl.mm", input_png, str(out),
                   "--param-sweep", "angle=1:5")
    assert proc.returncode != 0 and "--frames" in proc.stderr
    # no mixing with per-frame flag paths
    proc = run_cli("filters/Distorts/twirl.mm", input_png, str(out),
                   "--param-sweep", "angle=1:5", "--frames", "3",
                   "--interpret")
    assert proc.returncode != 0 and "does not combine" in proc.stderr


def test_param_sweep_batch_conflict(input_png, tmp_path):
    out = tmp_path / "o.png"
    proc = run_cli("filters/Distorts/twirl.mm", input_png, str(out),
                   "--param-sweep", "angle=1:5", "--frames", "3", "--batch")
    assert proc.returncode != 0 and "does not combine" in proc.stderr


def test_param_sweep_int_rounding_half_up():
    """int sweeps round half-UP: banker's rounding clusters a linear
    slider at .5 midpoints (0,2,2,4,4)."""
    from mathmap_tpu.cli import _parse_param_sweep

    f = mm.compile_source(
        "filter g (int k: 0-5 (0)) grayColor(k/5) end")
    _, vals = _parse_param_sweep("k=0:5", f, 11)
    assert vals == [0, 1, 1, 2, 2, 3, 3, 4, 4, 5, 5]


def test_region_render(tmp_path):
    """--region X,Y,WxH renders the selection crop of the full canvas."""
    out_r = tmp_path / "reg.png"
    out_f = tmp_path / "full.png"
    expr = "filter g () rgbaColor(x/W+0.5, y/H+0.5, 0.3, 1) end"
    p1 = run_cli(expr, str(out_r), "--size", "128x96",
                 "--region", "17,9,50x40")
    p2 = run_cli(expr, str(out_f), "--size", "128x96")
    assert p1.returncode == 0 and p2.returncode == 0, p1.stderr + p2.stderr
    reg = mm.read_image(str(out_r))
    full = mm.read_image(str(out_f))
    assert reg.shape == (40, 50, 4)
    assert np.array_equal(reg, full[9:49, 17:67])


def test_region_errors(tmp_path):
    out = tmp_path / "o.png"
    expr = "filter g () rgbaColor(x,y,0,1) end"
    p = run_cli(expr, str(out), "--size", "32x32", "--region", "30,0,10x4")
    assert p.returncode == 1 and "exceeds the 32x32 canvas" in p.stderr
    p = run_cli(expr, str(out), "--size", "32x32", "--region", "bogus")
    assert p.returncode != 0 and "X,Y,WxH" in p.stderr
    p = run_cli(expr, str(out), "--size", "32x32", "--region", "0,0,8x8",
                "--sharded")
    assert p.returncode != 0 and "--tiled" in p.stderr
    # negative X/Y and zero W/H are one-line CLI errors, not RenderOptions
    # tracebacks (ADVICE r4: int('-1') parses, so the parse block must
    # range-check before opts construction)
    # NB --region=-1,... (the = form): a bare '-1,...' never reaches the
    # parse block — argparse rejects it as an unknown flag
    for bad in ("-1,0,8x8", "0,-3,8x8", "0,0,0x8", "0,0,8x0"):
        p = run_cli(expr, str(out), "--size", "32x32", f"--region={bad}")
        assert p.returncode != 0 and "X,Y,WxH" in p.stderr, bad
        assert "Traceback" not in p.stderr, bad


def test_size_and_edge_color_errors_are_one_line(tmp_path):
    """Malformed --size / --edge-color print one-line errors, not raw
    tracebacks (review r5 — same treatment the r4 advisor asked for
    --region); '--size N' is the NxN square shorthand."""
    out = tmp_path / "o.png"
    expr = "filter g () rgbaColor(x,y,0,1) end"
    p = run_cli(expr, str(out), "--size", "24", "--interpret")
    assert p.returncode == 0, p.stderr[-500:]
    assert mm.read_image(str(out)).shape == (24, 24, 4)
    for argv in (("--size", "abc"), ("--size", "8x"), ("--size", "0x8"),
                 ("--edge-color", "1,z"), ("--edge-color", "1,2")):
        p = run_cli(expr, str(out), *argv)
        assert p.returncode != 0, argv
        assert "Traceback" not in p.stderr, (argv, p.stderr[-500:])


def test_tiled_region_interpret_keeps_inplace_contract(input_png, tmp_path):
    """--tiled --region through --interpret must keep the full-canvas
    in-place output (review r5: it silently degraded to the WxH crop)."""
    a = tmp_path / "ti.png"
    p = run_cli("filters/Distorts/ripple.mm", input_png, str(a),
                "--tiled", "--halo", "auto", "--region", "3,4,10x8",
                "--interpret")
    assert p.returncode == 0, p.stderr
    got = mm.read_image(str(a))
    src = mm.read_image(input_png)
    assert got.shape == src.shape  # full canvas, not the crop
    mask = np.zeros(src.shape[:2] + (1,), bool)
    mask[4:12, 3:13] = True
    np.testing.assert_array_equal(np.where(mask, src, got), src)
    # selection content == the oracle region render's crop (quantized)
    b = tmp_path / "crop.png"
    p2 = run_cli("filters/Distorts/ripple.mm", input_png, str(b),
                 "--region", "3,4,10x8", "--interpret")
    assert p2.returncode == 0, p2.stderr
    crop = mm.read_image(str(b))
    np.testing.assert_array_equal(got[4:12, 3:13], crop)


def test_chain_with_region(input_png, tmp_path):
    """--chain compiles to ONE composed filter, so --region composes:
    the crop is bitwise the full chain render's crop."""
    a, b = tmp_path / "cr.png", tmp_path / "cf.png"
    p1 = run_cli("--chain", "ripple|invert", input_png, str(a),
                 "--region", "3,4,10x8")
    p2 = run_cli("--chain", "ripple|invert", input_png, str(b))
    assert p1.returncode == 0, p1.stderr
    assert p2.returncode == 0, p2.stderr
    got, full = mm.read_image(str(a)), mm.read_image(str(b))
    assert got.shape == (8, 10, 4)
    np.testing.assert_array_equal(got, full[4:12, 3:13])
