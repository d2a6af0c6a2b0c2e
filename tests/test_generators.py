"""Code-generator exports (generators/ row of SURVEY §2.1)."""

import subprocess
import pytest
import sys

import numpy as np

import mathmap_tpu as mm
from mathmap_tpu.generators.standalone import export_python, export_stablehlo


def test_export_python_runs(tmp_path):
    f = mm.compile_file("filters/Colors/invert.mm")
    script = tmp_path / "invert_standalone.py"
    export_python(f, str(script))
    img = np.random.RandomState(0).rand(8, 8, 4).astype(np.float32)
    inp = tmp_path / "in.png"
    outp = tmp_path / "out.png"
    mm.write_image(str(inp), img)
    env = {"PYTHONPATH": ".", "PATH": "/usr/bin:/bin", "HOME": "/root", "JAX_PLATFORMS": "cpu"}
    proc = subprocess.run(
        [sys.executable, str(script), str(inp), str(outp), "--size", "8x8"],
        capture_output=True, text=True, env=env, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr[-2000:]
    out = mm.read_image(str(outp))
    expect = mm.read_image(str(inp))
    np.testing.assert_allclose(out[..., :3], 1 - expect[..., :3], atol=2 / 255)


def test_export_stablehlo_contains_program():
    f = mm.compile_file("filters/Colors/grayscale.mm")
    text = export_stablehlo(f, 16, 16)
    assert "stablehlo" in text or "func.func" in text
    assert "16x16" in text.replace(" ", "") or "16, 16" in text or "tensor<16x16" in text


def test_from_pipeline_rejects_generative_mid_chain():
    """A generative stage mid-pipeline would silently drop everything
    upstream (review r3) — it must raise instead."""
    import pytest as _pytest

    from mathmap_tpu.designer.graph import from_pipeline
    from mathmap_tpu.expression_db import default_db
    from mathmap_tpu.utils.errors import MMRuntimeError

    db = default_db()
    with _pytest.raises(MMRuntimeError, match="generative"):
        from_pipeline("grayscale | moire | grayscale", db)
    g = from_pipeline("moire | grayscale", db)  # gen START is fine
    assert len(g.nodes) == 2


def test_composer_rejects_unknown_param_names():
    """A typo'd param name on a node was SILENTLY ignored by codegen (only
    declared params are consulted), so the filter rendered with the default
    value — review r5: it must raise, naming the declared params."""
    import pytest as _pytest

    from mathmap_tpu.designer.graph import from_pipeline
    from mathmap_tpu.expression_db import default_db
    from mathmap_tpu.utils.errors import MMNameError

    db = default_db()
    g = from_pipeline("twirl anlge=4.5", db)  # typo: anlge
    with _pytest.raises(MMNameError, match="no parameter 'anlge'"):
        g.to_source()
    # the correctly-spelled param still compiles
    assert "twirl" in from_pipeline("twirl angle=4.5", db).to_source()


def test_load_mmc_counter_and_output_validation():
    from mathmap_tpu.designer.graph import from_mmc
    from mathmap_tpu.expression_db import default_db
    from mathmap_tpu.utils.errors import MMNameError, MMRuntimeError

    db = default_db()
    g = from_mmc('(composer (node "n1" "grayscale" (param "in" (input 0)))'
                 ' (output "n1"))', db=db)
    assert g.add("twirl") == "n2"  # counter restored past loaded ids
    g.output = "zzz"
    import pytest as _pytest

    with _pytest.raises(MMNameError, match="unknown node"):
        g.to_source()
    with _pytest.raises(MMRuntimeError, match="expected a number"):
        from_mmc('(composer (node "n1" "twirl" (param "angle" fast))'
                 ' (output "n1"))', db=db)


# -- AOT artifacts (generators/artifact.py) ----------------------------

def _art_filter():
    return mm.compile(
        "filter tw (image in, float angle: -10-10 (3), color tint) "
        "c = in(toXY(ra:[r, a + angle * (1 - r / R) ^ 2])); c * tint end")


def test_artifact_roundtrip_params_stay_runtime(tmp_path):
    """Export -> load -> render matches the live renderer, and param
    VALUES (slider + color) change at call time without re-export."""
    from mathmap_tpu.generators.artifact import export_artifact, load_artifact

    f = _art_filter()
    W, H = 48, 32
    p0 = {"angle": 3.0, "tint": [1.0, 0.8, 0.6, 1.0]}
    path = tmp_path / "tw.mmxa"
    export_artifact(f, str(path), W, H, params=p0)
    art = load_artifact(str(path))
    img = np.random.RandomState(0).rand(H, W, 4).astype(np.float32)
    for p in (p0, {"angle": 5.5, "tint": [0.2, 1.0, 0.4, 1.0]}):
        got = art.render(img, params=p, t=0.1)
        want = np.asarray(f.render(img, width=W, height=H, t=0.1, params=p))
        np.testing.assert_allclose(got, want, atol=1e-6)


def test_artifact_curve_lut_param(tmp_path):
    from mathmap_tpu.generators.artifact import export_artifact, load_artifact

    f = mm.compile("filter c (image in, curve cv) "
                   "grayColor(cv(clamp(abs(x / X), 0, 1))) end")
    lut = (np.linspace(0, 1, 16) ** 2).astype(np.float32)
    path = tmp_path / "c.mmxa"
    export_artifact(f, str(path), 48, 32, params={"cv": lut})
    art = load_artifact(str(path))
    img = np.random.RandomState(1).rand(32, 48, 4).astype(np.float32)
    got = art.render(img, params={"cv": (lut * 0.5).astype(np.float32)})
    want = np.asarray(f.render(img, width=48, height=32,
                               params={"cv": (lut * 0.5).astype(np.float32)}))
    np.testing.assert_allclose(got, want, atol=1e-6)


def test_artifact_validation_errors(tmp_path):
    from mathmap_tpu.generators.artifact import export_artifact, load_artifact

    f = _art_filter()
    path = tmp_path / "tw.mmxa"
    export_artifact(f, str(path), 48, 32,
                    params={"angle": 3.0, "tint": [1, 1, 1, 1]})
    art = load_artifact(str(path))
    img = np.zeros((32, 48, 4), np.float32)
    with pytest.raises(ValueError, match="needs a value"):
        art.render(img, params={"angle": 1.0})
    with pytest.raises(ValueError, match="no param"):
        art.render(img, params={"angle": 1.0, "tint": [1, 1, 1, 1],
                                "nope": 2})
    with pytest.raises(ValueError, match="input image"):
        art.render(params={"angle": 1.0, "tint": [1, 1, 1, 1]})
    with pytest.raises(ValueError, match="inputs must be"):
        art.render(np.zeros((8, 8, 4), np.float32),
                   params={"angle": 1.0, "tint": [1, 1, 1, 1]})
    bad = tmp_path / "bad.mmxa"
    bad.write_bytes(b"not an artifact")
    with pytest.raises(ValueError, match="not a mathmap_tpu artifact"):
        load_artifact(str(bad))


def test_artifact_scalar_param_value_forms(tmp_path):
    """0-d numpy scalars (accepted by the live path) must work — list()
    on a 0-d array raises TypeError (review r3)."""
    from mathmap_tpu.generators.artifact import export_artifact, load_artifact

    f = _art_filter()
    path = tmp_path / "tw.mmxa"
    export_artifact(f, str(path), 48, 32,
                    params={"angle": 3.0, "tint": [1, 1, 1, 1]})
    art = load_artifact(str(path))
    img = np.random.RandomState(2).rand(32, 48, 4).astype(np.float32)
    base = art.render(img, params={"angle": 4.0, "tint": [1, 1, 1, 1]})
    for v in (np.array(4.0), np.float32(4.0), np.array([4.0])):
        got = art.render(img, params={"angle": v,
                                      "tint": np.ones(4, np.float32)})
        np.testing.assert_allclose(got, base, atol=1e-6)


def test_artifact_truncated_files_raise_valueerror(tmp_path):
    """Truncated/corrupt .mmxa files must raise the documented ValueError,
    not struct.error / JSONDecodeError (review r3)."""
    from mathmap_tpu.generators.artifact import (_MAGIC, export_artifact,
                                                 load_artifact)

    f = _art_filter()
    path = tmp_path / "tw.mmxa"
    export_artifact(f, str(path), 48, 32,
                    params={"angle": 3.0, "tint": [1, 1, 1, 1]})
    whole = path.read_bytes()
    cases = [
        _MAGIC + b"\x01",                      # short length word
        whole[:len(_MAGIC) + 4 + 10],          # manifest cut off
    ]
    for i, data in enumerate(cases):
        bad = tmp_path / f"bad{i}.mmxa"
        bad.write_bytes(data)
        with pytest.raises(ValueError, match="truncated|corrupt"):
            load_artifact(str(bad))


def test_artifact_platform_pin(tmp_path):
    """A .mmxa loaded on a platform it wasn't exported for must fail at
    LOAD time with re-export guidance (jax.export programs are
    platform-pinned; the raw failure is an opaque XLA error at call
    time). Simulated by rewriting the manifest's platforms field —
    tests run on CPU, so a 'tpu'-pinned manifest is foreign here."""
    import json
    import struct

    from mathmap_tpu.generators.artifact import (_MAGIC, _check_platform,
                                                 export_artifact,
                                                 load_artifact)

    # unit: the check itself
    _check_platform(("cpu",), "cpu", "x")          # match: no raise
    _check_platform((), "tpu", "x")                # legacy empty: no raise
    _check_platform(("TPU",), "tpu", "x")          # case-insensitive
    with pytest.raises(ValueError, match="re-export"):
        _check_platform(("tpu",), "cpu", "x")

    # integration: tamper a real artifact's manifest to claim tpu-only
    f = _art_filter()
    path = tmp_path / "tw.mmxa"
    export_artifact(f, str(path), 48, 32,
                    params={"angle": 3.0, "tint": [1, 1, 1, 1]})
    art = load_artifact(str(path))           # cpu-exported loads on cpu
    assert art.platforms == ("cpu",)
    whole = path.read_bytes()
    (mlen,) = struct.unpack("<I", whole[len(_MAGIC):len(_MAGIC) + 4])
    body = len(_MAGIC) + 4 + mlen
    manifest = json.loads(whole[len(_MAGIC) + 4:body])
    assert manifest["platforms"] == ["cpu"]
    manifest["platforms"] = ["tpu"]
    raw = json.dumps(manifest).encode()
    pinned = tmp_path / "tpu_pinned.mmxa"
    pinned.write_bytes(_MAGIC + struct.pack("<I", len(raw)) + raw
                       + whole[body:])
    with pytest.raises(ValueError, match="platform.*re-export|re-export"):
        load_artifact(str(pinned))


def test_artifact_non_default_options_parity(tmp_path):
    """Export-time options (bicubic, wrap/reflect edges) are baked into the
    exported program, which stays bit-equal to the live renderer."""
    from mathmap_tpu.generators.artifact import export_artifact, load_artifact

    f = _art_filter()
    opts = mm.RenderOptions(interpolation="bicubic", edge_x="wrap",
                            edge_y="reflect")
    path = tmp_path / "twp.mmxa"
    export_artifact(f, str(path), 64, 32, options=opts,
                    params={"angle": 3.0, "tint": [1, 1, 1, 1]})
    art = load_artifact(str(path))
    img = np.random.RandomState(3).rand(32, 64, 4).astype(np.float32)
    p = {"angle": 2.5, "tint": [0.9, 1.0, 0.8, 1.0]}
    got = art.render(img, params=p, t=0.2)
    want = np.asarray(f.render(img, width=64, height=32, t=0.2,
                               params=p, options=opts))
    np.testing.assert_allclose(got, want, atol=1e-6)


@pytest.mark.parametrize("exported,current,ok", [
    (("cuda",), "cuda", True),
    (("cuda",), "gpu", True),     # jax.default_backend() names a CUDA card 'gpu'
    (("rocm",), "gpu", True),
    (("cuda",), "rocm", False),
    (("cuda",), "cpu", False),
    (("cpu", "cuda"), "gpu", True),
])
def test_artifact_platform_names_compare_canonically(exported, current, ok):
    """'gpu' (the backend name) and 'cuda'/'rocm' (the lowering platforms
    jax.export records) name the same card: a GPU export must load on the
    GPU that wrote it."""
    from mathmap_tpu.generators.artifact import _check_platform

    if ok:
        _check_platform(exported, current, "x")
    else:
        with pytest.raises(ValueError, match="re-export"):
            _check_platform(exported, current, "x")


def test_artifact_current_platform_is_lowering_name():
    from mathmap_tpu.generators.artifact import current_platform

    assert current_platform() == "cpu"


def test_artifact_loader_refuses_foreign_classes(tmp_path):
    """The program record is a pickle: a stream naming a class outside
    jax/numpy (here os.system) is refused as corrupt, never executed."""
    import pickle
    import struct

    from mathmap_tpu.generators.artifact import (_MAGIC, export_artifact,
                                                 load_artifact)

    f = _art_filter()
    path = tmp_path / "tw.mmxa"
    export_artifact(f, str(path), 48, 32,
                    params={"angle": 3.0, "tint": [1, 1, 1, 1]})
    whole = path.read_bytes()
    (mlen,) = struct.unpack("<I", whole[len(_MAGIC):len(_MAGIC) + 4])
    head = whole[:len(_MAGIC) + 4 + mlen]

    class Evil:
        def __reduce__(self):
            import os
            return (os.system, ("true",))

    bad = tmp_path / "evil.mmxa"
    bad.write_bytes(head + pickle.dumps(Evil()))
    with pytest.raises(ValueError, match="corrupt"):
        load_artifact(str(bad))


def test_artifact_render_batch_parity(tmp_path):
    """Batched artifact programs (export batch_sizes) match per-job
    renders AND the live render_batch bitwise; pad-to-bucket works; u8
    stacks normalize; unexported/oversized batches raise."""
    from mathmap_tpu.generators.artifact import export_artifact, load_artifact

    f = _art_filter()
    path = tmp_path / "tw.mmxa"
    export_artifact(f, str(path), 48, 32,
                    params={"angle": 3.0, "tint": [1, 1, 1, 1]},
                    batch_sizes=(4,))
    art = load_artifact(str(path))
    assert art.batch_sizes == (4,)
    stack = np.random.RandomState(5).rand(3, 32, 48, 4).astype(np.float32)
    plist = [{"angle": a, "tint": [1, 0.9, 0.8, 1]} for a in (1.0, 2.5, 4.0)]
    ts = [0.0, 0.1, 0.2]
    got = art.render_batch(stack, params=plist, ts=ts)
    for i in range(3):  # pad-3-to-4 vs per-job lone renders
        want = np.asarray(f.render(stack[i], width=48, height=32,
                                   t=ts[i], frame=float(i), params=plist[i]))
        np.testing.assert_array_equal(got[i], want)
    live = np.asarray(f.render_batch(stack, ts=np.asarray(ts),
                                     width=48, height=32, params=plist))
    np.testing.assert_array_equal(got, live)
    u8 = (stack * 255).round().astype(np.uint8)
    np.testing.assert_array_equal(
        art.render_batch(u8, params=plist, ts=ts),
        art.render_batch(u8.astype(np.float32) / 255.0, params=plist, ts=ts))
    with pytest.raises(ValueError, match="exceeds the largest"):
        art.render_batch(np.zeros((5, 32, 48, 4), np.float32),
                         params=plist[0], ts=np.zeros(5))
    # wrong-length frames raises readably (review r5: it used to die
    # inside the exported module with an opaque XLA shape error)
    with pytest.raises(ValueError, match="frame values for 3 jobs"):
        art.render_batch(stack, params=plist, ts=ts, frames=[0.0, 1.0])
    # an artifact without batch programs refuses render_batch
    export_artifact(f, str(tmp_path / "nb.mmxa"), 48, 32,
                    params={"angle": 3.0, "tint": [1, 1, 1, 1]})
    with pytest.raises(ValueError, match="no batched programs"):
        load_artifact(str(tmp_path / "nb.mmxa")).render_batch(
            stack, params=plist, ts=ts)


def test_artifact_render_animation_parity(tmp_path):
    """anim_frames exports the whole-sweep program; the loaded artifact's
    render_animation matches the live one bitwise (t spacing + frame
    internal + num_frames internal fixed at export)."""
    from mathmap_tpu.generators.artifact import export_artifact, load_artifact

    f = mm.compile(
        "filter an (image in, float k: 0-9 (2)) "
        "in(xy + xy:[k * sin(t * 2 * pi + y / 10), 0]) * "
        "grayColor(frame / 4 + 0.5) end")
    path = tmp_path / "an.mmxa"
    export_artifact(f, str(path), 48, 32, params={"k": 2.0},
                    anim_frames=4)
    art = load_artifact(str(path))
    img = np.random.RandomState(6).rand(32, 48, 4).astype(np.float32)
    got = art.render_animation(img, params={"k": 3.0})
    want = np.asarray(f.render_animation(img, num_frames=4, width=48,
                                         height=32, params={"k": 3.0}))
    assert got.shape == (4, 32, 48, 4)
    np.testing.assert_array_equal(got, want)
    # u8 input normalizes; periodic flag honored (different t spacing)
    u8 = (img * 255).round().astype(np.uint8)
    np.testing.assert_array_equal(
        art.render_animation(u8, params={"k": 3.0}),
        art.render_animation(u8.astype(np.float32) / 255.0,
                             params={"k": 3.0}))
    # periodic defaults True; a non-periodic export uses t=frame/(N-1)
    per = tmp_path / "an_per.mmxa"
    export_artifact(f, str(per), 48, 32, params={"k": 2.0}, anim_frames=4,
                    options=mm.RenderOptions(periodic=False))
    gp = load_artifact(str(per)).render_animation(img, params={"k": 3.0})
    wp = np.asarray(f.render_animation(
        img, num_frames=4, width=48, height=32, params={"k": 3.0},
        options=mm.RenderOptions(periodic=False)))
    np.testing.assert_array_equal(gp, wp)
    assert not np.array_equal(gp, got)
    # an artifact without the animation program refuses
    export_artifact(f, str(tmp_path / "na.mmxa"), 48, 32,
                    params={"k": 2.0})
    with pytest.raises(ValueError, match="no animation program"):
        load_artifact(str(tmp_path / "na.mmxa")).render_animation(
            img, params={"k": 3.0})
