"""chip_smoke.py on a machine without a GPU: its arguments, its checks,
and its refusal to report a result without a card or without the
program beside it. What it does on a card is its own run (README)."""

import pathlib
import shutil
import subprocess
import sys

import numpy as np
import pytest

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402


def test_parse_args():
    assert cs.parse_args([]).four_cards is False
    assert cs.parse_args(["--four-cards"]).four_cards is True
    with pytest.raises(SystemExit):
        cs.parse_args(["--bogus"])


def test_no_gpu_exits_2_without_a_result(capsys):
    assert cs.main([]) == 2
    out = capsys.readouterr()
    assert out.out == ""
    assert "no GPU" in out.err


def test_alone_in_a_directory_fails_without_a_result(tmp_path):
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout


def test_check_tolerance_shape_and_nan():
    a = np.zeros((4, 4, 4), np.float32)
    assert cs.check("same", a, a, 0)[3]
    assert not cs.check("off", a + 1e-3, a, 1e-4)[3]
    assert cs.check("within", a + 1e-5, a, 1e-4)[3]
    assert not cs.check("shape", a[:2], a, 1)[3]
    b = a.copy()
    b[0, 0, 0] = np.nan
    assert not cs.check("nan", b, a, 1)[3]
    u8 = np.full((2, 2, 4), 7, np.uint8)
    assert cs.check("u8-lsb", u8, u8 + 1, 1)[3]
    assert not cs.check("u8-2lsb", u8, u8 + 2, 1)[3]


def test_fraction_rules():
    a = np.zeros((10, 10, 4), np.float32)
    b = a.copy()
    b[0, :2] = 0.5  # 2 of 100 pixels differ
    name, frac, lim, ok = cs.check_frac("n", b, a, 1e-4, 0.05)
    assert frac == pytest.approx(0.02) and ok
    assert not cs.check_frac("n", b, a, 1e-4, 0.01)[3]
    assert cs.check_iter("it", b, a)[3]  # 2% of pixels: at the limit
    b[0, 2] = 0.5
    assert cs.check_iter("it", b, a)[3] is False  # 3%: over it


def test_phases_fail_on_exception_and_tolerance(capsys):
    ph = cs.Phases()
    ph.run("ok", lambda: [("c", 0.0, 1.0, True)])
    ph.run("tol", lambda: [("c", 2.0, 1.0, False)])

    def boom():
        raise RuntimeError("device lost")

    ph.run("raises", boom)
    assert ph.failed == ["tol", "raises"]
    out = capsys.readouterr()
    assert "phase ok:" in out.out and "OK" in out.out
    assert "phase raises: EXCEPTION" in out.out
    assert "device lost" in out.err


def test_image_is_deterministic_and_in_range():
    a = cs.image(20, 30, 5)
    b = cs.image(20, 30, 5)
    np.testing.assert_array_equal(a, b)
    assert a.shape == (20, 30, 4) and a.dtype == np.float32
    assert a.min() >= 0 and a.max() <= 1 and (a[..., 3] == 1).all()
    assert cs.image(8, 8, 1, frames=3).shape == (3, 8, 8, 4)
    assert cs.to_u8(a).dtype == np.uint8
