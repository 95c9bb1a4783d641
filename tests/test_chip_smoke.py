"""What of chip_smoke.py runs without a card: the float64 oracle and the
error measures it applies, its last line, and its refusal to run on
anything but a GPU."""

import json
import os
import shutil
import subprocess
import sys
from types import SimpleNamespace

import numpy as np
import pytest

import chip_smoke
from folve_tpu.engine.oracle import convolve_oracle, max_lsb_diff, quantize_pcm, snr_db

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_oracle_matches_direct_convolution(rng):
    ir = rng.standard_normal((2, 3, 17))
    ir[1, 2] = 0.0  # an empty routing pair contributes nothing
    x = rng.standard_normal((50, 2))
    y = convolve_oracle(ir, x)
    assert y.shape == (50, 3) and y.dtype == np.float64
    for o in range(3):
        ref = sum(np.convolve(x[:, i], ir[i, o])[:50] for i in range(2))
        np.testing.assert_allclose(y[:, o], ref, atol=1e-12)


@pytest.mark.parametrize(
    "scale,expected", [(1e-3, -60.0), (1e-5, -100.0), (0.1, -20.0)]
)
def test_snr_db(rng, scale, expected):
    ref = rng.standard_normal(4096)
    assert snr_db(ref, ref * (1 + scale)) == pytest.approx(expected, abs=1e-6)


def test_snr_db_silent_reference():
    assert snr_db(np.zeros(4), np.zeros(4)) == -np.inf
    assert snr_db(np.zeros(4), np.ones(4)) == np.inf


def test_quantize_pcm_rounds_half_even_and_clips():
    lsb = 1 / 32768
    y = np.array([0.5 * lsb, 1.5 * lsb, -0.5 * lsb, 2.0, -2.0, 1 - lsb / 4])
    np.testing.assert_array_equal(quantize_pcm(y, 16), [0, 2, 0, 32767, -32768, 32767])
    assert quantize_pcm(np.array([0.5]), 24)[0] == 1 << 22


def test_max_lsb_diff():
    lsb = 1 / 32768
    ref = np.array([[0.0, 0.25], [0.1, -0.3]])
    assert max_lsb_diff(ref, ref, 16) == 0
    got = ref + np.array([[lsb, 0.0], [0.0, -3 * lsb]])
    assert max_lsb_diff(ref, got, 16) == 3
    assert max_lsb_diff(ref[:0], got[:0], 16) == 0


def test_pcm16_signal_is_on_the_grid_at_about_minus_12_dbfs():
    x = chip_smoke.pcm16_signal(np.random.default_rng(1), 44100)
    assert x.shape == (44100, 2) and x.dtype == np.float32
    np.testing.assert_array_equal(x * 32768, np.round(x * 32768))
    assert 0.2 < np.max(np.abs(x)) <= chip_smoke.INPUT_PEAK


@pytest.mark.parametrize("count", [1, 4])
def test_result_line_format(count):
    dev = SimpleNamespace(platform="gpu", device_kind="NVIDIA H100 80GB HBM3")
    line = chip_smoke.result_line([dev] * count)
    assert "\n" not in line
    assert json.loads(line) == {
        "ok": True,
        "device": {"platform": "gpu", "kind": "NVIDIA H100 80GB HBM3", "count": count},
    }


def test_require_gpu_refuses_cpu():
    with pytest.raises(SystemExit) as e:
        chip_smoke.require_gpu(1)
    assert "needs a GPU" in str(e.value)


def _run_alone(script, cwd):
    env = {**os.environ, "JAX_PLATFORMS": "cpu"}
    return subprocess.run(
        [sys.executable, script], cwd=cwd, env=env,
        capture_output=True, text=True, timeout=120,
    )


def test_exits_nonzero_on_cpu():
    r = _run_alone(os.path.join(ROOT, "chip_smoke.py"), ROOT)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout
    assert "needs a GPU" in r.stderr


def test_exits_nonzero_without_the_repo(tmp_path):
    shutil.copy(os.path.join(ROOT, "chip_smoke.py"), tmp_path)
    r = _run_alone(str(tmp_path / "chip_smoke.py"), tmp_path)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout
