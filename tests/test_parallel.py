"""Multi-chip sharded serving tests (virtual 8-device CPU mesh).

The sharded step is the engine's own ``chunk_step`` in frequency-sharded
mode (one implementation for single-device and multi-chip), so these
tests check the shard_map plumbing: shardings, the inverse-FFT psum, and
state continuity across steps — for both the half-spectrum (default)
and full-spectrum bank layouts.
"""

import numpy as np
import pytest
from scipy import signal

from folve_tpu.engine import chunk_step, compile_filter_bank, init_state
from folve_tpu.parallel.serving import (
    check_freq_shardable,
    make_serving_mesh,
    make_sharded_serving_step,
    shard_states_and_bank,
)

import jax


@pytest.fixture(scope="module")
def has8():
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")


def _build_inputs(rng, s, t, fragm, size, layout="half", channels=(2, 2)):
    cin, cout = channels
    banks, irs = [], []
    for i in range(s):
        ir = rng.standard_normal((cin, cout, size)).astype(np.float32) / np.sqrt(size)
        irs.append(ir)
        banks.append(compile_filter_bank(ir, fragm=fragm, size=size, layout=layout))
    h_spec = np.stack([np.asarray(b.h_spec) for b in banks])
    st0 = init_state(banks[0])
    hist_re = np.zeros((s,) + st0.hist_re.shape, np.float32)
    hist_im = np.zeros((s,) + st0.hist_im.shape, np.float32)
    tail = np.zeros((s,) + st0.tail.shape, np.float32)
    max_abs = np.zeros((s,), np.float32)
    x = rng.standard_normal((s, t, cin, fragm)).astype(np.float32)
    n_valid = np.full((s,), t * fragm, np.int32)
    return banks, irs, h_spec, hist_re, hist_im, tail, max_abs, x, n_valid


@pytest.mark.parametrize("layout", ["half", "full"])
@pytest.mark.parametrize("freq_parallel", [1, 2, 4])
def test_sharded_matches_single_device(rng, has8, layout, freq_parallel):
    fragm, size, s, t = 128, 512, 8, 3
    mesh = make_serving_mesh(8, freq_parallel=freq_parallel)
    banks, irs, h_spec, hist_re, hist_im, tail, max_abs, x, n_valid = _build_inputs(
        rng, s, t, fragm, size, layout
    )
    step = make_sharded_serving_step(mesh, fragm)
    args = shard_states_and_bank(mesh, h_spec, hist_re, hist_im, tail, max_abs, x, n_valid)
    new_re, new_im, new_tail, new_max, y = step(*args)

    # Reference: per-stream single-device chunk_step.
    for i in range(s):
        st = init_state(banks[i])
        st2, y_ref = chunk_step(banks[i], st, x[i], int(n_valid[i]))
        np.testing.assert_allclose(np.asarray(y)[i], np.asarray(y_ref), atol=2e-5)
        np.testing.assert_allclose(
            np.asarray(new_tail)[i], np.asarray(st2.tail), atol=2e-5
        )
        np.testing.assert_allclose(
            float(np.asarray(new_max)[i]), float(st2.max_abs), atol=2e-5
        )


def test_shared_bank_broadcast(rng, has8):
    """One filter broadcast over all streams (no per-stream spectra copy)."""
    fragm, size, s, t = 128, 512, 8, 2
    mesh = make_serving_mesh(8, freq_parallel=2)
    banks, irs, h_spec, hist_re, hist_im, tail, max_abs, x, n_valid = _build_inputs(
        rng, s, t, fragm, size
    )
    step = make_sharded_serving_step(mesh, fragm, shared_bank=True)
    args = shard_states_and_bank(
        mesh, h_spec[0], hist_re, hist_im, tail, max_abs, x, n_valid,
        shared_bank=True,
    )
    _, _, _, _, y = step(*args)
    for i in range(s):
        st = init_state(banks[0])
        _, y_ref = chunk_step(banks[0], st, x[i], int(n_valid[i]))
        np.testing.assert_allclose(np.asarray(y)[i], np.asarray(y_ref), atol=2e-5)


def test_sharded_streaming_continuity(rng, has8):
    """Two sharded steps equal one long convolution (half layout)."""
    fragm, size, s = 128, 384, 8
    mesh = make_serving_mesh(8, freq_parallel=2)
    banks, irs, h_spec, hist_re, hist_im, tail, max_abs, x, n_valid = _build_inputs(
        rng, s, 4, fragm, size
    )
    step = make_sharded_serving_step(mesh, fragm)
    args = shard_states_and_bank(mesh, h_spec, hist_re, hist_im, tail, max_abs, x[:, :2], n_valid)
    r1, i1, t1, m1, y1 = step(*args)
    args2 = shard_states_and_bank(mesh, h_spec, np.asarray(r1), np.asarray(i1),
                                  np.asarray(t1), np.asarray(m1), x[:, 2:], n_valid)
    r2, i2, t2, m2, y2 = step(*args2)
    y = np.concatenate([np.asarray(y1), np.asarray(y2)], axis=1)
    for i in range(s):
        flat = x[i].transpose(0, 2, 1).reshape(-1, 2)
        ref = np.zeros((flat.shape[0], 2))
        for o in range(2):
            for ci in range(2):
                ref[:, o] += signal.fftconvolve(
                    flat[:, ci].astype(np.float64), irs[i][ci, o].astype(np.float64)
                )[: flat.shape[0]]
        got = y[i].transpose(0, 2, 1).reshape(-1, 2)
        err = 10 * np.log10(np.sum((got - ref) ** 2) / np.sum(ref**2))
        assert err < -90


def test_sharded_many_channels_einsum(rng, has8):
    """Serving einsum path (cin*cout > 16) on the virtual mesh."""
    fragm, size, s, t = 128, 256, 8, 2
    mesh = make_serving_mesh(8, freq_parallel=2)
    banks, irs, h_spec, hist_re, hist_im, tail, max_abs, x, n_valid = _build_inputs(
        rng, s, t, fragm, size, channels=(5, 4)
    )
    step = make_sharded_serving_step(mesh, fragm)
    args = shard_states_and_bank(mesh, h_spec, hist_re, hist_im, tail, max_abs, x, n_valid)
    _, _, _, _, y = step(*args)
    for i in range(s):
        st = init_state(banks[i])
        _, ref = chunk_step(banks[i], st, x[i], int(n_valid[i]))
        np.testing.assert_allclose(np.asarray(y)[i], np.asarray(ref), atol=3e-5)


@pytest.mark.parametrize("freq_parallel", [2, 4])
def test_sharded_half_layout_vs_oracle(rng, has8, freq_parallel):
    """Half-spectrum banks split into 2 or 4 k1-row shards: three chained
    steps (partial last chunk) equal the float64 oracle per stream."""
    from folve_tpu.engine.oracle import convolve_oracle, snr_db
    from folve_tpu.engine.rfft import half_bins

    fragm, size, s, t = 128, 640, 8, 2
    mesh = make_serving_mesh(8, freq_parallel=freq_parallel)
    banks, irs, h_spec, hist_re, hist_im, tail, max_abs, x, n_valid = _build_inputs(
        rng, s, 3 * t, fragm, size
    )
    assert banks[0].bins == half_bins(2 * fragm)
    step = make_sharded_serving_step(mesh, fragm)
    state = (hist_re, hist_im, tail, max_abs)
    outs = []
    for r in range(3):
        nv = n_valid // 3 - (50 if r == 2 else 0)
        args = shard_states_and_bank(
            mesh, h_spec, *map(np.asarray, state), x[:, r * t : (r + 1) * t], nv
        )
        *state, y = step(*args)
        outs.append(np.asarray(y))
    y = np.concatenate(outs, axis=1)
    n = 3 * t * fragm - 50
    for i in range(s):
        flat = x[i].transpose(0, 2, 1).reshape(-1, 2)[:n]
        got = y[i].transpose(0, 2, 1).reshape(-1, 2)[:n]
        assert snr_db(convolve_oracle(irs[i], flat), got) < -90
        assert float(np.asarray(state[3])[i]) == pytest.approx(
            float(np.max(np.abs(got))), rel=1e-5
        )


def test_check_freq_shardable():
    from folve_tpu.engine.rfft import half_bins

    assert check_freq_shardable(128, half_bins(256), 4)
    assert check_freq_shardable(128, 256, 4)
    assert not check_freq_shardable(128, 255, 4)
    # m1 = 16 for n=256: 32-way freq parallel is too deep.
    assert not check_freq_shardable(128, 256, 32)
