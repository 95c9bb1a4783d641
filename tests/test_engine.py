"""Golden tests: the device engine vs a float64 direct-convolution oracle.

The reference has no tests (SURVEY.md §4); its oracle was "listen to it".
Ours is numeric: output must match linear convolution to better than
-90 dB error (BASELINE.md accuracy target).
"""

import jax
import numpy as np
import pytest

from folve_tpu.engine import (
    batched_chunk_step,
    block_step,
    chunk_step,
    compile_filter_bank,
    derive_fragm,
    init_state,
    num_partitions,
    shared_filter_chunk_step,
)
from folve_tpu.engine.filter_bank import FilterBank
from folve_tpu.engine.oracle import convolve_oracle as oracle
from folve_tpu.engine.oracle import snr_db
from folve_tpu.engine.stream import _fdl_mac


def run_engine(ir, x, fragm=None, size=None, chunk_blocks=4):
    """Feed x through the engine in chunks, zero-padding the tail block."""
    bank = compile_filter_bank(ir, fragm=fragm, size=size)
    b = bank.fragm
    n, cin = x.shape
    t_total = -(-n // b)
    padded = np.zeros((t_total * b, cin), dtype=np.float32)
    padded[:n] = x
    blocks = padded.reshape(t_total, b, cin).transpose(0, 2, 1)  # [T, Cin, B]
    state = init_state(bank)
    outs = []
    done = 0
    for start in range(0, t_total, chunk_blocks):
        chunk = blocks[start : start + chunk_blocks]
        n_valid = min(n - start * b, chunk.shape[0] * b)
        state, y = chunk_step(bank, state, chunk, n_valid=max(n_valid, 0))
        outs.append(np.asarray(y))
        done += chunk.shape[0]
    y = np.concatenate(outs, axis=0)  # [T, Cout, B]
    y = y.transpose(0, 2, 1).reshape(t_total * b, -1)[:n]
    return bank, state, y


def test_derive_fragm_matches_reference_policy():
    # zita-fconfig.cc:74-77 — halve MAXQUANT while >= 2*size and > MINPART.
    assert derive_fragm(65536) == 8192
    assert derive_fragm(204800) == 8192
    assert derive_fragm(131072) == 8192
    assert derive_fragm(100) == 128
    assert derive_fragm(32) == 64
    assert derive_fragm(1) == 64
    assert num_partitions(65536, 8192) == 8
    assert num_partitions(131072, 8192) == 16
    assert num_partitions(204800, 8192) == 25


@pytest.mark.parametrize(
    "cin,cout,size,fragm",
    [
        (1, 1, 64, None),  # P=1 short filter
        (2, 2, 300, 64),  # P=5, ragged last partition
        (2, 2, 1024, 128),  # P=8
        (1, 2, 700, 256),  # channel upmix
        (2, 1, 513, 256),  # downmix, ragged
    ],
)
def test_chunk_matches_oracle(rng, cin, cout, size, fragm):
    ir = rng.standard_normal((cin, cout, size)).astype(np.float32) / np.sqrt(size)
    n = 5 * (fragm or derive_fragm(size)) + 37
    x = rng.standard_normal((n, cin)).astype(np.float32)
    _, _, y = run_engine(ir, x, fragm=fragm, size=size)
    ref = oracle(ir, x)
    assert snr_db(ref, y) < -90


def test_declared_size_larger_than_ir(rng):
    # /convolver/new declares maxsize; actual IR may be shorter
    # (zita-config.cc:130-135 truncates the other way round).
    ir = rng.standard_normal((2, 2, 1000)).astype(np.float32) / 30
    n = 4096 + 17
    x = rng.standard_normal((n, 2)).astype(np.float32)
    _, _, y = run_engine(ir, x, size=4096, fragm=512)
    ref = oracle(ir, x)
    assert snr_db(ref, y) < -90


def test_chunking_invariance(rng):
    """Different chunk sizes must be bit-identical state machines."""
    ir = rng.standard_normal((2, 2, 500)).astype(np.float32) / 20
    x = rng.standard_normal((8 * 128, 2)).astype(np.float32)
    _, _, y1 = run_engine(ir, x, fragm=128, chunk_blocks=1)
    _, _, y8 = run_engine(ir, x, fragm=128, chunk_blocks=8)
    np.testing.assert_allclose(y1, y8, atol=2e-6)
    ref = oracle(ir, x)
    assert snr_db(ref, y1) < -90


def test_block_step_matches_chunk(rng):
    ir = rng.standard_normal((2, 2, 256)).astype(np.float32) / 16
    bank = compile_filter_bank(ir, fragm=128)
    x = rng.standard_normal((4, 2, 128)).astype(np.float32)
    s1 = init_state(bank)
    outs = []
    for t in range(4):
        s1, y = block_step(bank, s1, x[t])
        outs.append(np.asarray(y))
    s2 = init_state(bank)
    s2, ychunk = chunk_step(bank, s2, x)
    np.testing.assert_allclose(np.stack(outs), np.asarray(ychunk), atol=1e-6)
    np.testing.assert_allclose(np.asarray(s1.tail), np.asarray(s2.tail), atol=1e-6)


def test_max_abs_monitor(rng):
    """max_abs tracks peak |output| over valid frames only
    (reference clipping monitor, sound-processor.cc:119-124)."""
    ir = np.zeros((1, 1, 64), dtype=np.float32)
    ir[0, 0, 0] = 2.0  # pure gain of 2
    bank = compile_filter_bank(ir, fragm=64)
    x = np.zeros((2, 1, 64), dtype=np.float32)
    x[0, 0, 5] = 0.6
    x[1, 0, 3] = 0.9  # lands in the invalid (padding) region below
    state = init_state(bank)
    state, _ = chunk_step(bank, state, x, n_valid=64)
    assert np.asarray(state.max_abs) == pytest.approx(1.2, rel=1e-5)
    # With everything valid the later peak dominates.
    state2 = init_state(bank)
    state2, _ = chunk_step(bank, state2, x, n_valid=128)
    assert np.asarray(state2.max_abs) == pytest.approx(1.8, rel=1e-5)


def test_long_ir_131k(rng):
    """BASELINE headline config: 131,072-tap stereo filter."""
    size = 131072
    ir = rng.standard_normal((2, 2, size)).astype(np.float32) / np.sqrt(size)
    fragm = derive_fragm(size)
    assert fragm == 8192
    n = 3 * fragm + 1234
    x = rng.standard_normal((n, 2)).astype(np.float32)
    _, _, y = run_engine(ir, x)
    ref = oracle(ir, x)
    assert snr_db(ref, y) < -90


def test_many_channels_einsum_path(rng):
    """cin*cout > 16 exercises the einsum MAC fallback."""
    cin, cout, size, fragm = 5, 4, 300, 64
    ir = rng.standard_normal((cin, cout, size)).astype(np.float32) / 17
    n = 4 * fragm + 31
    x = rng.standard_normal((n, cin)).astype(np.float32)
    _, _, y = run_engine(ir, x, fragm=fragm, size=size)
    ref = oracle(ir, x)
    assert snr_db(ref, y) < -90


def test_maxinp_maxout_64x64(rng):
    """The engine limit the reference enforces (Convproc MAXINP/MAXOUT,
    zita-fconfig.cc:49-60): a full 64x64 matrix convolver is accepted
    and correct."""
    from folve_tpu.engine import MAXINP, MAXOUT

    assert MAXINP == MAXOUT == 64
    cin, cout, size, fragm = 64, 64, 96, 32
    ir = rng.standard_normal((cin, cout, size)).astype(np.float32) / 80
    n = 2 * fragm + 7
    x = (rng.standard_normal((n, cin)) * 0.1).astype(np.float32)
    _, _, y = run_engine(ir, x, fragm=fragm, size=size)
    ref = oracle(ir, x)
    assert snr_db(ref, y) < -90
    # One past the limit is rejected (zita-fconfig.cc bounds checks).
    from folve_tpu.engine import compile_filter_bank

    with pytest.raises(ValueError):
        compile_filter_bank(np.zeros((65, 1, 8), np.float32), fragm=32, size=8)
    with pytest.raises(ValueError):
        compile_filter_bank(np.zeros((1, 65, 8), np.float32), fragm=32, size=8)


def _flat(y):
    """[T, C, B] blocks -> [T*B, C] frames."""
    return np.asarray(y).transpose(0, 2, 1).reshape(-1, np.asarray(y).shape[1])


def _blocks(x, fragm):
    """[N, C] frames (N a multiple of fragm) -> [T, C, B] blocks."""
    return x.reshape(-1, fragm, x.shape[1]).transpose(0, 2, 1)


@pytest.mark.parametrize(
    "p,t,fragm,cin,cout",
    [
        (4, 6, 64, 2, 2),  # T >= P-1
        (4, 2, 64, 2, 2),  # T < P-1: old history rows shift
        (6, 5, 128, 1, 1),  # mono, T == P-1
        (3, 4, 64, 1, 2),  # upmix
        (2, 3, 64, 2, 2),  # minimal FDL (one history slot)
    ],
)
def test_chunk_partial_valid_vs_oracle(rng, p, t, fragm, cin, cout):
    """One chunk per stream with a partial ``n_valid``: output matches the
    oracle over the valid frames and the clipping monitor sees only them."""
    ir = (rng.standard_normal((cin, cout, p * fragm - 3)) / 8).astype(np.float32)
    bank = compile_filter_bank(ir, fragm=fragm)
    assert bank.partitions == p
    for n_valid in (t * fragm, t * fragm - fragm // 2, 1):
        x = np.zeros((t * fragm, cin), np.float32)
        x[:n_valid] = rng.standard_normal((n_valid, cin))
        state, y = chunk_step(bank, init_state(bank), _blocks(x, fragm), n_valid)
        got = _flat(y)[:n_valid]
        ref = oracle(ir, x[:n_valid])
        assert snr_db(ref, got) < -90
        assert float(state.max_abs) == pytest.approx(
            float(np.max(np.abs(got))), rel=1e-6
        )


@pytest.mark.parametrize("p,t", [(4, 6), (4, 2), (2, 3)])
def test_serving_step_two_chunks_vs_oracle(rng, p, t):
    """The shared-filter batched serving step, chained over two chunks with
    per-stream partial ``n_valid``, equals per-stream chunk_step and the
    oracle, carried state included."""
    fragm, s = 64, 3
    ir = (rng.standard_normal((2, 2, p * fragm - 7)) / 8).astype(np.float32)
    bank = compile_filter_bank(ir, fragm=fragm)
    xs = rng.standard_normal((2, s, t, 2, fragm)).astype(np.float32)
    nv = np.array([t * fragm, t * fragm - 9, t * fragm], np.int32)
    step = jax.jit(shared_filter_chunk_step)
    states = jax.vmap(lambda _: init_state(bank))(np.arange(s))
    ys = []
    for r in range(2):
        states, y = step(bank, states, xs[r], nv)
        ys.append(np.asarray(y))
    for i in range(s):
        st = init_state(bank)
        for r in range(2):
            st, ref_y = chunk_step(bank, st, xs[r, i], int(nv[i]))
            np.testing.assert_allclose(ys[r][i], np.asarray(ref_y), atol=2e-5)
        for f in ("hist_re", "hist_im", "tail", "max_abs"):
            np.testing.assert_allclose(
                np.asarray(getattr(states, f))[i], np.asarray(getattr(st, f)),
                atol=2e-5,
            )
        x_flat = np.concatenate([_flat(xs[r, i]) for r in range(2)])
        got = np.concatenate([_flat(ys[r][i]) for r in range(2)])
        assert snr_db(oracle(ir, x_flat), got) < -90


def _complex_mac(h, xall_re, xall_im, t):
    """complex128 reference of the FDL MAC: Y[t] = sum_p H[p] X[t+P-1-p]."""
    hc = h[:, :, :, 0].astype(np.float64) + 1j * h[:, :, :, 1]
    xc = xall_re.astype(np.float64) + 1j * xall_im
    p = h.shape[0]
    y = 0
    for pi in range(p):
        off = (p - 1) - pi
        y = y + np.einsum("tik,iok->tok", xc[off : off + t], hc[pi])
    return y


@pytest.mark.parametrize(
    "p,cin,cout,k,t",
    [
        (4, 1, 1, 256, 3),
        (16, 2, 2, 2048, 4),
        (2, 1, 2, 4096, 2),
        (1, 2, 2, 128, 5),  # single partition
        (8, 2, 2, 512, 3),  # t < p-1: history outlives the chunk
        (4, 2, 2, 512, 8),  # t >= p-1
        (40, 2, 2, 256, 4),  # deep FDL
        (128, 1, 1, 256, 2),  # MAXSIZE-class partition count
        (3, 5, 4, 128, 2),  # cin*cout > 16: einsum path
    ],
)
def test_fdl_mac_matches_complex_reference(rng, p, cin, cout, k, t):
    h = rng.standard_normal((p, cin, cout, 2, k)).astype(np.float32)
    xall_re = rng.standard_normal((t + p - 1, cin, k)).astype(np.float32)
    xall_im = rng.standard_normal((t + p - 1, cin, k)).astype(np.float32)
    yr, yi = jax.jit(_fdl_mac, static_argnums=3)(h, xall_re, xall_im, t)
    ref = _complex_mac(h, xall_re, xall_im, t)
    tol = 1e-5 * np.sqrt(p * cin) * 8
    np.testing.assert_allclose(np.asarray(yr), ref.real, atol=tol)
    np.testing.assert_allclose(np.asarray(yi), ref.imag, atol=tol)


@pytest.mark.parametrize(
    "fragm,p,chunks",
    [
        (64, 8, (3, 12, 2, 9)),  # mixes t < P-1 and t >= P-1
        (64, 40, (5, 41, 1, 3)),  # P > 32
        (128, 2, (1, 1, 4)),
    ],
)
def test_streaming_across_chunks_vs_oracle(rng, fragm, p, chunks):
    """Chained chunks of varying T equal one long convolution."""
    size = p * fragm
    ir = (rng.standard_normal((2, 2, size)) / np.sqrt(size)).astype(np.float32)
    bank = compile_filter_bank(ir, fragm=fragm, size=size)
    assert bank.partitions == p
    x = rng.standard_normal((sum(chunks) * fragm, 2)).astype(np.float32)
    state, outs, start = init_state(bank), [], 0
    for t in chunks:
        state, y = chunk_step(bank, state, _blocks(x[start : start + t * fragm], fragm))
        outs.append(_flat(y))
        start += t * fragm
    assert snr_db(oracle(ir, x), np.concatenate(outs)) < -90


def test_batched_mixed_filters_match_single(rng):
    """vmap over per-stream filters (batched_chunk_step) is bit-identical
    to per-stream chunk_step across two chained chunks."""
    fragm, size, s, t = 64, 256, 3, 4
    banks = [
        compile_filter_bank(
            (rng.standard_normal((2, 2, size)) / 16).astype(np.float32),
            fragm=fragm, size=size,
        )
        for _ in range(s)
    ]
    bank_b = FilterBank(
        h_spec=np.stack([np.asarray(b.h_spec) for b in banks]), fragm=fragm, size=size
    )
    x = rng.standard_normal((s, t, 2, fragm)).astype(np.float32)
    nv = np.full((s,), t * fragm, np.int32)
    step = jax.jit(batched_chunk_step)
    states = jax.vmap(lambda _: init_state(banks[0]))(np.arange(s))
    st1, y1 = step(bank_b, states, x, nv)
    st2, y2 = step(bank_b, st1, x[:, ::-1], nv)
    single = jax.jit(chunk_step)
    for i in range(s):
        ss, r1 = single(banks[i], init_state(banks[i]), x[i], nv[i])
        ss, r2 = single(banks[i], ss, x[i, ::-1], nv[i])
        np.testing.assert_allclose(np.asarray(y1[i]), np.asarray(r1), atol=1e-6)
        np.testing.assert_allclose(np.asarray(y2[i]), np.asarray(r2), atol=1e-6)
        np.testing.assert_allclose(np.asarray(st2.tail[i]), np.asarray(ss.tail), atol=1e-6)
