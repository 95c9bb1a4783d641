"""Engine tests at full width on a GPU (skip elsewhere).

Run on a card with ``JAX_PLATFORMS=cuda python -m pytest -m gpu tests/``
(chip_smoke.py runs them too).  Their shapes are the deployments' own:
the 131,072-tap headline bank and the 4 s demo reverb (176,400 taps),
stereo, fragm 8192.
"""

import jax
import numpy as np
import pytest

from folve_tpu.engine import (
    chunk_step,
    compile_filter_bank,
    init_state,
    shared_filter_chunk_step,
)
from folve_tpu.engine.oracle import ENGINE_SNR_DB, convolve_oracle, snr_db

pytestmark = pytest.mark.gpu


def _ir(rng, taps):
    return (rng.standard_normal((2, 2, taps)) / np.sqrt(taps)).astype(np.float32)


def _flat(y):
    return np.asarray(y).transpose(0, 2, 1).reshape(-1, 2)


def test_headline_serving_step_vs_oracle(gpu, rng):
    """Shared-filter serving step, 131,072 taps, S=8 x T=16, two chained
    steps with a partial last chunk on one stream: every stream holds
    the -90 dB budget and the float32 GPU path agrees with the oracle
    (HIGHEST precision, no TF32)."""
    ir = _ir(rng, 131072)
    bank = compile_filter_bank(ir)
    assert (bank.fragm, bank.partitions) == (8192, 16)
    s, t, b = 8, 16, bank.fragm
    xs = rng.uniform(-0.25, 0.25, (2, s, t, 2, b)).astype(np.float32)
    nv = np.full((s,), t * b, np.int32)
    step = jax.jit(shared_filter_chunk_step)
    states = jax.vmap(lambda _: init_state(bank))(np.arange(s))
    ys = []
    for r in range(2):
        states, y = step(bank, states, xs[r], nv)
        ys.append(np.asarray(y))
    assert all(np.all(np.isfinite(y)) for y in ys)
    for i in range(s):
        x = np.concatenate([_flat(xs[r, i]) for r in range(2)])
        got = np.concatenate([_flat(ys[r][i]) for r in range(2)])
        assert snr_db(convolve_oracle(ir, x), got) <= ENGINE_SNR_DB


def test_reverb_bank_chunk_step_vs_oracle(gpu, rng):
    """The demo reverb's shape (176,400 taps, P=22) on the lone-stream
    step, chained chunks of T=8 and T=1 as the runtime pumps them."""
    ir = _ir(rng, 176400)
    bank = compile_filter_bank(ir)
    assert (bank.fragm, bank.partitions) == (8192, 22)
    b = bank.fragm
    x = rng.uniform(-0.25, 0.25, (8 + 8 + 1, b, 2)).astype(np.float32)
    step = jax.jit(chunk_step)
    state, outs, start = init_state(bank), [], 0
    for t in (8, 8, 1):
        blk = x[start : start + t].transpose(0, 2, 1)
        state, y = step(bank, state, blk, t * b)
        outs.append(_flat(y))
        start += t
    got = np.concatenate(outs)
    ref = convolve_oracle(ir, x.reshape(-1, 2))
    assert snr_db(ref, got) <= ENGINE_SNR_DB
    assert float(state.max_abs) == pytest.approx(float(np.max(np.abs(got))), rel=1e-6)
