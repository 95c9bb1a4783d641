"""Streaming partitioned convolution — the device engine.

Semantics match the reference's uniform partitioned scheme (zita-convolver
``Convproc`` as configured by zita-fconfig.cc:78-94: quantum = minpart =
maxpart = fragm): the output equals plain linear convolution of the input
with the accumulated impulse response, computed block-by-block with
overlap-add, with the convolution tail past end-of-input dropped by the
caller (the reference writes exactly as many frames as it reads,
sound-processor.cc:86-96).

Design notes:

* In a uniform frequency-delay-line (FDL) scheme the output block ``t``
  depends only on the *input* spectra of blocks ``t-P+1 .. t`` and on the
  previous block's overlap tail — there is no sequential data dependency
  through the filter state.  So unlike the reference's one-block-at-a-time
  pump (sound-processor.cc:98-127), the engine processes a whole chunk of
  ``T`` blocks in a single device step with full parallelism across
  blocks, streams, channels, and frequency bins.  Carried state is tiny:
  the last ``P-1`` input spectra and one ``fragm``-frame overlap tail.

* All spectra are (re, im) float32 planes in the permuted matmul-DFT
  bin layout of :mod:`folve_tpu.engine.rfft`; the transforms are dense
  matmuls at ``Precision.HIGHEST`` (a float32 product left at the
  default precision may run in TF32 on the GPU and miss the -90 dB
  accuracy budget).  The whole step is plain ``jax.numpy``/``lax``
  left to XLA.
"""

from __future__ import annotations

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
from jax import lax

from folve_tpu.engine.filter_bank import FilterBank
from folve_tpu.engine.rfft import (
    fft_real,
    get_plan,
    half_bins,
    ifft_from_half,
    ifft_to_real,
)

_PRECISION = lax.Precision.HIGHEST


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class StreamState:
    """Per-stream carried convolution state.

    ``hist_re``/``hist_im``: float32 ``[P-1, Cin, K]`` — re/im spectra of
    the most recent ``P-1`` input blocks, oldest first (the
    frequency-delay line), kept as separate planes so the step never
    materializes an interleaved copy.
    ``tail``: float32 ``[Cout, fragm]`` — overlap-add carry from the last
    processed block.
    ``max_abs``: float32 scalar — running max |output| over frames the
    caller declared valid (the reference's clipping monitor,
    sound-processor.cc:119-124).
    """

    hist_re: jax.Array
    hist_im: jax.Array
    tail: jax.Array
    max_abs: jax.Array


def init_state(bank: FilterBank) -> StreamState:
    p, cin, cout, _, k = bank.h_spec.shape
    return StreamState(
        hist_re=jnp.zeros((p - 1, cin, k), dtype=jnp.float32),
        hist_im=jnp.zeros((p - 1, cin, k), dtype=jnp.float32),
        tail=jnp.zeros((cout, bank.fragm), dtype=jnp.float32),
        max_abs=jnp.zeros((), dtype=jnp.float32),
    )


def _fdl_mac(
    h_spec: jax.Array, xall_re: jax.Array, xall_im: jax.Array, t: int
) -> tuple[jax.Array, jax.Array]:
    """Frequency-delay-line MAC: Y[t] = sum_p H[p] * Xall[t + (P-1) - p].

    ``h_spec``: [P, Cin, Cout, 2, K]; ``xall_re``/``xall_im``:
    [T+P-1, Cin, K].  Returns (Yr, Yi) each [T, Cout, K].
    """
    p, cin, cout, _, k = h_spec.shape

    # P is static — unroll in Python with *static* slices of the
    # concatenated spectra.  For the small channel counts of real filter
    # configs the contraction over Cin is pure elementwise work with
    # the filter row broadcast over blocks — spelling it out that way
    # keeps XLA from lowering a 2-wide contraction as degenerate
    # matmuls.  Large channel counts fall back to an einsum.
    # Accumulators are seeded from the first term rather than zero
    # constants: one add fewer, and under shard_map's varying-manual-axes
    # checking the seed inherits the data's vma set.
    if cin * cout <= 16:
        acc_r = [None] * cout
        acc_i = [None] * cout
        for pi in range(p):
            off = (p - 1) - pi
            for o in range(cout):
                for i in range(cin):
                    xr = xall_re[off : off + t, i]  # [T, K]
                    xi = xall_im[off : off + t, i]
                    hr = h_spec[pi, i, o, 0]  # [K]
                    hi = h_spec[pi, i, o, 1]
                    tr = xr * hr - xi * hi
                    ti = xr * hi + xi * hr
                    acc_r[o] = tr if acc_r[o] is None else acc_r[o] + tr
                    acc_i[o] = ti if acc_i[o] is None else acc_i[o] + ti
        yr = jnp.stack(acc_r, axis=1)
        yi = jnp.stack(acc_i, axis=1)
    else:
        yr = yi = None
        for pi in range(p):
            off = (p - 1) - pi
            xr = xall_re[off : off + t]  # [T, Cin, K]
            xi = xall_im[off : off + t]
            hr, hi = h_spec[pi, :, :, 0], h_spec[pi, :, :, 1]  # [Cin, Cout, K]
            rr = jnp.einsum("tik,iok->tok", xr, hr, precision=_PRECISION)
            ii = jnp.einsum("tik,iok->tok", xi, hi, precision=_PRECISION)
            ri = jnp.einsum("tik,iok->tok", xr, hi, precision=_PRECISION)
            ir = jnp.einsum("tik,iok->tok", xi, hr, precision=_PRECISION)
            yr = (rr - ii) if yr is None else yr + (rr - ii)
            yi = (ri + ir) if yi is None else yi + (ri + ir)
    return yr, yi


def chunk_step(
    bank: FilterBank,
    state: StreamState,
    x: jax.Array,
    n_valid: jax.Array | int | None = None,
    *,
    freq_axis: str | None = None,
    freq_shards: int = 1,
) -> tuple[StreamState, jax.Array]:
    """Convolve ``T`` full input blocks in one device step.

    ``x``: float32 ``[T, Cin, fragm]`` — the next T blocks of input.
    Partial final blocks must be zero-padded by the caller (mirroring the
    reference's tail-block zero-pad, sound-processor.cc:99-105); pass
    ``n_valid`` = number of genuine frames in the chunk so the clipping
    monitor ignores the padding's convolution output past end-of-stream.

    Returns ``(new_state, y)`` with ``y``: float32 ``[T, Cout, fragm]``.

    Frequency-sharded mode (inside ``shard_map``): with ``freq_axis``
    set, ``bank.h_spec`` and the state's FDL hold only this shard's k1
    rows of the permuted spectrum (``K_local = K_global / freq_shards``
    bins).  The forward transform computes local rows only, the MAC is
    elementwise in bins, and the inverse transform finishes its k1
    contraction with one ``psum`` over ``freq_axis`` — after which the
    time-domain output (and hence tail/max_abs) is replicated across the
    freq axis.  This is the engine's single source of truth for both the
    single-device and the multi-chip serving path
    (:mod:`folve_tpu.parallel.serving`).
    """
    p, cin, cout, _, k = bank.h_spec.shape
    b = bank.fragm
    t = x.shape[0]
    if x.shape[1] != cin or x.shape[2] != b:
        raise ValueError(f"x must be [T, {cin}, {b}], got {x.shape}")
    if n_valid is None:
        n_valid = t * b

    # 1. Block spectra: DFT of each block zero-padded to 2*fragm.  The
    # bank's (global) bin count says whether it was compiled half- or
    # full-layout.  Each stage runs under a named scope so a profiler
    # trace attributes device time to it.
    k_global = k * freq_shards
    half = k_global == half_bins(2 * b) and k_global != 2 * b
    if freq_axis is None:
        k1_window = {}
    else:
        plan = get_plan(2 * b)
        if plan.m1 % freq_shards:
            raise ValueError(
                f"M1={plan.m1} rows not divisible by freq_shards={freq_shards}"
            )
        k1_n = plan.m1 // freq_shards
        cols = plan.m2 // 2 + 1 if half else plan.m2
        if k != k1_n * cols:
            raise ValueError(
                f"local bins {k} != k1_n*cols = {k1_n}*{cols} (bad shard layout)"
            )
        k1_window = dict(k1_start=lax.axis_index(freq_axis) * k1_n, k1_n=k1_n)
    with jax.named_scope("fwd_dft"):
        xr, xi = fft_real(x.astype(jnp.float32), 2 * b, half=half, **k1_window)

    # 2. FDL MAC against all partitions, fully parallel across T.
    with jax.named_scope("fdl_mac"):
        xall_re = jnp.concatenate([state.hist_re, xr], axis=0)  # [T+P-1,...]
        xall_im = jnp.concatenate([state.hist_im, xi], axis=0)
        y_re, y_im = _fdl_mac(bank.h_spec, xall_re, xall_im, t)
        if p > 1:
            new_re, new_im = xall_re[t:], xall_im[t:]
        else:
            new_re, new_im = state.hist_re, state.hist_im

    # 3. Inverse DFT + overlap-add between consecutive blocks.  Half
    # banks (the compiler default) invert straight from the stored
    # rectangle (conjugate multiplicity weights — no reconstruction
    # pass, 65/128 stage-1 work); full banks use the plain two-stage
    # inverse.
    shard_kw = dict(axis_name=freq_axis, **k1_window) if freq_axis else {}
    with jax.named_scope("inv_dft_ola"):
        if half:
            y2 = ifft_from_half(y_re, y_im, 2 * b, **shard_kw)  # [T, Cout, 2B]
        else:
            y2 = ifft_to_real(y_re, y_im, 2 * b, **shard_kw)
        heads = y2[:, :, :b]
        tails = y2[:, :, b:]
        carry_in = jnp.concatenate([state.tail[None], tails[:-1]], axis=0)
        y = heads + carry_in  # [T, Cout, B]
        new_tail = tails[-1]

    # 4. Clipping monitor over valid frames only.
    frame_idx = lax.broadcasted_iota(jnp.int32, (t, 1, b), 0) * b + lax.broadcasted_iota(
        jnp.int32, (t, 1, b), 2
    )
    valid = frame_idx < jnp.asarray(n_valid, dtype=jnp.int32)
    max_abs = jnp.maximum(state.max_abs, jnp.max(jnp.where(valid, jnp.abs(y), 0.0)))

    new_state = StreamState(
        hist_re=new_re, hist_im=new_im, tail=new_tail, max_abs=max_abs
    )
    return new_state, y


def block_step(
    bank: FilterBank, state: StreamState, x: jax.Array
) -> tuple[StreamState, jax.Array]:
    """Single-block convenience wrapper: ``x`` is ``[Cin, fragm]``."""
    state, y = chunk_step(bank, state, x[None])
    return state, y[0]


@partial(jax.jit, static_argnames=("reset_max",))
def reset_state(state: StreamState, reset_max: bool = True) -> StreamState:
    """Re-arm a state for a fresh stream (reference: Convproc reset via
    SoundProcessor::Reset, sound-processor.cc:139-145)."""
    return StreamState(
        hist_re=jnp.zeros_like(state.hist_re),
        hist_im=jnp.zeros_like(state.hist_im),
        tail=jnp.zeros_like(state.tail),
        max_abs=jnp.zeros_like(state.max_abs) if reset_max else state.max_abs,
    )


# Batched serving: many streams, one device step (the analog of the
# reference's "multiple cores via parallel file accesses",
# README.md:362-364).  All streams in a batch share one FilterBank pytree
# *structure* (same shapes); distinct filters are fine — vmap carries a
# per-stream h_spec.
batched_chunk_step = jax.vmap(chunk_step, in_axes=(0, 0, 0, 0))

# Same-filter variant: one FilterBank broadcast across the stream batch.
shared_filter_chunk_step = jax.vmap(chunk_step, in_axes=(None, 0, 0, 0))
