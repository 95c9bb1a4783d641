"""Matmul FFT — the DFT as real-arithmetic dense matmuls.

This module implements the DFT as two stages of dense matmuls
(Cooley-Tukey N = M1·M2 decomposition, the FlashFFTConv formulation —
PAPERS.md): for N = 16384 both factor matrices are 128x128.  Complex
values are carried as separate (re, im) float32 planes, and every
matmul runs at ``Precision.HIGHEST`` (a float32 product at the default
precision may run in TF32 on the GPU and miss the -90 dB budget).
Whether ``jnp.fft`` (cuFFT) should replace it is an open question.

Bin layout.  With n = M2*n1 + n2 and k = k1 + M1*k2 the transform is

    X[k1, k2] = sum_{n2} W_N^{k1 n2} (sum_{n1} W_M1^{k1 n1} x[n1, n2])
                W_M2^{n2 k2}

and the natural output layout is the *permuted* matrix [k1, k2]
(flattened j = k1*M2 + k2 representing bin k = k1 + M1*k2).  The engine
never unscrambles: the frequency-domain MAC is elementwise in bins, so
filter spectra are simply stored in the same permuted layout
(:func:`permute_spectrum`) and the inverse transform consumes it directly.
"""

from __future__ import annotations

import dataclasses
from functools import lru_cache

import jax.numpy as jnp
import numpy as np
from jax import lax

_PRECISION = lax.Precision.HIGHEST


def _split_factors(n: int) -> tuple[int, int]:
    """Factor n = m1 * m2 with m1, m2 as close as possible (n power of 2)."""
    if n & (n - 1):
        raise ValueError(f"FFT size must be a power of two, got {n}")
    log = n.bit_length() - 1
    m1 = 1 << ((log + 1) // 2)
    return m1, n // m1


@dataclasses.dataclass(frozen=True)
class FFTPlan:
    """Constant factor matrices for one FFT size (host numpy; they are
    closed over by jitted functions and baked in as XLA constants)."""

    n: int
    m1: int
    m2: int
    f1_re: np.ndarray  # [M1, M1]
    f1_im: np.ndarray
    tw_re: np.ndarray  # [M1, M2] twiddle W_N^{k1 n2}
    tw_im: np.ndarray
    f2_re: np.ndarray  # [M2, M2]
    f2_im: np.ndarray


@lru_cache(maxsize=None)
def get_plan(n: int) -> FFTPlan:
    m1, m2 = _split_factors(n)

    def dft(m):
        k = np.arange(m)
        ang = -2.0 * np.pi * np.outer(k, k) / m
        return np.cos(ang), np.sin(ang)

    f1_re, f1_im = dft(m1)
    f2_re, f2_im = dft(m2)
    ang = -2.0 * np.pi * np.outer(np.arange(m1), np.arange(m2)) / n
    return FFTPlan(
        n=n,
        m1=m1,
        m2=m2,
        f1_re=f1_re.astype(np.float32),
        f1_im=f1_im.astype(np.float32),
        tw_re=np.cos(ang).astype(np.float32),
        tw_im=np.sin(ang).astype(np.float32),
        f2_re=f2_re.astype(np.float32),
        f2_im=f2_im.astype(np.float32),
    )


def _rows(mat, start, nrows: int, axis: int = 0):
    """Slice ``nrows`` rows starting at (possibly traced) ``start``."""
    return lax.dynamic_slice_in_dim(jnp.asarray(mat), start, nrows, axis=axis)


def half_bins(n: int) -> int:
    """Bin count of the half-spectrum rectangle: k2 <= M2/2 of the
    permuted [k1, k2] grid — a superset of the rfft half spectrum
    (real input implies X[N-k] = conj(X[k]); storing only these bins
    halves the frequency-domain MAC's memory traffic)."""
    plan = get_plan(n)
    return plan.m1 * (plan.m2 // 2 + 1)


def fft_real(
    x: jnp.ndarray,
    n: int,
    half: bool = False,
    *,
    k1_start=None,
    k1_n: int | None = None,
) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Forward DFT of a real signal, permuted-layout output.

    ``x``: float ``[..., L]`` with L <= n (zero-padded to n).
    Returns ``(re, im)`` each ``[..., n]`` in permuted bin order, or
    ``[..., half_bins(n)]`` when ``half`` (stage 2 computes only the
    k2 <= M2/2 columns).

    ``k1_start``/``k1_n`` restrict the output to a window of k1 rows of
    the permuted [k1, k2] grid — the frequency-sharded serving path
    computes only its local rows (``k1_start`` may be a traced scalar,
    e.g. ``lax.axis_index(...) * k1_n``); no communication is needed in
    the forward direction.  Output is then ``[..., k1_n * cols]``.
    """
    plan = get_plan(n)
    m1, m2 = plan.m1, plan.m2
    length = x.shape[-1]
    # Zero-padding awareness: a signal of L < n samples fills only the
    # first ceil(L/m2) rows of A, so stage 1 contracts over those rows
    # alone — for the engine's 2x zero-pad this halves the matmul.
    rows = min(m1, -(-length // m2))
    if length < rows * m2:
        pad = [(0, 0)] * (x.ndim - 1) + [(0, rows * m2 - length)]
        x = jnp.pad(x, pad)
    a = x.reshape(*x.shape[:-1], rows, m2)  # A[n1, n2], non-zero rows
    if k1_start is None:
        f1_re, f1_im = plan.f1_re[:, :rows], plan.f1_im[:, :rows]
        tr, ti = plan.tw_re, plan.tw_im
    else:
        f1_re = _rows(plan.f1_re[:, :rows], k1_start, k1_n)
        f1_im = _rows(plan.f1_im[:, :rows], k1_start, k1_n)
        tr = _rows(plan.tw_re, k1_start, k1_n)
        ti = _rows(plan.tw_im, k1_start, k1_n)
    # Stage 1 (real input): S1 = F1[local k1 rows, :rows] @ A.
    s1r = jnp.einsum("kn,...nm->...km", f1_re, a, precision=_PRECISION)
    s1i = jnp.einsum("kn,...nm->...km", f1_im, a, precision=_PRECISION)
    # Twiddle.
    t_r = s1r * tr - s1i * ti
    t_i = s1r * ti + s1i * tr
    # Stage 2: X = T @ F2 (contract n2); in half mode only the first
    # M2/2+1 output columns are produced.
    cols = m2 // 2 + 1 if half else m2
    f2_re, f2_im = plan.f2_re[:, :cols], plan.f2_im[:, :cols]
    xr = (
        jnp.einsum("...km,ml->...kl", t_r, f2_re, precision=_PRECISION)
        - jnp.einsum("...km,ml->...kl", t_i, f2_im, precision=_PRECISION)
    )
    xi = (
        jnp.einsum("...km,ml->...kl", t_r, f2_im, precision=_PRECISION)
        + jnp.einsum("...km,ml->...kl", t_i, f2_re, precision=_PRECISION)
    )
    batch = x.shape[:-1]
    out = (m1 if k1_start is None else k1_n) * cols
    return xr.reshape(*batch, out), xi.reshape(*batch, out)


def ifft_to_real(
    xr: jnp.ndarray,
    xi: jnp.ndarray,
    n: int,
    *,
    k1_start=None,
    k1_n: int | None = None,
    axis_name: str | None = None,
) -> jnp.ndarray:
    """Inverse DFT consuming permuted-layout spectra; returns the real part.

    ``xr``/``xi``: ``[..., n]`` permuted bins.  Returns float32 ``[..., n]``.

    With ``k1_start``/``k1_n`` the inputs hold only a window of k1 rows
    (``[..., k1_n * M2]``, the frequency-sharded layout): stage 1 and the
    twiddle are local, and stage 2's contraction over k1 is completed by
    one ``lax.psum`` over ``axis_name`` — the single collective of the
    whole sharded serving step.
    """
    plan = get_plan(n)
    m1, m2 = plan.m1, plan.m2
    rows = m1 if k1_start is None else k1_n
    ar = xr.reshape(*xr.shape[:-1], rows, m2)
    ai = xi.reshape(*xi.shape[:-1], rows, m2)
    # Stage 1: U[k1, n2] = sum_{k2} X[k1, k2] conj(F2)[k2, n2].
    ur = (
        jnp.einsum("...kl,ml->...km", ar, plan.f2_re, precision=_PRECISION)
        + jnp.einsum("...kl,ml->...km", ai, plan.f2_im, precision=_PRECISION)
    )
    ui = (
        -jnp.einsum("...kl,ml->...km", ar, plan.f2_im, precision=_PRECISION)
        + jnp.einsum("...kl,ml->...km", ai, plan.f2_re, precision=_PRECISION)
    )
    # Conjugate twiddle (local k1 rows).
    if k1_start is None:
        tr, ti = plan.tw_re, plan.tw_im
        f1_re, f1_im = plan.f1_re, plan.f1_im
    else:
        tr = _rows(plan.tw_re, k1_start, k1_n)
        ti = _rows(plan.tw_im, k1_start, k1_n)
        f1_re = _rows(plan.f1_re, k1_start, k1_n, axis=1)
        f1_im = _rows(plan.f1_im, k1_start, k1_n, axis=1)
    vr = ur * tr + ui * ti
    vi = -ur * ti + ui * tr
    # Stage 2: x[n1, n2] = (1/N) sum_{k1} conj(F1)[n1, k1] V[k1, n2]; real
    # part only (spectra of real signals).
    out = (
        jnp.einsum("nk,...km->...nm", f1_re, vr, precision=_PRECISION)
        + jnp.einsum("nk,...km->...nm", f1_im, vi, precision=_PRECISION)
    )
    if axis_name is not None:
        out = lax.psum(out, axis_name)
    return (out / n).reshape(*xr.shape[:-1], n)


def reconstruct_full(
    xr: jnp.ndarray, xi: jnp.ndarray, n: int
) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Rebuild the full permuted spectrum of a *real* signal from its
    half-spectrum rectangle via conjugate symmetry.

    With bin k = k1 + M1*k2 and X[N-k] = conj(X[k]), the missing
    columns k2 in [M2/2+1, M2) satisfy
      X[k1, k2] = conj(X[M1-k1, M2-1-k2])   for k1 > 0,
      X[0,  k2] = conj(X[0,     M2-k2]),
    both of which live inside the stored k2 <= M2/2 rectangle.
    """
    plan = get_plan(n)
    m1, m2 = plan.m1, plan.m2
    cols = m2 // 2 + 1
    take = m2 - cols  # number of missing columns
    batch = xr.shape[:-1]
    ar = xr.reshape(*batch, m1, cols)
    ai = xi.reshape(*batch, m1, cols)
    # Rows k1 -> (m1-k1) % m1 == roll(flip(rows), 1).
    mr = jnp.roll(jnp.flip(ar, axis=-2), 1, axis=-2)
    mi = jnp.roll(jnp.flip(ai, axis=-2), 1, axis=-2)
    # Columns for k1>0 rows: k2' = m2-1-k2 in [0, take-1] -> slice+flip.
    rec_r = jnp.flip(mr[..., :take], axis=-1)
    rec_i = -jnp.flip(mi[..., :take], axis=-1)
    # Row k1 = 0 mirrors within itself with k2' = m2-k2 in [1, take].
    row0_r = jnp.flip(ar[..., 0:1, 1 : take + 1], axis=-1)
    row0_i = -jnp.flip(ai[..., 0:1, 1 : take + 1], axis=-1)
    rec_r = jnp.concatenate([row0_r, rec_r[..., 1:, :]], axis=-2)
    rec_i = jnp.concatenate([row0_i, rec_i[..., 1:, :]], axis=-2)
    fr = jnp.concatenate([ar, rec_r], axis=-1)
    fi = jnp.concatenate([ai, rec_i], axis=-1)
    return fr.reshape(*batch, n), fi.reshape(*batch, n)


@lru_cache(maxsize=None)
def _half_weights(n: int) -> np.ndarray:
    """Per-stored-bin conjugate multiplicity c_k for the half-spectrum
    rectangle: the full inverse equals Re(two-stage-inverse(c ⊙ X_half))
    because every missing bin m satisfies X_m e_m = conj(X_σ(m) e_σ(m))
    for a stored σ(m) — so each stored bin contributes (1 + #images)
    times its real part."""
    plan = get_plan(n)
    m1, m2 = plan.m1, plan.m2
    cols = m2 // 2 + 1
    c = np.ones((m1, cols), dtype=np.float32)
    for k2 in range(cols, m2):
        for k1 in range(m1):
            k = k1 + m1 * k2
            m = (n - k) % n  # conjugate bin
            mk1, mk2 = m % m1, m // m1
            assert mk2 < cols, (k1, k2)
            c[mk1, mk2] += 1.0
    return c


def ifft_from_half(
    xr: jnp.ndarray,
    xi: jnp.ndarray,
    n: int,
    *,
    k1_start=None,
    k1_n: int | None = None,
    axis_name: str | None = None,
) -> jnp.ndarray:
    """Inverse DFT of a *real* signal directly from the half-spectrum
    rectangle — no reconstruction pass; stage 1 contracts only the
    stored k2 columns.

    The conjugate-multiplicity weights are per-(k1, k2), so the
    frequency-sharded variant (``k1_start``/``k1_n`` + ``axis_name``,
    see :func:`ifft_to_real`) shards them cleanly by k1 rows — the
    sharded path keeps the full half-spectrum 2x MAC-traffic win.
    """
    plan = get_plan(n)
    m1, m2 = plan.m1, plan.m2
    cols = m2 // 2 + 1
    rows = m1 if k1_start is None else k1_n
    if k1_start is None:
        w = jnp.asarray(_half_weights(n))
        tr, ti = plan.tw_re, plan.tw_im
        f1_re, f1_im = plan.f1_re, plan.f1_im
    else:
        w = _rows(_half_weights(n), k1_start, k1_n)
        tr = _rows(plan.tw_re, k1_start, k1_n)
        ti = _rows(plan.tw_im, k1_start, k1_n)
        f1_re = _rows(plan.f1_re, k1_start, k1_n, axis=1)
        f1_im = _rows(plan.f1_im, k1_start, k1_n, axis=1)
    batch = xr.shape[:-1]
    ar = xr.reshape(*batch, rows, cols) * w
    ai = xi.reshape(*batch, rows, cols) * w
    # Stage 1: contract k2 over the stored columns with conj(F2).
    f2r, f2i = plan.f2_re[:, :cols], plan.f2_im[:, :cols]
    ur = (
        jnp.einsum("...kl,ml->...km", ar, f2r, precision=_PRECISION)
        + jnp.einsum("...kl,ml->...km", ai, f2i, precision=_PRECISION)
    )
    ui = (
        -jnp.einsum("...kl,ml->...km", ar, f2i, precision=_PRECISION)
        + jnp.einsum("...kl,ml->...km", ai, f2r, precision=_PRECISION)
    )
    vr = ur * tr + ui * ti
    vi = -ur * ti + ui * tr
    out = (
        jnp.einsum("nk,...km->...nm", f1_re, vr, precision=_PRECISION)
        + jnp.einsum("nk,...km->...nm", f1_im, vi, precision=_PRECISION)
    )
    if axis_name is not None:
        out = lax.psum(out, axis_name)
    return (out / n).reshape(*batch, n)


def permute_spectrum(spec: np.ndarray, n: int, half: bool = False) -> np.ndarray:
    """Reorder a natural-order complex spectrum [..., n] (host numpy) into
    the permuted [k1, k2] layout produced by :func:`fft_real`; with
    ``half``, keep only the k2 <= M2/2 rectangle."""
    plan = get_plan(n)
    m1, m2 = plan.m1, plan.m2
    # P[k1, k2] = spec[k1 + M1*k2]; spec.reshape(M2, M1) indexes [k2, k1].
    mat = np.swapaxes(spec.reshape(*spec.shape[:-1], m2, m1), -1, -2)
    if half:
        cols = m2 // 2 + 1
        return mat[..., :cols].reshape(*spec.shape[:-1], m1 * cols)
    return mat.reshape(*spec.shape[:-1], n)
