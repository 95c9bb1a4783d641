"""Float64 host oracle for the convolution engine, and the error
measures the engine is held to.

The engine's semantics are plain linear convolution of the input with
the filter's impulse response, truncated to the input length (the
reference writes exactly as many frames as it reads,
sound-processor.cc:86-96).  This module computes that with SciPy in
float64, independent of the engine's partitioned matmul-DFT path.
"""

from __future__ import annotations

import numpy as np
from scipy import signal

# Accuracy budget of the device engine against this oracle (BASELINE.md).
ENGINE_SNR_DB = -90.0


def convolve_oracle(ir: np.ndarray, x: np.ndarray) -> np.ndarray:
    """``ir``: [Cin, Cout, L]; ``x``: [N, Cin] -> float64 [N, Cout]."""
    cin, cout, _ = ir.shape
    n = x.shape[0]
    y = np.zeros((n, cout))
    for o in range(cout):
        for i in range(cin):
            if not np.any(ir[i, o]):
                continue
            y[:, o] += signal.fftconvolve(
                np.asarray(x[:, i], np.float64), np.asarray(ir[i, o], np.float64)
            )[:n]
    return y


def snr_db(ref: np.ndarray, got: np.ndarray) -> float:
    """Error energy relative to the reference's energy, in dB (lower is
    better); -inf for an exact match of a silent reference."""
    ref = np.asarray(ref, dtype=np.float64)
    err = np.asarray(got, dtype=np.float64) - ref
    denom = np.sum(ref**2)
    if denom == 0:
        return -np.inf if np.sum(err**2) == 0 else np.inf
    return float(10 * np.log10(np.sum(err**2) / denom + 1e-300))


def quantize_pcm(y: np.ndarray, bits: int) -> np.ndarray:
    """Float samples -> integer PCM codes the way the encoders do it:
    scale by 2**(bits-1), round half to even, clip."""
    scale = float(1 << (bits - 1))
    return np.clip(np.round(np.asarray(y, np.float64) * scale), -scale, scale - 1).astype(
        np.int64
    )


def max_lsb_diff(ref: np.ndarray, got: np.ndarray, bits: int) -> int:
    """Largest difference, in least significant bits at ``bits`` depth,
    between the quantized reference and decoded output ``got`` (float
    samples on the same grid)."""
    return int(np.max(np.abs(quantize_pcm(ref, bits) - quantize_pcm(got, bits)), initial=0))
