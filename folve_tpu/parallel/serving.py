"""Multi-chip sharded serving — mesh, shardings, collectives.

The reference's only scale-out is "multiple cores via parallel file
accesses" (README.md:362-364).  The device equivalent is a 2D device
mesh:

* ``stream`` axis — data parallelism over the batch of open streams.
  The workload has no cross-stream coupling, so this axis needs no
  collectives; it rides pure SPMD.
* ``freq`` axis — tensor/sequence parallelism *within* a stream over
  frequency bins.  The matmul-FFT's permuted layout [k1, k2] is sharded
  by k1 rows: the forward transform computes only local rows (no
  communication), the frequency-domain MAC is elementwise in bins (no
  communication), and only the inverse transform's second stage — a
  contraction over k1 — needs a single ``psum`` over the ``freq`` axis.
  This also shards the FDL state and the filter spectra across HBMs,
  which is what lets very long IRs and deep FDLs scale.  Half-spectrum
  banks (the engine default) shard the same way: the k1-major flattening
  of the [k1, k2 <= M2/2] rectangle makes contiguous bin chunks exactly
  k1-row blocks, and the conjugate-multiplicity weights are per-(k1, k2)
  so they slice locally.

The per-shard compute is :func:`folve_tpu.engine.stream.chunk_step`
itself in frequency-sharded mode — one engine implementation for both
the single-device and the multi-chip path.  Built with ``shard_map`` so
the collective placement is explicit.
"""

from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

try:  # JAX >= 0.6 exposes shard_map at the top level
    from jax import shard_map as _shard_map
except ImportError:  # pragma: no cover
    from jax.experimental.shard_map import shard_map as _shard_map

from folve_tpu.engine.filter_bank import FilterBank
from folve_tpu.engine.rfft import get_plan
from folve_tpu.engine.stream import StreamState, chunk_step


def make_serving_mesh(
    n_devices: Optional[int] = None, freq_parallel: int = 1
) -> Mesh:
    """Devices factored into (stream, freq) axes."""
    devices = np.asarray(jax.devices())
    if n_devices is not None:
        devices = devices[:n_devices]
    n = devices.size
    if n % freq_parallel:
        raise ValueError(f"{n} devices not divisible by freq_parallel={freq_parallel}")
    grid = devices.reshape(n // freq_parallel, freq_parallel)
    return Mesh(grid, axis_names=("stream", "freq"))


def check_freq_shardable(fragm: int, bins: int, freq_parallel: int) -> bool:
    """True when a bank of ``bins`` (global) frequency bins at block
    length ``fragm`` splits into ``freq_parallel`` k1-row shards."""
    plan = get_plan(2 * fragm)
    if plan.m1 % freq_parallel:
        return False
    cols = bins // plan.m1
    return bins == plan.m1 * cols and cols in (plan.m2, plan.m2 // 2 + 1)


# Global-array PartitionSpecs for the serving step.  Bins (the last axis
# of spectra/FDL) shard over ``freq``; everything else is stream-data
# parallel.  The time-domain tail and the clipping max are replicated
# across ``freq`` (the post-psum output is identical on every freq
# shard).
SPEC_H = P("stream", None, None, None, None, "freq")
SPEC_H_SHARED = P(None, None, None, None, "freq")
SPEC_HIST = P("stream", None, None, "freq")
SPEC_TAIL = P("stream", None, None)
SPEC_SCALAR = P("stream")
SPEC_X = P("stream", None, None, None)


def make_sharded_serving_step(
    mesh: Mesh, fragm: int, *, shared_bank: bool = False, gather: bool = False
):
    """Build the jitted multi-chip serving step for one block length.

    Inputs (global shapes):
      ``h_spec``  [S, P, Cin, Cout, 2, K] — per-stream filter spectra
                  ([P, Cin, Cout, 2, K] broadcast when ``shared_bank``)
      ``hist_re``/``hist_im``  [S, P-1, Cin, K]
      ``tail``    [S, Cout, fragm]
      ``max_abs`` [S]
      ``x``       [S, T, Cin, fragm]
      ``n_valid`` [S] int32
    ``K`` may be the full or the half-spectrum layout.  Streams shard
    over the ``stream`` axis; the K bin axis shards over ``freq``
    (k1-row blocks of the permuted FFT layout).

    Returns a jitted ``step(h_spec, hist_re, hist_im, tail, max_abs, x,
    n_valid) -> (hist_re, hist_im, tail, max_abs, y)``.

    With ``gather``, the step takes a trailing ``idx`` [S] int32 and the
    state arrays may hold a previous step's batch in any order/capacity:
    states are re-gathered on device (XLA inserts any needed
    collectives) so the persistent-slot scheduler never round-trips
    convolution state through the host.
    """
    freq_shards = mesh.shape["freq"]
    plan = get_plan(2 * fragm)
    if plan.m1 % freq_shards:
        raise ValueError(f"M1={plan.m1} not divisible by freq={freq_shards}")

    spec_h = SPEC_H_SHARED if shared_bank else SPEC_H

    def local(h_spec, hist_re, hist_im, tail, max_abs, x, n_valid):
        def one(hs, hre, him, ta, ma, xx, nv):
            bank = FilterBank(h_spec=hs, fragm=fragm, size=hs.shape[0] * fragm)
            st = StreamState(hist_re=hre, hist_im=him, tail=ta, max_abs=ma)
            st2, y = chunk_step(
                bank, st, xx, nv, freq_axis="freq", freq_shards=freq_shards
            )
            return st2.hist_re, st2.hist_im, st2.tail, st2.max_abs, y

        bank_axis = None if shared_bank else 0
        return jax.vmap(one, in_axes=(bank_axis, 0, 0, 0, 0, 0, 0))(
            h_spec, hist_re, hist_im, tail, max_abs, x, n_valid
        )

    step = _shard_map(
        local,
        mesh=mesh,
        in_specs=(spec_h, SPEC_HIST, SPEC_HIST, SPEC_TAIL, SPEC_SCALAR,
                  SPEC_X, SPEC_SCALAR),
        out_specs=(SPEC_HIST, SPEC_HIST, SPEC_TAIL, SPEC_SCALAR, SPEC_X),
    )
    if not gather:
        return jax.jit(step)

    def gathered(h_spec, hist_re, hist_im, tail, max_abs, x, n_valid, idx):
        hist_re = jnp.take(hist_re, idx, axis=0)
        hist_im = jnp.take(hist_im, idx, axis=0)
        tail = jnp.take(tail, idx, axis=0)
        max_abs = jnp.take(max_abs, idx, axis=0)
        return step(h_spec, hist_re, hist_im, tail, max_abs, x, n_valid)

    return jax.jit(gathered)


def shard_states_and_bank(
    mesh: Mesh, h_spec, hist_re, hist_im, tail, max_abs, x, n_valid,
    *, shared_bank: bool = False,
):
    """Place global arrays with the serving shardings (helper for callers
    that build inputs on host)."""
    put = lambda arr, spec: jax.device_put(arr, NamedSharding(mesh, spec))
    return (
        put(h_spec, SPEC_H_SHARED if shared_bank else SPEC_H),
        put(hist_re, SPEC_HIST),
        put(hist_im, SPEC_HIST),
        put(tail, SPEC_TAIL),
        put(max_abs, SPEC_SCALAR),
        put(x, SPEC_X),
        put(n_valid, SPEC_SCALAR),
    )
