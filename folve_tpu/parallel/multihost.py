"""Multi-host serving tier — data parallelism over hosts.

The reference scales to "multiple cores via parallel file accesses" on
ONE machine (reference README.md:362-364); its only network socket is
the localhost status server (status-server.cc:190).  This tier is the
scale-out extension SURVEY §2 calls for: many hosts, each mounting its
own filesystem and feeding its own streams, sharing one global device
mesh.

Design — a 3-axis mesh ``("host", "stream", "freq")``:

* ``host`` — pure data parallelism over hosts.  NO collectives ever run
  on this axis, so the only cross-host traffic is XLA's program
  launch coordination; audio, state, filters and the one serving psum
  all stay host-local.
* ``stream`` — data parallelism over each host's local streams (as in
  :mod:`folve_tpu.parallel.serving`).
* ``freq`` — tensor parallelism over frequency bins; its single psum
  (inverse-FFT contraction) runs between devices of ONE host, never
  across the host network.  :func:`make_multihost_serving_mesh` guarantees this
  by construction: each host's devices form complete (stream × freq)
  subgrids.

Execution model: multi-host SPMD requires every process to enter the
same program at the same cadence, which does not fit demand-pulled
streams directly.  The :class:`SlotServer` therefore serves a fixed
table of stream *slots* advanced in global ticks (one ``T``-block device
step per tick): every host fills its local slots' input blocks (silence
+ ``active=False`` for empty/paused slots — the step then carries their
convolution state through UNCHANGED, so a stalled reader resumes
bit-exactly), and all hosts tick together.  State lives on device
between ticks; only audio crosses the host boundary, per host.

In a real multi-host deployment each process calls
``jax.distributed.initialize`` and feeds its process-local rows only:
SlotServer then builds every global array with
``jax.make_array_from_process_local_data`` and reads back only its own
addressable shards.  Single-process (tests: an 8-device virtual mesh
split into simulated hosts) drives all hosts from one instance with
plain ``device_put``.  The multi-process branches follow the standard
jax multi-controller recipe but no multi-host cluster exists in this
repository's tests — they are code-reviewed, not hardware-tested.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

try:
    from jax import shard_map as _shard_map
except ImportError:  # pragma: no cover
    from jax.experimental.shard_map import shard_map as _shard_map

from folve_tpu.engine.filter_bank import FilterBank
from folve_tpu.engine.rfft import get_plan
from folve_tpu.engine.stream import StreamState, chunk_step

# Stream dimension shards over (host, stream) jointly: host-major row
# blocks, so host h owns global rows [h*S_local, (h+1)*S_local).
SPEC_H = P(("host", "stream"), None, None, None, None, "freq")
SPEC_H_SHARED = P(None, None, None, None, "freq")
SPEC_HIST = P(("host", "stream"), None, None, "freq")
SPEC_TAIL = P(("host", "stream"), None, None)
SPEC_SCALAR = P(("host", "stream"))
SPEC_X = P(("host", "stream"), None, None, None)


def make_multihost_serving_mesh(
    n_hosts: Optional[int] = None,
    freq_parallel: int = 1,
    devices: Optional[Sequence] = None,
) -> Mesh:
    """Devices factored into (host, stream, freq).

    In a real multi-process run, devices group by ``process_index`` —
    each mesh "host" row is exactly one process's local devices, which
    is what keeps the freq psum inside one host.  Single-process (tests), pass
    ``n_hosts`` to split the device list into simulated hosts.
    """
    devs = list(devices) if devices is not None else list(jax.devices())
    by_proc: Dict[int, List] = {}
    for d in devs:
        by_proc.setdefault(getattr(d, "process_index", 0), []).append(d)
    if len(by_proc) > 1:
        # Real multi-host: one mesh row per process.
        rows = [by_proc[p] for p in sorted(by_proc)]
        per_host = len(rows[0])
        if any(len(r) != per_host for r in rows):
            raise ValueError("hosts expose unequal device counts")
        if n_hosts is not None and n_hosts != len(rows):
            raise ValueError(f"{len(rows)} processes != n_hosts={n_hosts}")
    else:
        if n_hosts is None:
            n_hosts = 1
        if len(devs) % n_hosts:
            raise ValueError(f"{len(devs)} devices not divisible by {n_hosts} hosts")
        per_host = len(devs) // n_hosts
        rows = [devs[h * per_host : (h + 1) * per_host] for h in range(n_hosts)]
    if per_host % freq_parallel:
        raise ValueError(
            f"{per_host} devices/host not divisible by freq_parallel={freq_parallel}"
        )
    grid = np.array(rows, dtype=object).reshape(
        len(rows), per_host // freq_parallel, freq_parallel
    )
    return Mesh(grid, axis_names=("host", "stream", "freq"))


def make_multihost_serving_step(mesh: Mesh, fragm: int, *,
                                shared_bank: bool = False):
    """Jitted global serving step over the (host, stream, freq) mesh.

    Same contract as serving.make_sharded_serving_step plus a trailing
    ``active`` [S_global] bool: inactive slots pass their state through
    untouched and output silence (their n_valid is forced to 0 so the
    clipping max also stays put).
    """
    freq_shards = mesh.shape["freq"]
    plan = get_plan(2 * fragm)
    if plan.m1 % freq_shards:
        raise ValueError(f"M1={plan.m1} not divisible by freq={freq_shards}")
    spec_h = SPEC_H_SHARED if shared_bank else SPEC_H

    def local(h_spec, hist_re, hist_im, tail, max_abs, x, n_valid, active):
        def one(hs, hre, him, ta, ma, xx, nv, act):
            bank = FilterBank(h_spec=hs, fragm=fragm, size=hs.shape[0] * fragm)
            st = StreamState(hist_re=hre, hist_im=him, tail=ta, max_abs=ma)
            # freq_axis is always named even at freq=1: the psum is the
            # shard_map replication proof for the freq-free outputs (it
            # lowers to singleton replica groups there — a no-op).
            st2, y = chunk_step(
                bank, st, xx, nv, freq_axis="freq", freq_shards=freq_shards
            )
            # Frozen slot: state unchanged, silent output.  The select
            # (not a cond) keeps the step a single fused program — the
            # wasted FLOPs of a frozen slot are the price of lockstep
            # SPMD, and slots are normally all active.
            keep = lambda new, old: jnp.where(act, new, old)
            return (
                keep(st2.hist_re, hre),
                keep(st2.hist_im, him),
                keep(st2.tail, ta),
                keep(st2.max_abs, ma),
                jnp.where(act, y, jnp.zeros_like(y)),
            )

        bank_axis = None if shared_bank else 0
        return jax.vmap(one, in_axes=(bank_axis, 0, 0, 0, 0, 0, 0, 0))(
            h_spec, hist_re, hist_im, tail, max_abs, x, n_valid, active
        )

    step = _shard_map(
        local,
        mesh=mesh,
        in_specs=(spec_h, SPEC_HIST, SPEC_HIST, SPEC_TAIL, SPEC_SCALAR,
                  SPEC_X, SPEC_SCALAR, SPEC_SCALAR),
        out_specs=(SPEC_HIST, SPEC_HIST, SPEC_TAIL, SPEC_SCALAR, SPEC_X),
    )
    return jax.jit(step)


def host_rows(mesh: Mesh, host: int, s_local: int) -> slice:
    """Global stream-row range owned by mesh host row ``host``."""
    del mesh
    return slice(host * s_local, (host + 1) * s_local)


class SlotServer:
    """Fixed slot-table lockstep server over a multi-host mesh.

    One instance per PROCESS in production (each host feeds only its
    ``host_index`` rows); tests drive all simulated hosts from one
    instance.  State stays device-resident between ticks.
    """

    def __init__(self, mesh: Mesh, bank: FilterBank, s_local: int, t: int):
        self.mesh = mesh
        self.bank = bank
        self.s_local = s_local
        self.t = t
        self.n_hosts = mesh.shape["host"]
        s = self.n_hosts * s_local
        self.s_global = s
        p, cin, cout, _, k = bank.h_spec.shape
        self.cin, self.cout = cin, cout
        self._step = make_multihost_serving_step(mesh, bank.fragm,
                                                 shared_bank=True)
        # Real deployments run one process per host: every global array is
        # built from process-local data (device_put onto a sharding that
        # spans non-addressable devices is not legal there).  The
        # single-process virtual mesh (tests) owns everything.
        self._multiproc = jax.process_count() > 1
        self.host_index = jax.process_index() if self._multiproc else None
        if self._multiproc:
            mk = lambda arr, spec: jax.make_array_from_process_local_data(
                NamedSharding(mesh, spec), arr
            )
            self._h = mk(np.asarray(bank.h_spec), SPEC_H_SHARED)
            self._hist_re = mk(
                np.zeros((s_local, p - 1, cin, k), np.float32), SPEC_HIST
            )
            self._hist_im = mk(
                np.zeros((s_local, p - 1, cin, k), np.float32), SPEC_HIST
            )
            self._tail = mk(
                np.zeros((s_local, cout, bank.fragm), np.float32), SPEC_TAIL
            )
            self._max = mk(np.zeros((s_local,), np.float32), SPEC_SCALAR)
        else:
            put = lambda arr, spec: jax.device_put(arr, NamedSharding(mesh, spec))
            self._h = put(np.asarray(bank.h_spec), SPEC_H_SHARED)
            self._hist_re = put(np.zeros((s, p - 1, cin, k), np.float32), SPEC_HIST)
            self._hist_im = put(np.zeros((s, p - 1, cin, k), np.float32), SPEC_HIST)
            self._tail = put(np.zeros((s, cout, bank.fragm), np.float32), SPEC_TAIL)
            self._max = put(np.zeros((s,), np.float32), SPEC_SCALAR)
        self.ticks = 0

    def reset_slot(self, row: int) -> None:
        """Zero one slot's convolution state (a new stream claims it).
        Host-side scatter of a zero row; cheap at slot-churn rates.
        Multi-process: a global computation — EVERY process must call
        this with the same row in the same tick gap (lockstep, exactly
        like tick)."""
        self._hist_re = self._hist_re.at[row].set(0.0)
        self._hist_im = self._hist_im.at[row].set(0.0)
        self._tail = self._tail.at[row].set(0.0)
        self._max = self._max.at[row].set(0.0)

    def tick(self, x_blocks: Dict[int, np.ndarray],
             n_valid: Optional[Dict[int, int]] = None) -> Dict[int, np.ndarray]:
        """Advance one global step.

        ``x_blocks``: global-row -> [T, Cin, fragm] input block for the
        ACTIVE slots this tick (production: each process passes only its
        own rows; the global array is assembled per-host).  Returns
        row -> [T, Cout, fragm] convolved audio for those rows.
        """
        t, b = self.t, self.bank.fragm
        if self._multiproc:
            # Process-local feeding: this process assembles ONLY its own
            # host's row block and reads back only its own shards.
            lo = host_rows(self.mesh, self.host_index, self.s_local)
            foreign = [r for r in x_blocks if not lo.start <= r < lo.stop]
            if foreign:
                raise ValueError(
                    f"process {self.host_index} owns rows "
                    f"[{lo.start},{lo.stop}) but was fed {foreign}"
                )
            x = np.zeros((self.s_local, t, self.cin, b), np.float32)
            nv = np.zeros((self.s_local,), np.int32)
            act = np.zeros((self.s_local,), bool)
            for row, blk in x_blocks.items():
                i = row - lo.start
                x[i] = blk
                nv[i] = (n_valid or {}).get(row, t * b)
                act[i] = True
            put = lambda arr, spec: jax.make_array_from_process_local_data(
                NamedSharding(self.mesh, spec), arr
            )
        else:
            s = self.s_global
            x = np.zeros((s, t, self.cin, b), np.float32)
            nv = np.zeros((s,), np.int32)
            act = np.zeros((s,), bool)
            for row, blk in x_blocks.items():
                x[row] = blk
                nv[row] = (n_valid or {}).get(row, t * b)
                act[row] = True
            put = lambda arr, spec: jax.device_put(
                arr, NamedSharding(self.mesh, spec)
            )
        self._hist_re, self._hist_im, self._tail, self._max, y = self._step(
            self._h, self._hist_re, self._hist_im, self._tail, self._max,
            put(x, SPEC_X), put(nv, SPEC_SCALAR), put(act, SPEC_SCALAR),
        )
        self.ticks += 1
        if self._multiproc:
            # SPEC_X replicates over the freq axis: each row block shows
            # up once PER FREQ SHARD among the addressable shards —
            # dedup by row start before reassembly.
            by_start = {}
            for sh in y.addressable_shards:
                by_start.setdefault(sh.index[0].start or 0, sh)
            y_local = np.concatenate(
                [np.asarray(by_start[k].data) for k in sorted(by_start)]
            )
            return {row: y_local[row - lo.start] for row in x_blocks}
        return {row: np.asarray(y[row]) for row in x_blocks}
