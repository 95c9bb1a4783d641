"""DeviceScheduler — fuse many streams' block work into one device step.

The reference's multi-stream story is "one FUSE thread per open file,
each running its own Convproc" (README.md:362-364).  The device
equivalent is a single device stepper that coalesces the block jobs of
all concurrently-pumping streams (FUSE reader threads, the prefetch
thread) into one batched ``vmap``-ed convolution step — BASELINE
config 5: "N concurrently open files convolved in one fused device
step".

Jobs are bucketed by filter-bank *shape* (partitions, channels, bins,
fragm) — streams with different filters batch together as long as the
shapes agree, since the batched step carries per-stream spectra.  Batch
sizes are padded to power-of-two buckets to bound XLA compilations.
"""

from __future__ import annotations

import atexit
import threading
import time
import weakref
from collections import OrderedDict
from concurrent.futures import Future
from typing import Dict, List, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from folve_tpu.engine.filter_bank import FilterBank
from folve_tpu.engine.stream import (
    StreamState,
    batched_chunk_step,
    chunk_step,
    shared_filter_chunk_step,
)
from folve_tpu.runtime.processor import _quantize

_batched_step = jax.jit(batched_chunk_step)
# Shared-filter fast path: one FilterBank broadcast across the batch —
# avoids stacking S copies of the spectra when all jobs use one filter.
_shared_step = jax.jit(shared_filter_chunk_step)

# Lone-stream fast path (no batch dim, no stack/unstack host work).
from folve_tpu.runtime.processor import _jitted_chunk as _single_step


def _single_step_quantized(bank, state, x, n_valid, bits):
    state, y = chunk_step(bank, state, x, n_valid)
    return state, _quantize(y, bits)


# One compile per bit depth (16/24); fusing the quantize saves a whole
# dispatch round-trip per chunk on the blocking single-stream path.
_single_step_q = jax.jit(_single_step_quantized, static_argnames=("bits",))


def _signature(bank: FilterBank) -> Tuple:
    return tuple(bank.h_spec.shape) + (bank.fragm,)


def _bucket(n: int, max_batch: int) -> int:
    b = 1
    while b < n:
        b *= 2
    return min(b, max_batch)


class _Job:
    __slots__ = ("bank", "state", "x", "n_valid", "quantize_bits", "future")

    def __init__(self, bank, state, x, n_valid, quantize_bits=None):
        self.bank = bank
        self.state = state
        self.x = x
        self.n_valid = n_valid
        # Best-effort: the lone-stream path folds PCM quantization into
        # the step (one dispatch instead of two); batched paths ignore
        # it and resolve with float audio (callers check y.dtype).
        self.quantize_bits = quantize_bits
        self.future: Future = Future()


class _SlotStates:
    """One sharded step's output states, kept device-resident."""

    __slots__ = ("hist_re", "hist_im", "tail", "max_abs", "__weakref__")

    def __init__(self, hist_re, hist_im, tail, max_abs):
        self.hist_re = hist_re
        self.hist_im = hist_im
        self.tail = tail
        self.max_abs = max_abs


class ShardedStateRef:
    """Duck-typed :class:`StreamState` view into a device-resident batch.

    Streams served by the sharded scheduler carry one of these instead
    of materialized arrays; the next step gathers rows on device
    (``jnp.take`` inside the jitted step), so convolution state never
    crosses the host between steps.  Accessing the fields lazily slices
    the parent batch — only fallback paths (reset, reordering across
    schedulers) ever do that.
    """

    __slots__ = ("parent", "idx")

    def __init__(self, parent: _SlotStates, idx: int):
        self.parent = parent
        self.idx = idx

    @property
    def hist_re(self):
        return self.parent.hist_re[self.idx]

    @property
    def hist_im(self):
        return self.parent.hist_im[self.idx]

    @property
    def tail(self):
        return self.parent.tail[self.idx]

    @property
    def max_abs(self):
        return self.parent.max_abs[self.idx]


_live_schedulers: "weakref.WeakSet[DeviceScheduler]" = weakref.WeakSet()


@atexit.register
def _stop_all_schedulers() -> None:
    # A scheduler thread dying mid-device-call during interpreter
    # teardown can abort the process; stop them in an orderly way.
    for sched in list(_live_schedulers):
        try:
            sched.stop()
        except Exception:
            pass


class DeviceScheduler:
    def __init__(self, max_batch: int = 16, window_s: float = 0.002, mesh=None):
        """``mesh``: optional ``jax.sharding.Mesh`` with ("stream", "freq")
        axes (see :func:`folve_tpu.parallel.serving.make_serving_mesh`).
        When set, batches whose filter banks are freq-shardable dispatch
        to the multi-chip sharded serving step instead of the
        single-device vmapped step."""
        _live_schedulers.add(self)
        self._max_batch = max_batch
        self._window_s = window_s
        self._mesh = mesh
        self._sharded_steps: Dict[Tuple, object] = {}
        # LRU of device-placed filter spectra (keys: id(h_spec) or an
        # id-tuple for per-stream stacks).  Bounded; evicted one-by-one.
        self._placed_banks: "OrderedDict[object, Tuple]" = OrderedDict()
        # Live device-resident state batch per bank signature (NOT per
        # chunk length: state shapes depend only on the bank).  Guarded
        # by _mutex — submit() reads it on caller threads while
        # _execute_sharded() replaces entries on the scheduler thread.
        self._parents: Dict[Tuple, list] = {}  # sig -> [weakref(_SlotStates)]
        # Stream tokens recently seen by submit(); used to skip the
        # coalescing window when provably only one stream is pumping.
        self._stream_seen: Dict[object, float] = {}
        self._last_anon = 0.0
        self._mutex = threading.Lock()
        self._cv = threading.Condition(self._mutex)
        self._queues: Dict[Tuple, List[_Job]] = {}
        self._thread: threading.Thread | None = None
        self._stop = False
        # Observability (status page / tests) — the reference's analog is
        # its CPU% prose and the status page's render timer; ours counts
        # batched device steps and their latency (SURVEY.md §5 tracing).
        self.steps = 0
        self.jobs = 0
        self.batched_jobs = 0
        self.sharded_steps = 0
        self.sharded_fast_steps = 0  # device-resident-state steps
        self.materialized = 0  # sharded states forced back to host
        self.coalesce_waits = 0  # times the window was actually paid
        self.total_step_s = 0.0
        self.last_step_s = 0.0
        self.last_batch = 0
        from folve_tpu.utils.profiling import LatencyStats

        self.latency = LatencyStats()

    def start(self) -> None:
        if self._thread is None:
            self._thread = threading.Thread(
                target=self._run, name="folve-device-scheduler", daemon=True
            )
            self._thread.start()

    def stop(self) -> None:
        with self._cv:
            self._stop = True
            self._cv.notify_all()
        if self._thread:
            self._thread.join(timeout=5)
            self._thread = None
        # Drain anything still queued: a reader blocked in
        # future.result() must complete (or see the error), never hang
        # across shutdown.  Per-signature batches, run on the caller.
        while True:
            with self._cv:
                take = None
                for sig, q in self._queues.items():
                    if q:
                        take = q[: self._max_batch]
                        self._queues[sig] = q[len(take) :]
                        break
            if not take:
                break
            try:
                self._execute(take)
            except Exception as e:
                for job in take:
                    if not job.future.done():
                        job.future.set_exception(e)

    def submit(
        self, bank: FilterBank, state: StreamState, x, n_valid, stream=None,
        quantize_bits=None,
    ) -> Future:
        """Queue one stream's chunk; resolves to (new_state, y).

        ``stream``: optional hashable identity of the submitting stream
        (the SoundProcessor passes ``id(self)``).  Lets the scheduler
        skip the coalescing window when only one stream is pumping —
        the window is pure added latency on a lone blocking read."""
        if isinstance(state, ShardedStateRef):
            with self._mutex:
                refs = self._parents.get(_signature(bank), ())
                live = any(r() is state.parent for r in refs)
            if not live:
                self.materialized += 1
                # Straggler holding a SUPERSEDED device batch:
                # materialize to host so old _SlotStates batches are
                # released promptly (a ref pins the whole padded batch,
                # not just its row).
                from folve_tpu.engine.stream import StreamState as _SS

                state = _SS(
                    hist_re=np.asarray(state.hist_re),
                    hist_im=np.asarray(state.hist_im),
                    tail=np.asarray(state.tail),
                    max_abs=np.asarray(state.max_abs),
                )
        job = _Job(bank, state, x, n_valid, quantize_bits)
        sig = _signature(bank) + (np.asarray(x).shape[0],)
        with self._cv:
            now = time.monotonic()
            if stream is not None:
                self._stream_seen[stream] = now
            else:
                self._last_anon = now
            if self._stop:
                # Shutdown race (e.g. a prefetch thread still pumping
                # while atexit stops schedulers): run inline.
                stopped = True
            else:
                stopped = False
                self._queues.setdefault(sig, []).append(job)
                self.jobs += 1
                self._cv.notify()
        if stopped:
            self._execute([job])
            return job.future
        self.start()
        return job.future

    def _coalesce_worthwhile(self, now: float) -> bool:
        """Called with the lock held: pay the coalescing window unless
        provably a single known stream is active (then the window is
        pure latency).  Unknown-identity (anonymous) submitters count
        as "maybe many" so direct submit() users keep batching."""
        if sum(len(q) for q in self._queues.values()) > 1:
            return True  # already multiple queued; may catch more
        active = 0
        for tok, ts in list(self._stream_seen.items()):
            if now - ts > 5.0:
                del self._stream_seen[tok]
            elif now - ts < 1.0:
                active += 1
        if now - self._last_anon < 1.0:
            return True
        return active != 1

    # -- scheduler thread --------------------------------------------------

    def _run(self) -> None:
        while True:
            with self._cv:
                while not self._stop and not any(self._queues.values()):
                    self._cv.wait()
                if self._stop:
                    return
                if self._coalesce_worthwhile(time.monotonic()):
                    # Small coalescing window: let concurrent pumps
                    # catch up so their blocks fuse into one step.
                    # Each submit() notifies the cv, so a single wait()
                    # would be cut short by the second arrival — hold
                    # until the deadline or a full batch, whichever
                    # comes first.
                    self.coalesce_waits += 1
                    deadline = time.monotonic() + self._window_s
                    while not self._stop and max(
                        (len(q) for q in self._queues.values()), default=0
                    ) < self._max_batch:
                        remaining = deadline - time.monotonic()
                        if remaining <= 0:
                            break
                        self._cv.wait(timeout=remaining)
                if self._stop:
                    return
                sig, jobs = max(
                    ((s, q) for s, q in self._queues.items() if q),
                    key=lambda kv: len(kv[1]),
                )
                take = jobs[: self._max_batch]
                self._queues[sig] = jobs[len(take) :]
            try:
                self._execute(take)
            except Exception as e:  # resolve futures with the error
                for job in take:
                    if not job.future.done():
                        job.future.set_exception(e)

    def _execute(self, jobs: List[_Job]) -> None:
        n = len(jobs)
        # Canonical batch order: row order inside a batch is free (each
        # job resolves its own future), so sort by filter identity —
        # mixed-filter batches then hit the placed-bank stack cache
        # regardless of arrival order.
        jobs = sorted(jobs, key=lambda j: id(j.bank.h_spec))
        bank0 = jobs[0].bank
        mesh = self._mesh
        if mesh is not None:
            from folve_tpu.parallel.serving import check_freq_shardable

            if not check_freq_shardable(
                bank0.fragm, bank0.bins, mesh.shape["freq"]
            ):
                mesh = None  # bank too small for this freq split
        padded = _bucket(n, self._max_batch)
        if mesh is not None:
            # The stream axis splits the batch: pad to a multiple.
            ss = mesh.shape["stream"]
            padded = -(-max(padded, ss) // ss) * ss
        # Pad with replicas of job 0 so only power-of-two batch shapes
        # ever compile.
        all_jobs = jobs + [jobs[0]] * (padded - n)
        if mesh is not None:
            self._execute_sharded(mesh, jobs, all_jobs)
            return
        if n == 1 and padded == 1:
            # Lone stream: run the plain engine step — no stack/unstack
            # host work, no batch dim (same math as the vmapped path,
            # bit-identity covered by test_scheduler).
            job = jobs[0]
            t0 = time.perf_counter()
            if job.quantize_bits is not None:
                state, y = _single_step_q(
                    job.bank, job.state, jnp.asarray(job.x),
                    jnp.int32(int(job.n_valid)), bits=job.quantize_bits,
                )
            else:
                state, y = _single_step(
                    job.bank, job.state, jnp.asarray(job.x),
                    jnp.int32(int(job.n_valid)),
                )
            jax.block_until_ready(y)
            dt = time.perf_counter() - t0
            self.steps += 1
            self.total_step_s += dt
            self.last_step_s = dt
            self.last_batch = 1
            self.latency.record(dt)
            job.future.set_result((state, y))
            return
        states = jax.tree_util.tree_map(
            lambda *xs: jnp.stack(xs), *[j.state for j in all_jobs]
        )
        x = jnp.stack([jnp.asarray(j.x) for j in all_jobs])
        n_valid = jnp.asarray([int(j.n_valid) for j in all_jobs], dtype=jnp.int32)
        shared = all(j.bank.h_spec is jobs[0].bank.h_spec for j in all_jobs)
        t0 = time.perf_counter()
        if shared:
            new_states, y = _shared_step(jobs[0].bank, states, x, n_valid)
        else:
            h_spec = jnp.stack([j.bank.h_spec for j in all_jobs])
            bank = FilterBank(
                h_spec=h_spec, fragm=jobs[0].bank.fragm, size=jobs[0].bank.size
            )
            new_states, y = _batched_step(bank, states, x, n_valid)
        jax.block_until_ready(y)
        dt = time.perf_counter() - t0
        self.steps += 1
        self.total_step_s += dt
        self.last_step_s = dt
        self.last_batch = n
        self.latency.record(dt)
        if n > 1:
            self.batched_jobs += n
        for idx, job in enumerate(jobs):
            state_i = jax.tree_util.tree_map(lambda a: a[idx], new_states)
            job.future.set_result((state_i, y[idx]))

    def _placed_bank(self, mesh, h_spec):
        """Shared-bank spectra placed with the serving sharding, cached
        so repeated steps don't re-transfer the filter."""
        from jax.sharding import NamedSharding

        from folve_tpu.parallel.serving import SPEC_H_SHARED

        key = id(h_spec)
        hit = self._placed_banks.get(key)
        if hit is not None and hit[0] is h_spec:
            self._placed_banks.move_to_end(key)
            return hit[1]
        placed = jax.device_put(h_spec, NamedSharding(mesh, SPEC_H_SHARED))
        self._placed_banks[key] = (h_spec, placed)
        while len(self._placed_banks) > 16:  # bounded (pool caps configs)
            self._placed_banks.popitem(last=False)
        return placed

    def _placed_bank_stack(self, mesh, specs):
        """Per-stream filter stack placed with the serving sharding,
        cached by identity tuple — without this, every fast-path step of
        a mixed-filter batch re-uploads all spectra from host."""
        from jax.sharding import NamedSharding

        from folve_tpu.parallel.serving import SPEC_H

        key = tuple(id(h) for h in specs)
        hit = self._placed_banks.get(key)
        if hit is not None and all(a is b for a, b in zip(hit[0], specs)):
            self._placed_banks.move_to_end(key)
            return hit[1]
        stacked = np.stack([np.asarray(h) for h in specs])
        placed = jax.device_put(stacked, NamedSharding(mesh, SPEC_H))
        self._placed_banks[key] = (tuple(specs), placed)
        while len(self._placed_banks) > 16:
            self._placed_banks.popitem(last=False)
        return placed

    def _execute_sharded(self, mesh, jobs: List[_Job], all_jobs: List[_Job]) -> None:
        """Dispatch one batch through the multi-chip sharded serving step.

        Steady-state streams carry :class:`ShardedStateRef`s from the
        previous step, so their convolution state stays device-resident:
        the jitted step gathers the referenced rows on device
        (``gather=True`` variant) and only the audio output crosses to
        the host.  Mixed/fresh batches fall back to a host stack →
        device_put once.
        """
        from jax.sharding import NamedSharding

        from folve_tpu.parallel.serving import (
            SPEC_SCALAR,
            SPEC_X,
            make_sharded_serving_step,
            shard_states_and_bank,
        )

        bank0 = all_jobs[0].bank
        shared = all(j.bank.h_spec is bank0.h_spec for j in all_jobs)
        states = [j.state for j in all_jobs]
        parent = states[0].parent if isinstance(states[0], ShardedStateRef) else None
        fast = parent is not None and all(
            isinstance(s, ShardedStateRef) and s.parent is parent for s in states
        )
        key = (bank0.fragm, shared, fast)
        step = self._sharded_steps.get(key)
        if step is None:
            step = make_sharded_serving_step(
                mesh, bank0.fragm, shared_bank=shared, gather=fast
            )
            self._sharded_steps[key] = step

        x = np.stack([np.asarray(j.x, dtype=np.float32) for j in all_jobs])
        n_valid = np.asarray([int(j.n_valid) for j in all_jobs], dtype=np.int32)

        t0 = time.perf_counter()
        if fast:
            put = lambda arr, spec: jax.device_put(arr, NamedSharding(mesh, spec))
            if shared:
                h_spec = self._placed_bank(mesh, bank0.h_spec)
            else:
                h_spec = self._placed_bank_stack(
                    mesh, [j.bank.h_spec for j in all_jobs]
                )
            idx = np.asarray([s.idx for s in states], dtype=np.int32)
            new_re, new_im, new_tail, new_max, y = step(
                h_spec,
                parent.hist_re,
                parent.hist_im,
                parent.tail,
                parent.max_abs,
                put(x, SPEC_X),
                put(n_valid, SPEC_SCALAR),
                idx,
            )
            self.sharded_fast_steps += 1
        else:
            hist_re = np.stack([np.asarray(s.hist_re) for s in states])
            hist_im = np.stack([np.asarray(s.hist_im) for s in states])
            tail = np.stack([np.asarray(s.tail) for s in states])
            max_abs = np.stack([np.asarray(s.max_abs) for s in states])
            if shared:
                h_spec = bank0.h_spec
            else:
                h_spec = np.stack([np.asarray(j.bank.h_spec) for j in all_jobs])
            args = shard_states_and_bank(
                mesh, h_spec, hist_re, hist_im, tail, max_abs, x, n_valid,
                shared_bank=shared,
            )
            new_re, new_im, new_tail, new_max, y = step(*args)
        y_host = jax.device_get(y)  # audio leaves; states stay on device
        dt = time.perf_counter() - t0
        n = len(jobs)
        self.steps += 1
        self.sharded_steps += 1
        self.total_step_s += dt
        self.last_step_s = dt
        self.last_batch = n
        self.latency.record(dt)
        if n > 1:
            self.batched_jobs += n
        new_parent = _SlotStates(new_re, new_im, new_tail, new_max)
        with self._mutex:
            # Several batches of the SAME signature can be live at once
            # (queue overflow splits, bulk vs edge-block chunk shapes):
            # a single slot would clobber and de-optimize every other
            # group to host round-trips each step.  Weak refs keep the
            # dict from pinning superseded batches in HBM — a parent
            # dies exactly when no stream's state ref holds it.
            refs = self._parents.setdefault(_signature(bank0), [])
            refs[:] = [r for r in refs if r() is not None][-7:]
            refs.append(weakref.ref(new_parent))
        for idx_i, job in enumerate(jobs):
            job.future.set_result((ShardedStateRef(new_parent, idx_i), y_host[idx_i]))
