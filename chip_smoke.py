#!/usr/bin/env python3
"""Smoke test: the serving path end to end on NVIDIA GPUs.

    python chip_smoke.py            # one card: engine, served path, CLI, gpu tests
    python chip_smoke.py --cards 4  # four cards: the sharded serving mesh only

Every phase runs on the card through the entry points a user calls and
is checked against the float64 host oracle (folve_tpu.engine.oracle).
The lines before the last name the card (nvidia-smi name and power
limit) and report each phase; the times printed are measurements of
this run on that card, not a benchmark.  The last line is one JSON
object:

    {"ok": true, "device": {"platform": "gpu", "kind": "...", "count": N}}

A failed phase raises, so the script exits non-zero without that line.
It also exits non-zero when JAX finds no GPU: there is no CPU fallback.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import socket
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
RATE = 44100
SEED = 20261016
# The headline bank: 131,072 taps, fragm 8192, P = 16.
HEADLINE_TAPS = 131072
# Engine phase: S streams x T blocks per step, STEPS chained steps.
ENGINE_S, ENGINE_T, ENGINE_STEPS = 64, 64, 8
# Served phase: seeded 16-bit stereo tracks at about -12 dBFS peak.
TRACK_SECONDS = 20.0
# The album reader reads this much of its first track, then waits for
# the other readers to finish before it reads on.  The handler cache
# holds 4 handlers, as the reference's does: with all four readers'
# files still open at the album's seam, the successor that adopts the
# first track's state would be evicted before its reader opens it, and
# the gapless join would be lost (the reference behaves the same).
ALBUM_HEAD_BYTES = 256 << 10
INPUT_RMS, INPUT_PEAK = 0.05, 0.25
SERVED_MAX_LSB = 2
SERVED_SNR_DB = -85.0
# Four-card phase: streams x blocks per step, chained steps.
MESH_S, MESH_T, MESH_STEPS = 8, 8, 3


def require_gpu(count: int):
    """The JAX devices to use; exits before any work without a GPU."""
    import jax

    devices = jax.devices()
    if devices[0].platform != "gpu":
        raise SystemExit(
            f"chip_smoke: needs a GPU; JAX found {devices[0].platform} "
            f"({devices[0].device_kind}). Nothing was run."
        )
    if len(devices) < count:
        raise SystemExit(f"chip_smoke: needs {count} GPUs; JAX found {len(devices)}")
    return devices[:count]


def print_cards() -> None:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout
    for line in out.strip().splitlines():
        print(f"card: {line.strip()}", flush=True)


def build_native() -> None:
    from folve_tpu.utils.native_build import ensure_built

    t0 = time.perf_counter()
    try:
        path = ensure_built()
    except subprocess.CalledProcessError as e:
        print(f"native build failed:\n{e.stdout}\n{e.stderr}", file=sys.stderr)
        raise
    print(f"setup: native library {path} ({time.perf_counter() - t0:.1f} s)")


def random_ir(rng, taps: int) -> np.ndarray:
    return (rng.standard_normal((2, 2, taps)) / np.sqrt(taps)).astype(np.float32)


def pcm16_signal(rng, frames: int) -> np.ndarray:
    """Seeded stereo noise on the 16-bit grid, peak at about -12 dBFS."""
    from folve_tpu.engine.oracle import quantize_pcm

    x = np.clip(rng.standard_normal((frames, 2)) * INPUT_RMS, -INPUT_PEAK, INPUT_PEAK)
    return (quantize_pcm(x, 16) / 32768.0).astype(np.float32)


def engine_phase(rng) -> None:
    """jit(shared_filter_chunk_step) at S x T with the headline bank,
    chained steps, one stream checked against the float64 oracle."""
    import jax
    import jax.numpy as jnp

    from folve_tpu.engine import compile_filter_bank, init_state, shared_filter_chunk_step
    from folve_tpu.engine.oracle import ENGINE_SNR_DB, convolve_oracle, snr_db

    ir = random_ir(rng, HEADLINE_TAPS)
    bank = compile_filter_bank(ir)
    s, t, b = ENGINE_S, ENGINE_T, bank.fragm
    step = jax.jit(shared_filter_chunk_step)
    make_x = jax.jit(
        lambda k: jax.random.uniform(k, (s, t, 2, b), jnp.float32, -INPUT_PEAK, INPUT_PEAK)
    )
    xs = [make_x(k) for k in jax.random.split(jax.random.key(SEED), ENGINE_STEPS)]
    nv = jnp.full((s,), t * b, jnp.int32)
    states = jax.vmap(lambda _: init_state(bank))(jnp.arange(s))

    t0 = time.perf_counter()
    compiled = step.lower(bank, states, xs[0], nv).compile()
    compile_s = time.perf_counter() - t0
    times, y0 = [], []
    for x in xs:
        t0 = time.perf_counter()
        states, y = compiled(bank, states, x, nv)
        y.block_until_ready()
        times.append(time.perf_counter() - t0)
        y0.append(np.asarray(y[0]))
    got = np.concatenate(y0).transpose(0, 2, 1).reshape(-1, 2)
    x0 = np.concatenate([np.asarray(x[0]) for x in xs]).transpose(0, 2, 1).reshape(-1, 2)
    if not np.all(np.isfinite(got)) or y.shape != (s, t, 2, b):
        raise AssertionError(f"engine output not finite or shape {y.shape}")
    snr = snr_db(convolve_oracle(ir, x0), got)
    steady = float(np.median(times[1:]))
    audio_s = s * t * b / RATE
    print(
        f"engine: {HEADLINE_TAPS}-tap bank (fragm {b}, P {bank.partitions}), "
        f"S={s} T={t}, {len(xs)} chained steps; SNR vs float64 oracle "
        f"{snr:.1f} dB (stream 0, budget {ENGINE_SNR_DB:.0f} dB)"
    )
    print(
        f"engine (this run): compile {compile_s:.1f} s; steady step "
        f"{1000 * steady:.2f} ms median, {1000 * min(times[1:]):.2f} ms min; "
        f"{audio_s / steady:.0f}x realtime ({audio_s:.1f} s of audio per step)"
    )
    if not snr <= ENGINE_SNR_DB:
        raise AssertionError(f"engine SNR {snr:.1f} dB above {ENGINE_SNR_DB} dB")


def check_served(label: str, ref: np.ndarray, blob: bytes) -> None:
    """Decode a served/written FLAC and hold it to the 16-bit oracle."""
    from folve_tpu.audio.flac import read_flac
    from folve_tpu.engine.oracle import max_lsb_diff, quantize_pcm, snr_db

    data, info = read_flac(blob)
    if data.shape != ref.shape:
        raise AssertionError(f"{label}: {data.shape} frames, expected {ref.shape}")
    bits = info.bits_per_sample
    lsb = max_lsb_diff(ref, data, bits)
    snr = snr_db(quantize_pcm(ref, bits) / float(1 << (bits - 1)), data)
    print(f"  {label}: {data.shape[0]} frames, {bits} bit, max |diff| {lsb} LSB, SNR {snr:.1f} dB")
    if lsb > SERVED_MAX_LSB or not snr <= SERVED_SNR_DB:
        raise AssertionError(
            f"{label}: {lsb} LSB / {snr:.1f} dB exceeds {SERVED_MAX_LSB} LSB / {SERVED_SNR_DB} dB"
        )


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _get(url: str, timeout: float = 600.0, byte_range: str | None = None) -> bytes:
    headers = {"Range": f"bytes={byte_range}"} if byte_range else {}
    with urllib.request.urlopen(urllib.request.Request(url, headers=headers), timeout=timeout) as r:
        return r.read()


def served_phase(rng, tmp: str, filters: str, ir: np.ndarray) -> None:
    """``serve -g -i reverb`` through the CLI; four concurrent HTTP
    readers, one of them playing a gapless album pair (pausing after
    ALBUM_HEAD_BYTES of its first track until the others are done)."""
    from folve_tpu import cli
    from folve_tpu.audio.flac import write_flac
    from folve_tpu.engine.oracle import convolve_oracle

    src = os.path.join(tmp, "music")
    frames = int(TRACK_SECONDS * RATE)
    singles = ("one/track.flac", "two/track.flac", "three/track.flac")
    album = ("album/01-a.flac", "album/02-b.flac")
    tracks = {}
    for path in singles + album:
        tracks[path] = pcm16_signal(rng, frames)
        os.makedirs(os.path.join(src, os.path.dirname(path)), exist_ok=True)
        write_flac(os.path.join(src, path), tracks[path], RATE, bits=16)

    port = _free_port()
    argv = ["serve", "-g", "-i", "reverb", "-C", filters, "--files-port", str(port), src]
    server = threading.Thread(target=cli.main, args=(argv,), name="smoke-serve", daemon=True)
    server.start()
    deadline = time.monotonic() + 300
    while True:
        try:
            _get(f"http://localhost:{port}/ls/", timeout=10)
            break
        except OSError:
            if not server.is_alive() or time.monotonic() > deadline:
                raise RuntimeError("serve did not come up")
            time.sleep(0.2)

    url = f"http://localhost:{port}/files/"
    served, errors = {}, []

    def guarded(fn):
        def run():
            try:
                fn()
            except Exception as e:  # re-raised on the main thread below
                errors.append(e)
        return run

    def single(path):
        served[path] = _get(url + path)

    def album_reader():
        a, b = album
        head = _get(url + a, byte_range=f"0-{ALBUM_HEAD_BYTES - 1}")
        if len(head) != ALBUM_HEAD_BYTES:
            raise AssertionError(f"range read gave {len(head)} bytes")
        for r in readers[:-1]:
            r.join(timeout=900)
        served[a] = head + _get(url + a, byte_range=f"{ALBUM_HEAD_BYTES}-")
        served[b] = _get(url + b)

    readers = [threading.Thread(target=guarded(lambda p=p: single(p))) for p in singles]
    readers.append(threading.Thread(target=guarded(album_reader)))
    t0 = time.perf_counter()
    for r in readers:
        r.start()
    for r in readers:
        r.join(timeout=900)
    wall = time.perf_counter() - t0
    if errors or any(r.is_alive() for r in readers):
        raise RuntimeError(f"served readers failed: {errors or 'timed out'}")
    status = _get(f"http://localhost:{port}/").decode()
    m = re.search(r"Device: (\d+) fused steps for (\d+) block jobs \((\d+)% batched", status)
    if m is None or int(m.group(3)) == 0:
        raise AssertionError("the device scheduler batched no jobs")
    audio = sum(len(x) for x in tracks.values()) / RATE
    print(
        f"served: {len(readers)} concurrent HTTP readers, {audio:.0f} s of audio "
        f"in {wall:.1f} s (this run, compiles included); scheduler "
        f"{m.group(1)} steps for {m.group(2)} jobs, {m.group(3)}% batched"
    )
    for p in singles:
        check_served(p, convolve_oracle(ir, tracks[p]), served[p])
    pair = convolve_oracle(ir, np.concatenate([tracks[p] for p in album]))
    check_served(f"{album[0]} (gapless)", pair[:frames], served[album[0]])
    check_served(f"{album[1]} (gapless)", pair[frames:], served[album[1]])


def cli_phase(rng, tmp: str, filters: str, ir: np.ndarray) -> None:
    """``convolve`` one file through the CLI."""
    from folve_tpu import cli
    from folve_tpu.audio.flac import write_flac
    from folve_tpu.engine.oracle import convolve_oracle

    x = pcm16_signal(rng, int(TRACK_SECONDS * RATE))
    src, out = os.path.join(tmp, "cli-in.flac"), os.path.join(tmp, "cli-out.flac")
    write_flac(src, x, RATE, bits=16)
    if cli.main(["convolve", "-C", filters, "-i", "reverb", src, out]) != 0:
        raise RuntimeError("convolve failed")
    with open(out, "rb") as f:
        blob = f.read()
    print("cli:")
    check_served("convolve", convolve_oracle(ir, x), blob)


def gpu_tests() -> None:
    """The tests marked ``gpu``, in this process (one process per card)."""
    import pytest

    class Count:
        passed = 0

        def pytest_runtest_logreport(self, report):
            if report.when == "call" and report.passed:
                self.passed += 1

    # The suite's conftest defaults JAX_PLATFORMS to cpu only where unset.
    os.environ["JAX_PLATFORMS"] = "cuda"
    count = Count()
    rc = pytest.main(
        ["-q", "-m", "gpu", "-p", "no:cacheprovider", os.path.join(HERE, "tests")],
        plugins=[count],
    )
    print(f"gpu tests: exit {int(rc)}, {count.passed} passed")
    if rc != 0 or count.passed == 0:
        raise AssertionError("gpu-marked tests failed")


def one_card(rng) -> None:
    from folve_tpu import cli
    from folve_tpu.filters.compiler import compile_config_file

    build_native()
    engine_phase(rng)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        filters = os.path.join(tmp, "filters")
        if cli.main(["make-demo-filters", filters]) != 0:
            raise RuntimeError("make-demo-filters failed")
        compiled = compile_config_file(os.path.join(filters, "reverb", f"filter-{RATE}.conf"), fsamp=RATE)
        print(
            f"setup: reverb demo filter, {compiled.ir.shape[-1]} taps, fragm "
            f"{compiled.fragm}, P {compiled.bank.partitions}"
        )
        served_phase(rng, tmp, filters, compiled.ir)
        cli_phase(rng, tmp, filters, compiled.ir)
    gpu_tests()


def four_cards(rng, devices) -> None:
    """DeviceScheduler on a (stream x freq) mesh of the four cards, for
    freq = 1 and 2: chained steps of mixed-filter streams against
    single-device chunk_step and the float64 oracle."""
    import jax

    from folve_tpu.engine import chunk_step, compile_filter_bank, init_state
    from folve_tpu.engine.oracle import ENGINE_SNR_DB, convolve_oracle, snr_db
    from folve_tpu.parallel.serving import make_serving_mesh
    from folve_tpu.runtime.scheduler import DeviceScheduler, ShardedStateRef

    irs = [random_ir(rng, HEADLINE_TAPS) for _ in range(2)]
    banks = [compile_filter_bank(ir) for ir in irs]
    b = banks[0].fragm
    which = [i % 2 for i in range(MESH_S)]
    xs = rng.uniform(-INPUT_PEAK, INPUT_PEAK, (MESH_STEPS, MESH_S, MESH_T, 2, b)).astype(np.float32)
    nv = MESH_T * b

    single = jax.jit(chunk_step)
    ref_y = np.zeros((MESH_S, MESH_STEPS, MESH_T, 2, b), np.float32)
    for i in range(MESH_S):
        st = init_state(banks[which[i]])
        for r in range(MESH_STEPS):
            st, y = single(banks[which[i]], st, xs[r, i], nv)
            ref_y[i, r] = np.asarray(y)
    flat = lambda a: a.reshape(-1, 2, b).transpose(0, 2, 1).reshape(-1, 2)
    oracle = [convolve_oracle(irs[which[i]], flat(xs[:, i])) for i in range(MESH_S)]

    for freq in (1, 2):
        mesh = make_serving_mesh(len(devices), freq_parallel=freq)
        sched = DeviceScheduler(max_batch=MESH_S, window_s=0.05, mesh=mesh)
        sched.start()
        states = [init_state(banks[w]) for w in which]
        got = np.zeros_like(ref_y)
        t0 = time.perf_counter()
        try:
            for r in range(MESH_STEPS):
                futs = [sched.submit(banks[which[i]], states[i], xs[r, i], nv) for i in range(MESH_S)]
                for i, fut in enumerate(futs):
                    states[i], y = fut.result(timeout=600)
                    got[i, r] = np.asarray(y)
        finally:
            sched.stop()
        wall = time.perf_counter() - t0
        if not all(isinstance(s, ShardedStateRef) for s in states) or sched.sharded_fast_steps == 0:
            raise AssertionError("device-resident sharded state path never engaged")
        parent = states[0].parent
        state_devs = {len(a.sharding.device_set) for a in (parent.hist_re, parent.hist_im, parent.tail)}
        bank_devs = {len(placed.sharding.device_set) for _, placed in sched._placed_banks.values()}
        if state_devs != {len(devices)} or bank_devs != {len(devices)}:
            raise AssertionError(f"state spans {state_devs}, banks span {bank_devs} devices")
        diff = float(np.max(np.abs(got - ref_y)))
        scale = float(np.max(np.abs(ref_y)))
        snr = max(snr_db(oracle[i], flat(got[i])) for i in range(MESH_S))
        print(
            f"mesh stream={mesh.shape['stream']} x freq={mesh.shape['freq']}: "
            f"{MESH_S} streams (2 filters, {HEADLINE_TAPS} taps), {MESH_STEPS} chained "
            f"steps of T={MESH_T}; {sched.sharded_steps} sharded steps "
            f"({sched.sharded_fast_steps} device-resident); state and banks span "
            f"{len(devices)} devices; max |sharded - chunk_step| {diff:.3g} "
            f"(peak {scale:.3g}); worst SNR vs float64 oracle {snr:.1f} dB; "
            f"{wall:.1f} s (this run, compiles included)"
        )
        if diff > 1e-5 * scale or not snr <= ENGINE_SNR_DB:
            raise AssertionError(f"sharded serving diverges (freq={freq})")


def result_line(devices) -> str:
    """The last line: the devices as JAX reports them."""
    d = devices[0]
    device = {"platform": d.platform, "kind": d.device_kind, "count": len(devices)}
    return json.dumps({"ok": True, "device": device})


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument(
        "--cards", type=int, choices=(1, 4), default=1,
        help="4: run only the four-card sharded serving phase",
    )
    args = parser.parse_args(argv)
    devices = require_gpu(args.cards)
    from folve_tpu.utils.compile_cache import configure_compile_cache

    print_cards()
    print(f"setup: JAX compilation cache {configure_compile_cache()}")
    rng = np.random.default_rng(SEED)
    if args.cards == 4:
        four_cards(rng, devices)
    else:
        one_card(rng)
    import jax

    print(result_line(jax.devices()))
    return 0


if __name__ == "__main__":
    sys.exit(main())
