"""SoundProcessor — the host-side block pump around the device engine.

Behavioral twin of sound-processor.{h,cc}: owns one compiled filter and
one stream's convolution state, fills a ``fragm``-frame input block from
a decode source, runs the device step lazily on first write, supports
partial output writes (``pending_writes``) for the gapless split, and
tracks the max output value for clipping detection.

The zita ``Convproc`` and its threads are replaced by a pure-JAX
state-in/state-out step (folve_tpu.engine.stream); the expensive
construction the reference's ProcessorPool amortizes
(Convproc::configure + IR load, processor-pool.h:28-30) maps here to
filter compilation + device upload, cached by the pool.
"""

from __future__ import annotations

import os
import time
from typing import Optional

import jax
import numpy as np

from folve_tpu.engine.stream import chunk_step, init_state
from folve_tpu.filters.compiler import CompiledFilter, compile_config_file
from folve_tpu.utils.profiling import LatencyStats

# Lone-stream pump step.
_jitted_chunk = jax.jit(chunk_step)


def _quantize(y, bits: int):
    """Device-side PCM quantization, bit-identical to the host encoders'
    float64 path: the scale is a power of two, so ``y * scale`` is exact
    in float32 and round-half-even picks the same integer either way.
    int16 output halves the device->host audio traffic for <=16-bit
    streams; deeper streams ship PACKED 3-byte little-endian lanes
    (uint8 [..., 3]) instead of int32 — 25% less D2H per sample.  The
    host side reassembles with :func:`_unpack24`."""
    import jax.numpy as jnp

    scale = float(1 << (bits - 1))
    q = jnp.clip(jnp.round(y * scale), -scale, scale - 1.0)
    if bits <= 16:
        return q.astype(jnp.int16)
    qi = q.astype(jnp.int32)
    return jnp.stack(
        [qi & 0xFF, (qi >> 8) & 0xFF, (qi >> 16) & 0xFF], axis=-1
    ).astype(jnp.uint8)


def _unpack24(out: np.ndarray) -> np.ndarray:
    """Host-side inverse of the packed-lane quantize: uint8 [..., 3]
    little-endian -> sign-extended int32 [...]."""
    if out.dtype == np.uint8 and out.ndim >= 1 and out.shape[-1] == 3:
        v = (out[..., 0].astype(np.int32)
             | (out[..., 1].astype(np.int32) << 8)
             | (out[..., 2].astype(np.int32) << 16))
        return (v << 8) >> 8  # sign-extend bit 23
    return out


_jitted_quantize = jax.jit(_quantize, static_argnames=("bits",))


def _is_quantized(y) -> bool:
    return np.issubdtype(np.dtype(y.dtype), np.integer)


def _mtime(path: str) -> float:
    try:
        return os.stat(path).st_mtime
    except OSError:
        return 0.0


class _Inflight:
    """One dispatched-but-unemitted bulk chunk (the pipeline depth is 1).

    Either ``future`` (DeviceScheduler path, resolves to (state, y)) or
    ``y`` (direct-jit path, an async device array whose state was already
    chained) is set.  ``sink``/``r`` say where and how much to emit."""

    __slots__ = ("future", "y", "r", "qbits", "sink")

    def __init__(self, future, y, r: int, qbits: Optional[int], sink):
        self.future = future
        self.y = y
        self.r = r
        self.qbits = qbits
        self.sink = sink


class SoundProcessor:
    def __init__(self, compiled: CompiledFilter, config_file: str, scheduler=None):
        self._compiled = compiled
        self.config_file = config_file
        self.config_file_timestamp = _mtime(config_file)
        self.bank = compiled.bank
        # Optional DeviceScheduler: routes block work into fused batched
        # device steps shared with other concurrently-pumping streams.
        self.scheduler = scheduler
        # Per-stream device-step latency (SURVEY §5 tracing: "per-stream
        # block latency counters surfaced on the status page").
        self.latency = LatencyStats()
        self._state = init_state(self.bank)
        b = self.bank.fragm
        self._in_buf = np.zeros((b, self.bank.ninp), dtype=np.float32)
        self._input_pos = 0
        self._out_buf: Optional[np.ndarray] = None  # [fragm, cout] when processed
        self._output_pos = -1  # <0: needs Process()
        self._max_out = 0.0
        # One-deep bulk-pump pipeline (see pump_chunk): while the device
        # runs chunk N, the host fetches + encodes chunk N-1.
        self._inflight: Optional[_Inflight] = None
        # Wall-time breakdown of the bulk path for the bench/status
        # (device dispatch+wait / D2H fetch / host encode).
        self.dispatch_s = 0.0
        self.fetch_s = 0.0
        self.encode_s = 0.0

    # -- introspection ----------------------------------------------------

    @property
    def input_channels(self) -> int:
        return self.bank.ninp

    @property
    def output_channels(self) -> int:
        return self.bank.nout

    @property
    def fragm(self) -> int:
        return self.bank.fragm

    def pending_writes(self) -> int:
        """Frames already processed but not yet written (gapless split,
        sound-processor.h:42-50)."""
        if self._output_pos < 0:
            return 0
        return self.fragm - self._output_pos

    def is_input_buffer_complete(self) -> bool:
        return self._input_pos == self.fragm

    def max_output_value(self) -> float:
        # Read-only peek: safe from the status thread while the handler
        # thread pumps.  A pending scheduler step's state is read off
        # its future without consuming the pipeline.
        st = self._state
        fl = self._inflight
        # Snapshot the future once: the handler thread may null fl.future
        # concurrently (pump_chunk / _resolve_inflight_state).
        fut = fl.future if fl is not None else None
        if fut is not None:
            st = fut.result()[0]
        dev = float(jax.device_get(st.max_abs))
        return max(self._max_out, dev)

    def reset_max_values(self) -> None:
        """Clear only the clipping monitor (SoundProcessor::ResetMaxValues);
        convolution state is untouched.  Handler-thread only."""
        import jax.numpy as jnp

        from folve_tpu.engine.stream import StreamState

        self._resolve_inflight_state()
        self._max_out = 0.0
        self._state = StreamState(
            hist_re=self._state.hist_re,
            hist_im=self._state.hist_im,
            tail=self._state.tail,
            max_abs=jnp.zeros((), dtype=jnp.float32),
        )

    def config_still_up_to_date(self) -> bool:
        """mtime staleness (sound-processor.cc:129-133)."""
        return self.config_file_timestamp == _mtime(self.config_file)

    # -- factory ----------------------------------------------------------

    @classmethod
    def create(
        cls, config_file: str, samplerate: int, channels: int
    ) -> Optional["SoundProcessor"]:
        """Compile a config for this stream shape; None on failure
        (SoundProcessor::Create, sound-processor.cc:34-50)."""
        try:
            compiled = compile_config_file(config_file, fsamp=samplerate)
        except Exception:
            return None
        del channels  # the config's /convolver/new channel counts govern
        return cls(compiled, config_file)

    # -- block pump -------------------------------------------------------

    def _resolve_inflight_state(self) -> None:
        """Fold a pending scheduler step's new state into ``_state``
        without emitting its audio (the emit stays queued)."""
        fl = self._inflight
        if fl is not None and fl.future is not None:
            state, y = fl.future.result()
            self._state = state
            fl.y, fl.future = y, None

    def _emit(self, fl: _Inflight) -> None:
        """Fetch one pipelined chunk to the host and hand it to its sink."""
        y = fl.y
        if fl.future is not None:
            state, y = fl.future.result()
            self._state = state
        if fl.qbits is not None and not _is_quantized(y):
            y = _jitted_quantize(y, fl.qbits)
        t0 = time.perf_counter()
        out = _unpack24(np.asarray(y))  # D2H (+ 3-byte lane reassembly)
        t1 = time.perf_counter()
        self.fetch_s += t1 - t0
        tb = out.shape[0]
        out = out.transpose(0, 2, 1).reshape(tb * self.fragm, -1)
        fl.sink(out[: fl.r])  # host FLAC/WAV encode
        self.encode_s += time.perf_counter() - t1

    def drain_pipeline(self) -> None:
        """Emit the pipelined chunk, if any.  Every non-bulk path that
        reads or writes convolution state or output order must call this
        first (fill_buffer does; close does)."""
        fl = self._inflight
        if fl is None:
            return
        self._inflight = None
        with self.latency.timer():
            self._emit(fl)

    def fill_buffer(self, source) -> int:
        """Read up to the missing part of the current block from
        ``source.read_float`` (sound-processor.cc:76-84).  Resets any
        processed-but-unwritten output (caller must drain first)."""
        self.drain_pipeline()
        needed = self.fragm - self._input_pos
        assert needed > 0, "call write_processed() before refilling"
        self._output_pos = -1
        data = source.read_float(needed)
        r = data.shape[0]
        if r:
            self._in_buf[self._input_pos : self._input_pos + r] = data
        self._input_pos += r
        return r

    def _process(self, quantize_bits: Optional[int] = None) -> None:
        """Zero-pad the tail, run the device step, fetch output
        (sound-processor.cc:98-127).

        ``quantize_bits``: device-quantize like the bulk path (halves
        the single-block D2H transfer).  Callers must pass None when
        the block may be split across a gapless handover — the two
        encoders can have different bit depths, so the split block must
        stay float."""
        assert self._inflight is None, "bulk pipeline must be drained first"
        if self._input_pos < self.fragm:
            self._in_buf[self._input_pos :] = 0.0
        x = self._in_buf.T[None]  # [1, Cin, fragm]
        with self.latency.timer():
            t0 = time.perf_counter()
            if self.scheduler is not None:
                fut = self.scheduler.submit(
                    self.bank, self._state, x, int(self._input_pos),
                    stream=id(self), quantize_bits=quantize_bits,
                )
                self._state, y = fut.result()
            else:
                self._state, y = _jitted_chunk(
                    self.bank, self._state, x, np.int32(self._input_pos)
                )
            if quantize_bits is not None and not _is_quantized(y):
                y = _jitted_quantize(y, quantize_bits)
            t1 = time.perf_counter()
            self.dispatch_s += t1 - t0
            self._out_buf = _unpack24(np.asarray(y[0])).T  # [fragm, Cout]
            self.fetch_s += time.perf_counter() - t1
        self._output_pos = 0

    def pump_chunk(self, source, sink, max_blocks: int,
                   quantize_bits: Optional[int] = None) -> int:
        """Fast path: read, convolve and write up to ``max_blocks`` full
        blocks in ONE device step (the replacement for the
        reference's one-block pump; used away from stream edges where
        the gapless partial-block semantics cannot trigger).

        Pipelined (depth 1): chunk N is dispatched to the device, then
        chunk N-1 — dispatched by the previous call — is fetched and
        encoded while N runs.  The reference's pull pump is strictly
        serial (convolve-file-handler.cc:370-424: read → convolve →
        write per block); here the device never idles during the host
        encode.  Ordering is FIFO: every non-bulk path drains first.

        ``quantize_bits``: when set, PCM-quantize on device and hand the
        sink integer frames (int16 for <=16 bits) instead of float32 —
        same values the encoder would produce, half the transfer.  The
        quantize is enqueued BEFORE the next step so its device work
        doesn't queue behind chunk N's convolution.

        Requires a clean block boundary (no partial input, no pending
        output).  Returns frames consumed from the source (0 = caller
        should use the single-block path)."""
        assert self._input_pos == 0 and self.pending_writes() == 0
        self._output_pos = -1
        b = self.fragm
        data = source.read_float(max_blocks * b)
        r = data.shape[0]
        if r == 0:
            self.drain_pipeline()
            return 0
        t = -(-r // b)
        padded = np.zeros((t * b, self.bank.ninp), dtype=np.float32)
        padded[:r] = data
        x = np.ascontiguousarray(padded.reshape(t, b, self.bank.ninp).transpose(0, 2, 1))
        with self.latency.timer():
            prev = self._inflight
            t0 = time.perf_counter()
            if self.scheduler is not None:
                if prev is not None and prev.future is not None:
                    # Chain the state (resolves once the scheduler
                    # thread finished chunk N-1) and enqueue its
                    # quantize ahead of chunk N (no-op when the
                    # scheduler's lone-stream path already fused it).
                    state, y = prev.future.result()
                    self._state = state
                    if prev.qbits is not None and not _is_quantized(y):
                        y = _jitted_quantize(y, prev.qbits)
                    prev.y, prev.future, prev.qbits = y, None, None
                fut = self.scheduler.submit(
                    self.bank, self._state, x, r, stream=id(self),
                    quantize_bits=quantize_bits,
                )
                self._inflight = _Inflight(fut, None, r, quantize_bits, sink)
            else:
                state, y = _jitted_chunk(
                    self.bank, self._state, x, np.int32(r))
                self._state = state  # async: chunk N queues on device
                if quantize_bits is not None:
                    y = _jitted_quantize(y, quantize_bits)
                self._inflight = _Inflight(None, y, r, None, sink)
            self.dispatch_s += time.perf_counter() - t0
            if prev is not None:
                self._emit(prev)  # D2H + encode of N-1 overlap chunk N
        return r

    def write_processed(self, sink, sample_count: int,
                        quantize_bits: Optional[int] = None) -> None:
        """Lazily process, then emit up to sample_count frames to
        ``sink(frames)``; partial writes leave the rest pending
        (sound-processor.cc:86-96).  ``quantize_bits`` only applies if
        this call triggers the processing (see _process)."""
        if self._output_pos < 0:
            self._process(quantize_bits)
        assert sample_count <= self.fragm - self._output_pos
        if sample_count > 0:
            sink(self._out_buf[self._output_pos : self._output_pos + sample_count])
        self._output_pos += sample_count
        if self._output_pos == self.fragm:
            self._input_pos = 0

    def drop_inflight(self) -> None:
        """Release a still-pipelined chunk without emitting it.  The
        chunk belongs to an aborted stream whose buffer died with it —
        resolving the future releases the scheduler's _SlotStates batch
        refs (the whole padded device batch) instead of pinning them in
        HBM until this object is garbage-collected."""
        fl, self._inflight = self._inflight, None
        if fl is not None and fl.future is not None:
            try:
                fl.future.result()
            except Exception:
                pass

    def reset(self) -> None:
        """Re-arm for a fresh stream before pooling; clears convolution
        state, the clipping monitor and the latency counters
        (sound-processor.cc:139-145)."""
        self.drop_inflight()
        self._state = init_state(self.bank)
        self._max_out = 0.0
        self._input_pos = 0
        self._output_pos = -1
        self._out_buf = None
        self.latency = LatencyStats()
        self.dispatch_s = self.fetch_s = self.encode_s = 0.0
