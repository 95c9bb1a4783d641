"""File handlers — per-open-file state machines.

Behavioral twins of file-handler.h, pass-through-handler.{h,cc} and
convolve-file-handler.{h,cc}: the convolving handler streams
decode -> TPU convolution -> FLAC encode into a ConversionBuffer,
with the reference's player-compatibility behaviors: end-of-file skip
zeros (convolve-file-handler.cc:102-126), prebuffer trigger past
header+64k (:134-149), verbatim FLAC-header copy with byte surgery
(:259-322, :438-482), dynamic size estimation (:183-200), clipping
stats (:169-180), premature-EOF close (:378-386), gapless handover
(:328-424).
"""

from __future__ import annotations

import dataclasses
import os
import struct
import threading
import time
from typing import Optional, TYPE_CHECKING

import numpy as np

from folve_tpu.audio.flac import FlacEncoder
from folve_tpu.audio.source import open_source
from folve_tpu.audio.types import Container
from folve_tpu.runtime.conversion_buffer import ConversionBuffer

if TYPE_CHECKING:
    from folve_tpu.runtime.filesystem import FolveFilesystem
    from folve_tpu.runtime.processor import SoundProcessor


class Status:
    OPEN = "open"
    IDLE = "idle"
    RETIRED = "retired"


@dataclasses.dataclass
class HandlerStats:
    """Status-page record (file-handler.h:31-51)."""

    filename: str = ""
    format: str = ""
    message: str = ""
    duration_seconds: float = 0.0
    access_progress: float = 0.0
    buffer_progress: float = 0.0
    status: str = Status.OPEN
    last_access: float = 0.0
    max_output_value: float = 0.0
    in_gapless: bool = False
    out_gapless: bool = False
    filter_dir: str = ""
    # Per-stream device-step latency summary; shown on the status page
    # only under -D / expensive_details (the reference's show_details,
    # status-server.cc:201-205).
    latency_summary: str = ""
    # Bulk-pump wall-time breakdown for THIS handler's stream (device
    # dispatch+wait / D2H fetch / host encode) — where serving time goes
    # (SURVEY §5 tracing; no reference analog, its pump is serial).
    pump_dispatch_s: float = 0.0
    pump_fetch_s: float = 0.0
    pump_encode_s: float = 0.0


@dataclasses.dataclass
class FileStat:
    """Mutable stat record served to the VFS layer."""

    st_size: int = 0
    st_mode: int = 0o100444
    st_mtime: float = 0.0
    st_atime: float = 0.0
    st_ctime: float = 0.0
    st_nlink: int = 1
    st_uid: int = 0
    st_gid: int = 0

    @classmethod
    def from_path(cls, path: str) -> "FileStat":
        st = os.stat(path)
        return cls(
            st_size=st.st_size,
            st_mode=st.st_mode,
            st_mtime=st.st_mtime,
            st_atime=st.st_atime,
            st_ctime=st.st_ctime,
            st_nlink=st.st_nlink,
            st_uid=st.st_uid,
            st_gid=st.st_gid,
        )


class FileHandler:
    """Abstract per-open-file interface (file-handler.h:59-86)."""

    def __init__(self, filter_dir: str):
        self._filter_dir = filter_dir

    def filter_dir(self) -> str:
        return self._filter_dir

    def read(self, size: int, offset: int) -> bytes:
        raise NotImplementedError

    def stat(self) -> FileStat:
        raise NotImplementedError

    def get_handler_status(self) -> HandlerStats:
        raise NotImplementedError

    def is_gapless(self) -> bool:
        return False

    def can_adopt_processor(self) -> bool:
        """True if a gapless handover could seed this handler's
        processor (fresh convolve handler that has not streamed yet).
        Used by the cache's prefer_gapless path to keep prewarmed
        successors instead of evicting them."""
        return False

    def passover_processor(self, processor: "SoundProcessor",
                           split_write=None) -> bool:
        return False

    def notify_passed_processor_unreferenced(self) -> None:
        pass

    def close(self) -> None:
        pass

    def release(self) -> None:
        """Teardown when evicted from the handler cache."""
        self.close()


class PassThroughHandler(FileHandler):
    """Direct pread passthrough for non-audio/unfiltered files
    (pass-through-handler.{h,cc})."""

    def __init__(self, underlying_file: str, filter_dir: str, info: HandlerStats):
        super().__init__(filter_dir)
        self._fd = os.open(underlying_file, os.O_RDONLY)
        self._stats = dataclasses.replace(info)
        self._file_size = os.fstat(self._fd).st_size
        self._max_accessed = 0
        if not self._stats.message:
            self._stats.message = "Not converting, just passing through."

    def read(self, size: int, offset: int) -> bytes:
        data = os.pread(self._fd, size, offset)
        end = offset + len(data)
        if end > self._max_accessed:
            self._max_accessed = end
        return data

    def stat(self) -> FileStat:
        fstat = os.fstat(self._fd)
        return FileStat(
            st_size=fstat.st_size,
            st_mode=fstat.st_mode,
            st_mtime=fstat.st_mtime,
            st_atime=fstat.st_atime,
            st_ctime=fstat.st_ctime,
            st_nlink=fstat.st_nlink,
            st_uid=fstat.st_uid,
            st_gid=fstat.st_gid,
        )

    def get_handler_status(self) -> HandlerStats:
        s = dataclasses.replace(self._stats)
        if self._file_size:
            s.access_progress = self._max_accessed / self._file_size
            s.buffer_progress = 1.0
        return s

    def close(self) -> None:
        if self._fd >= 0:
            os.close(self._fd)
            self._fd = -1


_FUDGE_OVERHANG = 512  # convolve-file-handler.cc:110
_WELL_BEYOND_HEADER = 64 << 10  # :141


class ConvolveFileHandler(FileHandler):
    """The workhorse: stream decode -> convolve (TPU) -> FLAC encode."""

    @classmethod
    def create(
        cls,
        fs: "FolveFilesystem",
        fs_path: str,
        filter_subdir: str,
        underlying_file: str,
    ) -> Optional["ConvolveFileHandler"]:
        """Probe the file and build the pipeline; None -> caller falls
        back to pass-through (convolve-file-handler.cc:54-93)."""
        source = open_source(underlying_file)
        partial = HandlerStats(
            filename=fs_path,
            filter_dir=filter_subdir,
            status=Status.OPEN,
            last_access=time.time(),
        )
        if source is None:
            partial.message = "Not a supported audio file; pass through."
            fs.record_handler_message(fs_path, partial.message)
            return None
        info = source.info
        partial.duration_seconds = info.duration_seconds
        partial.format = info.format_string()

        config_dir = os.path.join(fs.base_config_dir, filter_subdir)
        processor, errmsg = fs.processor_pool.get_or_create(
            config_dir, info.rate, info.channels, info.bits_per_sample
        )
        if processor is None:
            partial.message = errmsg or "No processor."
            fs.record_handler_message(fs_path, partial.message)
            source.close()
            return None
        if processor.input_channels != info.channels:
            # The resolved config declares a different channel count than
            # the file (e.g. only a stereo filter-<rate>.conf exists for a
            # mono file).  The reference would pump a mismatched
            # interleave into the convolver; we fall back cleanly.
            partial.message = (
                f"Filter expects {processor.input_channels} channels, "
                f"file has {info.channels}; pass through."
            )
            fs.record_handler_message(fs_path, partial.message)
            fs.processor_pool.return_processor(processor)
            source.close()
            return None
        return cls(fs, fs_path, filter_subdir, underlying_file, source, partial, processor)

    def __init__(self, fs, fs_path, filter_subdir, underlying_file, source, stats, processor):
        super().__init__(filter_subdir)
        self._fs = fs
        self._underlying_file = underlying_file
        self._source = source
        self._in_info = source.info
        self._base_stats = stats
        self._processor: Optional["SoundProcessor"] = processor
        # Pump-breakdown counters are cumulative per processor; snapshot
        # at acquisition so this handler reports only its own deltas
        # (matters across a gapless handover).
        self._pump_base = (processor.dispatch_s, processor.fetch_s,
                           processor.encode_s)
        self._error = False
        self._stats_lock = threading.Lock()
        self._input_frames_left = self._in_info.frames
        self._prewarmed = False  # successor prewarm fired (gapless)

        # Initial stat; the size is inflated by the oversize factor and
        # refined as output is produced (convolve-file-handler.cc:203-257).
        self._file_stat = FileStat.from_path(underlying_file)
        self._file_stat.st_mode &= ~0o222  # strip write bits (folve-main.cc:151)
        self._original_file_size = self._file_stat.st_size
        self._start_estimating_size = int(0.4 * self._file_stat.st_size)
        self._file_stat.st_size = int(self._file_stat.st_size * fs.file_oversize_factor)

        # Output format policy (convolve-file-handler.cc:237-251):
        # wav -> FLAC/24, ogg -> FLAC/16, flac stays flac at source depth
        # (capped at 24, our encoder's ceiling), aiff stays aiff
        # ("else: original format").
        from folve_tpu.audio.types import SampleCodec

        in_container = self._in_info.container
        if in_container == Container.WAV:
            out_bits = 24
        elif in_container == Container.OGG:
            # Vorbis is lossy float -> FLAC/16 (the reference's rule);
            # Ogg-FLAC is lossless, keep the source depth instead of
            # quantizing a 24-bit stream down to 16.
            if self._in_info.codec == SampleCodec.FLAC:
                out_bits = self._in_info.bits_per_sample
                if out_bits not in (16, 24):
                    out_bits = 24 if out_bits > 16 else 16
            else:
                out_bits = 16
        elif in_container == Container.AIFF:
            # AIFC compressed variants re-encode as plain PCM at the
            # nearest depth.  (The reference nominally keeps the full
            # input format here, but its libsndfile writers for the
            # coded variants patch chunk sizes with a close-time seek
            # that folve's append-only ConversionBuffer swallows — a
            # PCM header with exact sizes up front is strictly better.)
            out_bits = self._in_info.bits_per_sample
            if out_bits == 12:  # DWVW-12
                out_bits = 16
            elif out_bits not in (16, 24, 32):
                out_bits = 24
        elif in_container in (Container.AU, Container.W64, Container.CAF):
            # "else: original format" (convolve-file-handler.cc:249-251)
            # — these stay in their container at source depth.  Coded
            # telephony/ADPCM sample codecs decode to 16-bit range, so
            # 16-bit PCM out is already lossless (their declared
            # bits_per_sample is the coded width, e.g. 4 for ADPCM).
            if self._in_info.codec in (
                    SampleCodec.IMA_ADPCM, SampleCodec.MS_ADPCM,
                    SampleCodec.GSM610, SampleCodec.ALAW, SampleCodec.ULAW,
                    SampleCodec.G721_32, SampleCodec.G723_24,
                    SampleCodec.G723_40, SampleCodec.NMS_16,
                    SampleCodec.NMS_24, SampleCodec.NMS_32):
                out_bits = 16
            else:
                out_bits = self._in_info.bits_per_sample
                if out_bits not in (16, 24):
                    out_bits = 24
        elif in_container == Container.PAF:
            # PAF keeps 24-bit via the fmt-1 block packing; 8-bit
            # sources upconvert to 16 like the other legacy formats.
            out_bits = 24 if self._in_info.bits_per_sample == 24 else 16
        elif in_container in (Container.VOC, Container.IRCAM,
                              Container.NIST, Container.PVF,
                              Container.AVR, Container.MPC,
                              Container.WVE, Container.HTK):
            out_bits = 16  # these legacy containers are 16-bit PCM out
        elif (in_container == Container.MAT
              and self._in_info.bits_per_sample <= 16):
            # MAT stays in-container only at <=16-bit source depth (the
            # MAT5 writer emits int16); float/double/int32 wavedata
            # keeps the full path's depth via the FLAC/24 fallback
            # below instead of losing 8 bits.
            out_bits = 16
        else:
            out_bits = min(self._in_info.bits_per_sample, 24)
            if out_bits not in (8, 16, 24):
                out_bits = 24
        self._out_bits = out_bits
        self._copy_flac_header_verbatim = (
            in_container == Container.FLAC and not fs.workaround_flac_header_issue
        )

        self._buffer = ConversionBuffer(self)
        encoder_cls = None
        if in_container == Container.AIFF:
            from folve_tpu.audio.aiff import AiffStreamEncoder as encoder_cls
        elif in_container == Container.AU:
            from folve_tpu.audio.au import AuStreamEncoder as encoder_cls
        elif in_container == Container.W64:
            from folve_tpu.audio.w64 import W64StreamEncoder as encoder_cls
        elif in_container == Container.CAF:
            from folve_tpu.audio.caf import CafStreamEncoder as encoder_cls
        elif in_container == Container.VOC:
            from folve_tpu.audio.legacy import VocStreamEncoder as encoder_cls
        elif in_container == Container.IRCAM:
            from folve_tpu.audio.legacy import IrcamStreamEncoder as encoder_cls
        elif in_container == Container.NIST:
            from folve_tpu.audio.legacy import NistStreamEncoder as encoder_cls
        elif in_container == Container.PVF:
            from folve_tpu.audio.legacy import PvfStreamEncoder as encoder_cls
        elif in_container == Container.PAF:
            from folve_tpu.audio.legacy import PafStreamEncoder as encoder_cls
        elif in_container == Container.AVR:
            from folve_tpu.audio.legacy import AvrStreamEncoder as encoder_cls
        elif in_container == Container.MPC:
            from folve_tpu.audio.legacy import MpcStreamEncoder as encoder_cls
        elif (in_container == Container.WVE
              and processor.output_channels == 1
              and self._in_info.rate == 8000):
            # WVE is mono 8 kHz A-law by definition (the header has no
            # rate field); an upmixing filter — or a rate the container
            # cannot label — falls back to FLAC below.
            from folve_tpu.audio.legacy import WveStreamEncoder as encoder_cls
        elif in_container == Container.HTK and processor.output_channels == 1:
            from folve_tpu.audio.legacy import HtkStreamEncoder as encoder_cls
        elif in_container == Container.MAT and out_bits == 16:
            # >16-bit MAT sources keep their depth via FLAC/24 (the
            # MAT5 writer is int16-only; see out_bits selection above).
            from folve_tpu.audio.legacy import Mat5StreamEncoder as encoder_cls
        if encoder_cls is not None:
            self._encoder = encoder_cls(
                rate=self._in_info.rate,
                channels=processor.output_channels,
                bits=out_bits,
                total_frames=self._in_info.frames,
            )
        else:
            self._encoder = FlacEncoder(
                rate=self._in_info.rate,
                channels=processor.output_channels,
                bits=out_bits,
                blocksize=fs.flac_block_size,
                total_frames_hint=self._in_info.frames,
                # The served header's MD5 field is redacted/zero either
                # way (convolve-file-handler.cc:449-457): skip the
                # digest pass (~25% of encode on 24-bit material).
                md5=False,
            )
        self._setup_header()

    # ---------------------------------------------------------------- header

    def _setup_header(self) -> None:
        """Emit the output header into the buffer before any audio
        (SetOutputSoundfile, convolve-file-handler.cc:259-322)."""
        if self._copy_flac_header_verbatim:
            self._copy_flac_header()
            self._patch_streaminfo()
        else:
            # Carry string tags over for every regenerated header
            # (GenerateHeaderFromInputFile copies them for all formats,
            # convolve-file-handler.cc:484-495).
            metadata = self._read_input_tags()
            self._buffer.append(self._encoder.header(metadata))
        self._buffer.header_finished()

    def _read_input_tags(self) -> Optional[dict]:
        try:
            container = self._in_info.container
            if container == Container.WAV:
                from folve_tpu.audio.wav import read_wav_metadata

                return read_wav_metadata(self._underlying_file) or None
            if container == Container.AIFF:
                from folve_tpu.audio.aiff import read_aiff_metadata

                return read_aiff_metadata(self._underlying_file) or None
            if container == Container.OGG:
                from folve_tpu.audio.types import SampleCodec

                if self._in_info.codec == SampleCodec.FLAC:
                    from folve_tpu.audio.oggflac import read_ogg_flac_metadata

                    return read_ogg_flac_metadata(self._underlying_file) or None
                from folve_tpu.audio.ogg import read_ogg_comments

                return read_ogg_comments(self._underlying_file) or None
            if container == Container.CAF:
                from folve_tpu.audio.caf import read_caf_metadata

                return read_caf_metadata(self._underlying_file) or None
            if container == Container.MP3:
                from folve_tpu.audio.mp3 import read_mp3_metadata

                return read_mp3_metadata(self._underlying_file) or None
            if container == Container.FLAC:
                # Reached only in workaround_flac_header_issue mode (the
                # verbatim copy keeps the original VORBIS_COMMENT block).
                from folve_tpu.audio.flac import read_flac_metadata

                return read_flac_metadata(self._underlying_file) or None
        except Exception:
            pass
        return None

    def _copy_flac_header(self) -> None:
        """Verbatim metadata copy with MD5 redacted.  A source SEEKTABLE
        is REGENERATED instead of dropped (the reference drops it because
        re-encoded frame offsets are unknowable up front,
        convolve-file-handler.cc:459-464): placeholder points go out with
        the header, and real frame offsets are patched into the spill
        file as the encoder emits frames (_update_seektable)."""
        buf = self._buffer
        with open(self._underlying_file, "rb") as f:
            magic = f.read(4)
            if magic != b"fLaC":
                self._error = True
                return
            buf.append(b"fLaC")
            need_finish_padding = False
            while True:
                header = f.read(4)
                if len(header) < 4:
                    break
                is_last = bool(header[0] & 0x80)
                btype = header[0] & 0x7F
                blen = (header[1] << 16) | (header[2] << 8) | header[3]
                body = f.read(blen)
                need_finish_padding = False
                if btype == 0 and blen == 34:  # STREAMINFO: redact MD5
                    buf.append(header)
                    buf.append(body[:-16])
                    buf.append(bytes(16))
                elif btype == 3 and len(body) == blen and blen % 18 == 0:
                    # SEEKTABLE: same size, placeholder points
                    buf.append(header)
                    self._plan_seektable(body, buf.file_size())
                elif btype == 3:
                    # Malformed table (truncated / not 18-byte points):
                    # emitting fewer bytes than the copied header's blen
                    # would shift the whole stream — drop it like the
                    # reference does.
                    need_finish_padding = is_last
                else:
                    buf.append(header)
                    buf.append(body)
                if is_last:
                    break
            if need_finish_padding:  # last block was dropped: force finish
                buf.append(bytes([0x80 | 1, 0, 0, 0]))

    def _plan_seektable(self, src_body: bytes, body_off: int) -> None:
        """Emit a placeholder SEEKTABLE body (same point count as the
        source) and record which output frames should fill the slots.
        Placeholder points (sample 0xFF..FF) are spec-legal and patched
        in ascending order as frames stream out."""
        npoints = len(src_body) // 18
        self._buffer.append((b"\xff" * 8 + bytes(10)) * npoints)
        bs = self._encoder.blocksize
        total = max(1, self._in_info.frames)
        total_frames = -(-total // bs)
        targets = []
        for i in range(npoints):
            (sample,) = struct.unpack(">Q", src_body[i * 18 : i * 18 + 8])
            if sample == 0xFFFFFFFFFFFFFFFF:
                continue  # placeholder in the source too
            fidx = min(sample // bs, total_frames - 1)
            targets.append(int(fidx))
        self._seek_plan = sorted(set(targets))[:npoints]
        self._seektable_body_off = body_off
        self._seek_done = 0

    def _update_seektable(self) -> None:
        """Patch any seekpoints whose target frame has been emitted.
        Byte offsets are relative to the first audio byte, exactly as
        the spec defines them."""
        plan = getattr(self, "_seek_plan", None)
        if not plan or self._seek_done >= len(plan):
            return
        enc = self._encoder
        if enc is None:
            return
        nframes = enc.frame_count()
        bs = enc.blocksize
        total = self._in_info.frames
        while self._seek_done < len(plan):
            fidx = plan[self._seek_done]
            if fidx >= nframes:
                break
            nsamples = min(bs, max(0, total - fidx * bs)) or bs
            point = struct.pack(
                ">QQH", fidx * bs, enc.frame_offset(fidx), nsamples
            )
            self._buffer.write_bytes_at(
                point, self._seektable_body_off + self._seek_done * 18
            )
            self._seek_done += 1

    def _patch_streaminfo(self) -> None:
        """Byte surgery on the copied STREAMINFO: our encoder's block
        size, unknown frame sizes, output channels/bits
        (convolve-file-handler.cc:291-306)."""
        buf = self._buffer
        bs = self._encoder.blocksize
        buf.write_char_at((bs >> 8) & 0xFF, 8)
        buf.write_char_at(bs & 0xFF, 9)
        buf.write_char_at((bs >> 8) & 0xFF, 10)
        buf.write_char_at(bs & 0xFF, 11)
        for i in range(12, 18):  # min/max framesize: unknown
            buf.write_char_at(0, i)
        bits = self._out_bits
        channels = self._encoder.channels
        buf.write_char_at(
            ((self._in_info.rate & 0x0F) << 4)
            | ((channels - 1) << 1)
            | (((bits - 1) & 0x10) >> 4),
            20,
        )
        # Byte 21: bps-1 low nibble + total-samples top nibble.  The
        # verbatim-copied source byte is only valid when the output
        # depth equals the source depth; a 12/20/32-bit source capped
        # to 24 would otherwise declare a depth the frames don't carry.
        buf.write_char_at(
            (((bits - 1) & 0x0F) << 4) | ((self._in_info.frames >> 32) & 0x0F),
            21,
        )


    # ----------------------------------------------------------------- read

    def read(self, size: int, offset: int) -> bytes:
        if self._error:
            raise OSError(5, "handler in error state")
        current_filesize = self._buffer.file_size()
        read_horizon = offset + size
        # End-of-file skip heuristic: silently serve zeros instead of
        # convolving the whole file (convolve-file-handler.cc:107-126).
        if (
            current_filesize < offset
            and read_horizon + _FUDGE_OVERHANG >= self._file_stat.st_size
        ):
            pretended = min(size, self._file_stat.st_size - offset)
            return bytes(max(pretended, 0))

        result = self._buffer.read(size, offset)

        # Prebuffer only when clearly past the header (:134-149).
        well_beyond = self._buffer.header_size() + _WELL_BEYOND_HEADER
        if (
            read_horizon > well_beyond
            and read_horizon + self._fs.pre_buffer_size > current_filesize
            and not self._buffer.is_file_complete()
        ):
            self._fs.request_prebuffer(self._buffer)
        return result

    # ----------------------------------------------------------------- stat

    def stat(self) -> FileStat:
        """Dynamic size estimation: extrapolate from the compression
        ratio so far, only ever growing (convolve-file-handler.cc:183-200)."""
        current = self._buffer.file_size()
        if current > self._start_estimating_size:
            frames_done = self._in_info.frames - self.frames_left()
            if frames_done > 0:
                estimated_end = self._in_info.frames / frames_done
                new_size = int(estimated_end * current) + 65535
                if new_size > self._file_stat.st_size:
                    self._file_stat.st_size = new_size
        return self._file_stat

    # --------------------------------------------------------------- status

    def get_handler_status(self) -> HandlerStats:
        file_size = self._buffer.file_size()
        max_access = self._buffer.max_accessed()
        # Snapshot once: close() on the pump thread nulls _processor
        # concurrently with status polls.
        p = self._processor
        if p is not None:
            self._base_stats.max_output_value = p.max_output_value()
        if self._base_stats.max_output_value > 1.0:
            # (The reference stamps this after taking the snapshot so it
            # only shows on the *next* poll, convolve-file-handler.cc:169-180;
            # we stamp before — the message is the point.)
            self._base_stats.message = (
                f"Output clipping! (max={self._base_stats.max_output_value:.3f}; "
                f"Multiply gain with <= {1.0 / self._base_stats.max_output_value:.5f}"
                f" in {p.config_file if p else 'filter'})"
            )
        stats = dataclasses.replace(self._base_stats)
        if p is not None and p.latency.count:
            stats.latency_summary = p.latency.summary()
        if p is not None:
            base = self._pump_base
            stats.pump_dispatch_s = p.dispatch_s - base[0]
            stats.pump_fetch_s = p.fetch_s - base[1]
            stats.pump_encode_s = p.encode_s - base[2]
        frames_done = self._in_info.frames - self.frames_left()
        if frames_done == 0 or self._in_info.frames == 0 or file_size == 0:
            stats.buffer_progress = 0.0
            stats.access_progress = 0.0
        else:
            stats.buffer_progress = frames_done / self._in_info.frames
            stats.access_progress = stats.buffer_progress * max_access / file_size
        return stats

    def frames_left(self) -> int:
        with self._stats_lock:
            return self._input_frames_left

    # -------------------------------------------------------------- gapless

    def is_gapless(self) -> bool:
        return self._base_stats.in_gapless or self._base_stats.out_gapless

    def can_adopt_processor(self) -> bool:
        # Racy read is fine: passover_processor re-checks under the
        # pump lock; this only steers the cache's evict-vs-keep choice.
        return self._processor is not None and not self.has_started()

    def has_started(self) -> bool:
        return self._in_info.frames != self._input_frames_left

    def passover_processor(self, donor: "SoundProcessor",
                           split_write=None) -> bool:
        """Adopt the previous track's processor so its partially-filled
        block is finished with our beginning (convolve-file-handler.cc:328-351).

        The whole adoption — started-check, completing the donor's split
        block with our head, the donor's own partial output write
        (``split_write``), publishing the processor — runs under OUR
        conversion buffer's lock, the same lock that serializes this
        file's pump (``ConversionBuffer.fill_until``).  Without it a
        concurrent reader of this file can observe the donor mid-split
        (full input buffer, no pending output) and trip ``fill_buffer``'s
        invariant — or worse, trigger the split block's processing with
        ITS sink and route the previous track's tail into our stream.
        Lock order is acyclic: a donor only ever locks its strictly
        alphabetically-later successor."""
        with self._buffer.pump_lock:
            if self.has_started():
                return False
            assert self._processor is not None
            if (
                donor.config_file != self._processor.config_file
                or donor.config_file_timestamp != self._processor.config_file_timestamp
            ):
                return False
            self._fs.processor_pool.return_processor(self._processor)
            self._pump_base = (donor.dispatch_s, donor.fetch_s, donor.encode_s)
            if not donor.is_input_buffer_complete():
                with self._stats_lock:
                    self._input_frames_left -= donor.fill_buffer(self._source)
            if split_write is not None:
                split_write()
            self._processor = donor
            self._base_stats.in_gapless = True
            return True

    def notify_passed_processor_unreferenced(self) -> None:
        self._fs.request_prebuffer(self._buffer)

    # ------------------------------------------------------------- the pump

    # Blocks per bulk device dispatch on the bulk path (away from stream
    # edges); one block per call near EOF keeps gapless semantics exact.
    # Fewer blocks per dispatch pay the per-dispatch overhead more often;
    # more blocks make each blocking read wait longer.  Not measured on
    # the GPU yet.
    CHUNK_BLOCKS = 8

    def add_more_sound_data(self) -> bool:
        """Produce the next chunk of encoded output
        (AddMoreSoundData, convolve-file-handler.cc:370-424)."""
        if not self._input_frames_left:
            return False
        proc = self._processor
        if proc.pending_writes() > 0:
            proc.write_processed(self._write_frames, proc.pending_writes())
            return self._input_frames_left != 0

        # Bulk fast path: convolve as many FULL blocks as remain before
        # the stream edge in one device step (up to CHUNK_BLOCKS).  The
        # gapless partial-block handover can only trigger on the final
        # (possibly partial) block, which this path always leaves for
        # the single-block pump below: every full block except — when
        # the file length is an exact block multiple — the last one
        # (the stream must still end through fill_buffer so EOF /
        # close() semantics fire).
        left = self._input_frames_left
        # Successor prewarm: once the stream nears its end, build the
        # alphabetic successor's handler in the background — file open,
        # format probe, processor checkout and header encode all happen
        # BEFORE the handover instead of inside it.  The reference only
        # prebuffers the next track at handover time
        # (convolve-file-handler.cc:414); starting earlier removes the
        # handler-construction stall from the gapless seam.  The prewarm
        # must not read audio (a started successor refuses the
        # handover, passover_processor's has_started check).
        if (
            self._fs.gapless_processing
            and not self._prewarmed
            and left <= 4 * self.CHUNK_BLOCKS * proc.fragm
        ):
            self._prewarmed = True
            threading.Thread(
                target=self._prewarm_successor,
                name="folve-gapless-prewarm",
                daemon=True,
            ).start()
        avail = left // proc.fragm - (0 if left % proc.fragm else 1)
        chunk = min(self.CHUNK_BLOCKS, avail)
        if chunk >= 1:
            # Power-of-two chunks only: bounds distinct jitted shapes to
            # log2(CHUNK_BLOCKS)+1 per bank (compiles are expensive).
            chunk = 1 << (chunk.bit_length() - 1)
        if (
            chunk >= 1
            and proc.pending_writes() == 0
            and not proc.is_input_buffer_complete()
        ):
            r = proc.pump_chunk(
                self._source, self._write_frames, chunk,
                # Device quantization only up to 24 bits: at 32 the clip
                # bound 2^31-1 is not representable in float32 (rounds
                # to 2^31 and the int cast could overflow).
                quantize_bits=self._out_bits if self._out_bits <= 24 else None,
            )
            if r:
                with self._stats_lock:
                    self._input_frames_left -= r
                return self._input_frames_left != 0

        r = proc.fill_buffer(self._source)
        if r == 0:
            self._base_stats.message = "Premature EOF in input file."
            with self._stats_lock:
                self._input_frames_left = 0
            self.close()
            return False
        with self._stats_lock:
            self._input_frames_left -= r

        if (
            not self._input_frames_left
            and not proc.is_input_buffer_complete()
            and self._fs.gapless_processing
        ):
            # Split block: may carry the next track's head — stays float
            # so each side's encoder quantizes at its own bit depth.  On
            # a successful handover the write runs INSIDE
            # passover_processor, under the successor's pump lock, so no
            # reader of the next file can process the split block with
            # its own sink first.
            def split_write():
                proc.write_processed(self._write_frames, r)

            passed, next_path, next_handler = self._try_gapless_handover(
                proc, split_write)
            if passed:
                self._base_stats.out_gapless = True
                self._save_output_values()
                self._processor = None  # ownership moved
                self.close()
                next_handler.notify_passed_processor_unreferenced()
            else:
                split_write()
            if next_handler is not None:
                self._fs.close_handler(next_path, next_handler)
        else:
            proc.write_processed(
                self._write_frames, r,
                quantize_bits=self._out_bits if self._out_bits <= 24 else None,
            )
        if self._input_frames_left == 0:
            self.close()
        return self._input_frames_left != 0

    def _find_successor(self) -> Optional[str]:
        """Alphabetic successor with the same suffix in this directory
        (convolve-file-handler.cc:358-368, :398-400)."""
        filename = self._base_stats.filename
        slash = filename.rfind("/")
        if slash < 0:
            return None
        fs_dir = filename[: slash + 1]
        dot = filename.rfind(".")
        suffix = filename[dot:] if dot > slash else ""
        dirset = self._fs.list_directory(fs_dir, suffix)
        for cand in sorted(dirset):
            if cand > filename:
                return cand
        return None

    def _prewarm_successor(self) -> None:
        """Background: create (and immediately unpin) the successor's
        handler so the gapless handover finds it ready in the cache."""
        try:
            next_path = self._find_successor()
            if next_path is None:
                return
            h = self._fs.get_or_create_handler(next_path, want_gapless=True)
            if h is not None:
                self._fs.close_handler(next_path, h)
        except Exception:
            pass  # best-effort; the handover path builds it if need be

    def _try_gapless_handover(self, proc, split_write):
        """Find the alphabetic successor with the same suffix and offer it
        our processor (convolve-file-handler.cc:390-416)."""
        next_path = self._find_successor()
        if next_path is None:
            return False, None, None
        next_handler = self._fs.get_or_create_handler(next_path, want_gapless=True)
        if next_handler is None:
            return False, None, None
        passed = next_handler.passover_processor(proc, split_write=split_write)
        if not passed:
            # The cached successor refused — it already streamed, or its
            # prewarmed processor went config-stale.  Evict it and retry
            # ONCE with a freshly-built handler: the reference always
            # hands over to a fresh one (its find_and_pin evicts every
            # idle non-gapless handler); ours keeps adoptable prewarmed
            # handlers, so the stale case needs this explicit rebuild.
            key = self._fs.cache_key(next_handler.filter_dir(), next_path)
            self._fs.close_handler(next_path, next_handler)
            next_handler = None
            if self._fs.open_file_cache.evict_unreferenced(key):
                next_handler = self._fs.get_or_create_handler(
                    next_path, want_gapless=True)
                if next_handler is not None:
                    passed = next_handler.passover_processor(
                        proc, split_write=split_write)
        return passed, next_path, next_handler

    # ---------------------------------------------------------------- close

    def _write_frames(self, frames: np.ndarray) -> None:
        if np.issubdtype(frames.dtype, np.integer):
            # Device-quantized bulk-pump output (processor.pump_chunk).
            self._buffer.append(self._encoder.write_int(frames))
        else:
            self._buffer.append(self._encoder.write_float(frames))
        # Patch newly-known seekpoints HERE, on the pump thread: the
        # encoder's frame-offset list and handle are only ever touched
        # by the thread that writes/finishes the encode, so no lock is
        # needed (a read()-side patch would race the native push_back).
        self._update_seektable()

    def _save_output_values(self) -> None:
        if self._processor is not None:
            self._base_stats.max_output_value = self._processor.max_output_value()
            if self._processor.latency.count:
                self._base_stats.latency_summary = self._processor.latency.summary()
            p, base = self._processor, self._pump_base
            self._base_stats.pump_dispatch_s = p.dispatch_s - base[0]
            self._base_stats.pump_fetch_s = p.fetch_s - base[1]
            self._base_stats.pump_encode_s = p.encode_s - base[2]
            self._processor.reset_max_values()

    def close(self) -> None:
        """Finish encode, return processor, log mispredictions
        (convolve-file-handler.cc:504-535)."""
        if self._encoder is None:
            return
        if self._processor is not None:
            # A chunk may still sit in the bulk pipeline (eviction /
            # abort paths); emit it so the encoded stream stays
            # consistent before finish().
            self._processor.drain_pipeline()
        with self._stats_lock:
            self._input_frames_left = 0
        self._save_output_values()
        self._fs.processor_pool.return_processor(self._processor)
        self._processor = None
        self._buffer.append(self._encoder.finish())
        self._update_seektable()  # final points (incl. the last frame)
        self._encoder.close()
        self._encoder = None
        if self._source is not None:
            self._source.close()
            self._source = None
        factor = (
            self._buffer.file_size() / self._original_file_size
            if self._original_file_size
            else 0.0
        )
        if factor > self._fs.file_oversize_factor:
            self._fs.log(
                f"File larger than prediction: {self._base_stats.filename} "
                f"(x{factor:.2f}; adapt prediction with -O {factor:.2f})"
            )

    def release(self) -> None:
        """Full teardown when evicted from the handler cache."""
        self._buffer.notify_file_complete()
        self._fs.quit_buffering(self._buffer)
        self.close()
        self._buffer.close()
