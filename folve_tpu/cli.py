"""Command-line interface.

``folve-tpu mount`` mirrors the reference binary's flag set
(folve-main.cc:330-361: -C -i -p -r -g -b -O -P -t -D -R -f) on top of
the native FUSE transport; ``serve`` runs the same virtual filesystem
over HTTP instead (no kernel module needed); ``convolve`` is the
offline one-shot pipeline (SURVEY.md §7.4's minimum end-to-end slice).
"""

from __future__ import annotations

import argparse
import logging
import os
import sys
import time


def _add_common_fs_flags(p: argparse.ArgumentParser) -> None:
    p.add_argument("-C", "--config-dir", required=True, help="filter configuration directory")
    p.add_argument("-i", "--initial-filter", default="", help="initial filter subdir")
    p.add_argument("-p", "--port", type=int, default=0, help="status/control HTTP port")
    p.add_argument("-r", "--refresh", type=int, default=10, help="status page meta refresh seconds (-1 off)")
    p.add_argument("-g", "--gapless", action="store_true", help="gapless processing")
    p.add_argument(
        "-b", "--prebuffer", type=int, default=128,
        help="prebuffer size KiB (64..16384, reference folve-main.cc:44-45)",
    )
    p.add_argument("-O", "--oversize-factor", type=float, default=1.25, help="file size oversize prediction factor")
    p.add_argument("-P", "--pid-file", default="", help="write pid file")
    p.add_argument("-t", "--toplevel-filter", action="store_true", help="toplevel directories are filter names")
    p.add_argument("-D", "--debug", action="store_true", help="debug logging")
    p.add_argument("-R", "--readdir-dump", default="", help="readdir/stat trace log file")
    p.add_argument("--flac-block-size", type=int, default=4096, help="FLAC encoder block size")
    p.add_argument(
        "--flac-threads", type=int, default=0,
        help="parallel codec workers: FLAC frame encode/decode AND Ogg "
        "Vorbis packet decode share this pool (0 = auto: cores capped "
        "at 8, 1 = serial; output is identical at any setting)",
    )
    p.add_argument(
        "--workaround-flac-header", action="store_true",
        help="never copy FLAC headers verbatim; always regenerate "
        "(the reference's libsndfile-version workaround, folve-main.cc:295-300)",
    )
    p.add_argument(
        "--freq-parallel", type=int, default=1, metavar="N",
        help="multi-chip: shard each stream's frequency bins over N "
        "devices (remaining devices data-parallel over streams); "
        "requires >1 JAX device",
    )


def _build_fs(args, underlying_dir: str):
    import jax

    from folve_tpu.runtime.filesystem import FolveFilesystem

    if args.debug:
        logging.basicConfig(level=logging.DEBUG)
    prebuffer = args.prebuffer
    if prebuffer < 0:
        prebuffer = 0  # "-b -1" disables prebuffering (usage text)
    elif prebuffer and not (64 <= prebuffer <= 16384):
        sys.exit("-b prebuffer must be within 64..16384 KiB (or -1 to disable)")
    mesh = None
    freq_parallel = getattr(args, "freq_parallel", 1)
    n_dev = jax.device_count()
    if n_dev > 1:
        from folve_tpu.parallel.serving import make_serving_mesh

        try:
            mesh = make_serving_mesh(n_dev, freq_parallel=freq_parallel)
        except ValueError as e:
            sys.exit(f"--freq-parallel: {e}")
        print(
            f"serving mesh: {mesh.shape['stream']} stream x "
            f"{mesh.shape['freq']} freq devices"
        )
    elif freq_parallel > 1:
        sys.exit(f"--freq-parallel {freq_parallel} needs >1 device, have {n_dev}")
    fs = FolveFilesystem(serving_mesh=mesh)
    fs.underlying_dir = os.path.realpath(underlying_dir)
    fs.base_config_dir = os.path.realpath(args.config_dir)
    fs.initial_filter_config = args.initial_filter
    fs.gapless_processing = args.gapless
    fs.toplevel_dir_is_filter = args.toplevel_filter
    fs.pre_buffer_size = prebuffer << 10
    fs.file_oversize_factor = args.oversize_factor
    fs.flac_block_size = args.flac_block_size
    if getattr(args, "flac_threads", 0):
        from folve_tpu.audio.flac import set_encoder_threads

        set_encoder_threads(args.flac_threads)
    fs.workaround_flac_header_issue = getattr(args, "workaround_flac_header", False)
    if not fs.check_initialized():
        sys.exit("underlying dir or config dir missing / not a directory")
    fs.setup_initial_config()
    if args.pid_file:
        with open(args.pid_file, "w") as f:
            f.write(str(os.getpid()))
    return fs


def _build_vfs(args, fs):
    from folve_tpu.server.status import StatusServer
    from folve_tpu.server.vfs import FolveVfs, ReaddirLogger

    status = StatusServer(fs)
    status.meta_refresh = args.refresh
    status.expensive_details = args.debug
    if args.port:
        if status.start(args.port):
            print(f"status server on http://localhost:{status.port}/")
        else:
            print(f"cannot bind status server to port {args.port}", file=sys.stderr)
    rlog = ReaddirLogger(args.readdir_dump) if args.readdir_dump else None
    return FolveVfs(fs, status_server=status, readdir_logger=rlog)


def cmd_mount(args) -> int:
    from folve_tpu.fuse.mount import daemonize, mount_and_serve

    if getattr(args, "fuse_debug", False):
        args.foreground = True  # reference: -d implies -f
    if not args.foreground:
        # Daemonize BEFORE building the filesystem so no helper thread
        # (status server, scheduler, prefetcher) is lost in the fork
        # (the reference daemonizes inside fuse_main, folve-main.cc:539).
        # Everything cheaply checkable is validated FIRST so bad
        # invocations fail loudly with a nonzero exit instead of
        # vanishing into the daemon; deeper failures (mount syscall,
        # mesh setup) land in syslog after the fork.
        args.underlying_dir = os.path.realpath(args.underlying_dir)
        args.mount_point = os.path.realpath(args.mount_point)
        args.config_dir = os.path.realpath(args.config_dir)
        if args.pid_file:
            args.pid_file = os.path.realpath(args.pid_file)
        for label, d in (
            ("underlying dir", args.underlying_dir),
            ("mount point", args.mount_point),
            ("config dir", args.config_dir),
        ):
            if not os.path.isdir(d):
                sys.exit(f"{label} {d!r} is not a directory")
        if args.prebuffer >= 0 and args.prebuffer and not (
            64 <= args.prebuffer <= 16384
        ):
            sys.exit("-b prebuffer must be within 64..16384 KiB (or -1 to disable)")
        daemonize()
    fs = _build_fs(args, args.underlying_dir)
    vfs = _build_vfs(args, fs)
    if getattr(args, "fuse_debug", False):
        logging.getLogger("folve_tpu.fuse").setLevel(logging.DEBUG)
        logging.basicConfig(level=logging.DEBUG)
    return mount_and_serve(
        vfs, args.mount_point, options=getattr(args, "mount_options", "")
    )


def cmd_serve(args) -> int:
    """HTTP frontend: the virtual filesystem over plain HTTP."""
    fs = _build_fs(args, args.underlying_dir)
    vfs = _build_vfs(args, fs)
    from folve_tpu.server.httpfs import serve_http_files

    return serve_http_files(vfs, args.files_port)


def _output_encoder(out: str, rate: int, channels: int, in_bits: int,
                    total_frames: int):
    """Streaming encoder for the offline CLI, chosen by extension."""
    ext = os.path.splitext(out)[1].lower()
    bits = min(in_bits, 24)
    if bits not in (8, 16, 24):
        bits = 24
    pcm_bits = max(16, bits)
    if ext == ".wav":
        from folve_tpu.audio.wav import WavStreamEncoder

        return WavStreamEncoder(rate, channels, 24, total_frames)
    if ext in (".aiff", ".aif"):
        from folve_tpu.audio.aiff import AiffStreamEncoder

        return AiffStreamEncoder(rate, channels, pcm_bits, total_frames)
    if ext in (".au", ".snd"):
        from folve_tpu.audio.au import AuStreamEncoder

        return AuStreamEncoder(rate, channels, pcm_bits, total_frames)
    if ext == ".w64":
        from folve_tpu.audio.w64 import W64StreamEncoder

        return W64StreamEncoder(rate, channels, pcm_bits, total_frames)
    if ext == ".caf":
        from folve_tpu.audio.caf import CafStreamEncoder

        return CafStreamEncoder(rate, channels, pcm_bits, total_frames)
    if ext == ".voc":
        from folve_tpu.audio.legacy import VocStreamEncoder

        return VocStreamEncoder(rate, channels, 16, total_frames)
    if ext in (".sf", ".ircam"):
        from folve_tpu.audio.legacy import IrcamStreamEncoder

        return IrcamStreamEncoder(rate, channels, 16, total_frames)
    if ext in (".nist", ".sph"):
        from folve_tpu.audio.legacy import NistStreamEncoder

        return NistStreamEncoder(rate, channels, 16, total_frames)
    if ext == ".pvf":
        from folve_tpu.audio.legacy import PvfStreamEncoder

        return PvfStreamEncoder(rate, channels, 16, total_frames)
    if ext == ".paf":
        from folve_tpu.audio.legacy import PafStreamEncoder

        return PafStreamEncoder(rate, channels, 16, total_frames)
    if ext == ".avr":
        from folve_tpu.audio.legacy import AvrStreamEncoder

        return AvrStreamEncoder(rate, channels, 16, total_frames)
    if ext == ".mpc":
        from folve_tpu.audio.legacy import MpcStreamEncoder

        return MpcStreamEncoder(rate, channels, 16, total_frames)
    if ext == ".wve" and channels == 1 and rate == 8000:
        # The Psion WVE header carries no sample-rate field (readers
        # assume 8 kHz A-law mono); any other rate would be silently
        # mislabeled on readback — fall through to FLAC instead, like
        # the other impossible-container combinations.
        from folve_tpu.audio.legacy import WveStreamEncoder

        return WveStreamEncoder(rate, channels, 16, total_frames)
    if ext == ".htk" and channels == 1:
        from folve_tpu.audio.legacy import HtkStreamEncoder

        return HtkStreamEncoder(rate, channels, 16, total_frames)
    if ext == ".mat":
        from folve_tpu.audio.legacy import Mat5StreamEncoder

        return Mat5StreamEncoder(rate, channels, 16, total_frames)
    from folve_tpu.audio.flac import FlacEncoder

    return FlacEncoder(rate, channels, bits=bits,
                       total_frames_hint=total_frames)


def cmd_convolve(args) -> int:
    """Offline one-shot: streaming decode -> device convolve ->
    streaming encode.  Constant memory in the stream length (the runtime's
    serving path streams the same way)."""
    import numpy as np

    from folve_tpu.audio.source import open_source
    from folve_tpu.engine import chunk_step, init_state
    from folve_tpu.filters.compiler import compile_config_file
    from folve_tpu.filters.resolve import resolve_filter_config

    import jax

    if getattr(args, "flac_threads", 0):
        from folve_tpu.audio.flac import set_encoder_threads

        set_encoder_threads(args.flac_threads)
    t0 = time.time()
    src = open_source(args.input)
    if src is None:
        sys.exit(f"not a supported audio file: {args.input}")
    info = src.info
    config_dir = os.path.join(args.config_dir, args.initial_filter)
    conf = resolve_filter_config(
        config_dir, info.rate, info.channels, info.bits_per_sample
    )
    if conf is None:
        sys.exit(f"no filter config in {config_dir} for {info.rate}/{info.channels}")
    compiled = compile_config_file(conf, fsamp=info.rate)
    for w in compiled.warnings:
        print(f"warning: {w}", file=sys.stderr)
    bank = compiled.bank
    b = bank.fragm
    enc = _output_encoder(args.output, info.rate, bank.nout,
                          info.bits_per_sample, info.frames)
    state = init_state(bank)
    step = jax.jit(chunk_step)
    chunk = max(1, args.chunk_blocks)
    max_out = 0.0
    done = 0
    with open(args.output, "wb") as f:
        f.write(enc.header())
        while True:
            data = src.read_float(chunk * b)
            n = data.shape[0]
            if n == 0:
                break
            padded = np.zeros((chunk * b, bank.ninp), dtype=np.float32)
            padded[:n, : min(data.shape[1], bank.ninp)] = (
                data[:, : bank.ninp]
            )
            xs = np.ascontiguousarray(
                padded.reshape(chunk, b, bank.ninp).transpose(0, 2, 1)
            )
            state, y = step(bank, state, xs, n)
            y = np.asarray(y).transpose(0, 2, 1).reshape(-1, bank.nout)[:n]
            max_out = max(max_out, float(np.max(np.abs(y))) if n else 0.0)
            f.write(enc.write_float(y))
            done += n
        f.write(enc.finish())
        # A complete file is seekable: patch the real MD5 and min/max
        # frame sizes into STREAMINFO (the FUSE serving path can't —
        # its header streams out first — but offline output should
        # survive `flac -t`).
        from folve_tpu.audio.flac import FlacEncoder

        if isinstance(enc, FlacEncoder):
            f.seek(FlacEncoder.STREAMINFO_FILE_OFFSET)
            f.write(enc.streaminfo(with_md5=True))
    src.close()
    if max_out > 1.0:
        print(
            f"warning: output clipping (max={max_out:.3f}; multiply gain "
            f"with <= {1.0 / max_out:.5f} in {conf})",
            file=sys.stderr,
        )
    dt = time.time() - t0
    audio_sec = done / info.rate
    ratio = audio_sec / dt if dt > 0 else 0.0
    speed = f"{ratio:.1f}" if ratio < 10 else f"{ratio:.0f}"
    print(
        f"convolved {audio_sec:.1f}s of audio in {dt:.2f}s "
        f"({speed}x realtime) -> {args.output}"
    )
    return 0


def cmd_info(args) -> int:
    """Inspect an audio file or a filter config."""
    if args.path.endswith(".conf"):
        from folve_tpu.filters import parse_config

        spec = parse_config(args.path)
        conv = spec.convolver
        if conv is None:
            print("no /convolver/new declaration (pass-through candidate)")
        else:
            from folve_tpu.engine.constants import derive_fragm, num_partitions

            fragm = derive_fragm(conv.size)
            print(
                f"convolver: {conv.ninp}x{conv.nout}, size {conv.size} taps, "
                f"fragm {fragm}, {num_partitions(conv.size, fragm)} partitions"
            )
            print(f"{len(spec.ops)} impulse op(s)")
        for w in spec.warnings:
            print(f"warning: {w}")
        return 0
    from folve_tpu.audio import read_audio_info

    info = read_audio_info(args.path)
    print(
        f"{info.container.value}: {info.rate} Hz, {info.channels} ch, "
        f"{info.bits_per_sample} bit, {info.frames} frames "
        f"({info.duration_seconds:.2f}s)"
    )
    return 0


def cmd_filters(args) -> int:
    """List selectable filters and their per-rate configs."""
    from folve_tpu.filters import list_config_dirs

    base = os.path.realpath(args.config_dir)
    for name in sorted(list_config_dirs(base)):
        label = name if name else "(pass-through)"
        print(label)
        if name:
            d = os.path.join(base, name)
            for conf in sorted(os.listdir(d)):
                if conf.startswith("filter-") and conf.endswith(".conf"):
                    print(f"  {conf}")
    return 0


def cmd_make_demo_filters(args) -> int:
    from folve_tpu.tools.make_demo_filters import make_all

    make_all(args.target)
    print(f"demo filters written to {args.target}")
    return 0


_SUBCOMMANDS = (
    "mount", "serve", "convolve", "make-demo-filters", "info", "filters",
)


def main(argv=None) -> int:
    if argv is None:
        argv = sys.argv[1:]
    from folve_tpu.utils.compile_cache import configure_compile_cache

    configure_compile_cache()
    # Reference-compatible invocation: `folve [options] src mnt` with no
    # subcommand (folve-main.cc:330-361).  The main parser has no
    # options of its own, so in subcommand form the subcommand is always
    # the first positional-looking token — decide on that token alone.
    # (Scanning the whole argv would mis-parse a mount whose directory
    # happens to be NAMED like a subcommand, e.g. `folve-tpu -f /music
    # serve`.)
    head = next((a for a in argv if not a.startswith("-")), None)
    if argv and head is not None and head not in _SUBCOMMANDS:
        argv = ["mount"] + list(argv)
    parser = argparse.ArgumentParser(
        prog="folve-tpu",
        description="on-the-fly FIR filter convolution framework",
    )
    sub = parser.add_subparsers(dest="command", required=True)

    p = sub.add_parser("mount", help="mount the convolving filesystem (FUSE)")
    _add_common_fs_flags(p)
    p.add_argument("-f", "--foreground", action="store_true", help="stay in foreground")
    p.add_argument(
        "-d", "--fuse-debug", action="store_true",
        help="trace raw FUSE operations (reference -d)",
    )
    p.add_argument(
        "-o", "--mount-options", default="",
        help="comma-separated fuse mount options: allow_other, "
        "default_permissions, ro (default), rw; unknown options are "
        "ignored with a warning (reference folve-main.cc:499-512)",
    )
    p.add_argument("underlying_dir")
    p.add_argument("mount_point")
    p.set_defaults(func=cmd_mount)

    p = sub.add_parser("serve", help="serve the virtual filesystem over HTTP")
    _add_common_fs_flags(p)
    p.add_argument("--files-port", type=int, default=8080)
    p.add_argument("underlying_dir")
    p.set_defaults(func=cmd_serve)

    p = sub.add_parser("convolve", help="offline: convolve one file")
    p.add_argument("-C", "--config-dir", required=True)
    p.add_argument("-i", "--initial-filter", default="")
    p.add_argument("--chunk-blocks", type=int, default=32)
    p.add_argument(
        "--flac-threads", type=int, default=0,
        help="parallel codec workers (FLAC + Vorbis; 0 = auto)",
    )
    p.add_argument("input")
    p.add_argument("output")
    p.set_defaults(func=cmd_convolve)

    p = sub.add_parser("make-demo-filters", help="generate demo filter set")
    p.add_argument("target", nargs="?", default="demo-filters")
    p.set_defaults(func=cmd_make_demo_filters)

    p = sub.add_parser("info", help="inspect an audio file or .conf filter")
    p.add_argument("path")
    p.set_defaults(func=cmd_info)

    p = sub.add_parser("filters", help="list selectable filters in a config dir")
    p.add_argument("-C", "--config-dir", required=True)
    p.set_defaults(func=cmd_filters)

    args = parser.parse_args(argv)
    return args.func(args)


if __name__ == "__main__":
    sys.exit(main())
