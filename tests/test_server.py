"""VFS operations, status server, HTTP frontend, CLI tests."""

import io
import http.client
import os
import urllib.request

import numpy as np
import pytest

from folve_tpu.audio.flac import read_flac, write_flac
from folve_tpu.runtime import FolveFilesystem
from folve_tpu.server.status import StatusServer
from folve_tpu.server.vfs import STATUS_FILE_NAME, FolveVfs, might_be_passthrough_file

from tests.test_runtime import RATE, echo_ir, expected_conv, make_fs, write_song


def make_vfs(tmp_path, **kw):
    fs, src = make_fs(tmp_path, **kw)
    status = StatusServer(fs)
    return FolveVfs(fs, status_server=status), fs, src


class TestVfs:
    def test_readdir_injects_status_file(self, tmp_path):
        vfs, fs, src = make_vfs(tmp_path)
        write_song(src, "a.flac", 500)
        entries = vfs.readdir("/")
        assert "folve-status.html" in entries
        assert "a.flac" in entries

    def test_getattr_inflates_audio_but_not_covers(self, tmp_path):
        vfs, fs, src = make_vfs(tmp_path)
        write_song(src, "a.flac", 5000)
        (src / "cover.jpg").write_bytes(b"x" * 1000)
        audio_st = vfs.getattr("/a.flac")
        real = os.stat(src / "a.flac").st_size
        assert audio_st.st_size == int(real * fs.file_oversize_factor)
        cover_st = vfs.getattr("/cover.jpg")
        assert cover_st.st_size == 1000
        # Write bits stripped (folve-main.cc:151).
        assert not (audio_st.st_mode & 0o222)

    def test_open_read_release_cycle(self, tmp_path):
        vfs, fs, src = make_vfs(tmp_path)
        x = write_song(src, "a.flac", 1500)
        h = vfs.open("/a.flac")
        out = b""
        while True:
            d = vfs.read(h, 65536, len(out))
            if not d:
                break
            out += d
        vfs.release("/a.flac", h)
        got, _ = read_flac(out)
        ref = expected_conv(x, echo_ir())
        assert np.max(np.abs(got - ref)) < 2.5 / 32768

    def test_open_missing_raises_enoent(self, tmp_path):
        vfs, fs, src = make_vfs(tmp_path)
        with pytest.raises(OSError):
            vfs.open("/nope.flac")

    def test_status_file_read(self, tmp_path):
        vfs, fs, src = make_vfs(tmp_path)
        h = vfs.open(STATUS_FILE_NAME)
        st = vfs.getattr(STATUS_FILE_NAME, h)
        body = vfs.read(h, st.st_size, 0)
        assert b"Folve-TPU" in body
        vfs.release(STATUS_FILE_NAME, h)

    def test_toplevel_filter_mode(self, tmp_path):
        vfs, fs, src = make_vfs(tmp_path)
        fs.toplevel_dir_is_filter = True
        write_song(src, "a.flac", 800)
        entries = vfs.readdir("/")
        assert "_" in entries and "echo" in entries
        # Path translation strips the filter component.
        st = vfs.getattr("/echo/a.flac")
        assert st.st_size > 0
        h = vfs.open("/echo/a.flac")
        assert h.filter_dir() == "echo"
        vfs.release("/echo/a.flac", h)
        h2 = vfs.open("/_/a.flac")
        from folve_tpu.runtime import PassThroughHandler

        assert isinstance(h2, PassThroughHandler)
        vfs.release("/_/a.flac", h2)

    def test_passthrough_suffix_check(self):
        assert might_be_passthrough_file("/x/cover.JPG")
        assert might_be_passthrough_file("/a.txt")
        assert not might_be_passthrough_file("/a.flac")
        assert not might_be_passthrough_file("/noext")

    def test_readdir_logger(self, tmp_path):
        from folve_tpu.server.vfs import ReaddirLogger

        log_file = tmp_path / "rlog.txt"
        fs, src = make_fs(tmp_path)
        vfs = FolveVfs(fs, readdir_logger=ReaddirLogger(str(log_file)))
        write_song(src, "a.flac", 300)
        vfs.getattr("/a.flac")
        vfs.readdir("/")  # DONE flushes the log (folve-main.cc:97)
        text = log_file.read_text()
        assert "LIST /" in text
        assert "ITEM /a.flac" in text
        assert "DONE /" in text
        assert "STAT /a.flac" in text


class TestStatusServer:
    def test_page_and_filter_switch(self, tmp_path):
        vfs, fs, src = make_vfs(tmp_path)
        other = tmp_path / "filters" / "other"
        os.makedirs(other)
        (other / f"filter-{RATE}.conf").write_text(
            "/convolver/new 2 2 64 128\n/impulse/dirac 1 1 1.0 0\n"
        )
        write_song(src, "a.flac", 900)
        h = vfs.open("/a.flac")
        code, headers, body = fs_status(vfs).handle_http("/")
        assert code == 200
        assert b"a.flac" in body
        assert b"echo" in body and b"other" in body
        # Switch filter via the control route.
        code, headers, _ = fs_status(vfs).handle_http("/settings?f=other")
        assert code == 302
        assert fs.current_config_subdir == "other"
        vfs.release("/a.flac", h)

    def test_retired_history(self, tmp_path):
        vfs, fs, src = make_vfs(tmp_path)
        fs.open_file_cache.set_max_size(1)
        for i in range(3):
            write_song(src, f"s{i}.flac", 400, seed=i)
        for i in range(3):
            h = vfs.open(f"/s{i}.flac")
            vfs.read(h, 4096, 0)
            vfs.release(f"/s{i}.flac", h)
        _, _, body = fs_status(vfs).handle_http("/")
        assert b"Recently retired" in body

    def test_retired_overflow_counter(self, tmp_path):
        """Beyond the 20-entry ring the page shows '... (N more)'
        (status-server.cc:216,471)."""
        vfs, fs, src = make_vfs(tmp_path)
        write_song(src, "s.flac", 300)
        status = fs_status(vfs)
        h = fs.get_or_create_handler("/s.flac")
        for _ in range(23):
            status.retire_handler_event(h)
        fs.close_handler("/s.flac", h)
        _, _, body = status.handle_http("/")
        assert b"... (3 more)" in body

    def test_expensive_details_latency_column(self, tmp_path):
        """-D / expensive_details unlocks the per-stream device-step
        latency column (reference show_details, status-server.cc:201-205)."""
        vfs, fs, src = make_vfs(tmp_path)
        write_song(src, "a.flac", 900)
        h = vfs.open("/a.flac")
        out = b""  # read through the body to force device steps
        for _ in range(8):
            d = vfs.read(h, 65536, len(out))
            if not d:
                break
            out += d
        status = fs_status(vfs)
        _, _, body = status.handle_http("/")
        assert b"Device step latency" not in body  # default: off
        status.expensive_details = True
        _, _, body = status.handle_http("/")
        assert b"Device step latency" in body
        assert b"p99=" in body  # a populated per-stream summary cell
        assert b"Filter base directory" in body  # status-server.cc:401-405
        assert b"s)</span>" in body  # last-access age, status-server.cc:275
        vfs.release("/a.flac", h)

    def test_profile_endpoint(self, tmp_path):
        vfs, fs, src = make_vfs(tmp_path)
        status = fs_status(vfs)
        # Gated behind -D (ADVICE r2): inert on a default status port.
        code, _, _ = status.handle_http("/profile?secs=0.2")
        assert code == 403
        status.expensive_details = True
        code, _, body = status.handle_http("/profile?secs=abc")
        assert code == 400
        code, _, body = status.handle_http("/profile?secs=0.2")
        assert code == 200 and b"tracing" in body
        # A second capture while one runs is refused.
        code, _, _ = status.handle_http("/profile?secs=0.2")
        assert code == 409
        status._profile_thread.join(timeout=30)
        assert not status._profile_thread.is_alive()

    def test_clipping_marker(self, tmp_path):
        conf = (
            "/convolver/new 2 2 64 128\n"
            "/impulse/dirac 1 1 9.0 0\n/impulse/dirac 2 2 9.0 0\n"
        )
        vfs, fs, src = make_vfs(tmp_path, conf_text=conf)
        write_song(src, "loud.flac", 2000, amp=0.9)
        h = vfs.open("/loud.flac")
        out = b""
        while True:
            d = vfs.read(h, 65536, len(out))
            if not d:
                break
            out += d
        stats = h.get_handler_status()
        assert stats.max_output_value > 1.0
        assert "clipping" in stats.message.lower()
        _, _, body = fs_status(vfs).handle_http("/")
        assert b"clip" in body
        vfs.release("/loud.flac", h)


def fs_status(vfs):
    return vfs.status_server


class TestHttpFrontend:
    def test_serve_file_over_http(self, tmp_path):
        from folve_tpu.server.httpfs import start_httpfs_thread

        vfs, fs, src = make_vfs(tmp_path)
        x = write_song(src, "a.flac", 1200)
        httpd = start_httpfs_thread(vfs, 0)
        port = httpd.server_address[1]
        try:
            with urllib.request.urlopen(f"http://localhost:{port}/files/a.flac") as r:
                blob = r.read()
            got, _ = read_flac(blob)
            ref = expected_conv(x, echo_ir())
            assert np.max(np.abs(got - ref)) < 2.5 / 32768
            with urllib.request.urlopen(f"http://localhost:{port}/ls/") as r:
                listing = r.read().decode()
            assert "a.flac" in listing
            with urllib.request.urlopen(f"http://localhost:{port}/") as r:
                assert b"Folve-TPU" in r.read()
        finally:
            httpd.shutdown()

    def test_http_traversal_is_rejected(self, tmp_path):
        """HTTP delivers raw '..' (no kernel resolution like FUSE) — it
        must never escape the music root."""
        import http.client

        vfs, fs, src = make_vfs(tmp_path)
        write_song(src, "a.flac", 400)
        secret = tmp_path / "secret.txt"
        secret.write_text("top secret")
        from folve_tpu.server.httpfs import start_httpfs_thread

        httpd = start_httpfs_thread(vfs, 0)
        port = httpd.server_address[1]
        try:
            for raw in (
                "/files/../secret.txt",
                "/files/..%2fsecret.txt",
                "/files/%2e%2e/secret.txt",
                "/files/a/../../secret.txt",
            ):
                conn = http.client.HTTPConnection("localhost", port)
                # path sent verbatim (urlopen would normalize client-side)
                conn.request("GET", raw)
                resp = conn.getresponse()
                body = resp.read()
                assert b"top secret" not in body, raw
                assert resp.status in (400, 404), (raw, resp.status)
                conn.close()
            # Traversal in a listing collapses to the VFS root — never
            # the parent directory holding secret.txt.
            conn = http.client.HTTPConnection("localhost", port)
            conn.request("GET", "/ls/../..")
            resp = conn.getresponse()
            body = resp.read().decode()
            assert resp.status == 200 and "secret.txt" not in body
            assert "a.flac" in body  # it IS the mount root
            conn.close()
            # And the underlying-file API itself refuses '..' paths.
            with pytest.raises(OSError):
                fs.get_underlying_file("/../secret.txt")
        finally:
            httpd.shutdown()

    def test_http_head_and_suffix_range(self, tmp_path):
        import http.client

        vfs, fs, src = make_vfs(tmp_path)
        write_song(src, "a.flac", 1200)
        from folve_tpu.server.httpfs import start_httpfs_thread

        httpd = start_httpfs_thread(vfs, 0)
        port = httpd.server_address[1]
        try:
            # Full body for comparison.
            with urllib.request.urlopen(f"http://localhost:{port}/files/a.flac") as r:
                whole = r.read()
            # HEAD: headers only, no body, range advertised.
            conn = http.client.HTTPConnection("localhost", port)
            conn.request("HEAD", "/files/a.flac")
            resp = conn.getresponse()
            assert resp.status == 200
            assert resp.getheader("Accept-Ranges") == "bytes"
            assert resp.read() == b""
            conn.close()
            # Suffix range = the LAST N bytes of the ADVERTISED size.
            # Sizes are estimates (the reference inflates stat sizes the
            # same way), so the bytes must match a VFS read at that
            # offset — for an inflated size that's the end-skip zeros a
            # FUSE reader would get, not the real file tail.
            size = int(resp.getheader("Content-Length"))
            req = urllib.request.Request(
                f"http://localhost:{port}/files/a.flac",
                headers={"Range": "bytes=-100"},
            )
            with urllib.request.urlopen(req) as r:
                assert r.status == 206
                assert r.getheader("Content-Range").startswith(
                    f"bytes {size - 100}-"
                )
                tail = r.read()
            h = vfs.open("/a.flac")
            try:
                ref = vfs.read(h, 100, size - 100)
            finally:
                vfs.release("/a.flac", h)
            assert tail == ref and len(tail) <= 100
            # Malformed range: ignored, full 200 response.
            req = urllib.request.Request(
                f"http://localhost:{port}/files/a.flac",
                headers={"Range": "bytes=abc-"},
            )
            with urllib.request.urlopen(req) as r:
                assert r.status == 200
                assert r.read() == whole
            # Range entirely past the advertised end: 416 with */size.
            conn = http.client.HTTPConnection("localhost", port)
            conn.request(
                "GET", "/files/a.flac", headers={"Range": f"bytes={size}-"}
            )
            resp = conn.getresponse()
            assert resp.status == 416
            assert resp.getheader("Content-Range") == f"bytes */{size}"
            resp.read()
            conn.close()
            # HEAD with a range: 206 whose Content-Length is the RANGE
            # length, matching its Content-Range.
            conn = http.client.HTTPConnection("localhost", port)
            conn.request(
                "HEAD", "/files/a.flac", headers={"Range": "bytes=100-299"}
            )
            resp = conn.getresponse()
            assert resp.status == 206
            assert resp.getheader("Content-Length") == "200"
            assert resp.getheader("Content-Range") == f"bytes 100-299/{size}"
            resp.read()
            conn.close()
            # HEAD of a listing advertises the GET body's true length.
            with urllib.request.urlopen(f"http://localhost:{port}/ls/") as r:
                ls_len = len(r.read())
            conn = http.client.HTTPConnection("localhost", port)
            conn.request("HEAD", "/ls/")
            resp = conn.getresponse()
            assert int(resp.getheader("Content-Length")) == ls_len
            assert resp.read() == b""
            conn.close()
            # '/filesystem' must NOT be shadowed by the /files route.
            conn = http.client.HTTPConnection("localhost", port)
            conn.request("GET", "/filesystem")
            resp = conn.getresponse()
            body = resp.read()
            # falls through to the status server (serves the page)
            assert resp.status == 200 and b"Folve-TPU" in body
            conn.close()
        finally:
            httpd.shutdown()


class TestCli:
    def test_offline_convolve(self, tmp_path, capsys):
        from folve_tpu.cli import main

        fs, src = make_fs(tmp_path)
        x = write_song(src, "in.flac", 3000)
        out = str(tmp_path / "out.flac")
        rc = main(
            [
                "convolve",
                "-C",
                str(tmp_path / "filters"),
                "-i",
                "echo",
                str(src / "in.flac"),
                out,
            ]
        )
        assert rc == 0
        got, _ = read_flac(out)
        ref = expected_conv(x, echo_ir())
        assert np.max(np.abs(got - ref)) < 2.5 / 32768

    def test_make_demo_filters(self, tmp_path):
        from folve_tpu.cli import main

        rc = main(["make-demo-filters", str(tmp_path / "df")])
        assert rc == 0
        assert (tmp_path / "df" / "lowpass" / "filter-44100.conf").exists()
        assert (tmp_path / "df" / "echo" / "filter-96000.conf").exists()


class TestMetadataCarryover:
    def test_flac_tags_survive_regenerated_header(self, tmp_path):
        """workaround_flac_header_issue regenerates the header from
        scratch; string tags must still be copied
        (convolve-file-handler.cc:484-495)."""
        import numpy as np

        from folve_tpu.audio.flac import read_flac, read_flac_metadata, write_flac

        fs, src = make_fs(tmp_path)
        fs.workaround_flac_header_issue = True
        rng = np.random.default_rng(4)
        x = np.round(rng.uniform(-0.3, 0.3, (700, 2)) * 32768) / 32768
        meta = {"TITLE": "Workaround", "ALBUM": "Round Two"}
        write_flac(str(src / "w.flac"), x.astype(np.float32), RATE, bits=16,
                   metadata=meta)
        h = fs.get_or_create_handler("/w.flac")
        blob = b""
        while True:
            d = h.read(65536, len(blob))
            if not d:
                break
            blob += d
        got = read_flac_metadata(blob)
        assert got["TITLE"] == "Workaround"
        assert got["ALBUM"] == "Round Two"
        data, _ = read_flac(blob)
        assert data.shape[0] == 700
        fs.close_handler("/w.flac", h)

    def test_wav_tags_become_vorbis_comments(self, tmp_path):
        """GenerateHeaderFromInputFile tag copy
        (convolve-file-handler.cc:484-495)."""
        import numpy as np

        from folve_tpu.audio.flac import read_flac_metadata
        from folve_tpu.audio.types import SampleCodec
        from folve_tpu.audio.wav import read_wav_metadata, write_wav

        fs, src = make_fs(tmp_path)
        rng = np.random.default_rng(3)
        x = rng.uniform(-0.3, 0.3, (800, 2)).astype(np.float32)
        meta = {"TITLE": "Test Song", "ARTIST": "Unit Test", "ALBUM": "Fixtures"}
        write_wav(str(src / "t.wav"), x, RATE, SampleCodec.PCM_16, metadata=meta)
        assert read_wav_metadata(str(src / "t.wav")) == meta
        h = fs.get_or_create_handler("/t.wav")
        blob = b""
        while True:
            d = h.read(65536, len(blob))
            if not d:
                break
            blob += d
        got = read_flac_metadata(blob)
        assert got["TITLE"] == "Test Song"
        assert got["ARTIST"] == "Unit Test"
        # And the audio still decodes.
        from folve_tpu.audio.flac import read_flac

        data, info = read_flac(blob)
        assert data.shape[0] == 800
        fs.close_handler("/t.wav", h)

    def test_verbatim_flac_keeps_vorbis_comments(self, tmp_path):
        """Verbatim header copy preserves existing tags
        (CopyFlacHeader, convolve-file-handler.cc:438-482)."""
        from folve_tpu.audio.flac import FlacEncoder, read_flac_metadata

        fs, src = make_fs(tmp_path)
        import numpy as np

        rng = np.random.default_rng(4)
        x = np.round(rng.uniform(-0.4, 0.4, (900, 2)) * 32768).astype(np.int32)
        enc = FlacEncoder(RATE, 2, 16, 4096, total_frames_hint=900)
        blob = bytearray(enc.header({"TITLE": "Original"}))
        blob += enc.write_int(x)
        blob += enc.finish()
        (src / "tagged.flac").write_bytes(bytes(blob))
        h = fs.get_or_create_handler("/tagged.flac")
        out = b""
        while True:
            d = h.read(65536, len(out))
            if not d:
                break
            out += d
        assert read_flac_metadata(out)["TITLE"] == "Original"
        fs.close_handler("/tagged.flac", h)


class TestCliUtilities:
    def test_info_audio_and_conf(self, tmp_path, capsys):
        from folve_tpu.cli import main

        fs, src = make_fs(tmp_path)
        write_song(src, "a.flac", 4410)
        assert main(["info", str(src / "a.flac")]) == 0
        out = capsys.readouterr().out
        assert "44100 Hz" in out and "4410 frames" in out
        conf = str(tmp_path / "filters" / "echo" / f"filter-{RATE}.conf")
        assert main(["info", conf]) == 0
        out = capsys.readouterr().out
        assert "2x2" in out and "4 impulse op(s)" in out

    def test_prebuffer_disable_flag(self, tmp_path):
        """-b -1 disables prebuffering (reference usage text: 'Disable
        with -1'); invalid sizes still exit."""
        import argparse

        from folve_tpu.cli import _build_fs

        fs0, src = make_fs(tmp_path)

        def build(prebuffer):
            args = argparse.Namespace(
                config_dir=str(tmp_path / "filters"), initial_filter="echo",
                gapless=False, toplevel_filter=False, prebuffer=prebuffer,
                oversize_factor=1.25, flac_block_size=4096,
                workaround_flac_header=False, pid_file="", debug=False,
                freq_parallel=1,
            )
            return _build_fs(args, str(src))

        fs = build(-1)
        assert fs.pre_buffer_size == 0
        fs = build(256)
        assert fs.pre_buffer_size == 256 << 10
        with pytest.raises(SystemExit):
            build(7)  # below the 64 KiB floor

    def test_daemon_mode_fails_loudly_before_fork(self, tmp_path):
        """Without -f, bad dirs/flags must error with nonzero exit
        BEFORE daemonizing (they previously vanished into /dev/null)."""
        import subprocess
        import sys

        fs, src = make_fs(tmp_path)
        env = {**os.environ, "JAX_PLATFORMS": "cpu"}
        r = subprocess.run(
            [sys.executable, "-m", "folve_tpu", "mount",
             "-C", str(tmp_path / "filters"), str(src), "/nonexistent-mnt"],
            capture_output=True, text=True, timeout=120, env=env,
        )
        assert r.returncode != 0 and "not a directory" in r.stderr
        r = subprocess.run(
            [sys.executable, "-m", "folve_tpu", "mount",
             "-C", "/nope-dir", str(src), str(tmp_path)],
            capture_output=True, text=True, timeout=120, env=env,
        )
        assert r.returncode != 0 and "not a directory" in r.stderr
        r = subprocess.run(
            [sys.executable, "-m", "folve_tpu", "mount", "-b", "7",
             "-C", str(tmp_path / "filters"), str(src), str(tmp_path)],
            capture_output=True, text=True, timeout=120, env=env,
        )
        assert r.returncode != 0 and "prebuffer" in r.stderr

    def test_option_value_does_not_trigger_mount_rewrite(self, tmp_path):
        """A subcommand anywhere in argv suppresses the bare-invocation
        mount rewrite: `--files-port 8080 serve dir` errors loudly
        instead of silently becoming a mount."""
        import subprocess
        import sys

        fs, src = make_fs(tmp_path)
        r = subprocess.run(
            [sys.executable, "-m", "folve_tpu",
             "--files-port", "8080", "serve", str(src)],
            capture_output=True, text=True, timeout=120,
            env={**os.environ, "JAX_PLATFORMS": "cpu"},
        )
        assert r.returncode != 0
        assert "invalid choice" in r.stderr or "error" in r.stderr

    def test_reference_style_invocation_means_mount(self, tmp_path):
        """`folve [options] src mnt` with no subcommand is the reference
        binary's command line (folve-main.cc:330-361) — it must route to
        mount (here: fail on the bad mountpoint, proving the route)."""
        import subprocess
        import sys

        fs, src = make_fs(tmp_path)
        r = subprocess.run(
            [
                sys.executable, "-m", "folve_tpu",
                "-C", str(tmp_path / "filters"), "-f",
                str(src), str(tmp_path / "nope"),
            ],
            capture_output=True,
            text=True,
            timeout=120,
            env={**os.environ, "JAX_PLATFORMS": "cpu"},
        )
        assert r.returncode == 1
        assert "mount failed" in r.stdout + r.stderr

    def test_filters_listing(self, tmp_path, capsys):
        from folve_tpu.cli import main

        fs, src = make_fs(tmp_path)
        assert main(["filters", "-C", str(tmp_path / "filters")]) == 0
        out = capsys.readouterr().out
        assert "echo" in out and "(pass-through)" in out
        assert f"filter-{RATE}.conf" in out


class TestServeCommand:
    def test_serve_cli_subprocess(self, tmp_path):
        """`folve-tpu serve` end to end in a child process."""
        import subprocess
        import sys
        import time
        import urllib.request

        fs, src = make_fs(tmp_path)
        write_song(src, "a.flac", 800)
        proc = subprocess.Popen(
            [
                sys.executable, "-m", "folve_tpu", "serve",
                "-C", str(tmp_path / "filters"), "-i", "echo",
                "--files-port", "18744", str(src),
            ],
            stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT,
            env={**__import__("os").environ, "JAX_PLATFORMS": "cpu"},
        )
        try:
            deadline = time.time() + 120
            blob = None
            while time.time() < deadline:
                try:
                    with urllib.request.urlopen(
                        "http://localhost:18744/files/a.flac", timeout=5
                    ) as r:
                        blob = r.read()
                    break
                except Exception:
                    time.sleep(0.5)
            assert blob is not None, "serve never came up"
            assert blob[:4] == b"fLaC"
            got, _ = read_flac(blob)
            assert got.shape[0] == 800
        finally:
            proc.terminate()
            proc.wait(timeout=10)

    @pytest.mark.skipif(not os.path.exists("/dev/fuse"), reason="no /dev/fuse")
    def test_mount_daemon_mode(self, tmp_path):
        """Without -f the mount daemonizes: the CLI returns promptly,
        the mount lives on, and the pid file names the daemon
        (reference: fuse_main daemonize, folve-main.cc:539)."""
        import signal
        import subprocess
        import sys
        import time

        fs, src = make_fs(tmp_path)
        write_song(src, "a.flac", 600)
        mnt = tmp_path / "mnt"
        mnt.mkdir()
        pidfile = tmp_path / "folve.pid"
        r = subprocess.run(
            [
                sys.executable, "-m", "folve_tpu", "mount",
                "-C", str(tmp_path / "filters"), "-i", "echo",
                "-P", str(pidfile),
                str(src), str(mnt),
            ],
            capture_output=True,
            timeout=120,
            env={**os.environ, "JAX_PLATFORMS": "cpu"},
        )
        assert r.returncode == 0  # parent exits once the daemon forked
        daemon_pid = None
        try:
            deadline = time.time() + 60
            names = []
            while time.time() < deadline:
                if pidfile.exists():
                    try:
                        names = os.listdir(mnt)
                    except OSError:
                        names = []
                    if "a.flac" in names:
                        break
                time.sleep(0.2)
            assert "a.flac" in names, "daemon mount never appeared"
            daemon_pid = int(pidfile.read_text())
            assert daemon_pid != r.returncode  # a real, different process
            os.kill(daemon_pid, 0)  # alive
            blob = (mnt / "a.flac").read_bytes()
            assert blob[:4] == b"fLaC"
        finally:
            subprocess.run(["umount", str(mnt)], capture_output=True)
            if daemon_pid:
                try:
                    os.kill(daemon_pid, signal.SIGTERM)
                except ProcessLookupError:
                    pass

    def test_mount_cli_bad_mountpoint(self, tmp_path):
        """Graceful failure when the mountpoint is unusable."""
        import subprocess
        import sys

        fs, src = make_fs(tmp_path)
        r = subprocess.run(
            [
                sys.executable, "-m", "folve_tpu", "mount",
                "-C", str(tmp_path / "filters"), "-f",
                str(src), str(tmp_path / "does-not-exist"),
            ],
            capture_output=True,
            text=True,
            timeout=120,
            env={**__import__("os").environ, "JAX_PLATFORMS": "cpu"},
        )
        assert r.returncode == 1
        assert "mount failed" in r.stdout + r.stderr


class TestStatusRowParity:
    """Row-level parity details from VERDICT r3 #7
    (status-server.cc:284-288, 337-340, 346-364)."""

    def test_only_header_accessed_row(self, tmp_path):
        vfs, fs, src = make_vfs(tmp_path)
        write_song(src, "a.flac", 44100)
        h = vfs.open("/a.flac")  # open but never read audio
        _, _, body = fs_status(vfs).handle_http("/")
        assert b"Only header accessed" in body
        vfs.read(h, 1 << 16, 0)
        vfs.read(h, 1 << 16, 1 << 16)  # well inside the predicted size
        _, _, body = fs_status(vfs).handle_http("/")
        assert b"Only header accessed" not in body
        vfs.release("/a.flac", h)

    def test_filter_switch_one_shot_notice(self, tmp_path):
        vfs, fs, src = make_vfs(tmp_path)
        other = tmp_path / "filters" / "other"
        os.makedirs(other)
        (other / f"filter-{RATE}.conf").write_text(
            "/convolver/new 2 2 64 128\n/impulse/dirac 1 1 1.0 0\n"
        )
        status = fs_status(vfs)
        _, _, body = status.handle_http("/")
        assert b"Affects re- or newly opened files." not in body
        status.handle_http("/settings?f=other")
        _, _, body = status.handle_http("/")
        assert b"Affects re- or newly opened files." in body
        _, _, body = status.handle_http("/")  # one-shot: gone again
        assert b"Affects re- or newly opened files." not in body
        # switching to the SAME filter is not a switch
        status.handle_http("/settings?f=other")
        _, _, body = status.handle_http("/")
        assert b"Affects re- or newly opened files." not in body

    def test_boring_configuration_hint(self, tmp_path):
        vfs, fs, src = make_vfs(tmp_path)
        _, _, body = fs_status(vfs).handle_http("/")
        has_hint = b"boring configuration" in body
        # make_fs creates exactly one filter dir; whether the
        # passthrough pseudo-entry counts decides the hint — assert
        # consistency with the actual dir count like the reference.
        n = len(fs.get_available_config_dirs())
        assert has_hint == (n <= 1)
