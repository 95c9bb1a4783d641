"""Executable libsndfile parity matrix.

The reference convolves anything its libsndfile can decode
(convolve-file-handler.cc:62-76).  This test enumerates EVERY
(container, sample-codec, channels) combination the bundled libsndfile
1.1 oracle can write, produces a file, and asserts our `read_audio`
decodes it to what the oracle's own decoder returns — so "we cover the
reference's input formats" is executable truth, not a claim.

Exceptions are explicit registries:

* KNOWN_GAPS — combos we deliberately do not decode, asserted to FAIL
  (if support is ever added, the entry must be removed):
    - currently empty.  WAV/NMS-ADPCM 16/24/32 graduated (the predictor
      that resisted black-box probing was recovered by static analysis
      of the oracle binary — native/nms_codec.cc, tests/test_nms.py).
      OGG/OPUS graduated next (from-scratch RFC 6716 decoder: CELT +
      SILK + hybrid packet layer, trained tables extracted from the
      libopus oracle binary — native/{celt,silk}_codec.cc,
      native/opus_api.cc, tests/test_opus.py, tests/test_silk.py).
* ORACLE_BROKEN — combos the oracle itself cannot round-trip (its
  write or read path is non-functional); nothing to be compatible
  with.  Detected dynamically and cross-checked against this list.

RAW (headerless) is excluded by construction: sf_open needs explicit
caller-supplied parameters, so the reference's probe cannot open raw
files either — they pass through unconvolved there too.
"""

import ctypes

import numpy as np
import pytest

from folve_tpu.audio import read_audio
from tests.test_extra_formats import _sf

RATE = 44100

MAJORS = {
    0x010000: "WAV", 0x020000: "AIFF", 0x030000: "AU", 0x050000: "PAF",
    0x060000: "SVX", 0x070000: "NIST", 0x080000: "VOC", 0x0A0000: "IRCAM",
    0x0B0000: "W64", 0x0C0000: "MAT4", 0x0D0000: "MAT5", 0x0E0000: "PVF",
    0x0F0000: "XI", 0x100000: "HTK", 0x110000: "SDS", 0x120000: "AVR",
    0x130000: "WAVEX", 0x160000: "SD2", 0x170000: "FLAC", 0x180000: "CAF",
    0x190000: "WVE", 0x200000: "OGG", 0x210000: "MPC2K", 0x220000: "RF64",
    0x230000: "MPEG",
}
SUBS = {
    0x01: "PCM_S8", 0x02: "PCM_16", 0x03: "PCM_24", 0x04: "PCM_32",
    0x05: "PCM_U8", 0x06: "FLOAT", 0x07: "DOUBLE", 0x10: "ULAW",
    0x11: "ALAW", 0x12: "IMA_ADPCM", 0x13: "MS_ADPCM", 0x20: "GSM610",
    0x22: "NMS_16", 0x23: "NMS_24", 0x24: "NMS_32", 0x30: "G721_32",
    0x31: "G723_24", 0x32: "G723_40", 0x40: "DWVW_12", 0x41: "DWVW_16",
    0x42: "DWVW_24", 0x50: "DPCM_8", 0x51: "DPCM_16", 0x60: "VORBIS",
    0x64: "OPUS", 0x70: "ALAC_16", 0x71: "ALAC_20", 0x72: "ALAC_24",
    0x73: "ALAC_32", 0x80: "MPEG_L1", 0x81: "MPEG_L2", 0x82: "MPEG_L3",
}

# Deliberate decode gaps: asserted to NOT decode (keeps the list honest).
KNOWN_GAPS = set()

# The oracle's own write or read path is non-functional for these
# (writes zero frames / reads back zero frames); detected dynamically.
ORACLE_BROKEN = {
    ("AIFF", "DWVW_12"),  # reader and writer both return zero frames
}

# format_check accepts these but this oracle build cannot open them for
# write (no encoder linked in), so the matrix cannot produce a file.
# Raw MPEG and WAV/MPEG decode IS covered — by our own lame/twolame
# oracle fixtures in test_mp3.py / test_wav.py; Ogg Opus decode is
# covered by tests/test_opus.py against the libopus oracle.
ORACLE_NO_WRITE = {
    ("MPEG", "MPEG_L1"), ("MPEG", "MPEG_L2"), ("MPEG", "MPEG_L3"),
    ("WAV", "MPEG_L3"), ("OGG", "OPUS"),
}

# Decoders that re-quantize or run float DSP: compare with a tolerance
# (everything else must be bit-exact vs the oracle's own readback).
LOSSY_FLOAT = {"VORBIS", "MPEG_L1", "MPEG_L2", "MPEG_L3"}

_failed_writes = []


def _material(rng, n, ch, sub):
    t = np.arange(n) / RATE
    x = 0.35 * np.sin(2 * np.pi * np.array([330.0, 523.0])[:ch] * t[:, None])
    # Quiet noise floor: hot noise trips the oracle's corrupt
    # escape-frame encoder at ALAC-20 and dithers nothing useful.
    x = x + 0.002 * rng.standard_normal((n, ch))
    return np.ascontiguousarray(np.clip(x, -1, 1), np.float32)


def _enumerate():
    try:
        lib = _sf()
    except (Exception, pytest.skip.Exception):  # no oracle: no combinations
        return []
    lib.sf_format_check.argtypes = [ctypes.POINTER(lib.SfInfo)]
    combos = []
    for mj, mname in sorted(MAJORS.items()):
        for sb, sname in sorted(SUBS.items()):
            for ch in (1, 2):
                info = lib.SfInfo(0, RATE, ch, mj | sb, 0, 0)
                if lib.sf_format_check(ctypes.byref(info)):
                    combos.append((mname, sname, ch, mj | sb))
    return combos


_COMBOS = _enumerate()


@pytest.mark.parametrize(
    "mname,sname,ch,fmt",
    _COMBOS,
    ids=[f"{m}-{s}-{c}ch" for m, s, c, _ in _COMBOS],
)
def test_matrix(tmp_path, rng, mname, sname, ch, fmt):
    lib = _sf()
    n = 3000
    x = _material(rng, n, ch, sname)
    ext = {"SD2": "sd2", "XI": "xi"}.get(mname, "bin")
    p = tmp_path / f"m.{ext}"

    info = lib.SfInfo(0, RATE, ch, fmt, 0, 0)
    snd = lib.sf_open(str(p).encode(), 0x20, ctypes.byref(info))
    if not snd:
        assert (mname, sname) in ORACLE_BROKEN | ORACLE_NO_WRITE, \
            f"oracle cannot open {mname}/{sname} for write (not registered)"
        return
    wrote = lib.sf_writef_float(snd, x.ctypes.data, n)
    lib.sf_close(snd)
    if wrote != n:
        assert (mname, sname) in ORACLE_BROKEN, \
            f"oracle wrote {wrote}/{n} for {mname}/{sname} (not registered)"
        return

    # Oracle's own readback is the ground truth.
    info2 = lib.SfInfo(0, 0, 0, 0, 0, 0)
    snd = lib.sf_open(str(p).encode(), 0x10, ctypes.byref(info2))
    assert snd, "oracle cannot re-open its own file"
    oracle = np.zeros((max(1, info2.frames), max(1, info2.channels)),
                      np.float32)
    got = lib.sf_readf_float(snd, oracle.ctypes.data, info2.frames)
    lib.sf_close(snd)
    oracle = oracle[:got]
    if got == 0:
        assert (mname, sname) in ORACLE_BROKEN, \
            f"oracle reads zero frames of its own {mname}/{sname}"
        return
    assert (mname, sname) not in ORACLE_BROKEN, \
        f"{mname}/{sname} works in the oracle now — unregister it"

    if (mname, sname) in KNOWN_GAPS:
        try:
            ours, _ = read_audio(str(p))
        except Exception:
            return  # documented gap: refuses to decode
        # ...or decodes to something that is clearly not the audio.
        assert ours.shape[0] == 0 or not np.allclose(
            ours[: min(200, got)], oracle[: min(200, ours.shape[0])],
            atol=0.05), f"{mname}/{sname} decodes now — remove from gaps"
        return

    ours, ainfo = read_audio(str(p))
    assert ours.shape == oracle.shape, (
        f"{mname}/{sname}/{ch}ch: shape {ours.shape} vs oracle {oracle.shape}")
    if sname in LOSSY_FLOAT:
        err = np.max(np.abs(ours - oracle))
        assert err < 2e-4, f"{mname}/{sname}: max err {err}"
    else:
        np.testing.assert_array_equal(
            ours, oracle, err_msg=f"{mname}/{sname}/{ch}ch")


def test_matrix_is_nonempty():
    assert len(_COMBOS) >= 140, len(_COMBOS)
