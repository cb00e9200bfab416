"""flan_tpu_torch's file codecs (io/{au,caf,w64,aiff,flac,ogg,mp3}.py, the
dispatch of io/files.py behind Audio.load_from_file / save_to_file)
against flan_tpu's on the CPU: files cross both ways between the packages
(the port writes and flan_tpu reads, and the reverse), the lossless
writers give flan_tpu's bytes, garbage and truncated files are refused
with flan_tpu's errors, and the FLAC decoder's hand-built edge cases of
tests/test_flac.py decode alike. Ogg and MP3 need the system libvorbis /
mpg123 and lame and skip without them, as tests/test_io.py does. Inputs
are made with numpy from a seed.
"""
import struct

import numpy as np
import pytest
import torch

import flan_tpu
import flan_tpu_torch
from flan_tpu.io import flac as j_flac
from flan_tpu.io.flac import _BitWriter, _crc8, _crc16, _utf8_number
from flan_tpu_torch.io import aiff, au, caf, flac, mp3, ogg, w64


# One intra-op thread: on an 8-core x86 host torch 2.13's CPU kernels pay
# ~10 ms to wake their worker pool for a call of a few thousand elements
# (torch.round of 16,384 floats: 14 ms on 8 threads, 6 us on one), which
# the plain versions' many small calls multiply.
torch.set_num_threads(1)

SR = 8000.0

# the port's module and flan_tpu's for each codec, with (write, read)
_J = {"aiff": "flan_tpu.io.aiff", "au": "flan_tpu.io.au",
      "caf": "flan_tpu.io.caf", "w64": "flan_tpu.io.w64",
      "flac": "flan_tpu.io.flac", "ogg": "flan_tpu.io.ogg",
      "mp3": "flan_tpu.io.mp3"}
_P = {"aiff": aiff, "au": au, "caf": caf, "w64": w64, "flac": flac,
      "ogg": ogg, "mp3": mp3}
LOSSLESS = ("aiff", "au", "caf", "w64")


def _jmod(name):
    import importlib
    return importlib.import_module(_J[name])


def _io(mod, name):
    return getattr(mod, f"write_{name}"), getattr(mod, f"read_{name}")


def _need(name):
    """Skip an Ogg or MP3 case where the system library is absent, as
    tests/test_io.py:145,376 do."""
    if name in ("ogg", "mp3") and not _P[name].available():
        pytest.skip(f"system library for {name} not present")


def _signal(channels=2, seconds=0.5, sr=SR, seed=0, noise=0.05):
    """A tone a channel in light noise, inside (-1, 1)."""
    t = np.arange(int(seconds * sr)) / sr
    rng = np.random.default_rng(seed)
    x = np.stack([0.4 * np.sin(2 * np.pi * (330.0 + 110.0 * c) * t)
                  + noise * rng.standard_normal(len(t))
                  for c in range(channels)])
    return np.clip(x, -0.95, 0.95).astype(np.float32)


def _snr_db(x, y, guard):
    n = min(x.shape[-1], y.shape[-1])
    a, b = x[:, guard:n - guard], y[:, guard:n - guard]
    return 10 * np.log10((a ** 2).mean() / ((a - b) ** 2).mean())


def _quantized(x, bits=16):
    full = float(1 << (bits - 1))
    q = np.clip(np.rint(x.astype(np.float64) * full), -full, full - 1)
    return (q / full).astype(np.float32)


@pytest.mark.parametrize("writer", ["port", "flan_tpu"])
@pytest.mark.parametrize("name", ["aiff", "au", "caf", "w64", "flac", "ogg",
                                  "mp3"])
def test_files_cross_between_the_packages(tmp_path, name, writer):
    """One package writes, both read: the same arrays from both readers,
    the samples' bits for the lossless codecs, FLAC's 16-bit quantisation,
    and Ogg / MP3 within tests/test_io.py's distances on its tones (25 dB
    at quality 0.5 / 20 dB at 192 kb/s)."""
    _need(name)
    lossy = name in ("ogg", "mp3")
    sr = {"mp3": 32000.0, "ogg": 44100.0}.get(name, SR)
    x = _signal(sr=sr, seconds=1.0 if lossy else 0.5,
                noise=0.0 if lossy else 0.05)
    p = str(tmp_path / f"x.{name}")
    pw, pr = _io(_P[name], name)
    jw, jr = _io(_jmod(name), name)
    kw = {"quality": 0.5} if name == "ogg" else {}
    (pw if writer == "port" else jw)(p, x, sr, **kw)
    got, got_sr = pr(p)
    want, want_sr = jr(p)
    assert got_sr == want_sr == sr
    assert got.dtype == np.float32 and got.shape[0] == 2
    np.testing.assert_array_equal(got, want)
    if name in LOSSLESS:
        np.testing.assert_array_equal(got, x)
    elif name == "flac":
        np.testing.assert_array_equal(got, _quantized(x))
    else:
        assert _snr_db(x, got, 2048) > (25.0 if name == "ogg" else 20.0)


@pytest.mark.parametrize("name,bits", [
    ("aiff", 8), ("aiff", 16), ("aiff", 24), ("aiff", 32),
    ("au", 8), ("au", 16), ("au", 24), ("au", 32),
    ("caf", 16), ("caf", 24), ("caf", 32),
    ("w64", 16), ("w64", 24), ("w64", 32), ("flac", 24)])
def test_lossless_writers_give_flan_tpus_bytes(tmp_path, name, bits):
    x = _signal(channels=1, seed=bits)
    a, b = str(tmp_path / f"p.{name}"), str(tmp_path / f"j.{name}")
    _io(_P[name], name)[0](a, x, SR, bits=bits)
    _io(_jmod(name), name)[0](b, x, SR, bits=bits)
    assert open(a, "rb").read() == open(b, "rb").read()


def _error(fn, *args):
    try:
        fn(*args)
    except Exception as e:          # the error itself is what is compared
        return type(e), str(e)
    return None


@pytest.mark.parametrize("cut", ["garbage", "header", "half"])
@pytest.mark.parametrize("name", ["wav", "aiff", "au", "caf", "w64", "flac",
                                  "ogg", "mp3"])
def test_bad_files_are_refused_as_flan_tpu_refuses_them(tmp_path, name,
                                                        cut):
    """Garbage, a file cut after its first 16 bytes and one cut in half:
    Audio.load_from_file of the port raises flan_tpu's error (type and
    message), or reads what flan_tpu reads. A file cut in half can still
    be read: a WAV or Wave64 data chunk cut short gives its whole frames,
    as flan_tpu's native decoder reads them (its numpy fallback refuses a
    partial frame instead), and they are the signal's first frames."""
    _need(name)
    p = str(tmp_path / f"x.{name}")
    sr = 32000.0 if name == "mp3" else SR
    x = _signal(sr=sr)
    if cut == "garbage":
        open(p, "wb").write(b"garbage bytes, not audio at all....." * 3)
    else:
        flan_tpu.Audio.create_from_array(x, sr).save_to_file(p)
        raw = open(p, "rb").read()
        open(p, "wb").write(raw[:16] if cut == "header"
                            else raw[:len(raw) // 2])
    got = _error(flan_tpu_torch.Audio.load_from_file, p, False, "cpu")
    want = _error(flan_tpu.Audio.load_from_file, p)
    if cut != "half" or got is not None:
        assert got is not None and got == want
        return
    a = flan_tpu_torch.Audio.load_from_file(p, device="cpu").to_numpy()
    if want is None:
        np.testing.assert_array_equal(
            a, np.array(flan_tpu.Audio.load_from_file(p).data))
    else:
        assert name in ("wav", "w64") and "multiple of element" in want[1]
    if name in ("wav", "w64"):
        assert 0 < a.shape[1] < x.shape[1]
        np.testing.assert_array_equal(a, x[:, :a.shape[1]])


@pytest.mark.parametrize("name", ["ogg", "mp3"])
def test_a_missing_system_library_raises_and_writes_nothing(
        tmp_path, monkeypatch, name):
    """Without its shared objects an Ogg or MP3 codec raises flan_tpu's
    RuntimeError and leaves no file (never a WAV in its place)."""
    import ctypes

    def absent(*args, **kwargs):
        raise OSError("absent")

    jmod = _jmod(name)
    for mod in (_P[name], jmod):
        monkeypatch.setattr(mod, "_LIBS", None)
        monkeypatch.setattr(mod, "_LIB_ERR", None)
    monkeypatch.setattr(ctypes, "CDLL", absent)
    monkeypatch.setattr(ctypes.util, "find_library", lambda name: None)
    p = str(tmp_path / f"x.{name}")
    x = _signal()
    with pytest.raises(RuntimeError) as e:
        flan_tpu_torch.Audio.create_from_array(x, SR, device="cpu"
                                               ).save_to_file(p)
    assert not (tmp_path / f"x.{name}").exists()
    with pytest.raises(RuntimeError) as j:
        flan_tpu.Audio.create_from_array(x, SR).save_to_file(p)
    assert str(e.value) == str(j.value)
    open(p, "wb").write(b"OggS" if name == "ogg" else b"ID3" + b"\0" * 64)
    assert (_error(flan_tpu_torch.Audio.load_from_file, p, False, "cpu")
            == _error(flan_tpu.Audio.load_from_file, p))
    assert not _P[name].available()


@pytest.mark.parametrize("ext,magic", [
    ("flac", b"fLaC"), ("aiff", b"FORM"), ("aif", b"FORM"),
    ("aifc", b"FORM"), ("ogg", b"OggS"), ("oga", b"OggS"), ("w64", b"riff"),
    ("au", b".snd"), ("snd", b".snd"), ("caf", b"caff"), ("mp3", None),
    ("wav", b"RIFF")])
def test_save_to_file_writes_the_extensions_format(tmp_path, ext, magic):
    """C.20: a name's extension picks its codec (the port wrote RIFF under
    every name); both packages read the file back alike."""
    _need({"oga": "ogg"}.get(ext, ext))
    sr = 32000.0 if ext == "mp3" else SR
    x = _signal(sr=sr)
    p = str(tmp_path / f"x.{ext}")
    flan_tpu_torch.Audio.create_from_array(x, sr, device="cpu").save_to_file(p)
    head = open(p, "rb").read(4)
    if magic is None:               # MP3: an ID3 tag or a frame sync
        assert head[:3] == b"ID3" or (head[0] == 0xFF
                                      and head[1] & 0xE0 == 0xE0)
    else:
        assert head == magic
    a = flan_tpu_torch.Audio.load_from_file(p, device="cpu")
    b = flan_tpu.Audio.load_from_file(p)
    assert a.sample_rate == b.sample_rate == sr
    np.testing.assert_array_equal(a.to_numpy(), np.array(b.data))


def test_load_keeps_wav_strings_and_names_the_device(tmp_path):
    s = flan_tpu_torch.SndfileStrings(title="a song", artist="someone")
    p = str(tmp_path / "m.wav")
    a = flan_tpu_torch.Audio.create_from_array(_signal(), SR, device="cpu")
    a.save_to_file(p, s)
    b, got = flan_tpu_torch.Audio.load_from_file(p, True, device="cpu")
    assert (got.title, got.artist) == ("a song", "someone")
    assert b.device.type == "cpu"
    _, want = flan_tpu.Audio.load_from_file(p, return_strings=True)
    assert (want.title, want.artist) == (got.title, got.artist)
    p2 = str(tmp_path / "m.flac")
    a.save_to_file(p2)
    _, none = flan_tpu_torch.Audio.load_from_file(p2, True, device="cpu")
    assert none == flan_tpu_torch.SndfileStrings()


# --- the FLAC decoder's hand-built streams (tests/test_flac.py) -----------

def _stream(frames_payload, nch=1, total=0):
    sbw = _BitWriter()
    for v, bits in ((4096, 16), (4096, 16), (0, 24), (0, 24), (48000, 20),
                    (nch - 1, 3), (15, 5), (total, 36)):
        sbw.write(v, bits)
    sbw.align()
    sinfo = sbw.data() + b"\x00" * 16
    return (b"fLaC" + bytes([0x80]) + len(sinfo).to_bytes(3, "big")
            + sinfo + frames_payload)


def _frame_header(bw, block_size, ch_code):
    for v, bits in ((0b11111111111110, 14), (0, 1), (0, 1), (7, 4),
                    (10, 4), (ch_code, 4), (4, 3), (0, 1)):
        bw.write(v, bits)
    for b in _utf8_number(0):
        bw.write(b, 8)
    bw.write(block_size - 1, 16)
    bw.write(_crc8(np.frombuffer(bytes(bw.buf), np.uint8)), 8)


def _finish_frame(bw):
    bw.align()
    body = bw.data()
    return body + struct.pack(">H", _crc16(np.frombuffer(body, np.uint8)))


def _rice(bw, residuals, k):
    bw.write(0, 2)
    bw.write(0, 4)
    bw.write(k, 4)
    for r in residuals:
        u = (int(r) << 1) ^ (int(r) >> 63)
        bw.write_unary(u >> k)
        bw.write(u & ((1 << k) - 1), k)


def _lpc():
    rng = np.random.default_rng(3)
    n, order, prec, shift = 64, 3, 12, 9
    coefs = [410, -230, 117]
    warm = rng.integers(-2000, 2000, order).tolist()
    res = rng.integers(-60, 60, n - order).tolist()
    x = list(warm)
    for i in range(order, n):
        x.append(res[i - order]
                 + (sum(coefs[j] * x[i - 1 - j] for j in range(order))
                    >> shift))
    bw = _BitWriter()
    _frame_header(bw, n, 0)
    bw.write(0, 1)
    bw.write(32 | (order - 1), 6)
    bw.write(0, 1)
    for v in warm:
        bw.write(int(v), 16)
    bw.write(prec - 1, 4)
    bw.write(shift, 5)
    for c in coefs:
        bw.write(c, prec)
    _rice(bw, res, 4)
    return _stream(_finish_frame(bw), total=n), np.asarray([x])


def _stereo(ch_code):
    rng = np.random.default_rng(4 + ch_code)
    n = 48
    L = rng.integers(-30000, 30000, n)
    R = rng.integers(-30000, 30000, n)
    side = L - R
    subs = {8: [(L, 16), (side, 17)], 9: [(side, 17), (R, 16)],
            10: [((L + R) >> 1, 16), (side, 17)]}[ch_code]
    bw = _BitWriter()
    _frame_header(bw, n, ch_code)
    for vals, bits in subs:
        bw.write(0, 1)
        bw.write(1, 6)
        bw.write(0, 1)
        for v in vals:
            bw.write(int(v), bits)
    return _stream(_finish_frame(bw), nch=2, total=n), np.stack([L, R])


def _wasted_fixed4():
    rng = np.random.default_rng(7)
    n, wasted = 16, 3
    i = np.arange(n, dtype=np.int64)
    x = ((i ** 3 - 5 * i ** 2 + 3 * i + 7 + rng.integers(-2, 3, n))
         << wasted).astype(np.int64)
    y = x >> wasted
    res = y.copy()
    for _ in range(4):
        res = np.diff(res)
    bw = _BitWriter()
    _frame_header(bw, n, 0)
    bw.write(0, 1)
    bw.write(8 + 4, 6)
    bw.write(1, 1)
    bw.write(1, wasted)
    for v in y[:4].tolist():
        bw.write(int(v), 16 - wasted)
    _rice(bw, res.tolist(), 2)
    return _stream(_finish_frame(bw), total=n), x[None]


def _rice2_escape():
    rng = np.random.default_rng(8)
    n = 64
    x = rng.integers(-50, 50, n)
    bw = _BitWriter()
    _frame_header(bw, n, 0)
    bw.write(0, 1)
    bw.write(8, 6)
    bw.write(0, 1)
    bw.write(1, 2)
    bw.write(2, 4)
    for i, part in enumerate(np.array_split(x, 4)):
        if i == 1:
            bw.write(0x1F, 5)
            bw.write(7, 5)
            for v in part.tolist():
                bw.write(int(v), 7)
        else:
            bw.write(3, 5)
            for r in part.tolist():
                u = (int(r) << 1) ^ (int(r) >> 63)
                bw.write_unary(u >> 3)
                bw.write(u & 7, 3)
    return _stream(_finish_frame(bw), total=n), x[None]


def _corrupted():
    import tempfile
    x = (0.1 * np.sin(np.arange(5000) * 0.01)).astype(np.float32)[None]
    with tempfile.TemporaryDirectory() as d:
        p = d + "/c.flac"
        j_flac.write_flac(p, x, 48000.0)
        raw = bytearray(open(p, "rb").read())
    raw[len(raw) // 2] ^= 0x40
    return bytes(raw), None


FLAC_STREAMS = {
    "lpc_order3": _lpc, "left_side": lambda: _stereo(8),
    "right_side": lambda: _stereo(9), "mid_side": lambda: _stereo(10),
    "wasted_bits_fixed4": _wasted_fixed4,
    "rice2_partitions_escape": _rice2_escape, "crc16_corrupted": _corrupted,
}


@pytest.mark.parametrize("case", sorted(FLAC_STREAMS))
def test_flac_decoder_edge_cases(tmp_path, case):
    """The decode-only paths (LPC, stereo decorrelation, wasted bits, RICE2
    with an escaped partition) give the integers the stream was built
    from, as flan_tpu's decoder does; a corrupted frame is refused by
    both with one error."""
    data, want = FLAC_STREAMS[case]()
    p = tmp_path / f"{case}.flac"
    p.write_bytes(data)
    if want is None:
        err = _error(flac.read_flac, str(p))
        assert err is not None and err[0] is ValueError
        assert err == _error(j_flac.read_flac, str(p))
        return
    got, sr = flac.read_flac(str(p))
    ref, ref_sr = j_flac.read_flac(str(p))
    assert sr == ref_sr
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(np.rint(got * 32768).astype(np.int64),
                                  want)


def test_flac_rice_fallback_matches_the_fixed_point():
    """The sequential fallback and the vectorized fixed point decode the
    same residuals (tests/test_flac.py's case, on the port's reader)."""
    rng = np.random.default_rng(9)
    res = rng.integers(-200, 200, 500).tolist()
    bw = _BitWriter()
    for r in res:
        u = (r << 1) ^ (r >> 63)
        bw.write_unary(u >> 4)
        bw.write(u & 15, 4)
    bw.align()
    vals = flac._BitReader(bw.data()).read_rice_block(500, 4)
    np.testing.assert_array_equal(vals, np.asarray(res))
