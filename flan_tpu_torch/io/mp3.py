"""MP3 codec via the system libmpg123 (decode) and libmp3lame (encode).

The reference delegates every compressed format to an external codec
library (libsndfile; reference src/flan/Audio/AudioBuffer.cpp:86-117) —
this module does the same for MP3 with the OS decoder/encoder stack,
the same lazy-ctypes pattern as io/ogg.py. No Python packages
are required; when the shared objects are absent, read/write raise a
clear RuntimeError naming the missing library.

Decode forces float32 output (MPG123_FORCE_FLOAT) so no integer scaling
convention is involved; mpg123 honors LAME/Xing gapless tags, so
round-trips through write_mp3 come back at (close to) the original
length. Encode is CBR via lame_encode_buffer_ieee_float (±1.0 range).

Copied from flan_tpu/io/mp3.py as numpy only: this package never
imports the JAX package.
"""
from __future__ import annotations

import ctypes
import ctypes.util
from typing import Optional, Tuple

import numpy as np

_LIBS: Optional[Tuple] = None
_LIB_ERR: Optional[str] = None

_MPG123_OK = 0
_MPG123_DONE = -12
_MPG123_NEW_FORMAT = -11
_MPG123_ADD_FLAGS = 2           # enum mpg123_parms
_MPG123_FORCE_FLOAT = 0x400     # enum mpg123_param_flags
_MPG123_QUIET = 0x20
_MPG123_ENC_FLOAT_32 = 0x200


def _load():
    global _LIBS, _LIB_ERR
    if _LIBS is not None or _LIB_ERR is not None:
        return _LIBS
    libs = {}
    for key, cands in {
            "mpg123": ("libmpg123.so.0", "libmpg123.so", "mpg123"),
            "mp3lame": ("libmp3lame.so.0", "libmp3lame.so", "mp3lame"),
    }.items():
        lib = None
        for c in cands:
            try:
                lib = ctypes.CDLL(c)
                break
            except OSError:
                found = ctypes.util.find_library(c)
                if found:
                    try:
                        lib = ctypes.CDLL(found)
                        break
                    except OSError:
                        pass
        if lib is None:
            _LIB_ERR = (f"system lib{key} not found; MP3 support needs "
                        "the OS mpg123/lame stack")
            return None
        libs[key] = lib

    mg, lm = libs["mpg123"], libs["mp3lame"]
    mg.mpg123_init.restype = ctypes.c_int
    mg.mpg123_new.argtypes = [ctypes.c_char_p,
                              ctypes.POINTER(ctypes.c_int)]
    mg.mpg123_new.restype = ctypes.c_void_p
    mg.mpg123_param.argtypes = [ctypes.c_void_p, ctypes.c_int,
                                ctypes.c_long, ctypes.c_double]
    mg.mpg123_param.restype = ctypes.c_int
    mg.mpg123_open.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
    mg.mpg123_open.restype = ctypes.c_int
    mg.mpg123_getformat.argtypes = [ctypes.c_void_p,
                                    ctypes.POINTER(ctypes.c_long),
                                    ctypes.POINTER(ctypes.c_int),
                                    ctypes.POINTER(ctypes.c_int)]
    mg.mpg123_getformat.restype = ctypes.c_int
    mg.mpg123_format_none.argtypes = [ctypes.c_void_p]
    mg.mpg123_format.argtypes = [ctypes.c_void_p, ctypes.c_long,
                                 ctypes.c_int, ctypes.c_int]
    mg.mpg123_outblock.argtypes = [ctypes.c_void_p]
    mg.mpg123_outblock.restype = ctypes.c_size_t
    mg.mpg123_read.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                               ctypes.c_size_t,
                               ctypes.POINTER(ctypes.c_size_t)]
    mg.mpg123_read.restype = ctypes.c_int
    mg.mpg123_close.argtypes = [ctypes.c_void_p]
    mg.mpg123_delete.argtypes = [ctypes.c_void_p]

    lm.lame_init.restype = ctypes.c_void_p
    for fn in ("lame_set_in_samplerate", "lame_set_num_channels",
               "lame_set_brate", "lame_set_quality"):
        getattr(lm, fn).argtypes = [ctypes.c_void_p, ctypes.c_int]
        getattr(lm, fn).restype = ctypes.c_int
    lm.lame_init_params.argtypes = [ctypes.c_void_p]
    lm.lame_init_params.restype = ctypes.c_int
    lm.lame_encode_buffer_ieee_float.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_float),
        ctypes.POINTER(ctypes.c_float), ctypes.c_int,
        ctypes.c_void_p, ctypes.c_int]
    lm.lame_encode_buffer_ieee_float.restype = ctypes.c_int
    lm.lame_encode_flush.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                     ctypes.c_int]
    lm.lame_encode_flush.restype = ctypes.c_int
    lm.lame_get_lametag_frame.argtypes = [ctypes.c_void_p,
                                          ctypes.c_void_p,
                                          ctypes.c_size_t]
    lm.lame_get_lametag_frame.restype = ctypes.c_size_t
    lm.lame_close.argtypes = [ctypes.c_void_p]

    mg.mpg123_init()
    _LIBS = (mg, lm)
    return _LIBS


def available() -> bool:
    return _load() is not None


def read_mp3(path: str) -> Tuple[np.ndarray, float]:
    """MP3 file -> (float32 [channels, frames], sample_rate)."""
    libs = _load()
    if libs is None:
        raise RuntimeError(_LIB_ERR)
    mg, _ = libs
    err = ctypes.c_int(0)
    h = mg.mpg123_new(None, ctypes.byref(err))
    if not h:
        raise RuntimeError(f"mpg123_new failed (rc={err.value})")
    try:
        mg.mpg123_param(h, _MPG123_ADD_FLAGS,
                        _MPG123_FORCE_FLOAT | _MPG123_QUIET, 0.0)
        if mg.mpg123_open(h, path.encode()) != _MPG123_OK:
            raise ValueError(f"{path}: not a decodable MP3 file")
        rate = ctypes.c_long(0)
        channels = ctypes.c_int(0)
        enc = ctypes.c_int(0)
        if mg.mpg123_getformat(h, ctypes.byref(rate),
                               ctypes.byref(channels),
                               ctypes.byref(enc)) != _MPG123_OK \
                or channels.value < 1:
            raise ValueError(f"{path}: no decodable MP3 stream found")
        # lock the output format so mid-stream changes cannot occur
        mg.mpg123_format_none(h)
        mg.mpg123_format(h, rate.value, channels.value,
                         _MPG123_ENC_FLOAT_32)
        size = max(int(mg.mpg123_outblock(h)), 4096)
        buf = ctypes.create_string_buffer(size)
        done = ctypes.c_size_t(0)
        chunks = []
        while True:
            rc = mg.mpg123_read(h, buf, size, ctypes.byref(done))
            if done.value:
                chunks.append(np.frombuffer(
                    buf.raw[:done.value], dtype=np.float32).copy())
            if rc == _MPG123_DONE:
                break
            if rc not in (_MPG123_OK, _MPG123_NEW_FORMAT):
                break
        if not chunks:
            raise ValueError(f"{path}: MP3 stream decoded to no audio")
        flat = np.concatenate(chunks)
        ch = channels.value
        frames = len(flat) // ch
        data = flat[:frames * ch].reshape(frames, ch)
        return np.ascontiguousarray(data.T), float(rate.value)
    finally:
        mg.mpg123_close(h)
        mg.mpg123_delete(h)


def write_mp3(path: str, data: np.ndarray, sample_rate: float,
              bitrate_kbps: int = 192) -> None:
    """float32 [channels, frames] -> MP3 (CBR; >2 channels rejected —
    the format itself is mono/stereo only)."""
    libs = _load()
    if libs is None:
        raise RuntimeError(_LIB_ERR)
    _, lm = libs
    data = np.ascontiguousarray(np.asarray(data, np.float32))
    channels, frames = data.shape
    if channels > 2:
        raise ValueError(f"MP3 supports at most 2 channels, got "
                         f"{channels}")
    gfp = lm.lame_init()
    if not gfp:
        raise RuntimeError("lame_init failed")
    try:
        lm.lame_set_in_samplerate(gfp, int(round(sample_rate)))
        lm.lame_set_num_channels(gfp, channels)
        lm.lame_set_brate(gfp, int(bitrate_kbps))
        lm.lame_set_quality(gfp, 2)
        if lm.lame_init_params(gfp) < 0:
            raise ValueError(
                f"lame_init_params rejected rate={sample_rate} "
                f"channels={channels} bitrate={bitrate_kbps}")
        left = data[0]
        right = data[1] if channels == 2 else data[0]
        out_cap = int(1.25 * frames) + 7200
        out = ctypes.create_string_buffer(out_cap)
        n = lm.lame_encode_buffer_ieee_float(
            gfp,
            left.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            right.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            frames, out, out_cap)
        if n < 0:
            raise RuntimeError(f"lame_encode_buffer failed (rc={n})")
        blobs = [out.raw[:n]]
        n = lm.lame_encode_flush(gfp, out, out_cap)
        if n > 0:
            blobs.append(out.raw[:n])
        stream = bytearray(b"".join(blobs))
        # overwrite the placeholder first frame with the finished
        # Xing/LAME info tag so decoders (incl. mpg123) can trim the
        # codec delay/padding — without it round-trips come back ~2.5k
        # samples long and misaligned
        tag_n = int(lm.lame_get_lametag_frame(gfp, out, out_cap))
        if 0 < tag_n <= len(stream):
            stream[:tag_n] = out.raw[:tag_n]
        with open(path, "wb") as f:
            f.write(bytes(stream))
    finally:
        lm.lame_close(gfp)
