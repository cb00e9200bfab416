"""Ogg/Vorbis codec via the system libvorbis, bound with ctypes.

The reference delegates every compressed format to an external codec
library (libsndfile; reference src/flan/Audio/AudioBuffer.cpp:86-117) —
this module does the same for Ogg/Vorbis with the system libvorbisfile
(decode) and libvorbisenc/libogg (encode), keeping the codec on
the host. No Python packages are required: the
shared objects ship with the OS image and are loaded lazily; when they
are absent, read/write raise a clear RuntimeError naming the missing
library (the WAV/FLAC/AIFF codecs stay pure-Python).

Opaque libvorbis state structs (OggVorbis_File, vorbis_dsp_state,
vorbis_block, ogg_stream_state) are allocated as oversized byte buffers
and only ever handled by address — the standard ctypes pattern for
libraries whose struct internals are private ABI. The few structs whose
fields we read (vorbis_info.channels/rate, ogg_packet, ogg_page) have
stable public layouts declared below.

Copied from flan_tpu/io/ogg.py as numpy only: this package never
imports the JAX package.
"""
from __future__ import annotations

import ctypes
import ctypes.util
from typing import Optional, Tuple

import numpy as np

_LIBS: Optional[Tuple] = None
_LIB_ERR: Optional[str] = None


class _VorbisInfo(ctypes.Structure):
    # public prefix of vorbis_info (codec.h); the tail is opaque
    _fields_ = [("version", ctypes.c_int),
                ("channels", ctypes.c_int),
                ("rate", ctypes.c_long),
                ("bitrate_upper", ctypes.c_long),
                ("bitrate_nominal", ctypes.c_long),
                ("bitrate_lower", ctypes.c_long),
                ("bitrate_window", ctypes.c_long),
                ("codec_setup", ctypes.c_void_p)]


class _VorbisComment(ctypes.Structure):
    _fields_ = [("user_comments", ctypes.POINTER(ctypes.c_char_p)),
                ("comment_lengths", ctypes.POINTER(ctypes.c_int)),
                ("comments", ctypes.c_int),
                ("vendor", ctypes.c_char_p)]


class _OggPacket(ctypes.Structure):
    _fields_ = [("packet", ctypes.POINTER(ctypes.c_ubyte)),
                ("bytes", ctypes.c_long),
                ("b_o_s", ctypes.c_long),
                ("e_o_s", ctypes.c_long),
                ("granulepos", ctypes.c_int64),
                ("packetno", ctypes.c_int64)]


class _OggPage(ctypes.Structure):
    _fields_ = [("header", ctypes.POINTER(ctypes.c_ubyte)),
                ("header_len", ctypes.c_long),
                ("body", ctypes.POINTER(ctypes.c_ubyte)),
                ("body_len", ctypes.c_long)]


def _opaque(size: int):
    """Oversized zeroed buffer standing in for a private-ABI struct."""
    return ctypes.create_string_buffer(size)


def _load():
    global _LIBS, _LIB_ERR
    if _LIBS is not None or _LIB_ERR is not None:
        return _LIBS
    names = {
        "vorbisfile": ("libvorbisfile.so.3", "libvorbisfile.so",
                       "vorbisfile"),
        "vorbis": ("libvorbis.so.0", "libvorbis.so", "vorbis"),
        "vorbisenc": ("libvorbisenc.so.2", "libvorbisenc.so", "vorbisenc"),
        "ogg": ("libogg.so.0", "libogg.so", "ogg"),
    }
    libs = {}
    for key, cands in names.items():
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
            _LIB_ERR = (f"system lib{key} not found; Ogg/Vorbis support "
                        "needs the OS libvorbis stack")
            return None
        libs[key] = lib

    vf, vo, ve, og = (libs["vorbisfile"], libs["vorbis"],
                      libs["vorbisenc"], libs["ogg"])
    vf.ov_fopen.argtypes = [ctypes.c_char_p, ctypes.c_void_p]
    vf.ov_fopen.restype = ctypes.c_int
    vf.ov_info.argtypes = [ctypes.c_void_p, ctypes.c_int]
    vf.ov_info.restype = ctypes.POINTER(_VorbisInfo)
    vf.ov_pcm_total.argtypes = [ctypes.c_void_p, ctypes.c_int]
    vf.ov_pcm_total.restype = ctypes.c_int64
    vf.ov_read_float.argtypes = [
        ctypes.c_void_p,
        ctypes.POINTER(ctypes.POINTER(ctypes.POINTER(ctypes.c_float))),
        ctypes.c_int, ctypes.POINTER(ctypes.c_int)]
    vf.ov_read_float.restype = ctypes.c_long
    vf.ov_clear.argtypes = [ctypes.c_void_p]

    vo.vorbis_info_init.argtypes = [ctypes.c_void_p]
    vo.vorbis_comment_init.argtypes = [ctypes.c_void_p]
    vo.vorbis_analysis_init.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
    vo.vorbis_block_init.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
    vo.vorbis_analysis_headerout.argtypes = [ctypes.c_void_p] * 2 + [
        ctypes.POINTER(_OggPacket)] * 3
    vo.vorbis_analysis_buffer.argtypes = [ctypes.c_void_p, ctypes.c_int]
    vo.vorbis_analysis_buffer.restype = ctypes.POINTER(
        ctypes.POINTER(ctypes.c_float))
    vo.vorbis_analysis_wrote.argtypes = [ctypes.c_void_p, ctypes.c_int]
    vo.vorbis_analysis_blockout.argtypes = [ctypes.c_void_p,
                                            ctypes.c_void_p]
    vo.vorbis_analysis_blockout.restype = ctypes.c_int
    vo.vorbis_analysis.argtypes = [ctypes.c_void_p,
                                   ctypes.POINTER(_OggPacket)]
    vo.vorbis_bitrate_addblock.argtypes = [ctypes.c_void_p]
    vo.vorbis_bitrate_flushpacket.argtypes = [ctypes.c_void_p,
                                              ctypes.POINTER(_OggPacket)]
    vo.vorbis_bitrate_flushpacket.restype = ctypes.c_int

    ve.vorbis_encode_init_vbr.argtypes = [ctypes.c_void_p, ctypes.c_long,
                                          ctypes.c_long, ctypes.c_float]
    ve.vorbis_encode_init_vbr.restype = ctypes.c_int

    og.ogg_stream_init.argtypes = [ctypes.c_void_p, ctypes.c_int]
    og.ogg_stream_packetin.argtypes = [ctypes.c_void_p,
                                       ctypes.POINTER(_OggPacket)]
    og.ogg_stream_flush.argtypes = [ctypes.c_void_p,
                                    ctypes.POINTER(_OggPage)]
    og.ogg_stream_flush.restype = ctypes.c_int
    og.ogg_stream_pageout.argtypes = [ctypes.c_void_p,
                                      ctypes.POINTER(_OggPage)]
    og.ogg_stream_pageout.restype = ctypes.c_int
    og.ogg_stream_clear.argtypes = [ctypes.c_void_p]

    _LIBS = (vf, vo, ve, og)
    return _LIBS


def available() -> bool:
    return _load() is not None


def read_ogg(path: str) -> Tuple[np.ndarray, float]:
    """Ogg/Vorbis file -> (float32 [channels, frames], sample_rate)."""
    libs = _load()
    if libs is None:
        raise RuntimeError(_LIB_ERR)
    vf = libs[0]
    ovf = _opaque(4096)   # OggVorbis_File (real sizeof ~944 on x86-64)
    rc = vf.ov_fopen(path.encode(), ovf)
    if rc != 0:
        raise ValueError(f"{path}: not a decodable Ogg/Vorbis file "
                         f"(ov_fopen rc={rc})")
    try:
        info = vf.ov_info(ovf, -1).contents
        channels, sr = int(info.channels), float(info.rate)
        total = int(vf.ov_pcm_total(ovf, -1))
        chunks = []
        pcm = ctypes.POINTER(ctypes.POINTER(ctypes.c_float))()
        bitstream = ctypes.c_int(0)
        while True:
            n = vf.ov_read_float(ovf, ctypes.byref(pcm), 4096,
                                 ctypes.byref(bitstream))
            if n == 0:
                break
            if n < 0:     # hole in the stream; libvorbisfile resyncs
                continue
            block = np.stack([
                np.ctypeslib.as_array(pcm[c], shape=(n,)).copy()
                for c in range(channels)])
            chunks.append(block)
        data = (np.concatenate(chunks, axis=1) if chunks
                else np.zeros((channels, 0), np.float32))
        if 0 < total < data.shape[1]:
            data = data[:, :total]
        return np.ascontiguousarray(data, np.float32), sr
    finally:
        vf.ov_clear(ovf)


def write_ogg(path: str, data: np.ndarray, sample_rate: float,
              quality: float = 0.4) -> None:
    """float32 [channels, frames] -> Ogg/Vorbis (VBR, quality in [-0.1, 1])."""
    libs = _load()
    if libs is None:
        raise RuntimeError(_LIB_ERR)
    _, vo, ve, og = libs
    data = np.ascontiguousarray(np.asarray(data, np.float32))
    channels, frames = data.shape

    vi = _opaque(256)         # vorbis_info (sizeof 64)
    vc = _opaque(256)         # vorbis_comment (sizeof 32)
    vd = _opaque(4096)        # vorbis_dsp_state (sizeof ~144)
    vb = _opaque(4096)        # vorbis_block (sizeof ~192)
    os_ = _opaque(4096)       # ogg_stream_state (sizeof ~408)
    vo.vorbis_info_init(vi)
    rc = ve.vorbis_encode_init_vbr(vi, channels, int(sample_rate),
                                   float(quality))
    if rc != 0:
        vo.vorbis_info_clear(vi)
        raise ValueError(
            f"vorbis_encode_init_vbr failed (rc={rc}): channels="
            f"{channels} rate={sample_rate} quality={quality}")
    vo.vorbis_comment_init(vc)
    vo.vorbis_analysis_init(vd, vi)
    vo.vorbis_block_init(vd, vb)
    og.ogg_stream_init(os_, 1)

    page = _OggPage()
    pkt = _OggPacket()
    out = []

    def drain_pages(flush: bool) -> None:
        fn = og.ogg_stream_flush if flush else og.ogg_stream_pageout
        while fn(os_, ctypes.byref(page)) != 0:
            out.append(ctypes.string_at(page.header, page.header_len))
            out.append(ctypes.string_at(page.body, page.body_len))

    try:
        h1, h2, h3 = _OggPacket(), _OggPacket(), _OggPacket()
        vo.vorbis_analysis_headerout(vd, vc, ctypes.byref(h1),
                                     ctypes.byref(h2), ctypes.byref(h3))
        for h in (h1, h2, h3):
            og.ogg_stream_packetin(os_, ctypes.byref(h))
        drain_pages(flush=True)   # headers must end their own page

        step = 4096
        pos = 0
        while True:
            n = min(step, frames - pos)
            buf = vo.vorbis_analysis_buffer(vd, max(n, 1))
            for c in range(channels):
                if n > 0:
                    ctypes.memmove(
                        buf[c],
                        data[c, pos:pos + n].ctypes.data,
                        n * 4)
            vo.vorbis_analysis_wrote(vd, n)   # n == 0 marks end of stream
            while vo.vorbis_analysis_blockout(vd, vb) == 1:
                vo.vorbis_analysis(vb, None)
                vo.vorbis_bitrate_addblock(vb)
                while vo.vorbis_bitrate_flushpacket(
                        vd, ctypes.byref(pkt)) == 1:
                    og.ogg_stream_packetin(os_, ctypes.byref(pkt))
                    drain_pages(flush=False)
            if n == 0:
                break
            pos += n
        drain_pages(flush=True)
    finally:
        og.ogg_stream_clear(os_)
        vo.vorbis_block_clear(vb)
        vo.vorbis_dsp_clear(vd)
        vo.vorbis_comment_clear(vc)
        vo.vorbis_info_clear(vi)

    with open(path, "wb") as f:
        f.write(b"".join(out))
