"""WAV codec: host-side RIFF/WAVE encode/decode with metadata, numpy only.

Adapted from flan_tpu/io/wav.py without its native fast path: importing
that module pulls in the JAX package, which this package never imports.
Reads PCM 8/16/24/32-bit and IEEE float32/64; writes IEEE float32 or PCM
16/24/32-bit. The 10 metadata strings the reference round-trips through
libsndfile (reference: AudioBuffer.cpp:102-111) live in a LIST/INFO chunk.
"""
from __future__ import annotations

import struct
from typing import Optional, Tuple

import numpy as np

from flan_tpu_torch.core.audio_buffer import SndfileStrings

# libsndfile-style string fields <-> RIFF LIST/INFO tag ids
_INFO_TAGS = [
    ("title", b"INAM"),
    ("copyright", b"ICOP"),
    ("software", b"ISFT"),
    ("artist", b"IART"),
    ("comment", b"ICMT"),
    ("date", b"ICRD"),
    ("album", b"IPRD"),
    ("license", b"ICLS"),
    ("tracknumber", b"ITRK"),
    ("genre", b"IGNR"),
]

WAVE_FORMAT_PCM = 1
WAVE_FORMAT_IEEE_FLOAT = 3
WAVE_FORMAT_EXTENSIBLE = 0xFFFE


def _decode_samples(raw: bytes, fmt_tag: int, bits: int,
                    num_channels: int) -> np.ndarray:
    """Raw data chunk -> float32 [channels, frames] (channel-major). A
    chunk cut short (a truncated file) gives its whole frames, as
    flan_tpu's native decoder and libsndfile read it."""
    frame_bytes = num_channels * (bits // 8)
    if frame_bytes > 0:
        raw = raw[: len(raw) // frame_bytes * frame_bytes]
    if fmt_tag == WAVE_FORMAT_IEEE_FLOAT:
        if bits not in (32, 64):
            raise ValueError(f"Unsupported float bit depth: {bits}")
        x = np.frombuffer(raw, dtype="<f4" if bits == 32 else "<f8")
        x = x.astype(np.float32)
    elif fmt_tag == WAVE_FORMAT_PCM:
        if bits == 8:
            x = (np.frombuffer(raw, dtype=np.uint8).astype(np.float32)
                 - 128.0) / 128.0
        elif bits == 16:
            x = np.frombuffer(raw, dtype="<i2").astype(np.float32) / 32768.0
        elif bits == 24:
            b = np.frombuffer(raw, dtype=np.uint8)
            n = len(b) // 3
            b = b[: n * 3].reshape(n, 3)
            vals = (b[:, 0].astype(np.int32)
                    | (b[:, 1].astype(np.int32) << 8)
                    | (b[:, 2].astype(np.int32) << 16))
            vals = np.where(vals >= (1 << 23), vals - (1 << 24), vals)
            x = vals.astype(np.float32) / float(1 << 23)
        elif bits == 32:
            x = np.frombuffer(raw, dtype="<i4").astype(np.float32) / float(
                1 << 31)
        else:
            raise ValueError(f"Unsupported PCM bit depth: {bits}")
    else:
        raise ValueError(f"Unsupported WAVE format tag: {fmt_tag}")
    num_frames = len(x) // num_channels
    x = x[: num_frames * num_channels].reshape(num_frames, num_channels)
    return np.ascontiguousarray(x.T)  # interleaved -> channel-major


def _encode_samples(data: np.ndarray, float_format: bool, bits: int) -> bytes:
    """float32 [channels, frames] -> raw interleaved bytes."""
    interleaved = np.ascontiguousarray(data.T)  # [frames, channels]
    if float_format:
        return interleaved.astype("<f4").tobytes()
    clipped = np.clip(interleaved, -1.0, 1.0)
    if bits == 16:
        q = np.clip(np.round(clipped * 32768.0), -32768,
                    32767).astype("<i2")
        return q.tobytes()
    if bits == 24:
        q = np.clip(np.round(clipped * float(1 << 23)), -(1 << 23),
                    (1 << 23) - 1).astype(np.int32)
        out = np.empty((q.size, 3), dtype=np.uint8)
        flat = q.reshape(-1)
        out[:, 0] = flat & 0xFF
        out[:, 1] = (flat >> 8) & 0xFF
        out[:, 2] = (flat >> 16) & 0xFF
        return out.tobytes()
    if bits == 32:
        # the clamp runs in float64: 2^31-1 is not representable in
        # float32, and a float32 clip would round back up to 2^31 and wrap
        # +1.0 to INT32_MIN
        q = np.clip(np.round(clipped.astype(np.float64) * float(1 << 31)),
                    -(2.0 ** 31), (1 << 31) - 1).astype("<i4")
        return q.tobytes()
    raise ValueError(f"Unsupported write bit depth: {bits}")


def read_wav(path: str) -> Tuple[np.ndarray, float, SndfileStrings]:
    """Load a WAV file -> (float32 [channels, frames], sample_rate, strings)."""
    with open(path, "rb") as f:
        blob = f.read()
    if len(blob) < 12 or blob[0:4] != b"RIFF" or blob[8:12] != b"WAVE":
        raise ValueError(f"Not a RIFF/WAVE file: {path}")

    pos = 12
    fmt = None
    raw = None
    meta = {}
    while pos + 8 <= len(blob):
        cid = blob[pos:pos + 4]
        (size,) = struct.unpack_from("<I", blob, pos + 4)
        body = blob[pos + 8: pos + 8 + size]
        if cid == b"fmt ":
            if size < 16:
                raise ValueError(f"WAV fmt chunk too short: {path}")
            fmt_tag, nch, sr, _brate, _balign, bits = struct.unpack_from(
                "<HHIIHH", body, 0)
            if fmt_tag == WAVE_FORMAT_EXTENSIBLE and size >= 40:
                # sub-format GUID's first two bytes hold the real tag
                (fmt_tag,) = struct.unpack_from("<H", body, 24)
            fmt = (fmt_tag, nch, sr, bits)
        elif cid == b"data":
            raw = body
        elif cid == b"LIST" and body[:4] == b"INFO":
            ipos = 4
            while ipos + 8 <= len(body):
                tag = body[ipos:ipos + 4]
                (tsize,) = struct.unpack_from("<I", body, ipos + 4)
                val = body[ipos + 8: ipos + 8 + tsize].split(b"\x00")[0]
                for name, tag_id in _INFO_TAGS:
                    if tag == tag_id:
                        meta[name] = val.decode("utf-8", errors="replace")
                ipos += 8 + tsize + (tsize & 1)
        pos += 8 + size + (size & 1)

    if fmt is None or raw is None:
        raise ValueError(f"WAV missing fmt/data chunk: {path}")
    fmt_tag, nch, sr, bits = fmt
    if nch < 1:
        raise ValueError(f"WAV has no channels: {path}")
    data = _decode_samples(raw, fmt_tag, bits, nch)
    return data, float(sr), SndfileStrings(**meta)


def write_wav(path: str, data: np.ndarray, sample_rate: float,
              strings: Optional[SndfileStrings] = None,
              bits: int = 32, float_format: bool = True) -> None:
    """Save float32 [channels, frames] as WAV (default IEEE float32)."""
    data = np.asarray(data, dtype=np.float32)
    if data.ndim != 2:
        raise ValueError("expected [channels, frames] array")
    nch, _ = data.shape
    sr = int(round(sample_rate))
    fmt_tag = WAVE_FORMAT_IEEE_FLOAT if float_format else WAVE_FORMAT_PCM
    if float_format:
        bits = 32
    raw = _encode_samples(data, float_format, bits)
    block_align = nch * bits // 8
    fmt_body = struct.pack("<HHIIHH", fmt_tag, nch, sr, sr * block_align,
                           block_align, bits)
    if float_format:
        fmt_body += struct.pack("<H", 0)  # cbSize for non-PCM formats

    chunks = [(b"fmt ", fmt_body), (b"data", raw)]
    if strings is not None:
        info = b"INFO"
        for name, tag_id in _INFO_TAGS:
            val = getattr(strings, name, "")
            if val:
                vb = val.encode("utf-8") + b"\x00"
                if len(vb) & 1:
                    vb += b"\x00"
                info += tag_id + struct.pack("<I", len(vb)) + vb
        if info != b"INFO":
            chunks.append((b"LIST", info))

    body = b""
    for cid, cbody in chunks:
        body += cid + struct.pack("<I", len(cbody)) + cbody
        if len(cbody) & 1:
            body += b"\x00"
    with open(path, "wb") as f:
        f.write(b"RIFF" + struct.pack("<I", 4 + len(body)) + b"WAVE" + body)
