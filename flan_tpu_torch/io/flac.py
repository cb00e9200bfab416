"""FLAC codec: host-side decode (subset-complete) + minimal encode.

Closes the last I/O-boundary gap vs the reference, which loads every
libsndfile format (reference: src/flan/Audio/AudioBuffer.cpp:86-117);
WAV covers the save path and FLAC is the one compressed format the
reference's own docs/tests actually use. Pure numpy on the host — like
io/wav.py, the codec feeds one host-to-device copy and the compute path
never touches it.

Decoder coverage (https://xiph.org/flac/format.html):
* STREAMINFO + skipped metadata blocks, fixed & variable blocking
* frame-header block-size/sample-rate/sample-size escapes, CRC-8/CRC-16
* channel assignments: independent, left/side, right/side, mid/side
* subframes: CONSTANT, VERBATIM, FIXED orders 0-4, LPC orders 1-32,
  wasted bits
* residual: RICE (4-bit) and RICE2 (5-bit) partitions incl. escape
  (raw n-bit) partitions

Rice decoding is vectorized: terminator bits are located by a monotone
fixed-point over the global ones-positions array (the fixed-point
condition IS the code's self-consistency, so convergence == correctness;
a bisect loop is the guaranteed fallback).

Encoder (for Audio.save and the round-trip tests): 16/24-bit, fixed
blocking, independent channels, CONSTANT/VERBATIM/FIXED(0-2) subframes,
single-partition Rice, MD5 signature.

Copied from flan_tpu/io/flac.py as numpy only: this package never
imports the JAX package.
"""
from __future__ import annotations

import hashlib
import struct
from typing import List, Tuple

import numpy as np

_BLOCK_SIZES = {1: 192, 2: 576, 3: 1152, 4: 2304, 5: 4608,
                8: 256, 9: 512, 10: 1024, 11: 2048, 12: 4096,
                13: 8192, 14: 16384, 15: 32768}
_SAMPLE_RATES = {1: 88200, 2: 176400, 3: 192000, 4: 8000, 5: 16000,
                 6: 22050, 7: 24000, 8: 32000, 9: 44100, 10: 48000,
                 11: 96000}
_SAMPLE_SIZES = {1: 8, 2: 12, 4: 16, 5: 20, 6: 24, 7: 32}

_CRC8_TABLE = None
_CRC16_TABLE = None


def _crc_tables():
    global _CRC8_TABLE, _CRC16_TABLE
    if _CRC8_TABLE is None:
        t8 = np.zeros(256, np.uint8)
        for i in range(256):
            c = i
            for _ in range(8):
                c = ((c << 1) ^ 0x07) & 0xFF if c & 0x80 else (c << 1) & 0xFF
            t8[i] = c
        t16 = np.zeros(256, np.uint16)
        for i in range(256):
            c = i << 8
            for _ in range(8):
                c = ((c << 1) ^ 0x8005) & 0xFFFF if c & 0x8000 \
                    else (c << 1) & 0xFFFF
            t16[i] = c
        _CRC8_TABLE, _CRC16_TABLE = t8, t16
    return _CRC8_TABLE, _CRC16_TABLE


def _crc8(data: np.ndarray) -> int:
    t8, _ = _crc_tables()
    c = 0
    for b in data.tolist():
        c = int(t8[c ^ b])
    return c


def _crc16(data: np.ndarray) -> int:
    _, t16 = _crc_tables()
    c = 0
    for b in data.tolist():
        c = (int(t16[((c >> 8) ^ b) & 0xFF]) ^ ((c << 8) & 0xFFFF))
    return c


class _BitReader:
    """MSB-first reader over a byte buffer, tracking a global bit pos."""

    def __init__(self, data: bytes):
        self.bytes = np.frombuffer(data, np.uint8)
        self.bits = np.unpackbits(self.bytes)
        self.ones = np.flatnonzero(self.bits).astype(np.int64)
        self.pos = 0

    def read(self, n: int) -> int:
        if n == 0:
            return 0
        if self.pos + n > self.bits.shape[0]:
            raise ValueError("flac: bitstream truncated")
        v = 0
        for b in self.bits[self.pos:self.pos + n].tolist():
            v = (v << 1) | int(b)
        self.pos += n
        return v

    def read_signed(self, n: int) -> int:
        v = self.read(n)
        return v - (1 << n) if v & (1 << (n - 1)) else v

    def read_unary(self) -> int:
        i = np.searchsorted(self.ones, self.pos)
        if i >= self.ones.shape[0]:
            raise ValueError("flac: bitstream truncated (unary)")
        stop = int(self.ones[i])
        q = stop - self.pos
        self.pos = stop + 1
        return q

    def align(self) -> None:
        self.pos = (self.pos + 7) & ~7

    def read_utf8_number(self) -> int:
        """FLAC's UTF-8-style coded number (frame/sample index)."""
        b0 = self.read(8)
        if b0 < 0x80:
            return b0
        n = 0
        mask = 0x40
        while b0 & mask:
            n += 1
            mask >>= 1
        if n < 1 or n > 6:
            raise ValueError("flac: bad coded number")
        v = b0 & (mask - 1)
        for _ in range(n):
            c = self.read(8)
            if (c & 0xC0) != 0x80:
                raise ValueError("flac: bad coded number continuation")
            v = (v << 6) | (c & 0x3F)
        return v

    def read_rice_block(self, n: int, k: int) -> np.ndarray:
        """n Rice(k) codes -> zigzag-decoded int64 values, vectorized."""
        if n == 0:
            return np.zeros(0, np.int64)
        ones, bits, pos = self.ones, self.bits, self.pos
        start = int(np.searchsorted(ones, pos))
        if start + n > ones.shape[0]:
            raise ValueError("flac: bitstream truncated (rice)")
        if k == 0:
            sel = np.arange(start, start + n, dtype=np.int64)
        else:
            # terminator chain: sel[0] = first one at/after pos;
            # sel[j+1] = first one past terminator j's k remainder bits.
            # Jacobi-style iteration with a cumulative-displacement
            # update; the exact chain condition (not iterate equality)
            # decides convergence, so an interim overshoot cannot be
            # accepted as an answer.
            sel = np.arange(start, start + n, dtype=np.int64)
            ok = False
            for _ in range(64):
                # interim iterates may overshoot the ones array; clamp -
                # the exact-chain check below never passes on a clamped
                # wrong answer, and true truncation was raised above
                sel = np.minimum(sel, ones.shape[0] - 1)
                t = ones[sel]
                nxt = np.searchsorted(ones, t + k + 1)
                if n == 1 or np.array_equal(sel[1:], nxt[:-1]):
                    ok = True
                    break
                sel_new = np.empty(n, np.int64)
                sel_new[0] = start
                # cumulative displacement: ones swallowed by remainders
                sel_new[1:] = start + np.arange(1, n) + np.cumsum(
                    nxt[:-1] - sel[:-1] - 1)
                sel = np.maximum.accumulate(sel_new)
            if not ok:          # guaranteed fallback: bisect chain
                sel = np.empty(n, np.int64)
                p = pos
                for j in range(n):
                    i = int(np.searchsorted(ones, p))
                    if i >= ones.shape[0]:
                        raise ValueError(
                            "flac: bitstream truncated (rice)")
                    sel[j] = i
                    p = int(ones[i]) + 1 + k
        t = ones[sel]
        prev_end = np.empty(n, np.int64)
        prev_end[0] = pos
        prev_end[1:] = t[:-1] + 1 + k
        q = t - prev_end
        if (q < 0).any():
            raise ValueError("flac: corrupt rice stream")
        u = q.astype(np.int64) << k
        if k:
            idx = t[:, None] + 1 + np.arange(k, dtype=np.int64)[None, :]
            if int(idx[-1, -1]) >= bits.shape[0]:
                raise ValueError("flac: bitstream truncated (rice)")
            rem = bits[idx].astype(np.int64) @ (
                1 << np.arange(k - 1, -1, -1, dtype=np.int64))
            u |= rem
        self.pos = int(t[-1]) + 1 + k
        return (u >> 1) ^ -(u & 1)

    def read_fixed_block(self, n: int, nbits: int) -> np.ndarray:
        """n signed nbits-wide integers, vectorized."""
        if n == 0 or nbits == 0:
            return np.zeros(n, np.int64)
        if self.pos + n * nbits > self.bits.shape[0]:
            raise ValueError("flac: bitstream truncated (raw)")
        idx = (self.pos + np.arange(n, dtype=np.int64)[:, None] * nbits
               + np.arange(nbits, dtype=np.int64)[None, :])
        v = self.bits[idx].astype(np.int64) @ (
            1 << np.arange(nbits - 1, -1, -1, dtype=np.int64))
        self.pos += n * nbits
        sign = 1 << (nbits - 1)
        return (v ^ sign) - sign


def _decode_residual(br: _BitReader, block_size: int,
                     pred_order: int) -> np.ndarray:
    method = br.read(2)
    if method > 1:
        raise ValueError("flac: reserved residual method")
    pbits, escape = (4, 0xF) if method == 0 else (5, 0x1F)
    po = br.read(4)
    nparts = 1 << po
    if block_size % nparts or block_size >> po <= pred_order:
        raise ValueError("flac: bad partition order")
    out = np.empty(block_size - pred_order, np.int64)
    w = 0
    for p in range(nparts):
        cnt = (block_size >> po) - (pred_order if p == 0 else 0)
        k = br.read(pbits)
        if k == escape:
            nbits = br.read(5)
            vals = br.read_fixed_block(cnt, nbits)
        else:
            vals = br.read_rice_block(cnt, k)
        out[w:w + cnt] = vals
        w += cnt
    return out


_FIXED_COEFS = {0: [], 1: [1], 2: [2, -1], 3: [3, -3, 1], 4: [4, -6, 4, -1]}


def _undo_fixed(order: int, warm: np.ndarray, res: np.ndarray) -> np.ndarray:
    """Invert the order-th difference: `order` chained int64 cumsums.

    The FIXED residual is exactly the order-th forward difference of the
    signal, so reconstruction = repeated prefix sums seeded from the
    warmup samples' own difference pyramid (exact in int64)."""
    out = np.concatenate([warm, res])
    if order == 0:
        return out
    # difference pyramid of the warmup: d[j] = j-th difference at the
    # boundary; res continues the order-th difference sequence
    levels = [out[:order + 0].copy()]
    for j in range(1, order + 1):
        levels.append(np.diff(levels[-1]))
    seq = out[order:].copy()           # order-th differences (residuals)
    for j in range(order, 0, -1):
        seed = levels[j - 1][-1]
        seq = seed + np.cumsum(seq)
    return np.concatenate([warm, seq])


def _decode_subframe(br: _BitReader, block_size: int,
                     bps: int) -> np.ndarray:
    if br.read(1):
        raise ValueError("flac: bad subframe padding bit")
    t = br.read(6)
    wasted = 0
    if br.read(1):
        wasted = br.read_unary() + 1
    eff = bps - wasted
    if t == 0:                                          # CONSTANT
        out = np.full(block_size, br.read_signed(eff), np.int64)
    elif t == 1:                                        # VERBATIM
        out = br.read_fixed_block(block_size, eff)
    elif 8 <= t <= 12:                                  # FIXED 0-4
        order = t - 8
        warm = br.read_fixed_block(order, eff)
        res = _decode_residual(br, block_size, order)
        out = _undo_fixed(order, warm, res)
    elif t >= 32:                                       # LPC
        order = (t & 31) + 1
        warm = br.read_fixed_block(order, eff)
        prec = br.read(4) + 1
        if prec == 16:
            raise ValueError("flac: invalid qlp precision")
        shift = br.read_signed(5)
        if shift < 0:
            raise ValueError("flac: negative qlp shift")
        coefs = [br.read_signed(prec) for _ in range(order)]
        res = _decode_residual(br, block_size, order)
        out = np.empty(block_size, np.int64)
        out[:order] = warm
        hist = [int(v) for v in warm[::-1]]             # newest first
        co = [int(cc) for cc in coefs]
        r = res.tolist()
        o = out
        for i in range(order, block_size):
            p = 0
            for j in range(order):
                p += co[j] * hist[j]
            v = r[i - order] + (p >> shift)
            o[i] = v
            hist = [v] + hist[:-1]
    else:
        raise ValueError(f"flac: reserved subframe type {t}")
    return out << wasted if wasted else out


def read_flac(path: str) -> Tuple[np.ndarray, float]:
    """Decode a FLAC file -> (float32 [channels, frames] in [-1, 1),
    sample_rate). Mirrors io/wav.py's PCM scaling (1 / 2^(bps-1))."""
    with open(path, "rb") as f:
        data = f.read()
    try:
        return _read_flac_bytes(data)
    except (IndexError, struct.error) as e:
        # truncated/garbage stream: any out-of-range bit read means the
        # file ended mid-structure — surface it like every other codec
        # error instead of an internal IndexError
        raise ValueError(f"flac: truncated or corrupt stream "
                         f"({path!r}): {e}") from e


def _read_flac_bytes(data: bytes) -> Tuple[np.ndarray, float]:
    if data[:4] != b"fLaC":
        raise ValueError("flac: bad stream marker")
    off = 4
    sinfo = None
    while True:
        hdr = data[off]
        btype = hdr & 0x7F
        blen = int.from_bytes(data[off + 1:off + 4], "big")
        body = data[off + 4:off + 4 + blen]
        if btype == 0:
            if blen < 34:
                raise ValueError("flac: short STREAMINFO")
            br = _BitReader(body)
            br.read(16)  # min block size
            br.read(16)  # max block size
            br.read(24)
            br.read(24)
            sr = br.read(20)
            nch = br.read(3) + 1
            bps = br.read(5) + 1
            total = br.read(36)
            sinfo = (sr, nch, bps, total)
        off += 4 + blen
        if hdr & 0x80:
            break
    if sinfo is None:
        raise ValueError("flac: missing STREAMINFO")
    sr, nch, bps, total = sinfo

    br = _BitReader(data[off:])
    chans: List[List[np.ndarray]] = [[] for _ in range(nch)]
    nbits = br.bits.shape[0]
    while br.pos + 32 <= nbits:
        # skip any zero padding at EOF
        probe = br.read(14)
        if probe != 0b11111111111110:
            if probe == 0 and br.pos >= nbits - 32:
                break
            raise ValueError("flac: lost frame sync")
        hdr_start = (br.pos - 14) // 8
        br.read(1)  # reserved
        br.read(1)  # blocking strategy
        bs_code = br.read(4)
        sr_code = br.read(4)
        ch_code = br.read(4)
        ss_code = br.read(3)
        br.read(1)  # reserved
        br.read_utf8_number()
        if bs_code == 0:
            raise ValueError("flac: reserved block size code")
        elif bs_code == 6:
            block_size = br.read(8) + 1
        elif bs_code == 7:
            block_size = br.read(16) + 1
        else:
            block_size = _BLOCK_SIZES[bs_code]
        if sr_code == 12:
            br.read(8)
        elif sr_code in (13, 14):
            br.read(16)
        elif sr_code == 15:
            raise ValueError("flac: invalid sample rate code")
        frame_bps = bps if ss_code == 0 else _SAMPLE_SIZES[ss_code]
        hdr_bytes = br.bytes[hdr_start:br.pos // 8]
        if _crc8(hdr_bytes) != br.read(8):
            raise ValueError("flac: frame header CRC mismatch")

        if ch_code < 8:
            if ch_code + 1 != nch:
                raise ValueError("flac: channel count mismatch")
            subs = [_decode_subframe(br, block_size, frame_bps)
                    for _ in range(nch)]
        elif ch_code in (8, 9, 10):
            if nch != 2:
                raise ValueError("flac: stereo decorrelation on non-stereo")
            side_first = ch_code == 9
            b0 = frame_bps + (1 if side_first else 0)
            b1 = frame_bps + (0 if side_first else 1)
            s0 = _decode_subframe(br, block_size, b0)
            s1 = _decode_subframe(br, block_size, b1)
            if ch_code == 8:                      # left/side: R = L - S
                subs = [s0, s0 - s1]
            elif ch_code == 9:                    # side/right: L = S + R
                subs = [s0 + s1, s1]
            else:                                 # mid/side
                total2 = (s0 << 1) | (s1 & 1)
                subs = [(total2 + s1) >> 1, (total2 - s1) >> 1]
        else:
            raise ValueError("flac: reserved channel assignment")
        br.align()
        frame_bytes = br.bytes[hdr_start:br.pos // 8]
        if _crc16(frame_bytes) != br.read(16):
            raise ValueError("flac: frame CRC-16 mismatch")
        for c in range(nch):
            chans[c].append(subs[c])
        # stop once the declared total is reached (padding may follow)
        if total and sum(a.shape[0] for a in chans[0]) >= total:
            break

    sig = np.stack([np.concatenate(c) if c else np.zeros(0, np.int64)
                    for c in chans])
    if total:
        sig = sig[:, :total]
    scale = np.float32(1.0 / (1 << (bps - 1)))
    return sig.astype(np.float32) * scale, float(sr)


# ===========================================================================
# Encoder (minimal, spec-valid): fixed blocking, independent channels,
# CONSTANT / VERBATIM / FIXED(0-2) subframes, single-partition Rice.
# ===========================================================================

class _BitWriter:
    def __init__(self):
        self.buf = bytearray()
        self.acc = 0
        self.n = 0

    def write(self, v: int, bits: int) -> None:
        if bits == 0:
            return
        self.acc = (self.acc << bits) | (v & ((1 << bits) - 1))
        self.n += bits
        while self.n >= 8:
            self.n -= 8
            self.buf.append((self.acc >> self.n) & 0xFF)
        self.acc &= (1 << self.n) - 1

    def write_unary(self, q: int) -> None:
        while q >= 32:
            self.write(0, 32)
            q -= 32
        self.write(1, q + 1)

    def align(self) -> None:
        if self.n:
            self.write(0, 8 - self.n)

    def data(self) -> bytes:
        assert self.n == 0
        return bytes(self.buf)


def _utf8_number(n: int) -> bytes:
    if n < 0x80:
        return bytes([n])
    out = []
    nbytes = 1
    while n >= (1 << (6 + 5 * nbytes)) and nbytes < 6:
        nbytes += 1
    head = (0xFF << (7 - nbytes)) & 0xFF
    out.append(head | (n >> (6 * nbytes)))
    for i in range(nbytes - 1, -1, -1):
        out.append(0x80 | ((n >> (6 * i)) & 0x3F))
    return bytes(out)


def _best_rice_k(res: np.ndarray) -> int:
    u = (np.abs(res.astype(np.int64)) << 1)
    mean = float(u.mean()) if u.size else 0.0
    k = 0
    while (1 << (k + 1)) < mean + 1 and k < 14:
        k += 1
    return k


def _write_residual(bw: _BitWriter, res: np.ndarray) -> None:
    bw.write(0, 2)       # RICE, 4-bit params
    bw.write(0, 4)       # partition order 0
    k = _best_rice_k(res)
    bw.write(k, 4)
    u = ((res.astype(np.int64) << 1) ^ (res.astype(np.int64) >> 63))
    for v in u.tolist():
        bw.write_unary(v >> k)
        bw.write(v & ((1 << k) - 1), k)


def _write_subframe(bw: _BitWriter, x: np.ndarray, bps: int) -> None:
    if np.all(x == x[0]):
        bw.write(0, 1)
        bw.write(0, 6)
        bw.write(0, 1)
        bw.write(int(x[0]), bps)
        return
    best = None
    for order in (0, 1, 2):
        if x.shape[0] <= order:
            continue
        res = x.copy()
        for _ in range(order):
            res = np.diff(res)
        k = _best_rice_k(res)
        u = (np.abs(res) << 1)
        cost = int(np.sum(u >> k)) + res.shape[0] * (k + 1) + order * bps
        if best is None or cost < best[0]:
            best = (cost, order, res)
    cost, order, res = best
    if cost > x.shape[0] * bps:          # verbatim beats coding
        bw.write(0, 1)
        bw.write(1, 6)
        bw.write(0, 1)
        for v in x.tolist():
            bw.write(int(v), bps)
        return
    bw.write(0, 1)
    bw.write(8 + order, 6)
    bw.write(0, 1)
    for v in x[:order].tolist():
        bw.write(int(v), bps)
    _write_residual(bw, res)


def write_flac(path: str, data: np.ndarray, sample_rate: float,
               bits: int = 16, block_size: int = 4096) -> None:
    """Encode float32 [channels, frames] (clipped to [-1, 1]) as FLAC."""
    data = np.asarray(data, np.float32)
    if data.ndim != 2:
        raise ValueError("write_flac expects [channels, frames]")
    nch, n = data.shape
    if not (1 <= nch <= 8):
        raise ValueError("flac: 1..8 channels")
    if bits not in (16, 24):
        raise ValueError("flac: encoder supports 16/24-bit")
    sr = int(round(sample_rate))
    full = np.float64(1 << (bits - 1))
    q = np.clip(np.rint(data.astype(np.float64) * full),
                -full, full - 1).astype(np.int64)

    # MD5 of the interleaved little-endian signed samples
    inter = q.T.reshape(-1)
    width = bits // 8
    raw = np.zeros((inter.shape[0], width), np.uint8)
    u = inter.astype(np.int64) & ((1 << bits) - 1)
    for i in range(width):
        raw[:, i] = (u >> (8 * i)) & 0xFF
    md5 = hashlib.md5(raw.tobytes()).digest()

    sbw = _BitWriter()
    nframes_pcm = n
    # fixed blocking: min == max == block_size by convention (the final
    # short frame is excluded, as the reference encoder does)
    sbw.write(block_size, 16)
    sbw.write(block_size, 16)
    sbw.write(0, 24)
    sbw.write(0, 24)
    sbw.write(sr, 20)
    sbw.write(nch - 1, 3)
    sbw.write(bits - 1, 5)
    sbw.write(nframes_pcm & ((1 << 36) - 1), 36)
    sbw.align()
    sinfo = sbw.data() + md5

    out = bytearray()
    out += b"fLaC"
    out += bytes([0x80]) + len(sinfo).to_bytes(3, "big") + sinfo

    nblocks = max(1, -(-n // block_size))
    for fi in range(nblocks):
        seg = q[:, fi * block_size:(fi + 1) * block_size]
        bs = seg.shape[1]
        bw = _BitWriter()
        bw.write(0b11111111111110, 14)
        bw.write(0, 1)
        bw.write(0, 1)                       # fixed blocking
        bs_code = {192: 1, 576: 2, 1152: 3, 2304: 4, 4608: 5, 256: 8,
                   512: 9, 1024: 10, 2048: 11, 4096: 12, 8192: 13,
                   16384: 14, 32768: 15}.get(bs, 7)
        bw.write(bs_code, 4)
        sr_code = {88200: 1, 176400: 2, 192000: 3, 8000: 4, 16000: 5,
                   22050: 6, 24000: 7, 32000: 8, 44100: 9, 48000: 10,
                   96000: 11}.get(sr, 0)
        bw.write(sr_code, 4)
        bw.write(nch - 1, 4)                 # independent channels
        bw.write({16: 4, 24: 6}[bits], 3)
        bw.write(0, 1)
        for b in _utf8_number(fi):
            bw.write(b, 8)
        if bs_code == 7:
            bw.write(bs - 1, 16)
        hdr = bw.buf[:]
        assert bw.n == 0
        bw.write(_crc8(np.frombuffer(bytes(hdr), np.uint8)), 8)
        for c in range(nch):
            _write_subframe(bw, seg[c], bits)
        bw.align()
        body = bw.data()
        crc16 = _crc16(np.frombuffer(body, np.uint8))
        out += body + struct.pack(">H", crc16)

    with open(path, "wb") as f:
        f.write(bytes(out))
