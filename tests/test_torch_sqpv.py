"""flan_tpu_torch's SQPV slice against flan_tpu on the CPU.

The plain versions of kernels B3 and B4 (ops/sqpv_kernels.py) are held
against the JAX scan path and the fused Pallas forward in interpret mode;
the class path, its algorithms, mid/side and the new SPV methods against
flan_tpu on the same inputs; and the analytic oracles of
tests/test_sqpv_transform.py. tests/test_torch_cuda.py holds the CUDA
kernels to the plain versions on the card. Inputs are made with numpy from
a seed and handed to both packages; every tolerance names the reading it
was set from (CPU).
"""
import math
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import flan_tpu
import flan_tpu_torch
from flan_tpu.ops.sqpv_pallas import _cq_tables, sqpv_forward_fused
from flan_tpu.sqpv import SQPV as JaxSQPV
from flan_tpu.sqpv.transform import _cq_params as jax_cq_params
from flan_tpu.sqpv.transform import sqpv_forward as jax_sqpv_forward
from flan_tpu.sqpv.transform import sqpv_inverse as jax_sqpv_inverse
from flan_tpu_torch import SQPV, Audio
from flan_tpu_torch.convert import (audio_from_numpy, spv_from_numpy,
                                    sqpv_from_numpy)
from flan_tpu_torch.ops import build, sqpv_kernels
from flan_tpu_torch.ops.stft import true_div
from flan_tpu_torch.sqpv.transform import _cq_params, cq_geometry


# One intra-op thread: on an 8-core x86 host torch 2.13's CPU kernels pay
# ~10 ms to wake their worker pool for a call of a few thousand elements
# (torch.round of 16,384 floats: 14 ms on 8 threads, 6 us on one), which
# the plain versions' many small calls multiply.
torch.set_num_threads(1)

SR = 8000.0
BPO = 6.0
BAND = (100.0, 3000.0)


def _np(a):
    return np.array(a)


def _signal(n=2000, ch=1):
    rng = np.random.default_rng(7)
    t = np.arange(n, dtype=np.float32) / SR
    x = (0.4 * np.sin(2 * np.pi * 440.0 * t)
         + 0.2 * np.sin(2 * np.pi * 1187.0 * t + 0.3)
         + 0.01 * rng.standard_normal(n).astype(np.float32))
    return np.ascontiguousarray(np.stack([x, -0.5 * x])[:ch],
                                dtype=np.float32)


def _tone(f0=440.0, n=3000, ch=1):
    t = np.arange(n, dtype=np.float32) / SR
    x = (0.5 * np.sin(2 * np.pi * f0 * t)).astype(np.float32)
    return np.tile(x, (ch, 1))


def _freq(pitch, positive):
    return np.where(positive, 1.0, -1.0) * 2.0 ** pitch.astype(np.float64)


def _fit_tone_snr(y, f0, lo=1000, hi=2500):
    """SNR after fitting amplitude and phase (the inverse accumulates phase
    from zero), as tests/test_sqpv_transform.py."""
    t = np.arange(len(y), dtype=np.float64)[lo:hi] / SR
    basis = np.stack([np.sin(2 * np.pi * f0 * t),
                      np.cos(2 * np.pi * f0 * t)], 1)
    coef, *_ = np.linalg.lstsq(basis, y[lo:hi], rcond=None)
    fit = basis @ coef
    err = y[lo:hi] - fit
    return 10 * np.log10(fit @ fit / max(err @ err, 1e-20))


@pytest.fixture(scope="module", params=[(1, 2000), (2, 1300)],
                ids=["mono", "stereo-ragged"])
def forward_case(request):
    ch, n = request.param
    x = _signal(n, ch)
    xj = jnp.asarray(x)
    scan = tuple(_np(a) for a in jax_sqpv_forward(xj, SR, BPO, BAND))
    fused = tuple(_np(a) for a in sqpv_forward_fused(
        xj, sample_rate=SR, bins_per_octave=BPO, bandwidth=BAND))
    ours = tuple(a.numpy() for a in sqpv_kernels.sqpv_forward_ref(
        torch.from_numpy(x), SR, BPO, BAND))
    return x, scan, fused, ours


def test_geometry_matches_flan_tpu():
    ours, theirs = _cq_params(48000.0, 24.0, (16.0, 24000.0)), \
        jax_cq_params(48000.0, 24.0, (16.0, 24000.0))
    assert ours[0] == theirs[0] and ours[1] == theirs[1] == 254
    assert np.array_equal(ours[2], theirs[2])
    assert np.array_equal(ours[3], theirs[3])
    geo = cq_geometry(48000.0, 24.0, (16.0, 24000.0))
    # the issue's bench numbers: 102,382-sample period at 16 Hz, 121 odd
    assert geo.periods[0] == 102382 and geo.w0 == 51193
    assert int((geo.periods % 2 == 1).sum()) == 121


def test_kernel_tables_are_bit_identical():
    """The forward kernel's float32 twiddle tables are the fused TPU
    kernel's (sqpv_pallas._cq_tables), bin for bin."""
    geo = cq_geometry(SR, BPO, BAND)
    theirs = _cq_tables(SR, BPO, BAND, 128)[4:]
    t1, t2 = geo.twiddle_tables(128)
    ours = [a.astype(np.float32) for a in (t1.real, t1.imag, t2.real,
                                           t2.imag)]
    assert all(np.array_equal(a, b[..., :geo.nbins])
               for a, b in zip(ours, theirs))


def test_forward_ref_has_odd_periods_in_play(forward_case):
    periods = cq_geometry(SR, BPO, BAND).periods
    assert (periods % 2 == 1).any()
    x, (m_s, _, _), _, (mag, _, _) = forward_case
    assert mag.shape == m_s.shape == (x.shape[0], x.shape[1],
                                      len(periods))


@pytest.mark.parametrize("jax_path", ["scan", "fused"])
def test_forward_ref_matches_jax(forward_case, jax_path):
    x, scan, fused, (mag, pitch, positive) = forward_case
    want_m, want_p, want_s = scan if jax_path == "scan" else fused
    assert mag.shape == want_m.shape and positive.dtype == np.bool_
    scale = np.abs(want_m).max()
    # readings: 1.0e-6 (scan), 9.0e-7 (fused, which carries per 128-frame
    # tile); bound 5e-6
    assert np.abs(mag - want_m).max() < 5e-6 * scale
    # frequencies on bins above 1e-2 of the peak: readings 0.029 Hz (scan)
    # and 0.055 Hz (fused); bound 0.1 Hz, the SPV tests' bound
    live = want_m > 1e-2 * scale
    assert live.any()
    assert np.abs(_freq(pitch, positive) - _freq(want_p, want_s))[live].max() \
        < 0.1
    assert np.array_equal(positive[live], want_s[live])


@pytest.mark.parametrize("planes_from", ["port", "jax"])
def test_inverse_ref_matches_jax(forward_case, planes_from):
    _, scan, _, ours = forward_case
    planes = ours if planes_from == "port" else scan
    want = _np(jax_sqpv_inverse(*(jnp.asarray(a) for a in planes), SR, BPO,
                                BAND))
    got = sqpv_kernels.sqpv_inverse_ref(
        *(torch.from_numpy(a) for a in planes), SR, BPO, BAND).numpy()
    assert got.shape == want.shape
    # reading 9.0e-5 of the peak: the JAX side sums its mod-1 cycles in
    # float32 blocks, the port in float64; bound 2e-4
    assert np.abs(got - want).max() < 2e-4 * np.abs(want).max()


def test_float64_plain_version_bounds_float32_drift():
    """The plain versions compute in their input's dtype; float64 is the
    reference the card checks measure float32 drift against."""
    x = torch.from_numpy(_signal(1500))
    m32, p32, s32 = sqpv_kernels.sqpv_forward_ref(x, SR, BPO, BAND)
    m64, p64, s64 = sqpv_kernels.sqpv_forward_ref(x.double(), SR, BPO, BAND)
    assert m64.dtype == p64.dtype == torch.float64 and s64.dtype == torch.bool
    scale = m64.abs().max()
    # readings 4.8e-7 (magnitude), 0.024 Hz (live bins) and 1.6e-5
    # (inverse); bounds as above, and 5e-5 for the inverse
    assert (m32 - m64).abs().max() < 5e-6 * scale
    live = (m64 > 1e-2 * scale).numpy()
    assert np.abs(_freq(p32.numpy(), s32.numpy())
                  - _freq(p64.numpy(), s64.numpy()))[live].max() < 0.1
    y32 = sqpv_kernels.sqpv_inverse_ref(m32, p32, s32, SR, BPO, BAND)
    y64 = sqpv_kernels.sqpv_inverse_ref(m64, p64, s64, SR, BPO, BAND)
    assert y64.dtype == torch.float64
    assert (y32 - y64).abs().max() < 5e-5 * y64.abs().max()


def test_short_chunks_change_nothing_but_rounding():
    """A chunk of 100 frames, off every 128-frame block, still matches
    (readings 5.3e-7 and 6.6e-7 of the peaks)."""
    x = torch.from_numpy(_signal(1300, 2))
    a = sqpv_kernels.sqpv_forward_ref(x, SR, BPO, BAND)
    b = sqpv_kernels.sqpv_forward_ref(x, SR, BPO, BAND, chunk=100)
    scale = a[0].abs().max()
    assert (a[0] - b[0]).abs().max() < 2e-6 * scale
    y = sqpv_kernels.sqpv_inverse_ref(*a, SR, BPO, BAND)
    y100 = sqpv_kernels.sqpv_inverse_ref(*a, SR, BPO, BAND, chunk=100)
    assert (y - y100).abs().max() < 3e-6 * y.abs().max()


# ---- the class path and its algorithms against flan_tpu

def _both(x, band=BAND, bpo=BPO):
    jsq = flan_tpu.Audio.create_from_array(x, SR).convert_to_SQPV(band, bpo)
    sq = Audio.create_from_array(x, SR, device="cpu").convert_to_SQPV(band,
                                                                      bpo)
    return jsq, sq


def test_class_round_trip_matches_flan_tpu():
    x = _signal(2500, 2)
    jsq, sq = _both(x)
    assert (sq.num_channels, sq.num_frames, sq.num_bins) == (
        jsq.num_channels, jsq.num_frames, jsq.num_bins)
    assert sq.bandwidth == jsq.bandwidth and sq.q == jsq.q
    assert np.allclose(sq.bin_frequencies(), jsq.bin_frequencies())
    assert sq.get_period(3) == jsq.get_period(3)
    want = _np(jsq.convert_to_audio().data)
    got = sq.convert_to_audio().to_numpy()
    assert got.shape == want.shape == x.shape
    # forward frequency differences integrate into phase: reading 9.8e-5 of
    # the peak, bound 2e-4
    assert np.abs(got - want).max() < 2e-4 * np.abs(want).max()


def test_state_carries_across_from_flan_tpu():
    x = _signal(2000, 1)
    jsq = flan_tpu.Audio.create_from_array(x, SR).convert_to_SQPV(BAND, BPO)
    sq = sqpv_from_numpy(_np(jsq.mag), _np(jsq.pitch), _np(jsq.positive),
                         SR, BPO, BAND, device="cpu")
    assert sq.positive.dtype == torch.bool and sq.device.type == "cpu"
    assert sq.get_max_partial_magnitude() == pytest.approx(
        jsq.get_max_partial_magnitude())
    assert [a.shape for a in sq.to_numpy()] == [jsq.mag.shape] * 3
    with pytest.raises(ValueError):
        sqpv_from_numpy(np.zeros((1, 4, 3)), np.zeros((1, 4, 2)),
                        np.ones((1, 4, 3), bool), SR, BPO, BAND,
                        device="cpu")


@pytest.fixture(scope="module")
def carried():
    """The same SQPV planes in both packages."""
    x = _signal(2000, 2)
    jsq = flan_tpu.Audio.create_from_array(x, SR).convert_to_SQPV(BAND, BPO)
    sq = sqpv_from_numpy(_np(jsq.mag), _np(jsq.pitch), _np(jsq.positive),
                         SR, BPO, BAND, device="cpu")
    return jsq, sq


@pytest.mark.parametrize("factor", [1.5, "callable"])
def test_repitch_matches_flan_tpu(carried, factor):
    jsq, sq = carried
    if factor == "callable":
        jf, tf = (lambda t, p: 1.0 + 0.5 * t), (lambda t, p: 1.0 + 0.5 * t)
    else:
        jf = tf = factor
    jup, up = jsq.repitch(jf), sq.repitch(tf)
    assert np.abs(up.pitch.numpy() - _np(jup.pitch)).max() < 1e-5
    assert np.array_equal(up.mag.numpy(), _np(jup.mag))
    want = _np(jup.convert_to_audio().data)
    got = up.convert_to_audio().to_numpy()
    # the inverse alone on one set of planes: readings 1.5e-4 (1.5x) and
    # 9.9e-5 (callable), bound 3e-4
    assert np.abs(got - want).max() < 3e-4 * np.abs(want).max()


def test_modify_pitch_matches_flan_tpu(carried):
    jsq, sq = carried
    want = _np(jsq.modify_pitch(lambda t, p: p + 0.5 * t).pitch)
    got = sq.modify_pitch(lambda t, p: p + 0.5 * t).pitch.numpy()
    assert np.abs(got - want).max() < 1e-5          # reading 0
    const = sq.modify_pitch(9.0).pitch
    assert const.shape == sq.pitch.shape and bool((const == 9.0).all())


@pytest.mark.parametrize("length,selector", [
    (0.2, lambda t, p: 0.5 * t + 0.01),
    (0.1, lambda t, p: t + 0.001 * (p - 8.0)),
    (0.1, lambda t, p: t + 100.0)])
def test_select_matches_flan_tpu(carried, length, selector):
    jsq, sq = carried
    jout, out = jsq.select(length, selector), sq.select(length, selector)
    assert out.mag.shape == jout.mag.shape
    assert np.allclose(out.mag.numpy(), _np(jout.mag), rtol=1e-6, atol=1e-9)
    assert np.allclose(out.pitch.numpy(), _np(jout.pitch), atol=1e-6)
    assert np.array_equal(out.positive.numpy(), _np(jout.positive))


def test_mid_side_sqpv_and_lr_audio_match_flan_tpu():
    x = _signal(2000, 2)
    ja = flan_tpu.Audio.create_from_array(x, SR)
    a = Audio.create_from_array(x, SR, device="cpu")
    assert np.array_equal(a.convert_to_mid_side().to_numpy(),
                          _np(ja.convert_to_mid_side().data))
    back = a.convert_to_mid_side().convert_to_left_right().to_numpy()
    assert np.abs(back - x).max() < 1e-6
    jsq, sq = ja.convert_to_ms_SQPV(BAND, BPO), a.convert_to_ms_SQPV(BAND,
                                                                      BPO)
    scale = np.abs(_np(jsq.mag)).max()
    # readings 9.9e-7 (magnitude) and 5.5e-5 (audio); bounds 5e-6, 1.5e-4
    assert np.abs(sq.mag.numpy() - _np(jsq.mag)).max() < 5e-6 * scale
    want = _np(jsq.convert_to_lr_audio().data)
    got = sq.convert_to_lr_audio().to_numpy()
    assert got.shape == want.shape == (2, 2000)
    assert np.abs(got - want).max() < 1.5e-4 * np.abs(want).max()
    mono = Audio.create_from_array(x[:1], SR, device="cpu")
    assert np.array_equal(mono.convert_to_mid_side().to_numpy(), x[:1])


def test_spv_methods_match_flan_tpu():
    x = _signal(1500, 2)
    ja = flan_tpu.Audio.create_from_array(x, SR)
    jspv = ja.convert_to_ms_SPV(64)
    spv = Audio.create_from_array(x, SR, device="cpu").convert_to_ms_SPV(64)
    scale = np.abs(_np(jspv.mag)).max()
    # reading 4.9e-7, bound the SPV tests' 1e-5
    assert np.abs(spv.mag.numpy() - _np(jspv.mag)).max() < 1e-5 * scale
    carried = spv_from_numpy(_np(jspv.mag), _np(jspv.freq), SR, device="cpu")
    assert carried.copy().freq is carried.freq
    for jmod, mod in ((jspv.repitch(1.5), carried.repitch(1.5)),
                      (jspv.modify_frequency(lambda t, f: f + 10.0 * t),
                       carried.modify_frequency(lambda t, f: f + 10.0 * t))):
        assert np.abs(mod.freq.numpy() - _np(jmod.freq)).max() < 1e-4  # 0
        want = _np(jmod.convert_to_lr_audio().data)
        got = mod.convert_to_lr_audio().to_numpy()
        assert got.shape == want.shape == x.shape
        # the SPV inverse on one set of planes: readings 6.2e-5 and 8.0e-5
        assert np.abs(got - want).max() < 2e-4 * np.abs(want).max()


# ---- analytic oracles (tests/test_sqpv_transform.py)

def test_pitch_plane_reads_true_pitch():
    sq = Audio.create_from_array(_tone(), SR, device="cpu").convert_to_SQPV(
        (200.0, 2000.0), 8.0)
    m = sq.mag[0].numpy()
    pk = int(m[1500].argmax())
    assert abs(sq.bin_to_frequency(pk) - 440.0) < 440.0 * (2 ** (1 / 8) - 1)
    # reading 5.2e-5; bound of tests/test_sqpv_transform.py
    assert abs(float(sq.pitch[0, 1500, pk]) - np.log2(440.0)) < 1e-3
    assert bool(sq.positive[0, 1500, pk])


@pytest.mark.parametrize("factor,f_out,floor_db", [(1.0, 440.0, 40.0),
                                                   (2.0, 880.0, 25.0)])
def test_tone_round_trip_snr(factor, f_out, floor_db):
    """Floors of tests/test_sqpv_transform.py; readings 96.1 and 65.7 dB."""
    sq = Audio.create_from_array(_tone(n=4000), SR, device="cpu") \
        .convert_to_SQPV((200.0, 2000.0), 8.0)
    y = sq.repitch(factor).convert_to_audio().to_numpy()[0]
    lo, hi = (1000, 2500) if factor == 1.0 else (1500, 3500)
    assert _fit_tone_snr(y, f_out, lo, hi) > floor_db


def test_null_objects_propagate():
    null = Audio.create_null()
    assert null.convert_to_SQPV(BAND, BPO).is_null()
    assert null.convert_to_mid_side().is_null()
    assert SQPV.create_null().repitch(2.0).is_null()
    assert SQPV.create_null().select(1.0, lambda t, p: t).is_null()
    assert SQPV.create_null().convert_to_audio().is_null()
    assert flan_tpu_torch.SPV.create_null().repitch(2.0).is_null()
    assert SQPV.create(2, 10, BPO, SR, BAND, device="cpu").num_bins == \
        JaxSQPV.create(2, 10, BPO, SR, BAND).num_bins


# ---- devices and dispatch, without a card

@pytest.mark.parametrize("call", ["create_from_array", "load_from_file",
                                  "audio_from_numpy", "sqpv_from_numpy",
                                  "sqpv_create"])
def test_host_data_goes_to_the_card_by_default(tmp_path, call):
    """With no device argument host data goes to "cuda": where torch sees
    a GPU the result lies there, and where it sees none the call raises as
    torch raises, instead of carrying on quietly on the CPU."""
    x = _signal(300)
    path = str(tmp_path / "x.wav")
    Audio.create_from_array(x, SR, device="cpu").save_to_file(path)
    planes = (np.zeros((1, 8, 30), np.float32),) * 2 + (
        np.ones((1, 8, 30), bool),)
    make = {
        "create_from_array": lambda: Audio.create_from_array(x, SR).data,
        "load_from_file": lambda: Audio.load_from_file(path).data,
        "audio_from_numpy": lambda: audio_from_numpy(x, SR).data,
        "sqpv_from_numpy": lambda: sqpv_from_numpy(*planes, SR, BPO,
                                                   BAND).mag,
        "sqpv_create": lambda: SQPV.create(1, 8, BPO, SR, BAND).mag}[call]
    if torch.cuda.is_available():
        assert make().device.type == "cuda"
    else:
        with pytest.raises((AssertionError, RuntimeError)):
            make()
    # a tensor keeps its own device
    t = torch.from_numpy(x)
    assert Audio.create_from_array(t, SR).device == t.device


def test_cpu_tensors_take_the_plain_versions():
    sqpv_kernels.reset_launch_counts()
    sq = Audio.create_from_array(_signal(300), SR, device="cpu") \
        .convert_to_SQPV(BAND, BPO)
    assert sq.convert_to_audio().data.shape == (1, 300)
    assert sqpv_kernels.LAUNCHES == {"sqpv_forward": 0, "sqpv_inverse": 0}


def test_other_devices_raise():
    from flan_tpu_torch.sqpv.transform import sqpv_forward, sqpv_inverse
    with pytest.raises(ValueError):
        sqpv_forward(torch.zeros((1, 64), device="meta"), SR, BPO, BAND)
    plane = torch.zeros((1, 8, 30), device="meta")
    with pytest.raises(ValueError):
        sqpv_inverse(plane, plane, plane.bool(), SR, BPO, BAND)


def test_plain_sqrt_and_log2_are_correctly_rounded_on_the_cpu():
    """stft.cpu_exact, which the plain versions take their sqrt and log2
    from, in a fresh process whose intra-op worker threads have not run
    either yet: torch's own float32 CPU versions were off there by up to
    3e-4 relative in about one process in two (sqrt) and in five (log2),
    which made the plain forward give two magnitudes for one input."""
    code = (
        "import numpy as np, torch\n"
        "from flan_tpu_torch.ops.stft import cpu_exact\n"
        "rng = np.random.default_rng(0)\n"
        "w = torch.from_numpy(rng.random((1, 4096, 300), np.float32))\n"
        "for _ in range(3):\n"
        "    w = w * 1.0001 + 0.5\n"
        "e = torch.from_numpy(rng.random((1, 696, 30), np.float32) * 1e-4"
        " + 1e-6)\n"
        "for fn, ref in ((torch.sqrt, np.sqrt), (torch.log2, np.log2)):\n"
        "    got = cpu_exact(fn, e).numpy()\n"
        "    want = ref(e.numpy().astype(np.float64)).astype(np.float32)\n"
        "    assert (np.abs(got - want) <= np.spacing(np.abs(want))).all()\n")
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    run = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=repo)
    assert run.returncode == 0, run.stderr


def test_kernel_library_lists_every_source():
    names = [p.name for p in build.sources()]
    assert names == ["probe_kernels.cu", "pv_info_kernels.cu",
                     "pv_stage_kernels.cu", "random_kernels.cu",
                     "scan_kernels.cu", "sequential_kernels.cu",
                     "spv_kernels.cu", "sqpv_kernels.cu", "synth_kernels.cu"]
    assert set(build.SIGNATURES) == {"flan_spv_forward", "flan_spv_inverse",
                                     "flan_sqpv_forward",
                                     "flan_sqpv_inverse", "flan_scan",
                                     "flan_scan_kxk", "flan_probe",
                                     "flan_saturator_multinotch",
                                     "flan_saturator_backward_maps",
                                     "flan_saturator_backward_readout",
                                     "flan_comb_swept",
                                     "flan_comb_swept_backward",
                                     "flan_stereo_delay_swept",
                                     "flan_stereo_delay_swept_backward",
                                     "flan_salience_histogram",
                                     "flan_threefry", "flan_cycle_scan",
                                     "flan_grain_overlap_add",
                                     "flan_pv_analysis", "flan_pv_synthesis"}



# ------------------------------------ the arithmetic of the redesigned B3

_GEOMETRIES = [(8000.0, 6.0, (100.0, 3000.0)), (8000.0, 24.0, (100.0, 3000.0)),
               (48000.0, 12.0, (16.0, 24000.0)),
               (48000.0, 24.0, (16.0, 24000.0))]


@pytest.mark.parametrize("sr,bpo,band", _GEOMETRIES)
def test_t1_is_the_conjugate_of_t2_one_row_up(sr, bpo, band):
    """The forward kernel stores t2 = a^(i+1) alone and takes t1 = a^-i as
    the conjugate of the row before: the float32 tables must agree bit for
    bit, row 0 of t1 being 1."""
    t1, t2 = cq_geometry(sr, bpo, band).twiddle_tables(128)
    t1r, t1i, t2r, t2i = (a.astype(np.float32) for a in
                          (t1.real, t1.imag, t2.real, t2.imag))
    assert np.array_equal(t1r[:, 1:], t2r[:, :-1])
    assert np.array_equal(t1i[:, 1:], -t2i[:, :-1])
    assert np.all(t1r[:, 0] == 1.0) and np.all(t1i[:, 0] == 0.0)


@pytest.mark.parametrize("sr,bpo,band", _GEOMETRIES[::3])
def test_forward_consts_hold_the_tables(sr, bpo, band):
    """The kernel's constants: t2 [128, B, 3, 2] is the float32 table of
    the plain version, row for row; the carry's powers start at 1, and
    their row 1 is the last row of t2 bit for bit (one tile's rotation)."""
    geo = cq_geometry(sr, bpo, band)
    t2, apow, bin_f, bin_i = (t.numpy() for t in sqpv_kernels.forward_consts(
        sr, bpo, band, torch.device("cpu")))
    _, want = geo.twiddle_tables(128)
    assert t2.shape == (128, geo.nbins, 3, 2)
    assert np.array_equal(t2[..., 0], want.real.astype(
        np.float32).transpose(1, 2, 0))
    assert np.array_equal(t2[..., 1], want.imag.astype(
        np.float32).transpose(1, 2, 0))
    assert apow.shape == (2, 3, build.SQPV_CARRY_CHUNK + 1, geo.nbins)
    assert np.all(apow[0, :, 0] == 1.0) and np.all(apow[1, :, 0] == 0.0)
    assert np.array_equal(apow[0, :, 1], t2[127, :, :, 0].T)
    assert np.array_equal(apow[1, :, 1], t2[127, :, :, 1].T)
    assert bin_f.shape == (6, geo.nbins) and bin_i.shape == (4, geo.nbins)
    scratch = sqpv_kernels.forward_scratch(2, 1000, geo, "cpu")
    ntiles = -(-(geo.w0 + 1000) // 128)
    nchunks = -(-ntiles // build.SQPV_CARRY_CHUNK)
    assert scratch.numel() == 2 * (ntiles + nchunks) * 6 * geo.nbins


def forward_carry_sequential(totals: torch.Tensor, a: torch.Tensor):
    """The forward's carry over tiles, one tile after the other: C_0 = 0,
    C_{k+1} = a (C_k + S_k) along axis 0 of the complex totals [K, ...];
    a broadcasts to one tile's shape. What the plain recurrence is and
    what the first kernel ran; returns C [K, ...]."""
    carry = torch.zeros_like(totals[0])
    out = []
    for s_k in totals:
        out.append(carry)
        carry = a * (carry + s_k)
    return torch.stack(out)


def forward_carry_chunked(totals: torch.Tensor, apow: torch.Tensor,
                          chunk: int = build.SQPV_CARRY_CHUNK):
    """The same carry in the kernel's order (csrc/sqpv_kernels.cu): within
    each chunk of `chunk` tiles the carry from 0, L_{i+1} = a (L_i + S_i)
    with a = apow[1]; over the chunks X_{q+1} = apow[chunk] X_q + D_q with
    D_q the carry out of chunk q; then C_{q chunk + i} = apow[i] X_q + L_i.
    totals: complex [K, ...]; apow: complex [chunk + 1, ...], the powers
    a^i as the host builds them."""
    k = totals.shape[0]
    nchunks = -(-k // chunk)
    pad = torch.zeros((nchunks * chunk - k,) + totals.shape[1:],
                      dtype=totals.dtype, device=totals.device)
    s = torch.cat([totals, pad]).reshape((nchunks, chunk) + totals.shape[1:])
    local = []
    carry = torch.zeros_like(s[:, 0])
    for i in range(chunk):
        local.append(carry)
        carry = apow[1] * (carry + s[:, i])
    into, x = [], torch.zeros_like(carry[0])
    for d_q in carry:               # the chunks' carries out, in turn
        into.append(x)
        x = apow[chunk] * x + d_q
    into = torch.stack(into)
    out = torch.stack([apow[i] * into + local[i] for i in range(chunk)],
                      dim=1)
    return out.reshape((nchunks * chunk,) + totals.shape[1:])[:k]


def _carry_case(sr, bpo, band, tiles, seed=3):
    """Random tile totals [tiles, 3, B] and the carry's powers in float64."""
    geo = cq_geometry(sr, bpo, band)
    rng = np.random.default_rng(seed)
    shape = (tiles, 3, geo.nbins)
    totals = rng.standard_normal(shape) + 1j * rng.standard_normal(shape)
    return totals, sqpv_kernels.carry_powers_np(geo)


@pytest.mark.parametrize("sr,bpo,band", _GEOMETRIES[::3])
@pytest.mark.parametrize("tiles", [1, 31, 32, 33, 64, 1000, 4151])
def test_chunked_carry_is_the_sequential_carry(sr, bpo, band, tiles):
    """The kernel's chunked carry against the tile-by-tile one: equal to
    rounding in float64 (6.6e-13 of the peak read at 4151 tiles), and in
    float32 as close to the float64 carry as the sequential float32 one
    (48 kHz, 4151 tiles: chunked 2.8e-6 of the peak, sequential 7.3e-5: the
    host's powers round once where the sequential product rounds every
    tile)."""
    totals, apow = _carry_case(sr, bpo, band, tiles)
    t64, p64 = torch.from_numpy(totals), torch.from_numpy(apow).movedim(1, 0)
    want = forward_carry_sequential(t64, p64[1])
    got64 = forward_carry_chunked(t64, p64)
    peak = float(want.abs().max()) or 1.0
    assert got64.shape == want.shape
    assert float((got64 - want).abs().max()) <= 1e-11 * peak
    t32, p32 = t64.to(torch.complex64), p64.to(torch.complex64)
    seq32 = forward_carry_sequential(t32, p32[1])
    got32 = forward_carry_chunked(t32, p32)
    err_chunked = float((got32.to(torch.complex128) - want).abs().max())
    err_seq = float((seq32.to(torch.complex128) - want).abs().max())
    assert err_chunked <= 2.0 * err_seq + 1e-6 * peak


# ------------------------------------ the arithmetic of the redesigned B4

def increments_fixed(pitch: torch.Tensor, positive: torch.Tensor,
                     sample_rate: float) -> torch.Tensor:
    """The inverse kernel's cycle increments (csrc/sqpv_kernels.cu
    cycle_increment): q = 2^pitch / sr in float32 (true division), q -
    round(q) (exact, in [-0.5, 0.5]), times 2^32, rounded half to even into
    an integer modulo 2^32 (half a cycle is 2^31), negated modulo 2^32
    where the sign is negative. int64 holding the u32 values."""
    q = true_div(torch.exp2(pitch.to(torch.float32)), sample_rate)
    r = (q - torch.round(q)).double() * 2.0 ** 32
    u = torch.round(r).to(torch.int64) % 2 ** 32
    return torch.where(positive, u, (-u) % 2 ** 32)


def _sincos_half_turns(cycles: torch.Tensor):
    """(sin, cos) of 2 pi cycles / 2^32 as the kernel takes them: the u32
    cycles as a signed fraction of a half turn rounded to float32, then
    sincospif, here correctly rounded (the card's is within 1 ulp)."""
    signed = (cycles + 2 ** 31) % 2 ** 32 - 2 ** 31
    half = (signed.to(torch.float32) * 2.0 ** -31).double() * math.pi
    return torch.sin(half).float(), torch.cos(half).float()


def sqpv_inverse_emulated(mag, pitch, positive, sample_rate, bins_per_octave,
                          bandwidth) -> torch.Tensor:
    """The inverse kernel's arithmetic in PyTorch, float32 out, for the CPU
    tests: fixed-point increments summed modulo 2^32 (exact in any order),
    the twiddle folded into each bin's starting cycles, and per tile of
    sqpv_kernels.inverse_tile_frames(B) frames mag cos and mag sin of the
    cycles within the tile, combined with the cosine and sine of the cycles
    before it: cos(before + local) = cos before cos local - sin before sin
    local, summed over the bins."""
    geo = cq_geometry(sample_rate, bins_per_octave, bandwidth)
    c, n, b = mag.shape
    frames = sqpv_kernels.inverse_tile_frames(b)
    whole = torch.cumsum(increments_fixed(pitch, positive, sample_rate), 1)
    start = torch.arange(n) // frames * frames
    before = torch.cat([torch.zeros((c, 1, b), dtype=torch.int64), whole],
                       1)[:, start]
    offset = torch.from_numpy(
        sqpv_kernels.inverse_offsets_np(geo).astype(np.int64))
    s_in, c_in = _sincos_half_turns((whole - before) % 2 ** 32)
    s_be, c_be = _sincos_half_turns((before + offset) % 2 ** 32)
    m = mag.to(torch.float32)
    return torch.sum(c_be * (m * c_in) - s_be * (m * s_in), dim=-1)


def test_inverse_tile_frames():
    """Frames per tile of the inverse: a multiple of 4 whose 9 bytes a
    frame-bin fit 64 KB, from 4 to 128 (the card test holds the library to
    the same numbers)."""
    assert [sqpv_kernels.inverse_tile_frames(b) for b in
            (1, 59, 254, 507, 2048)] == [128, 120, 28, 12, 4]


@pytest.mark.parametrize("sr,bpo,band", _GEOMETRIES)
def test_inverse_offsets_are_the_synthesis_twiddle(sr, bpo, band):
    """Each bin's starting cycles, 32-bit fixed point, are the angle of its
    synthesis twiddle e^{2 pi i Q / N_b} to 2^-33 cycles."""
    geo = cq_geometry(sr, bpo, band)
    off = sqpv_kernels.inverse_offsets_np(geo).astype(np.float64)
    got = np.exp(2j * np.pi * off / 2.0 ** 32)
    assert off.dtype == np.float64 and got.shape == (geo.nbins,)
    assert np.abs(got - geo.synthesis_twiddle).max() < 2 * np.pi * 2.0 ** -32


def test_fixed_point_increments_of_signed_frequencies():
    """+-2^p at sr 8192, where every q is exact: a quarter cycle, half a
    cycle (2^31 for either sign, not saturated), whole cycles (0), a tiny
    one, and their negatives (the two's complement, modulo 2^32)."""
    pitch = torch.tensor([[[11.0, 12.0, 14.0, -10.0, 12.5]]])
    pos = torch.ones_like(pitch, dtype=torch.bool)
    up = increments_fixed(pitch, pos, 8192.0)[0, 0].tolist()
    down = increments_fixed(pitch, ~pos, 8192.0)[0, 0].tolist()
    q = 2.0 ** 12.5 / 8192.0
    q32 = float(np.float32(np.float32(2.0 ** 12.5) / np.float32(8192.0)))
    want = round((q32 - round(q32)) * 2.0 ** 32) % 2 ** 32
    assert abs(q32 - q) < 1e-6
    assert up == [2 ** 30, 2 ** 31, 0, 2 ** 9, want]
    assert down == [3 * 2 ** 30, 2 ** 31, 0, 2 ** 32 - 2 ** 9,
                    (2 ** 32 - want) % 2 ** 32]


@pytest.mark.parametrize("frames", [4, 12, 28, 128, 1000])
def test_fixed_point_sums_associate_exactly(frames):
    """Tile totals chained by a prefix over tiles give every frame's cycles
    bit for bit as the whole running sum does, whatever the tile: what lets
    the kernel's look-back add whichever tiles are ready."""
    rng = np.random.default_rng(frames)
    pitch = torch.from_numpy(rng.uniform(4.0, 14.5, (2, 3001, 7)).astype(
        np.float32))
    pos = torch.from_numpy(rng.random((2, 3001, 7)) < 0.6)
    inc = increments_fixed(pitch, pos, 48000.0)
    whole = torch.cumsum(inc, 1) % 2 ** 32
    chained, carry = [], torch.zeros((2, 1, 7), dtype=torch.int64)
    for t0 in range(0, 3001, frames):
        part = inc[:, t0:t0 + frames]
        chained.append((carry + torch.cumsum(part, 1)) % 2 ** 32)
        carry = (carry + part.sum(1, keepdim=True)) % 2 ** 32
    assert torch.equal(torch.cat(chained, 1), whole)


@pytest.mark.parametrize("planes_from", ["port", "jax"])
def test_inverse_emulation_matches_plain_and_flan_tpu(forward_case,
                                                     planes_from):
    """The redesigned inverse kernel's arithmetic against the plain version
    and flan_tpu's inverse on the same planes, and against a float64 plain
    run: no further from it than the float32 plain run. Readings, as shares
    of the peak: 3.3e-7 to 3.6e-7 from the plain version (bound 1e-5, the
    SPV emulation's), 3.3e-5 to 9.0e-5 from flan_tpu, whose mod-1 cycle
    sums are float32 blocks (bound 2e-4, test_inverse_ref_matches_jax's);
    from float64 1.9e-6 to 3.1e-6, the plain run 1.9e-6 to 3.1e-6."""
    _, scan, _, ours = forward_case
    planes = [torch.from_numpy(a) for a in
              (ours if planes_from == "port" else scan)]
    got = sqpv_inverse_emulated(*planes, SR, BPO, BAND)
    plain = sqpv_kernels.sqpv_inverse_ref(*planes, SR, BPO, BAND)
    p64 = sqpv_kernels.sqpv_inverse_ref(planes[0].double(),
                                        planes[1].double(), planes[2], SR,
                                        BPO, BAND)
    want = torch.from_numpy(_np(jax_sqpv_inverse(
        *(jnp.asarray(a.numpy()) for a in planes), SR, BPO, BAND)))
    peak = float(p64.abs().max())
    err_plain = float((got - plain).abs().max()) / peak
    err_jax = float((got - want).abs().max()) / peak
    err_k64 = float((got.double() - p64).abs().max()) / peak
    err_p64 = float((plain.double() - p64).abs().max()) / peak
    print(f"{planes_from}: plain {err_plain:.3g}, jax {err_jax:.3g}, "
          f"from float64 emulation {err_k64:.3g} plain {err_p64:.3g}")
    assert got.shape == plain.shape and got.dtype == torch.float32
    assert err_plain < 1e-5
    assert err_jax < 2e-4
    assert err_k64 <= err_p64
