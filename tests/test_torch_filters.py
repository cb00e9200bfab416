"""flan_tpu_torch's filter family (audio/filters.py, ops/filter_cores.py,
ops/fir.py) against flan_tpu on the CPU, and against the compiled
reference's filter goldens (tests/test_algo_golden.py:228-316).

Each ported Audio method runs on both packages at sr 8000: at 512 frames
(the scan path) and at 20000 frames (constant parameters take the FIR path
there, probed on the scans), with constant and swept parameters. Inputs
are made with numpy from a seed; every tolerance names the reading it was
set from (CPU).
"""
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import flan_tpu
import flan_tpu_torch
from flan_tpu.ops import filter_cores as jax_cores
from flan_tpu.ops import fir as jax_fir
from flan_tpu_torch.ops import filter_cores, fir, scan_kernels


# One intra-op thread: on an 8-core x86 host torch 2.13's CPU kernels pay
# ~10 ms to wake their worker pool for a call of a few thousand elements
# (torch.round of 16,384 floats: 14 ms on 8 threads, 6 us on one), which
# the plain versions' many small calls multiply.
torch.set_num_threads(1)

SR = 8000.0
FIXDIR = os.path.join(os.path.dirname(__file__), "fixtures", "reference")


def _np(a):
    return np.array(a)


def _signal(n, ch=2, seed=3):
    rng = np.random.default_rng(seed)
    t = np.arange(n) / SR
    x = (0.4 * np.sin(2 * np.pi * 440 * t) + 0.3 * np.sin(2 * np.pi * 1500 * t)
         + 0.1 * rng.standard_normal(n))
    return np.stack([x, -0.7 * np.roll(x, 17)])[:ch].astype(np.float32)


def _rel_err(got, want):
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.abs(got - want).max() / np.abs(want).max())


# Largest reading of the port against flan_tpu over these cases, 512 and
# 20000 frames, splits included: 1.05e-6 of the peak (CPU); bound 1e-5.
TOL = 1e-5

CASES = {
    "1p_lp3": ("filter_1pole_lowpass", (800.0, 3)),
    "1p_hp2_swept": ("filter_1pole_highpass", (lambda t: 300.0 + 2000.0 * t,
                                               2)),
    "1p_ls": ("filter_1pole_lowshelf", (500.0, -9.0, 1)),
    "1p_hs2": ("filter_1pole_highshelf", (1000.0, 6.0, 2)),
    "1p_hs_swept": ("filter_1pole_highshelf", (1000.0,
                                               lambda t: 6.0 - 4.0 * t, 1)),
    "1p_rep_low": ("filter_1pole_repeat_low", (800.0, 3)),
    "1p_rep_high": ("filter_1pole_repeat_high", (400.0, 2)),
    "2p_lp2": ("filter_2pole_lowpass", (1200.0, 0.3, 2)),
    "2p_lp3_swept": ("filter_2pole_lowpass", (lambda t: 400.0 + 1000.0 * t,
                                              0.5, 3)),
    "2p_bp_swept": ("filter_2pole_bandpass", (lambda t: 400.0 + 3000.0 * t,
                                              0.5, 1)),
    "2p_bp_overdamped": ("filter_2pole_bandpass", (900.0, 1.5, 2)),
    "2p_hp3": ("filter_2pole_highpass", (600.0, 0.4, 3)),
    "2p_notch": ("filter_2pole_notch", (700.0, 0.2, 1)),
    "2p_ls": ("filter_2pole_lowshelf", (500.0, 0.5, -6.0, 1)),
    "2p_bs_swept": ("filter_2pole_bandshelf", (1000.0, 0.4,
                                               lambda t: 5.0 - 10.0 * t, 2)),
    "2p_hs": ("filter_2pole_highshelf", (1500.0, 0.4, 5.0, 1)),
    "comb": ("filter_comb", (1000.0, 0.5, 0.5, False)),
    "comb_inv_swept_feedback": ("filter_comb", (333.0, lambda t: 0.2 + 0.2 * t,
                                                0.7, True)),
}


@pytest.mark.parametrize("n", [512, 20000])
@pytest.mark.parametrize("case", sorted(CASES))
def test_filter_matches_flan_tpu(case, n):
    name, args = CASES[case]
    x = _signal(n)
    want = _np(getattr(flan_tpu.Audio.create_from_array(x, SR), name)(
        *args).data)
    got = getattr(flan_tpu_torch.Audio.create_from_array(x, SR, device="cpu"),
                  name)(*args)
    assert got.device.type == "cpu"
    assert _rel_err(got.to_numpy(), want) < TOL


@pytest.mark.parametrize("n", [512, 20000])
def test_split_matches_flan_tpu(n):
    x = _signal(n, seed=4)
    for name, args in (("filter_1pole_split", (700.0, 2)),
                       ("filter_2pole_split", (700.0, 0.6, 1))):
        want = getattr(flan_tpu.Audio.create_from_array(x, SR), name)(*args)
        got = getattr(flan_tpu_torch.Audio.create_from_array(
            x, SR, device="cpu"), name)(*args)
        for g, w in zip(got, want):
            assert _rel_err(g.to_numpy(), _np(w.data)) < TOL


# shift_frequency: the JAX side sums its cycles in float32 (307 cycles
# after 20000 frames: 3e-5 cycles per ulp), the port in float64; 9.1e-4
# of the peak read at 20000 frames (swept), 6.2e-6 at 512 (CPU); bound
# 3e-3.
@pytest.mark.parametrize("n", [512, 20000])
@pytest.mark.parametrize("shift", [123.0, -250.0, "swept"])
def test_shift_frequency_matches_flan_tpu(n, shift):
    x = _signal(n, seed=5)
    if shift == "swept":
        shift = lambda t: 50.0 + 400.0 * t  # noqa: E731
    want = _np(flan_tpu.Audio.create_from_array(x, SR).shift_frequency(
        shift).data)
    got = flan_tpu_torch.Audio.create_from_array(
        x, SR, device="cpu").shift_frequency(shift).to_numpy()
    assert _rel_err(got, want) < 3e-3


@pytest.mark.parametrize("n", [512, 20000])
def test_halfband_modulate_and_multiply_match_flan_tpu(n):
    """The Hilbert pair (allpass cascades; FIR from 16384 frames) under a
    constant complex modulator and a product of two audios: 1.45e-6 of the
    peak read (CPU); bound 1e-5."""
    x, y = _signal(n, seed=6), _signal(n, ch=1, seed=7)
    jx, jy = (flan_tpu.Audio.create_from_array(v, SR) for v in (x, y))
    tx, ty = (flan_tpu_torch.Audio.create_from_array(v, SR, device="cpu")
              for v in (x, y))
    mod = lambda t: (0.5 + 0.0 * t, 0.25 + 0.0 * t)  # noqa: E731
    assert _rel_err(tx.halfband_modulate(mod).to_numpy(),
                    _np(jx.halfband_modulate(mod).data)) < TOL
    assert _rel_err(tx.halfband_multiply(ty).to_numpy(),
                    _np(jx.halfband_multiply(jy).data)) < TOL


def test_cores_match_flan_tpu():
    """The filter cores called directly, with per-frame coefficients."""
    rng = np.random.default_rng(8)
    x = rng.standard_normal((2, 3000)).astype(np.float32)
    g = rng.uniform(0.01, 0.8, (1, 3000)).astype(np.float32)
    R = rng.uniform(0.1, 1.5, (1, 3000)).astype(np.float32)
    k = rng.uniform(0.0, 0.6, 3000).astype(np.float32)
    jx, tx = jnp.asarray(x), torch.from_numpy(x)
    pairs = [
        (jax_cores.onepole_core(jx, jnp.asarray(g)),
         filter_cores.onepole_core(tx, torch.from_numpy(g))),
        (jax_cores.svf_core(jx, jnp.asarray(g), jnp.asarray(R)),
         filter_cores.svf_core(tx, torch.from_numpy(g), torch.from_numpy(R))),
        ((jax_cores.allpass_1pole_chain(jx, [0.05, 0.3, 1.2]),),
         (filter_cores.allpass_1pole_chain(tx, [0.05, 0.3, 1.2]),)),
        ((jax_cores.comb_core(jx, 13, jnp.asarray(k), True,
                              jnp.asarray(0.3)),),
         (filter_cores.comb_core(tx, 13, torch.from_numpy(k), True,
                                 torch.tensor(0.3)),)),
    ]
    for want, got in pairs:
        for w, g_ in zip(want, got):
            assert _rel_err(g_.numpy(), _np(w)) < TOL
    assert scan_kernels.LAUNCHES == {k: 0 for k in scan_kernels.LAUNCHES}
    assert filter_cores.butterworth_poles(5) == jax_cores.butterworth_poles(5)
    assert (filter_cores.phase_diff_network_poles(20, 5.0, 22000.0)
            == jax_cores.phase_diff_network_poles(20, 5.0, 22000.0))


@pytest.mark.parametrize("k", [7, 3000, 9000])
def test_fir_apply_matches_flan_tpu(k):
    """Block FFT convolution (torch.fft here, the JAX package's matmul FFT
    there) against flan_tpu and a direct float64 convolution: 6.7e-7 and
    2.6e-7 of the peak
    read (CPU); bound 1e-5."""
    rng = np.random.default_rng(9)
    x = rng.standard_normal((2, 20000)).astype(np.float32)
    h = (rng.standard_normal(k) * np.exp(-np.arange(k) / (k / 4))).astype(
        np.float32)
    got = fir.fir_apply(torch.from_numpy(x), h).numpy()
    want = _np(jax_fir.fir_apply(jnp.asarray(x), jnp.asarray(h)))
    direct = np.stack([np.convolve(r.astype(np.float64), h)[:20000]
                       for r in x])
    assert _rel_err(got, want) < TOL
    assert _rel_err(got, direct) < TOL


def test_impulse_response_is_cached_per_device():
    calls = []

    def run(data):
        calls.append(data.shape[1])
        return filter_cores.onepole_core(data, torch.tensor(0.2))[0]

    key = ("test-onepole", 0.2)
    h = fir.impulse_response(run, 50000, device="cpu", cache_key=key)
    again = fir.impulse_response(run, 50000, device="cpu", cache_key=key)
    assert again is h and calls == [4096]
    assert h.shape == (4096,) and abs(float(h.sum()) - 1.0) < 1e-5
    assert (key, "cpu") in fir._IR_CACHE


def test_unported_filters_raise():
    """The three filters that raised NotImplementedError until their scans
    were ported now run on the CPU tensors' plain versions (no kernel
    launched) and return finite audio of the input's shape; their values
    are held to flan_tpu in tests/test_torch_multinotch.py."""
    from flan_tpu_torch.ops import sequential_kernels
    a = flan_tpu_torch.Audio.create_from_array(_signal(600), SR,
                                               device="cpu")
    scan_kernels.reset_launch_counts()
    for out in (a.filter_1pole_multinotch(2, 800.0, 0.3),
                a.filter_2pole_multinotch(2, 800.0, 0.35, 0.3),
                a.filter_comb(lambda t: 500.0 + 100.0 * t, 0.5),
                a.filter_1pole_multinotch(2, 800.0, 0.3, use_saturator=True)):
        assert out.data.shape == a.data.shape and out.device.type == "cpu"
        assert bool(torch.isfinite(out.data).all())
    assert scan_kernels.LAUNCHES == dict.fromkeys(scan_kernels.LAUNCHES, 0)
    assert sequential_kernels.LAUNCHES == dict.fromkeys(
        sequential_kernels.LAUNCHES, 0)


def test_null_and_order_zero():
    null = flan_tpu_torch.Audio.create_null()
    assert null.filter_1pole_lowpass(500.0).is_null()
    assert null.filter_2pole_notch(500.0, 0.5).is_null()
    assert null.shift_frequency(10.0).is_null()
    a = flan_tpu_torch.Audio.create_from_array(_signal(600), SR,
                                               device="cpu")
    assert torch.equal(a.filter_2pole_highpass(500.0, 0.5, 0).data, a.data)


# ----------------------------------------------- compiled-reference goldens

def _fixture(name):
    dims = tuple(int(v) for v in
                 open(os.path.join(FIXDIR, name + ".dims")).read().split())
    return np.fromfile(os.path.join(FIXDIR, name + ".f32"),
                       dtype="<f4").reshape(dims)


def _snr_db(ref, got):
    ref = np.asarray(ref, np.float64).ravel()
    got = np.asarray(got, np.float64).ravel()
    err = ((ref - got) ** 2).mean()
    return 10.0 * np.log10(max((ref ** 2).mean(), 1e-300) / max(err, 1e-300))


# (golden, method, args, SNR floor in dB): tests/test_algo_golden.py's
# calls and floors
GOLDENS = [
    ("filt_1p_lp3", "filter_1pole_lowpass", (800.0, 3), 60.0),
    ("filt_1p_hp2", "filter_1pole_highpass", (500.0, 2), 60.0),
    ("filt_1p_ls", "filter_1pole_lowshelf", (500.0, -9.0, 1), 60.0),
    ("filt_1p_hs2", "filter_1pole_highshelf", (1000.0, 6.0, 2), 60.0),
    ("filt_1p_rep", "filter_1pole_repeat_low", (800.0, 3), 60.0),
    ("filt_2p_lp2", "filter_2pole_lowpass", (1200.0, 0.3, 2), 60.0),
    ("filt_2p_lp_var", "filter_2pole_lowpass",
     (lambda t: 400.0 + 20000.0 * t, 0.5, 1), 60.0),
    ("filt_2p_bp", "filter_2pole_bandpass", (900.0, 0.5, 1), 60.0),
    ("filt_2p_hp", "filter_2pole_highpass", (600.0, 0.4, 1), 60.0),
    ("filt_2p_notch", "filter_2pole_notch", (700.0, 0.2, 1), 60.0),
    ("filt_2p_ls", "filter_2pole_lowshelf", (500.0, 0.5, -6.0, 1), 60.0),
    ("filt_2p_bs", "filter_2pole_bandshelf", (1000.0, 0.4, 5.0, 1), 60.0),
    ("filt_2p_hs", "filter_2pole_highshelf", (1500.0, 0.4, 5.0, 1), 60.0),
    ("filt_comb", "filter_comb", (1000.0, 0.5, 0.5, False), 60.0),
    ("filt_comb_inv", "filter_comb", (1000.0, 0.25, 0.5, True), 60.0),
    ("filt_shift", "shift_frequency", (123.0, 30.0), 40.0),
]


@pytest.mark.parametrize("golden,name,args,floor", GOLDENS,
                         ids=[g[0] for g in GOLDENS])
def test_filter_golden(golden, name, args, floor):
    x = _fixture("filt_sig")
    out = getattr(flan_tpu_torch.Audio.create_from_array(x, SR, device="cpu"),
                  name)(*args).to_numpy()
    ref = _fixture(golden)
    assert out.shape == ref.shape
    assert _snr_db(ref, out) >= floor
