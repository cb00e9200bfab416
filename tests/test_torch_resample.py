"""flan_tpu_torch's time-domain operations that wait on resampling and FFT
convolution (ops/resample.py, ops/fft_conv.py, Audio.resample, waveshape,
add_moisture, mix, join, select, convolve) against flan_tpu on the CPU,
and against the compiled reference's goldens (tests/test_algo_golden.py:
334-372, 402-432, 463-471) at their SNR floors. Inputs are made with
numpy from a seed; every tolerance names the reading it was set from
(CPU).
"""
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import flan_tpu
import flan_tpu_torch
from flan_tpu.ops import fft_conv as jax_fft_conv
from flan_tpu.ops import resample as jax_resample
from flan_tpu_torch.ops import fft_conv, resample


# One intra-op thread: on an 8-core x86 host torch 2.13's CPU kernels pay
# ~10 ms to wake their worker pool for a call of a few thousand elements
# (torch.round of 16,384 floats: 14 ms on 8 threads, 6 us on one), which
# the plain versions' many small calls multiply.
torch.set_num_threads(1)

SR = 8000.0
FIXDIR = os.path.join(os.path.dirname(__file__), "fixtures", "reference")


def _noise(shape, seed=0, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape)
            * scale).astype(np.float32)


def _rel_err(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.abs(got - want).max() / np.abs(want).max())


def _audios(x, sr=SR):
    return (flan_tpu.Audio.create_from_array(x, sr),
            flan_tpu_torch.Audio.create_from_array(x, sr, device="cpu"))


# resampling against flan_tpu: the same float64 design and polyphase
# matrix, the block product summed in another order (torch.matmul against
# XLA's einsum): up to 3.1e-7 of the peak read (CPU); bound 2e-6
TOL_RESAMPLE = 2e-6


@pytest.mark.parametrize("sr_out", [12000.0, 11025.0, 32000.0, 4000.0,
                                    7350.0])
def test_resample_matches_flan_tpu(sr_out):
    x = _noise((2, 3001))
    want = np.array(jax_resample.resample(jnp.asarray(x), SR, sr_out))
    got = resample.resample(torch.from_numpy(x), SR, sr_out).numpy()
    assert _rel_err(got, want) < TOL_RESAMPLE


def test_resample_chunks_give_the_same_result(monkeypatch):
    """Chunks of blocks (at most _CHUNK_FLOATS floats of windows at once)
    against one chunk: the products are the same rows, so equal up to the
    matmul's own blocking (3.1e-7 of the peak read with 1000-float chunks,
    CPU)."""
    x = torch.from_numpy(_noise((2, 3001), seed=1))
    whole = resample.resample(x, SR, 11025.0)
    monkeypatch.setattr(resample, "_CHUNK_FLOATS", 1000)
    chunked = resample.resample(x, SR, 11025.0)
    assert _rel_err(chunked.numpy(), whole.numpy()) < TOL_RESAMPLE
    assert resample.resample(x, SR, SR) is x


def test_polyphase_matrix_is_the_jax_packages():
    for L, M in ((3, 2), (147, 160), (4, 1), (1, 4)):
        mat, off = resample.polyphase_matrix(L, M, 64, 140.0)
        want, want_off = jax_resample._polyphase_matrix(L, M, 64, 140.0)
        assert off == want_off and np.array_equal(mat, want)


def test_fractional_gather_matches_flan_tpu():
    """Positions past both ends (zeros there) and per-output cutoffs: 1.6e-7
    of the peak read (CPU); bound 2e-6."""
    rng = np.random.default_rng(2)
    x = _noise((2, 3001), seed=2)
    pos = np.sort(rng.uniform(-40.0, 3040.0, 2000)).astype(np.float32)
    cut = rng.uniform(0.3, 1.0, 2000).astype(np.float32)
    want = np.array(jax_resample.fractional_gather(
        jnp.asarray(x), jnp.asarray(pos), jnp.asarray(cut)))
    got = resample.fractional_gather(*(torch.from_numpy(v)
                                       for v in (x, pos, cut))).numpy()
    assert _rel_err(got, want) < 2e-6


def test_variable_rate_positions_match_flan_tpu():
    rates = np.float32([1.0, 0.5, 1.5, 0.75])
    assert np.array_equal(resample.variable_rate_positions(rates, 64),
                          jax_resample.variable_rate_positions(rates, 64))


@pytest.mark.parametrize("ch", [1, 2, 3])
def test_audio_resample_matches_flan_tpu(ch):
    """Audio.resample with the reference's flat channel-major stream for
    more than one channel: up to 3.2e-7 of the peak read (CPU); bound
    2e-6."""
    ja, ta = _audios(_noise((ch, 2999), seed=ch))
    for sr in (11025.0, 16000.0, SR):
        want, got = ja.resample(sr), ta.resample(sr)
        assert got.sample_rate == want.sample_rate
        assert _rel_err(got.to_numpy(), np.array(want.data)) < TOL_RESAMPLE


# waveshape through two resampling passes: up to 1.5e-7 of the peak read
# (CPU); bound 2e-6
def test_waveshape_matches_flan_tpu():
    ja, ta = _audios(_noise((2, 3001), seed=3, scale=0.3))
    for factor in (1, 2, 4):
        want = ja.waveshape(lambda t, x: x - x * x * x / 3.0, factor)
        got = ta.waveshape(lambda t, x: x - x * x * x / 3.0, factor)
        assert _rel_err(got.to_numpy(), np.array(want.data)) < TOL_RESAMPLE


def test_add_moisture_matches_flan_tpu():
    """add_moisture on noise peaking near 0.8: the default shaper's sine
    takes 2 pi f |s|^skew cycles (393 at the peak), where an ulp of the
    power (torch's pow against XLA's) turns the phase by up to 2e-4 rad.
    Read over three seeds (CPU): 7.2e-5 to 8.7e-5 of the peak with the
    default sine, 4.3e-5 to 5.9e-5 with a swept amount, 3.1e-5 to 3.7e-5
    with the triangle; bound 3e-4."""
    from flan_tpu.func.function import waveforms as jax_waveforms
    from flan_tpu_torch.func.function import waveforms
    ja, ta = _audios(_noise((2, 3001), seed=4, scale=0.2))
    cases = [((), {}), ((lambda t: 0.3 + t, 50.0, 2.0), {}),
             ((0.7, 30.0, 3.0), {"waveform": "triangle"})]
    for args, kw in cases:
        jkw = {k: getattr(jax_waveforms, v) for k, v in kw.items()}
        tkw = {k: getattr(waveforms, v) for k, v in kw.items()}
        want = np.array(ja.add_moisture(*args, **jkw).data)
        got = ta.add_moisture(*args, **tkw).to_numpy()
        assert _rel_err(got, want) < 3e-4


def test_waveforms_match_flan_tpu():
    from flan_tpu.func.function import waveforms as jax_waveforms
    from flan_tpu_torch.func.function import waveforms
    t = np.linspace(-2.0, 3.0, 4001).astype(np.float32)
    for name in ("sine", "square", "saw", "triangle"):
        want = np.array(getattr(jax_waveforms, name)(jnp.asarray(t)))
        got = getattr(waveforms, name)(torch.from_numpy(t)).numpy()
        assert np.abs(got - want).max() < 1e-6, name


# full convolution: the port's one cuFFT-sized transform against the JAX
# package's overlap-save blocks (and, for an IR too long to block, its one
# transform): up to 7.5e-7 of the peak read (CPU); bound 5e-6
@pytest.mark.parametrize("n,m", [(3000, 1), (3000, 500), (500, 3000),
                                 (20000, 4097), (140000, 135000)])
def test_fft_convolve_full_matches_flan_tpu(n, m):
    x, h = _noise((2, n), seed=5), _noise((2, m), seed=6)
    want = np.array(jax_fft_conv.fft_convolve_full(jnp.asarray(x),
                                                   jnp.asarray(h)))
    got = fft_conv.fft_convolve_full(torch.from_numpy(x),
                                     torch.from_numpy(h)).numpy()
    assert got.shape == (2, n + m - 1)
    assert _rel_err(got, want) < 5e-6


def test_fft_convolve_full_is_a_direct_convolution():
    x, h = _noise((1, 777), seed=7), _noise((1, 91), seed=8)
    got = fft_conv.fft_convolve_full(torch.from_numpy(x),
                                     torch.from_numpy(h)).numpy()
    want = np.convolve(x[0].astype(np.float64), h[0])[None]
    assert _rel_err(got, want) < 5e-6
    with pytest.raises(ValueError, match="channels"):
        fft_conv.fft_convolve_full(torch.ones((2, 8)), torch.ones((1, 8)))


def test_combination_matches_flan_tpu():
    """mix (gains of global time, offsets, cyclic reuse of the inputs),
    join, select and convolve (IR channels used cyclically, an IR at
    another rate resampled first): mix and join 0.0 read, select 6.0e-8,
    convolve up to 7.2e-7 (CPU); bound 5e-6."""
    x = _noise((2, 3001), seed=9, scale=0.3)
    ja, ta = _audios(x)
    jb, tb = _audios(x[::-1, ::-1].copy())
    jm, tm = _audios(x[:1, :1000].copy())
    J, T = flan_tpu.Audio, flan_tpu_torch.Audio
    pairs = [
        (J.mix([ja, jb], [0.0, 0.01], [lambda t: 1.0 - 4.0 * t, 0.5]),
         T.mix([ta, tb], [0.0, 0.01], [lambda t: 1.0 - 4.0 * t, 0.5])),
        (J.mix([ja, jm], [0.0, 0.1, -0.05], [1.0, 0.5, 0.25]),
         T.mix([ta, tm], [0.0, 0.1, -0.05], [1.0, 0.5, 0.25])),
        (J.join([ja, jb], 0.005), T.join([ta, tb], 0.005)),
        (J.join([ja, jm, jb], offsets=[0.0, -0.01, 0.02, 0.0]),
         T.join([ta, tm, tb], offsets=[0.0, -0.01, 0.02, 0.0])),
        (J.select([ja, jb], lambda t: 16.0 * t),
         T.select([ta, tb], lambda t: 16.0 * t)),
    ]
    for ir, sr in ((_noise((1, 700), seed=10), SR),
                   (_noise((3, 333), seed=11), SR),
                   (_noise((2, 300), seed=12), 16000.0)):
        jir, tir = _audios(ir, sr)
        pairs.append((ja.convolve(jir), ta.convolve(tir)))
        pairs.append((ja.convolve(jir, False), ta.convolve(tir, False)))
    for want, got in pairs:
        assert got.sample_rate == want.sample_rate
        assert _rel_err(got.to_numpy(), np.array(want.data)) < 5e-6
    assert T.mix([]).is_null() and T.join([T.create_null()]).is_null()
    assert ta.convolve(T.create_null()).is_null()


# ----------------------------------------------- compiled-reference goldens

def _fixture(name):
    dims = tuple(int(v) for v in
                 open(os.path.join(FIXDIR, name + ".dims")).read().split())
    return np.fromfile(os.path.join(FIXDIR, name + ".f32"),
                       dtype="<f4").reshape(dims)


def _snr_db(ref, got):
    ref = np.asarray(ref, np.float64).ravel()
    got = np.asarray(got, np.float64).ravel()
    n = min(len(ref), len(got))
    err = float(((ref[:n] - got[:n]) ** 2).mean())
    return 10.0 * np.log10(max(float((ref[:n] ** 2).mean()), 1e-300)
                           / max(err, 1e-300))


def _golden_input():
    return flan_tpu_torch.Audio.create_from_array(_fixture("filt_sig"), SR,
                                                  device="cpu")


def _reverse(a):
    """The reference's reverse: time and channel order (flan_tpu/audio/
    audio.py:370-376)."""
    return a._with(data=a.data.flip(0).flip(1))


def _golden_cases():
    a = _golden_input()
    ar = _reverse(a)
    T = flan_tpu_torch.Audio
    ir = T.create_from_array(np.fromfile(os.path.join(FIXDIR, "comb_ir.f32"),
                                          dtype="<f4")[None], SR,
                             device="cpu")
    return {
        "conv_resample": (lambda: a.resample(11025.0), 40.0),
        "vol_waveshape": (lambda: a.waveshape(
            lambda t, x: x - x * x * x / 3.0, 2), 40.0),
        "comb_mix": (lambda: T.mix([a, ar], [0.0, 0.01],
                                   [lambda t: 1.0 - 4.0 * t, 0.5]), 80.0),
        "comb_join": (lambda: T.join([a, ar], 0.005), 80.0),
        "comb_select": (lambda: T.select([a, ar], lambda t: 16.0 * t), 80.0),
        "comb_convolve": (lambda: a.convolve(ir), 60.0),
    }


@pytest.mark.parametrize("golden", ["conv_resample", "vol_waveshape",
                                    "comb_mix", "comb_join", "comb_select",
                                    "comb_convolve"])
def test_golden(golden):
    """tests/test_algo_golden.py's calls and SNR floors."""
    run, floor = _golden_cases()[golden]
    out = run().to_numpy()
    ref = _fixture(golden)
    assert out.shape == ref.shape
    assert _snr_db(ref, out) >= floor
