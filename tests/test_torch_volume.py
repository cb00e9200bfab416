"""flan_tpu_torch's dynamics (audio/volume.py: compress and the ADSR / AR
envelopes; the Audio volume methods; func/function.py adsr) against
flan_tpu on the CPU, and against the compiled reference's volume goldens
(tests/test_algo_golden.py:334-372). Inputs are made with numpy from a
seed; every tolerance names the reading it was set from (CPU).
"""
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import flan_tpu
import flan_tpu_torch
from flan_tpu.func.function import adsr as jax_adsr
from flan_tpu_torch.ops import scan_kernels


# One intra-op thread: on an 8-core x86 host torch 2.13's CPU kernels pay
# ~10 ms to wake their worker pool for a call of a few thousand elements
# (torch.round of 16,384 floats: 14 ms on 8 threads, 6 us on one), which
# the plain versions' many small calls multiply.
torch.set_num_threads(1)

SR = 8000.0
FIXDIR = os.path.join(os.path.dirname(__file__), "fixtures", "reference")


def _signal(n, ch=2, seed=3):
    rng = np.random.default_rng(seed)
    t = np.arange(n) / SR
    env = 0.2 + 0.8 * np.abs(np.sin(2 * np.pi * 1.3 * t))
    x = env * (0.6 * np.sin(2 * np.pi * 440 * t)
               + 0.1 * rng.standard_normal(n))
    return np.stack([x, -0.8 * np.roll(x, 29)])[:ch].astype(np.float32)


def _rel_err(got, want):
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.abs(got - want).max() / np.abs(want).max())


def _both(x, method, *args, **kwargs):
    want = np.array(getattr(flan_tpu.Audio.create_from_array(x, SR),
                            method)(*args, **kwargs).data)
    got = getattr(flan_tpu_torch.Audio.create_from_array(x, SR, device="cpu"),
                  method)(*args, **kwargs)
    assert got.device.type == "cpu"
    return got.to_numpy(), want


# compress against flan_tpu: 1.3e-6 of the peak read at 20000 frames,
# 9.4e-8 at 512 (CPU); bound 1e-5
COMPRESS = {
    "soft_knee": (-12.0, 4.0, 0.005, 0.02, 6.0),
    "hard_knee": (-20.0, 8.0, 0.001, 0.1, 0.0),
    "swept": (lambda t: -30.0 + 10.0 * t, lambda t: 2.0 + t, 0.01,
              lambda t: 0.05 + 0.1 * t, 3.0),
}


@pytest.mark.parametrize("n", [512, 20000])
@pytest.mark.parametrize("case", sorted(COMPRESS))
def test_compress_matches_flan_tpu(case, n):
    assert _rel_err(*_both(_signal(n), "compress", *COMPRESS[case])) < 1e-5
    assert scan_kernels.LAUNCHES == {k: 0 for k in scan_kernels.LAUNCHES}


@pytest.mark.parametrize("n", [512, 20000])
def test_compress_with_sidechain_matches_flan_tpu(n):
    x, side = _signal(n), _signal(n // 2, ch=1, seed=9) * 3.0
    want = np.array(flan_tpu.Audio.create_from_array(x, SR).compress(
        -15.0, 3.0, 0.002, 0.05, 2.0,
        flan_tpu.Audio.create_from_array(side, SR)).data)
    got = flan_tpu_torch.Audio.create_from_array(x, SR, device="cpu").compress(
        -15.0, 3.0, 0.002, 0.05, 2.0,
        flan_tpu_torch.Audio.create_from_array(side, SR, device="cpu"))
    assert _rel_err(got.to_numpy(), want) < 1e-5


@pytest.mark.parametrize("exps", [(1.0, 1.0, 1.0), (2.0, 0.5, 3.0)])
def test_adsr_matches_flan_tpu(exps):
    """The envelope Function on a grid through every segment: 3.0e-8
    read (CPU); bound 1e-6."""
    t = np.linspace(-0.01, 0.08, 2001, dtype=np.float32)
    args = (0.01, 0.015, 0.02, 0.025, 0.4) + exps
    want = np.array(jax_adsr(*args)(jnp.asarray(t)))
    got = flan_tpu_torch.adsr(*args)(torch.from_numpy(t)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


@pytest.mark.parametrize("n", [512, 20000])
def test_envelopes_and_volume_match_flan_tpu(n):
    x = _signal(n, seed=4)
    calls = [("apply_adsr_envelope", (0.01, 0.01, 0.02, 0.015, 0.5, 2.0,
                                      0.5, 1.0)),
             ("apply_ar_envelope", (0.3, 0.5, 2.0, 0.5)),
             ("modify_volume", (lambda t: 0.25 + 8.0 * t,)),
             ("modify_volume", (0.7,)),
             ("set_volume", (0.5,)),
             ("invert_phase", ())]
    for method, args in calls:
        assert _rel_err(*_both(x, method, *args)) < 1e-6, method


def test_null_audio_compresses_to_null():
    assert flan_tpu_torch.Audio.create_null().compress(-12.0).is_null()


def test_time_grid_keeps_the_float32_count():
    """arange(N) / sr in float32 with true division, as the JAX package
    builds it."""
    a = flan_tpu_torch.Audio.create_from_array(np.zeros((1, 8)), SR,
                                               device="cpu")
    np.testing.assert_array_equal(
        a.time_grid().numpy(),
        np.arange(8, dtype=np.float32) / np.float32(SR))


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
GOLDENS = [
    ("vol_compress", "compress", (-12.0, 4.0, 0.005, 0.02, 6.0, None), 60.0),
    ("vol_adsr", "apply_adsr_envelope",
     (0.01, 0.01, 0.02, 0.015, 0.5, 2.0, 0.5, 1.0), 80.0),
    ("vol_mod", "modify_volume", (lambda t: 0.25 + 8.0 * t,), 100.0),
    ("vol_set", "set_volume", (0.5,), 100.0),
    ("vol_invert", "invert_phase", (), 120.0),
]


@pytest.mark.parametrize("golden,name,args,floor", GOLDENS,
                         ids=[g[0] for g in GOLDENS])
def test_volume_golden(golden, name, args, floor):
    out = getattr(flan_tpu_torch.Audio.create_from_array(
        _fixture("filt_sig"), SR, device="cpu"), name)(*args).to_numpy()
    ref = _fixture(golden)
    assert out.shape == ref.shape
    assert _snr_db(ref, out) >= floor
