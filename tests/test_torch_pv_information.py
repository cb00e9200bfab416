"""flan_tpu_torch's melody machinery (pv/information.py: get_salience,
get_contours, prism) and the salience histogram's plain version
(ops/pv_info_kernels.py) against flan_tpu on the CPU, against the compiled
reference's goldens info_salience, info_contours, algo_prism_local and
algo_prism_global (tests/test_algo_golden.py:675-724, with its
tolerances) and against the JAX package's scalar prism loop; and the PV
class's parity with flan_tpu's. Inputs are the goldens' tonal PV and a
harmonic tone's planes made with numpy at 8 kHz.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import flan_tpu
from flan_tpu.pv import information as j_info
from flan_tpu.pv.pv import PV as JPV
from flan_tpu_torch import PV
from flan_tpu_torch.convert import pv_from_numpy
from flan_tpu_torch.ops import pv_info_kernels as pk
from flan_tpu_torch.pv import information
from test_torch_pv_methods import FIXDIR, HOP, SR, WIN, _planes, assert_golden

# salience against JAX, times its peak (1): 1.2e-7 read (four of the 21
# spread taps are XLA's cos an ulp off the correctly rounded ones the port
# uses; the taps' sum order); bound 1e-6
TOL_SAL = 1e-6

# flan_tpu's PV names the port does not have yet: the graph and bitmap
# methods, for graph/ (ROADMAP A.15)
WAITING = {"convert_to_graph", "save_to_bmp"}


def tonal_pvs():
    """(port PV on the CPU, JAX PV) on the melodia goldens' tonal input
    (tests/test_algo_golden.py:539 _tonal_pv): 1 x 96 x 17, hop 8."""
    m, f = _planes("algo_tonal_in")
    return (pv_from_numpy(m, f, SR, HOP, WIN, device="cpu"),
            JPV(mag=jnp.asarray(m), freq=jnp.asarray(f), sample_rate=SR,
                hop_size=HOP, window_size=WIN))


def _tone_planes(seconds=1.2, seed=0):
    """Planes of a stereo harmonic tone gliding 220 -> 260 Hz (and 330 Hz
    on the right) in light noise, analysed by flan_tpu at 8 kHz, window
    512, hop 64: [2, F, 257] float32 numpy."""
    n = int(seconds * SR)
    t = np.arange(n) / SR
    rng = np.random.default_rng(seed)
    out = []
    for f0 in (220.0, 330.0):
        ph = 2 * np.pi * np.cumsum(f0 + 40.0 * t / seconds * (f0 == 220.0)) \
            / SR
        x = sum(0.5 / k * np.sin(k * ph) for k in range(1, 6))
        out.append(x + 0.01 * rng.standard_normal(n))
    pv = flan_tpu.Audio.create_from_array(np.asarray(out, np.float32),
                                          SR).convert_to_PV(512, 64, 512)
    return np.array(pv.mag), np.array(pv.freq)


def tone_pvs():
    m, f = _tone_planes()
    return (pv_from_numpy(m, f, SR, 64, 512, device="cpu"),
            JPV(mag=jnp.asarray(m), freq=jnp.asarray(f), sample_rate=SR,
                hop_size=64, window_size=512))


# ------------------------------------------------------------------ salience

def test_salience_matches_golden_and_jax():
    tp, jp = tonal_pvs()
    ours = tp.get_salience(0, 55.0, 1760.0)
    theirs = jp.get_salience(0, 55.0, 1760.0)
    dims = tuple(int(x) for x in open(
        os.path.join(FIXDIR, "info_salience.dims")).read().split())
    ref = np.fromfile(os.path.join(FIXDIR, "info_salience.f32"),
                      dtype="<f4").reshape(dims)
    assert isinstance(ours, PV.Salience)
    assert (ours.num_frames, ours.num_bins) == dims
    assert ours.buffer.dtype == np.float32
    np.testing.assert_allclose(ours.buffer, ref, rtol=1e-3, atol=1e-3)
    np.testing.assert_allclose(ours.buffer, np.array(theirs.buffer),
                               rtol=0, atol=TOL_SAL)
    assert ours.get(5, 100) == float(ours.buffer[5, 100])


@pytest.mark.parametrize("channel,band,max_peaks", [
    (0, (55.0, 1760.0), None), (1, (55.0, 1760.0), None),
    (0, (80.0, 1000.0), None), (1, (55.0, 1760.0), 3)])
def test_salience_of_a_tone_matches_jax(channel, band, max_peaks):
    """Both channels of a harmonic tone, another band, and a cap of 3
    peaks a frame (lossy; the same peaks in both packages)."""
    tp, jp = tone_pvs()
    ours = tp.get_salience(channel, *band, max_peaks=max_peaks)
    theirs = jp.get_salience(channel, *band, max_peaks=max_peaks)
    assert ours.buffer.shape == np.array(theirs.buffer).shape
    np.testing.assert_allclose(ours.buffer, np.array(theirs.buffer),
                               rtol=0, atol=TOL_SAL)


def _jax_contributions(i_f, i_m, width, log2_min):
    """The JAX package's scatter operands (flan_tpu/pv/information.py:
    105-131) from the same peaks: (flat, contribution) as numpy."""
    i_f, i_m = jnp.asarray(i_f), jnp.asarray(i_m)
    h = jnp.arange(1, 21, dtype=jnp.float32)
    alpha_pow = 0.8 ** jnp.arange(20, dtype=jnp.float32)
    sub_f = i_f[..., None] / h[None, None, :]
    b_c = jnp.round(120.0 * (jnp.log2(jnp.maximum(sub_f, 1e-9))
                             - log2_min)).astype(jnp.int32)
    contrib = alpha_pow[None, None, :] * i_m[..., None]
    valid = (b_c >= 0) & (b_c < width - 10) & (i_f[..., None] > 0)
    frame_ix = jnp.broadcast_to(jnp.arange(i_f.shape[0])[:, None, None],
                                b_c.shape)
    flat = frame_ix * width + jnp.clip(b_c, 0, width - 1) + 10
    return (np.array(flat), np.array(jnp.where(valid, contrib, 0.0)),
            np.array(b_c))


def test_plain_histogram_is_jaxs_scatter_add_bit_for_bit():
    """The plain version's rows (index_add_ in flat order on the CPU)
    against JAX's .at[flat].add on the same operands: the same bits; and
    the port's own operands against JAX's: the same bins, contributions
    an ulp apart at most (0.8^h in float32 and float64-rounded)."""
    tp, _ = tone_pvs()
    log2_min = float(np.log2(55.0))
    width = 620
    i_f, i_m = information.salience_peaks(tp, 0)
    flat, contrib, b_c = _jax_contributions(i_f.numpy(), i_m.numpy(), width,
                                            log2_min)
    frames = i_f.shape[0]
    # the JAX package's scatter drops the indices past the end (an invalid
    # contribution of 0 there); index_add_ needs them in range
    keep = flat < frames * width
    want = np.array(jnp.zeros(frames * width, jnp.float32).at[
        jnp.asarray(flat.reshape(-1))].add(
            jnp.asarray(contrib.reshape(-1)))).reshape(frames, width)
    got = pk.histogram_rows_ref(torch.from_numpy(np.where(keep, flat, 0)),
                                torch.from_numpy(np.where(keep, contrib,
                                                          0.0)),
                                frames, width).numpy()
    np.testing.assert_array_equal(got, want)
    t_flat, t_contrib = pk.subharmonic_contributions(i_f, i_m, width,
                                                     log2_min)
    valid = contrib != 0
    assert np.array_equal(t_flat.numpy()[valid], flat[valid])
    np.testing.assert_allclose(t_contrib.numpy(), contrib, rtol=1.2e-7,
                               atol=0)


def test_spread_matches_jaxs_convolution():
    """The 21 shifted slices in tap order against JAX's HIGHEST-precision
    convolution on the same rows: 6e-8 of the peak read (taps an ulp off,
    another sum order); bound 1e-6."""
    rows = np.random.default_rng(2).random((40, 620)).astype(np.float32)
    rows[:, :200] = 0.0
    offs = jnp.arange(-10, 11)
    g = 0.5 * (1.0 + jnp.cos(jnp.abs(offs) / 10 * jnp.pi / 2.0))
    want = np.array(jax.lax.conv_general_dilated(
        jnp.asarray(rows)[:, None, :], g[None, None, :], (1,), "VALID",
        dimension_numbers=("NCH", "OIH", "NCH"),
        precision=jax.lax.Precision.HIGHEST)[:, 0, :])
    got = pk.spread_ref(torch.from_numpy(rows)).numpy()
    assert got.shape == (40, 600)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-6 * np.abs(want).max())


def histogram_loop(i_f, i_m, width, log2_min):
    """The kernel's function step by step on the host in float32: each
    frame's row from zeros, contributions in (k, h) order, then each output
    the taps in order (csrc/pv_info_kernels.cu)."""
    i_f, i_m = np.asarray(i_f, np.float32), np.asarray(i_m, np.float32)
    alpha, g = pk.alpha_powers(), pk.spread_taps()
    lm = np.float32(log2_min)
    frames, k_cnt = i_f.shape
    out = np.zeros((frames, width - 20), np.float32)
    for f in range(frames):
        row = np.zeros(width, np.float32)
        for k in range(k_cnt):
            fk, mk = i_f[f, k], i_m[f, k]
            if not fk > 0 or mk == 0:
                continue
            for h in range(1, 21):
                sub = max(np.float32(fk / np.float32(h)), np.float32(1e-9))
                lg = np.float32(np.log2(np.float64(sub)))
                b = int(np.rint(np.float32(120.0) * np.float32(lg - lm)))
                if 0 <= b < width - 10:
                    row[b + 10] = np.float32(row[b + 10]
                                             + np.float32(alpha[h - 1] * mk))
        for j in range(width - 20):
            acc = np.float32(0.0)
            for i in range(21):
                acc = np.float32(acc + np.float32(row[j + i] * g[i]))
            out[f, j] = acc
    return out


def histogram_inputs(frames=6, k_cnt=16, width=620, seed=1):
    """Peaks with the kernel's edge cases: a frame with no peak (all i_m
    0), contributions on the row's first and last valid bins (55 Hz and
    just under the band's top at h = 1), i_f <= 0 entries, and K slots
    past a frame's peaks."""
    rng = np.random.default_rng(seed)
    i_f = rng.uniform(60.0, 3000.0, (frames, k_cnt)).astype(np.float32)
    i_m = rng.uniform(0.0, 2.0, (frames, k_cnt)).astype(np.float32)
    i_m[1] = 0.0                                     # no peak
    top = 55.0 * 2.0 ** ((width - 21) / 120.0)
    i_f[2, :3] = (55.0, top, 55.0 * 2.0 ** (-0.5 / 120.0))
    i_f[3, 4:7] = (0.0, -5.0, 1e-12)
    i_m[4, k_cnt // 2:] = 0.0                        # slots past the peaks
    return torch.from_numpy(i_f), torch.from_numpy(i_m)


@pytest.mark.parametrize("k_cnt", [1, 16, 48])
def test_plain_histogram_matches_the_kernels_loop(k_cnt):
    """The plain version against the kernel's order written as a loop, on
    the edge cases of histogram_inputs: the same bits."""
    i_f, i_m = histogram_inputs(k_cnt=max(k_cnt, 8))
    i_f, i_m = i_f[:, :k_cnt].contiguous(), i_m[:, :k_cnt].contiguous()
    log2_min = float(np.log2(55.0))
    got = pk.salience_histogram(i_f, i_m, 620, log2_min).numpy()
    np.testing.assert_array_equal(got, histogram_loop(i_f, i_m, 620,
                                                      log2_min))
    assert pk.LAUNCHES["salience_histogram"] == 0


def test_salience_peaks_lossless_k():
    """K is the most peaks in a frame rounded up to 16: a larger K adds
    only empty slots (i_m 0), and the peaks themselves come in the same
    order (the loudest first)."""
    tp, _ = tone_pvs()
    i_f, i_m = information.salience_peaks(tp, 1)
    k = i_f.shape[1]
    assert k % 16 == 0
    more_f, more_m = information.salience_peaks(tp, 1, max_peaks=k + 16)
    assert torch.equal(more_m[:, :k], i_m) and not more_m[:, k:].any()
    live = i_m > 0
    assert torch.equal(more_f[:, :k][live], i_f[live])


# ------------------------------------------------------------------ contours

def test_contours_match_golden_and_jax():
    tp, jp = tonal_pvs()
    cons = tp.get_contours(0, 55.0, 1760.0, 30, 20.0)
    want = jp.get_contours(0, 55.0, 1760.0, 30, 20.0)
    cd = np.fromfile(os.path.join(FIXDIR, "info_contours.f32"), dtype="<f4")
    n_ref = int(open(os.path.join(FIXDIR,
                                  "info_contours.dims")).read().split()[0])
    assert len(cons) == n_ref == len(want)
    i = 0
    for c, w in zip(cons, want):
        assert isinstance(c, PV.Contour)
        pm, ps, sm, ss, sf, nb = cd[i:i + 6]
        assert abs(c.pitch_mean - pm) < 0.5
        assert abs(c.pitch_std_dev - ps) < 0.5
        assert abs(c.salience_mean - sm) < 1e-2 * max(1.0, abs(sm))
        assert abs(c.salience_std_dev - ss) < 1e-2 * max(1.0, abs(ss))
        assert c.start_frame == int(sf) == w.start_frame
        assert len(c.bins) == int(nb)
        bins_ref = cd[i + 6:i + 6 + 2 * int(nb)].reshape(-1, 2)
        np.testing.assert_allclose(c.bins[:, 0], bins_ref[:, 0], atol=0.5)
        np.testing.assert_allclose(c.bins, w.bins, rtol=0, atol=1e-5)
        i += 6 + 2 * int(nb)


@pytest.mark.parametrize("channel", [0, 1])
def test_contours_of_a_tone_match_jax(channel):
    """The same contours (start frames, lengths, pitch bins) as JAX on a
    harmonic tone; saliences within TOL_SAL."""
    tp, jp = tone_pvs()
    cons = tp.get_contours(channel, 55.0, 1760.0, 10, 20.0)
    want = jp.get_contours(channel, 55.0, 1760.0, 10, 20.0)
    assert len(cons) == len(want) > 0
    for c, w in zip(cons, want):
        assert c.start_frame == w.start_frame
        assert c.bins.shape == w.bins.shape
        np.testing.assert_allclose(c.bins, w.bins, rtol=0, atol=1e-4)


# --------------------------------------------------------------------- prism

def _pf_local(n, t, h, f, hm):
    h = np.asarray(h, np.float32)
    return hm * (1.1 - 0.05 * h), f * h * 1.02


def _pf_global(n, t, h, f, hm):
    h = np.asarray(h, np.float32)
    return hm * (0.9 + 4.0 * t), f * h


@pytest.mark.parametrize("local,pf,golden", [
    (True, _pf_local, "algo_prism_local"),
    (False, _pf_global, "algo_prism_global")])
def test_prism_matches_golden_and_jax(local, pf, golden):
    """prism against its golden and against JAX's batched prism: the same
    bits."""
    tp, jp = tonal_pvs()
    ours = tp.prism(pf, local)
    assert_golden(ours, golden)
    theirs = jp.prism(pf, local)
    np.testing.assert_array_equal(ours.mag.numpy(), np.array(theirs.mag))
    np.testing.assert_array_equal(ours.freq.numpy(), np.array(theirs.freq))


def _octave(note, t, harmonic, base_freq, harmonic_mags):
    return harmonic_mags[harmonic - 1], base_freq * harmonic * 2.0


def _fifth_fading(note, t, harmonic, base_freq, harmonic_mags):
    return (harmonic_mags[harmonic - 1] * (1.0 - 5.0 * t),
            base_freq * harmonic * 1.5)


@pytest.mark.parametrize("local", [True, False])
@pytest.mark.parametrize("pf", [_octave, _fifth_fading])
def test_prism_matches_jaxs_scalar_loop(local, pf):
    """prism against the JAX package's scalar reference loop
    (_prism_scalar_reference, the oracle of its batched prism), with
    callbacks that answer a harmonic or a vector of them: the same
    bits."""
    tp, jp = tonal_pvs()
    ours = tp.prism(pf, local)
    theirs = j_info._prism_scalar_reference(jp, pf, local)
    np.testing.assert_array_equal(ours.mag.numpy(), np.array(theirs.mag))
    np.testing.assert_array_equal(ours.freq.numpy(), np.array(theirs.freq))


def test_prism_with_a_scalar_callback_and_null():
    """A scalar-only callback is retried per harmonic, as in JAX; a PV
    without contours gives a null PV."""
    tp, jp = tonal_pvs()

    def scalar(n, t, h, f, hm):
        if np.ndim(h):
            raise TypeError("scalar harmonics only")
        return float(hm[h - 1]) * 0.5, f * h
    ours, theirs = tp.prism(scalar, True), jp.prism(scalar, True)
    np.testing.assert_array_equal(ours.mag.numpy(), np.array(theirs.mag))
    np.testing.assert_array_equal(ours.freq.numpy(), np.array(theirs.freq))
    quiet = pv_from_numpy(np.zeros((1, 8, 17), np.float32),
                          np.zeros((1, 8, 17), np.float32), SR, HOP, WIN,
                          device="cpu")
    assert quiet.prism(_pf_local).is_null()
    assert quiet.get_contours(0) == []
    assert PV.create_null().get_salience(0).buffer.size == 0


# --------------------------------------------------------------- PV parity

def test_pv_has_flan_tpus_public_names_but_the_waiting_ones():
    """Every method flan_tpu/pv/__init__.py binds on PV (and every other
    public name of flan_tpu's PV) is on the port's, except the graph and
    bitmap methods that wait for A.15; none of those is there."""
    want = {n for n in dir(flan_tpu.PV) if not n.startswith("_")}
    have = {n for n in dir(PV) if not n.startswith("_")}
    assert want - have == WAITING
    for name in ("desample", "smear_time", "time_extrapolate",
                 "stretch_spline", "modify", "get_salience", "get_contours",
                 "prism", "Salience", "Contour"):
        assert name in have
