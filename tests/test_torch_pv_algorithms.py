"""flan_tpu_torch/pv/algorithms.py against flan_tpu on the CPU and against
the compiled reference's goldens (tests/fixtures/reference/algo_*, as
tests/test_algo_golden.py reads them). perturb and synthesize draw their
noise from a torch.Generator; here their deterministic remainders are fed
the JAX package's own noise, drawn with jax.random from the same keys.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flan_tpu.pv.pv import PV as JPV
from flan_tpu_torch import PV, PVFormat
from flan_tpu_torch.pv import algorithms as talg
from test_torch_pv_methods import (assert_golden, assert_like_jax,
                                   input_planes, input_pvs)


def _both(method, *args, seed=0, **kw):
    """method on the port's and JAX's copy of the goldens' input PV."""
    tp, jp = input_pvs(seed)
    return getattr(tp, method)(*args, **kw), getattr(jp, method)(*args, **kw)


def _pair(seed=997):
    """The amp_source operand: the generator's seed-997 input PV."""
    return input_pvs(seed)


# name -> (method, args for the port, args for JAX, golden)
GOLDEN = {
    "freeze": ("freeze", ([0.004, 0.012], [0.003, 0.005]), None,
               "algo_freeze"),
    "harmonics": ("add_harmonics", (lambda t, h: 1.0 / (1.0 + h),), None,
                  "algo_harmonics"),
    "subtract": ("subtract_amplitudes", ("PAIR", 0.5), None,
                 "algo_subtract_amp"),
    "replace": ("replace_amplitudes",
                ("PAIR", lambda t, f: 0.25 + 20.0 * t), None,
                "algo_replace_amp"),
    "resonate": ("resonate", (0.04, lambda t, f: 0.3 + 10.0 * t), None,
                 "algo_resonate"),
    "retain": ("retain_n_loudest_partials", (lambda t: 2 + t * 250.0,),
               None, "algo_retain"),
    "remove": ("remove_n_loudest_partials", (lambda t: 2 + t * 250.0,),
               None, "algo_remove"),
    "select": ("select", (0.030, lambda t, f: (t * 0.5 + 0.002, f * 0.9)),
               None, "algo_select"),
    "shape_f": ("shape", (lambda m, f: (m * 0.7 + 0.1, f * 0.95 + 30.0),
                          False), None, "algo_shape_f"),
    "shape_t": ("shape", (lambda m, f: (m * 0.7 + 0.1, f * 0.95 + 30.0),
                          True), None, "algo_shape_t"),
    "shape_tie": ("shape", (lambda m, f: (torch.full_like(m, 0.5),
                                          f * 0.9 + 40.0), True),
                  (lambda m, f: (jnp.full_like(m, 0.5), f * 0.9 + 40.0),
                   True), "algo_shape_tie"),
}


def _run(name):
    method, args, jargs, golden = GOLDEN[name]
    tp, jp = input_pvs()
    tq, jq = _pair()
    targs = tuple(tq if a == "PAIR" else a for a in args)
    jargs = tuple(jq if a == "PAIR" else a for a in (jargs or args))
    return getattr(tp, method)(*targs), getattr(jp, method)(*jargs), golden


@pytest.mark.parametrize("name", list(GOLDEN))
def test_algorithm_matches_golden_and_jax(name):
    """Each against the compiled reference (tests/test_algo_golden.py's
    tolerances) and against flan_tpu on the same planes: every one reads
    the same bits as JAX here; bound float32 rounding (1e-6 relative, 1e-6
    absolute on magnitudes below 1000, 1e-3 Hz on frequencies below
    5000 Hz)."""
    ours, theirs, golden = _run(name)
    assert_golden(ours, golden)
    assert_like_jax(ours, theirs)


def test_synthesize_golden_and_jax():
    """With no frequency jitter the noise drops out: the reference's planes
    and JAX's (read 1.9e-6 apart on the magnitudes: the hann profile's
    cosine), from the port's own generator."""
    args = (0.02, lambda t: 400.0 + 3000.0 * t, lambda t, h: 1.0 / (1.0 + h))
    kw = dict(harmonic_bandwidth=120.0, harmonic_frequency_std_dev=0.0)
    ours = PV.synthesize(*args, device="cpu", **kw)
    assert_golden(ours, "algo_synth")
    assert_like_jax(ours, JPV.synthesize(*args, **kw), mag_atol=2e-5)


def test_synthesize_with_jax_noise_matches_jax():
    """A frequency jitter: the port's planes from JAX's own noise
    (jax.random.normal on PRNGKey(seed)) against JAX's synthesize. Read:
    the frequencies equal, the magnitudes within 3.8e-6 of a 64 peak (the
    hann profile's cosine); bound 2e-5."""
    seed = 4
    args = (0.05, lambda t: 300.0 + 500.0 * t, None, 80.0,
            lambda t, f: 3.0 + 0.0 * f)
    want = JPV.synthesize(*args, seed=seed)
    out = PV.create_from_format(PVFormat(1, int(0.05 * 48000 / 128), 2049,
                                         48000.0, 128, 2048), device="cpu")
    noise = np.array(jax.random.normal(jax.random.PRNGKey(seed),
                                       (out.num_frames, out.num_bins),
                                       jnp.float32))
    got = talg._synthesize_planes(out, *args[1:], torch.from_numpy(noise))
    assert_like_jax(got, want, mag_atol=2e-5, freq_atol=1e-3)
    # the port's own draw: reproducible from the seed, moved by another
    a, b, c = (PV.synthesize(*args, seed=s, device="cpu") for s in (4, 4, 5))
    assert torch.equal(a.freq, b.freq) and not torch.equal(a.freq, c.freq)
    assert torch.equal(a.mag, got.mag)


@pytest.mark.parametrize("std", [(0.05, 0.5), 0.2,
                                 (lambda t, f: 0.1 * t * 50.0,
                                  lambda t, f: 1.0 + f / 1000.0)])
def test_perturb_with_jax_noise_matches_jax(std):
    """The two damped recurrences (frames per bin, then bins per frame,
    each first step doubled through y0) and the per-channel magnitude walk,
    fed JAX's noise (PRNGKey(seed) split into the acceleration and the
    magnitude keys): JAX's planes. Read: the frequencies equal (offsets up
    to 475 Hz), the magnitudes within 3e-8 (the walk's cumsum order)."""
    seed = 7
    tp, jp = input_pvs()
    want = jp.perturb(std, 0.97, seed=seed)
    k_acc, k_mag = jax.random.split(jax.random.PRNGKey(seed))
    na = np.array(jax.random.normal(k_acc, (24, 17), jnp.float32))
    nm = np.array(jax.random.normal(k_mag, (2, 24), jnp.float32))
    got = talg._perturb_planes(tp, std, 0.97, torch.from_numpy(na),
                               torch.from_numpy(nm))
    assert_like_jax(got, want, mag_atol=1e-6, freq_atol=1e-3)
    a, b = (tp.perturb(std, 0.97, seed=s) for s in (1, 1))
    assert torch.equal(a.freq, b.freq) and torch.equal(a.mag, b.mag)


def test_add_octaves_matches_jax():
    ours, theirs = _both("add_octaves", lambda t, h: 0.5 ** h)
    assert_like_jax(ours, theirs)
    ours, theirs = _both("add_harmonics", 0.3, max_harmonics=4)
    assert_like_jax(ours, theirs)


def test_harmonic_series_must_be_scalar_over_time():
    tp, _ = input_pvs()
    with pytest.raises(ValueError, match="scalar"):
        tp.add_harmonics(lambda t, h: t * torch.ones(17), max_harmonics=2)


def test_select_reads_stacked_pairs():
    """A selector returning one tensor with a last axis of 2 is read as
    (time, frequency), as a tuple is."""
    tp, jp = input_pvs()
    ours = tp.select(0.030, lambda t, f: torch.stack(
        torch.broadcast_tensors(t * 0.5 + 0.002, f * 0.9), -1))
    assert_golden(ours, "algo_select")


def test_algorithms_on_null_and_mismatched_inputs():
    null = PV.create_null()
    tp, _ = input_pvs()
    assert null.resonate(0.1, 0.5).is_null()
    assert null.perturb(0.1).is_null()
    assert tp.replace_amplitudes(null).is_null()
    assert tp.freeze([0.01], [0.01, 0.02]).is_null()
    assert tp.select(0.0, lambda t, f: (t, f)).is_null()
    assert PV.synthesize(0.0001, 440.0, device="cpu").is_null()
    # a shorter amp source: the planes past its frames are zero
    m, f = input_planes(997)
    short, _ = input_pvs(planes=(m[:, :10], f[:, :10]))
    out = tp.replace_amplitudes(short, 0.5)
    assert not out.mag[:, 10:].any() and not out.freq[:, 10:].any()


def test_resonate_and_perturb_go_through_ops_scan(monkeypatch):
    """resonate runs the max-affine recurrence along frames once (the
    decay plane shared by the channels, c one value); perturb the linear
    recurrence twice, with start states: the calls the card's scan kernels
    take."""
    from flan_tpu_torch.ops import scan
    calls = []
    for name in ("linear_recurrence", "max_affine_recurrence"):
        real = getattr(scan, name)

        def spy(*a, _real=real, _name=name, **k):
            calls.append((_name, k.get("axis"), "y0" in k))
            return _real(*a, **k)
        monkeypatch.setattr(talg, name, spy)
    tp, _ = input_pvs()
    tp.resonate(0.04, 0.5)
    tp.perturb(0.1)
    assert calls == [("max_affine_recurrence", 1, False),
                     ("linear_recurrence", 0, True),
                     ("linear_recurrence", 1, True)]
