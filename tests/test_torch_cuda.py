"""flan_tpu_torch's CUDA kernels against their plain versions, on the card.

Marked `cuda`: each test skips where torch sees no GPU. The file imports
no jax, so it also runs where jax is not installed:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch

import flan_tpu_torch
from flan_tpu_torch.ops import (build, probe_kernels, scan, scan_kernels,
                                 sequential_kernels, spv_kernels,
                                 sqpv_kernels)
from flan_tpu_torch.sqpv.transform import sqpv_forward, sqpv_inverse

SR = 48000.0


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


def _signal(n, ch, seed=7):
    rng = np.random.default_rng(seed)
    t = np.arange(n, dtype=np.float32) / SR
    x = (0.4 * np.sin(2 * np.pi * 440.0 * t)
         + 0.2 * np.sin(2 * np.pi * 1187.0 * t + 0.3)
         + 0.01 * rng.standard_normal(n).astype(np.float32))
    return np.ascontiguousarray(np.stack([x, -0.5 * x])[:ch],
                                dtype=np.float32)


@pytest.mark.cuda
@pytest.mark.parametrize("nbins,ch,n", [(16, 1, 4001), (96, 2, 20000),
                                        (512, 1, 30011), (2048, 1, 9000)])
def test_spv_kernels_match_plain(cuda_device, nbins, ch, n):
    x = torch.from_numpy(_signal(n, ch)).to(cuda_device)
    before = dict(spv_kernels.LAUNCHES)
    mag, freq = spv_kernels.spv_forward(x, nbins, SR)
    ref_m, ref_f = spv_kernels.spv_forward_ref(x, nbins, SR)
    m64, f64 = spv_kernels.spv_forward_ref(x.double(), nbins, SR)
    out = spv_kernels.spv_inverse(ref_m, ref_f, SR)
    ref_out = spv_kernels.spv_inverse_ref(ref_m, ref_f, SR)
    torch.cuda.synchronize()
    assert spv_kernels.LAUNCHES["spv_forward"] == before["spv_forward"] + 1
    assert spv_kernels.LAUNCHES["spv_inverse"] == before["spv_inverse"] + 1
    scale = ref_m.abs().max()
    assert (mag - ref_m).abs().max() < 1e-5 * scale
    # frequencies: as accurate as the float32 plain version, against the
    # float64 one (float32 drift on weak bins: see chip_smoke.py phase 2)
    live = m64 > 1e-3 * scale
    drift_kernel = (freq[live] - f64[live]).pow(2).mean().sqrt()
    drift_plain = (ref_f[live] - f64[live]).pow(2).mean().sqrt()
    assert drift_kernel <= 2.0 * drift_plain + 1e-4
    assert (out - ref_out).abs().max() < 1e-4 * ref_out.abs().max()


@pytest.mark.cuda
@pytest.mark.parametrize("nbins,ch,n", [
    (2, 1, 1), (2, 2, 300), (3, 3, 129), (17, 1, 127), (33, 2, 1000),
    # just off a multiple of 4: single bins beside the 4-bin path of 512
    (510, 1, 2000), (514, 3, 2000), (512, 2, 2000),
    # one frame, and lengths around one 128-frame tile, on the 4-bin path
    (16, 1, 1), (16, 3, 127), (128, 1, 129), (2048, 1, 4223),
    # two 4-bin groups a thread; single bins, 8 a thread
    (1028, 1, 3000), (2047, 1, 3000)])
def test_spv_kernels_edge_shapes(cuda_device, nbins, ch, n):
    """The smallest bin count, one partial tile, odd bin counts, bin counts
    on and just off the 16-byte path and three channels; short enough that
    float32 drift stays at rounding."""
    x = torch.from_numpy(np.tile(_signal(n, 1), (ch, 1)) *
                         np.float32([[1.0], [-0.5], [0.25]][:ch])).to(
        cuda_device)
    mag, freq = spv_kernels.spv_forward(x, nbins, SR)
    ref_m, ref_f = spv_kernels.spv_forward_ref(x, nbins, SR)
    out = spv_kernels.spv_inverse(ref_m, ref_f, SR)
    ref_out = spv_kernels.spv_inverse_ref(ref_m, ref_f, SR)
    torch.cuda.synchronize()
    assert mag.shape == (ch, n, nbins) and out.shape == (ch, n)
    scale = ref_m.abs().max()
    assert (mag - ref_m).abs().max() <= 1e-5 * scale
    strong = ref_m > 1e-2 * scale
    assert (freq - ref_f)[strong].abs().max() < 0.1
    assert (out - ref_out).abs().max() <= 1e-4 * ref_out.abs().max()


@pytest.mark.cuda
def test_spv_kernels_long_small_bins(cuda_device):
    """83 s at 16 bins: 31,251 tiles, 123 chunks of the prefix over tiles.
    At this length float32 summation orders sit further from float64 than
    1e-5 of the peak (on a 220 Hz tone in noise the kernel's magnitudes
    read 1.10e-5 from the float32 plain version's, which reads 3.7e-5 from
    the float64 one, H100), so the magnitudes and frequencies are held to
    twice the plain version's own distance from float64; the inverse,
    whose cycles are exact, to the plain inverse."""
    nbins, n = 16, 4_000_003
    x = torch.from_numpy(_signal(n, 1)).to(cuda_device)
    mag, freq = spv_kernels.spv_forward(x, nbins, SR)
    ref_m, ref_f = spv_kernels.spv_forward_ref(x, nbins, SR)
    m64, f64 = spv_kernels.spv_forward_ref(x.double(), nbins, SR)
    out = spv_kernels.spv_inverse(ref_m, ref_f, SR)
    ref_out = spv_kernels.spv_inverse_ref(ref_m, ref_f, SR)
    torch.cuda.synchronize()
    assert (mag - m64).abs().max() <= 2.0 * (ref_m - m64).abs().max()
    live = m64 > 1e-3 * m64.abs().max()
    drift_kernel = (freq[live] - f64[live]).pow(2).mean().sqrt()
    drift_plain = (ref_f[live] - f64[live]).pow(2).mean().sqrt()
    assert drift_kernel <= 2.0 * drift_plain + 1e-4
    assert (out - ref_out).abs().max() < 1e-4 * ref_out.abs().max()


@pytest.mark.cuda
def test_spv_inverse_kernel_matches_its_emulation(cuda_device):
    """The inverse kernel against the PyTorch emulation of its fixed-point
    arithmetic: only the order of the sum over bins and the last place of
    the cosine differ (3.3e-7 of the peak read at 2048 bins, H100)."""
    x = torch.from_numpy(_signal(9000, 2)).to(cuda_device)
    ref_m, ref_f = spv_kernels.spv_forward_ref(x, 512, SR)
    out = spv_kernels.spv_inverse(ref_m, ref_f, SR)
    emu = spv_kernels.spv_inverse_emulated(ref_m, ref_f, SR)
    torch.cuda.synchronize()
    assert (out - emu).abs().max() < 2e-6 * emu.abs().max()


@pytest.mark.cuda
def test_spv_inverse_takes_an_unaligned_view(cuda_device):
    """Planes whose first element is not 16-byte aligned take the single-bin
    path and give the same result to rounding."""
    x = torch.from_numpy(_signal(3000, 1)).to(cuda_device)
    ref_m, ref_f = spv_kernels.spv_forward_ref(x, 64, SR)
    flat_m = torch.empty(ref_m.numel() + 1, device=cuda_device)
    flat_f = torch.empty_like(flat_m)
    mag, freq = flat_m[1:].view_as(ref_m), flat_f[1:].view_as(ref_f)
    mag.copy_(ref_m), freq.copy_(ref_f)
    assert mag.data_ptr() % 16 != 0 and mag.is_contiguous()
    got = spv_kernels.spv_inverse(mag, freq, SR)
    want = spv_kernels.spv_inverse(ref_m, ref_f, SR)
    torch.cuda.synchronize()
    assert (got - want).abs().max() < 2e-6 * want.abs().max()


@pytest.mark.cuda
def test_kernel_wrappers_reject_bad_input(cuda_device):
    x = torch.zeros((1, 256), device=cuda_device)
    with pytest.raises(ValueError):
        spv_kernels.spv_forward(x.double(), 16, SR)
    with pytest.raises(ValueError):
        spv_kernels.spv_forward(x, spv_kernels.MAX_BINS + 1, SR)
    with pytest.raises(ValueError):
        spv_kernels.spv_forward(x[:, ::2], 16, SR)


@pytest.mark.cuda
def test_stretch_runs_on_the_card(cuda_device):
    """The stretch on the card against the CPU, at the size the CPU tests
    hold the port to the JAX package (sr 8000, 6000 samples)."""
    x = _signal(6000, 2)
    cpu = (flan_tpu_torch.Audio.create_from_array(x, 8000.0, device="cpu")
           .convert_to_PV(512, 64, 512).stretch(2.0).convert_to_audio())
    gpu = (flan_tpu_torch.Audio.create_from_array(x, 8000.0,
                                                  device=cuda_device)
           .convert_to_PV(512, 64, 512).stretch(2.0).convert_to_audio())
    assert gpu.device.type == "cuda"
    want = cpu.to_numpy()
    got = gpu.to_numpy()
    assert got.shape == want.shape
    # cuFFT against pocketfft, integrated into phase by the inverse: 6.0e-5
    # of the peak on chip_smoke.py's signal of this size (H100); bound 3x
    assert np.abs(got - want).max() < 2e-4 * np.abs(want).max()


def _decoded(pitch, positive):
    return torch.where(positive, 1.0, -1.0).double() * torch.exp2(
        pitch.double())


def _rms_mod(a, b, period):
    """RMS of a - b with each difference wrapped into [-period/2, period/2]."""
    d = a - b
    return (d - period * (d / period).round()).pow(2).mean().sqrt()


def _sqpv_checks(x, sr, bpo, band, tol_mag=2e-5, tol_inv=2e-4):
    """B3 and B4 against their plain versions on the same CUDA tensors:
    magnitude against the peak, the decoded frequency's RMS drift against
    the float64 plain version at most twice the float32 plain version's
    (modulo the sample rate, as chip_smoke.py sqpv_errors says why), and
    the inverse on the plain planes against the plain inverse."""
    before = dict(sqpv_kernels.LAUNCHES)
    mag, pitch, pos = sqpv_forward(x, sr, bpo, band)
    ref = sqpv_kernels.sqpv_forward_ref(x, sr, bpo, band)
    ref64 = sqpv_kernels.sqpv_forward_ref(x.double(), sr, bpo, band)
    out = sqpv_inverse(*ref, sr, bpo, band)
    ref_out = sqpv_kernels.sqpv_inverse_ref(*ref, sr, bpo, band)
    torch.cuda.synchronize()
    assert sqpv_kernels.LAUNCHES["sqpv_forward"] == \
        before["sqpv_forward"] + 1
    assert sqpv_kernels.LAUNCHES["sqpv_inverse"] == \
        before["sqpv_inverse"] + 1
    assert mag.shape == pitch.shape == pos.shape == ref[0].shape
    assert pos.dtype == torch.bool and out.shape == x.shape
    scale = ref[0].abs().max()
    live = ref64[0] > 1e-3 * scale
    f64 = _decoded(*ref64[1:])[live]
    drift_kernel = _rms_mod(_decoded(pitch, pos)[live], f64, sr)
    drift_plain = _rms_mod(_decoded(*ref[1:])[live], f64, sr)
    mag_err = (mag - ref[0]).abs().max() / scale
    inv_err = (out - ref_out).abs().max() / ref_out.abs().max()
    print(f"sr={sr} bpo={bpo} band={band} shape={tuple(mag.shape)}: "
          f"mag {float(mag_err):.3g}, drift {float(drift_kernel):.4g} vs "
          f"{float(drift_plain):.4g} Hz, inverse {float(inv_err):.3g}")
    # chip_smoke.py's tolerances: its largest readings are 1.21e-5
    # (magnitude) and 1.00e-4 (inverse) at 10 s, 1.05e-5 here on one bin
    assert mag_err <= tol_mag
    assert drift_kernel <= 2.0 * drift_plain + 1e-4
    assert inv_err <= tol_inv


@pytest.mark.cuda
@pytest.mark.parametrize("sr,bpo,band,ch,n", [
    (8000.0, 6.0, (100.0, 3000.0), 1, 16000),
    (8000.0, 12.0, (100.0, 3000.0), 2, 12345),
    (48000.0, 24.0, (16.0, 24000.0), 1, 96000),
    (48000.0, 12.0, (16.0, 24000.0), 2, 50001),
    # 507 bins: tiles of 12 frames, two bins a thread in the inverse
    (48000.0, 48.0, (16.0, 24000.0), 1, 30000)])
def test_sqpv_kernels_match_plain(cuda_device, sr, bpo, band, ch, n):
    x = torch.from_numpy(_signal(n, ch)).to(cuda_device)
    _sqpv_checks(x, sr, bpo, band)


@pytest.mark.cuda
@pytest.mark.parametrize("bpo,band,ch,n", [
    (6.0, (1150.0, 1250.0), 1, 3000),      # one bin, at the 1187 Hz tone
    (6.0, (100.0, 3000.0), 1, 100),        # shorter than a tile
    (8.0, (200.0, 2000.0), 3, 1300),       # three channels, odd periods
    (6.0, (100.0, 1600.0), 2, 5000),       # 24 bins: a multiple of 4
    (12.0, (100.0, 3000.0), 1, 127),       # 59 bins: odd; one frame short
    (12.0, (100.0, 3000.0), 2, 4097),      # a carry chunk of 32 tiles + 1
    (64.0, (100.0, 3900.0), 1, 3000)])     # 339 bins: two blocks of bins
def test_sqpv_kernels_edge_shapes(cuda_device, bpo, band, ch, n):
    x = torch.from_numpy(np.tile(_signal(n, 1), (ch, 1)) *
                         np.float32([[1.0], [-0.5], [0.25]][:ch])).to(
        cuda_device)
    _sqpv_checks(x.contiguous(), 8000.0, bpo, band)


@pytest.mark.cuda
def test_sqpv_forward_gives_the_same_bits_every_call(cuda_device):
    """B3 at the bench shape (10 s mono 48 kHz, 254 bins): every order of
    summation is fixed, so three calls agree bit for bit."""
    x = torch.from_numpy(_signal(480000, 1)).to(cuda_device)
    args = (SR, 24.0, (16.0, 24000.0))
    first = sqpv_forward(x, *args)
    for _ in range(2):
        again = sqpv_forward(x, *args)
        torch.cuda.synchronize()
        assert all(torch.equal(a, b) for a, b in zip(first, again))


BENCH_SQPV = (SR, 24.0, (16.0, 24000.0))   # 254 bins


def _random_planes(ch, n, device, seed=3, nbins=254):
    """SQPV planes of random magnitudes, pitches of 16 Hz to 24 kHz and
    signs, made on the card from a seed."""
    gen = torch.Generator(device=device).manual_seed(seed)
    shape = (ch, n, nbins)
    mag = torch.rand(shape, device=device, generator=gen)
    pitch = torch.empty(shape, device=device).uniform_(4.0, 14.55,
                                                       generator=gen)
    positive = torch.rand(shape, device=device, generator=gen) < 0.7
    return mag, pitch, positive


@pytest.mark.cuda
def test_sqpv_inverse_is_as_accurate_as_the_plain_version(cuda_device):
    """B4's error against a float64 plain run on the same planes is at most
    the float32 plain run's: its cycles are 32-bit fixed point (exact sums)
    where the plain version's are float64 sums of float32 increments cast
    back to float32. Both float32 runs decode each frame's increment with
    float32 exp2 and division, whose rounding integrates over the frames and
    sets most of both errors (1.6518e-4 and 1.6516e-4 of a 0.493 peak at
    these 2 s, H100); what is left differs by the order of the sum over
    bins, so the kernel's may exceed the plain run's by 1e-6 of the peak."""
    x = torch.from_numpy(_signal(96000, 1)).to(cuda_device)
    planes = sqpv_kernels.sqpv_forward_ref(x, *BENCH_SQPV)
    out = sqpv_inverse(*planes, *BENCH_SQPV)
    y32 = sqpv_kernels.sqpv_inverse_ref(*planes, *BENCH_SQPV)
    y64 = sqpv_kernels.sqpv_inverse_ref(planes[0].double(),
                                        planes[1].double(), planes[2],
                                        *BENCH_SQPV)
    torch.cuda.synchronize()
    err_k = float((out.double() - y64).abs().max())
    err_p = float((y32.double() - y64).abs().max())
    peak = float(y64.abs().max())
    print(f"from float64: kernel {err_k:.5g}, plain {err_p:.5g}, peak "
          f"{peak:.3g}")
    assert err_k <= err_p + 1e-6 * peak


@pytest.mark.cuda
def test_sqpv_inverse_gives_the_same_bits_every_call(cuda_device):
    """Stereo at 10 s of 48 kHz, 254 bins: 34,286 tiles whose blocks wait
    on each other in the look-back, in whatever order they run; the sums
    over tiles are exact and the sum over bins runs in a fixed order, so
    three calls agree bit for bit."""
    planes = _random_planes(2, 480000, cuda_device)
    first = sqpv_inverse(*planes, *BENCH_SQPV)
    for _ in range(2):
        again = sqpv_inverse(*planes, *BENCH_SQPV)
        torch.cuda.synchronize()
        assert torch.equal(first, again)
    assert bool(torch.isfinite(first).all())


@pytest.mark.cuda
def test_sqpv_inverse_takes_unaligned_planes(cuda_device):
    """Planes that start 1 element past a 16-byte boundary (4 bytes for the
    floats, 1 for the signs) stage through the same shared memory shifted:
    the same bits as aligned planes."""
    planes = _random_planes(2, 3001, cuda_device, nbins=59)
    band = (100.0, 3000.0)
    shifted = []
    for p in planes:
        flat = torch.empty(p.numel() + 1, dtype=p.dtype, device=cuda_device)
        view = flat[1:].view_as(p)
        view.copy_(p)
        shifted.append(view)
    assert all(v.data_ptr() % 16 != 0 for v in shifted)
    want = sqpv_inverse(*planes, 8000.0, 12.0, band)
    got = sqpv_inverse(*shifted, 8000.0, 12.0, band)
    ref = sqpv_kernels.sqpv_inverse_ref(*planes, 8000.0, 12.0, band)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    assert (got - ref).abs().max() <= 2e-4 * ref.abs().max()


@pytest.mark.cuda
def test_sqpv_inverse_refuses_a_misaligned_scratch(cuda_device):
    """A descriptor word of the look-back is one 64-bit store and load, so
    flan_sqpv_inverse refuses a scratch that is not 8-byte aligned
    (cudaErrorInvalidValue) and launches nothing."""
    lib = build.load_library()
    mag, pitch, positive = _random_planes(1, 1000, cuda_device)
    offsets = sqpv_kernels.inverse_offsets(*BENCH_SQPV, cuda_device)
    nbytes = lib.flan_sqpv_inverse_scratch_bytes(1, 1000, 254)
    assert nbytes > 8
    scratch = torch.zeros(nbytes // 8 + 1, dtype=torch.int64,
                          device=cuda_device)
    out = torch.zeros((1, 1000), device=cuda_device)
    stream = torch.cuda.current_stream().cuda_stream
    args = (mag.data_ptr(), pitch.data_ptr(), positive.data_ptr(),
            offsets.data_ptr())
    tail = (out.data_ptr(), 1, 1000, 254, SR, stream)
    assert lib.flan_sqpv_inverse(*args, scratch.data_ptr() + 4, *tail) == 1
    torch.cuda.synchronize()
    assert not bool((out != 0).any())
    assert lib.flan_sqpv_inverse(*args, scratch.data_ptr() + 8, *tail) == 0
    torch.cuda.synchronize()
    assert bool(torch.isfinite(out).all()) and bool((out != 0).any())


@pytest.mark.cuda
def test_sqpv_inverse_tile_frames_match_the_library(cuda_device):
    """ops/sqpv_kernels.py's mirror of the kernel's frames per tile, which
    the CPU emulation of tests/test_torch_sqpv.py tiles by."""
    lib = build.load_library()
    for nbins in (1, 24, 59, 254, 339, 507, 1024, 2048):
        assert lib.flan_sqpv_inverse_tile_frames(nbins) == \
            sqpv_kernels.inverse_tile_frames(nbins)


@pytest.mark.cuda
def test_sqpv_wrappers_reject_bad_input(cuda_device):
    x = torch.zeros((1, 256), device=cuda_device)
    band = (100.0, 3000.0)
    with pytest.raises(ValueError):
        sqpv_forward(x.double(), 8000.0, 6.0, band)
    with pytest.raises(ValueError):
        sqpv_forward(x[:, ::2], 8000.0, 6.0, band)
    mag = torch.zeros((1, 8, 30), device=cuda_device)
    with pytest.raises(ValueError):
        sqpv_inverse(mag, mag, mag, 8000.0, 6.0, band)   # positive not bool
    with pytest.raises(ValueError):
        sqpv_inverse(mag, mag, mag.bool(), 8000.0, 8.0, band)   # 27 bins


@pytest.mark.cuda
def test_sqpv_round_trip_runs_on_the_card(cuda_device):
    """The SQPV class path and repitch on the card against the CPU."""
    x = _signal(3000, 2)
    band = (100.0, 3000.0)
    runs = [flan_tpu_torch.Audio.create_from_array(x, 8000.0, device=d)
            .convert_to_SQPV(band, 6.0).repitch(1.5).convert_to_audio()
            for d in ("cpu", cuda_device)]
    want, got = (a.to_numpy() for a in runs)
    assert runs[1].device.type == "cuda" and got.shape == want.shape
    assert np.abs(got - want).max() < 1e-3 * np.abs(want).max()


# ------------------------------------------------- scans (T1/T2) and T3

def _scan_planes(kind, ch, n, seed=11, shared_a=False):
    """Float32 planes and start states of one scan kind: decay factors
    spread from 0.5 to 0.99999, as the filters' and the compressor's. With
    shared_a the coefficient planes are one row for all rows; with "all"
    every plane is (_run_scan expands them; the start states differ)."""
    rng = np.random.default_rng(seed)
    rows = 1 if shared_a else ch
    own = 1 if shared_a == "all" else ch
    a = rng.uniform(0.5, 0.99999, (rows, n)).astype(np.float32)
    if kind == "scan_linear":
        planes = (a, rng.standard_normal((own, n)))
    elif kind == "scan_max_affine":
        m = rng.standard_normal((own, n))
        planes = (m, a, (1.0 - a) * m)
    else:
        theta = rng.uniform(0.0, 0.2, (rows, n))
        planes = (a * np.cos(theta), -a * np.sin(theta), a * np.sin(theta),
                  a * np.cos(theta), rng.standard_normal((own, n)),
                  rng.standard_normal((own, n)))
    y0 = rng.standard_normal((ch, 1, 2))
    return ([np.asarray(p, np.float32) for p in planes],
            [np.asarray(y0[..., i], np.float32) for i in range(2)])


def _run_scan(kind, planes, y0s, rows=None):
    """(kernel, plain float32, plain float64) outputs of one scan kind; with
    `rows`, every plane is expanded to that many rows on the card."""
    n_states = 2 if kind == "scan_affine2x2" else 1
    y0s = y0s[:n_states]
    kernel = {"scan_linear": scan_kernels.scan_linear,
              "scan_max_affine": scan_kernels.scan_max_affine,
              "scan_affine2x2": scan_kernels.scan_affine2x2}[kind]
    plain = {"scan_linear": scan_kernels.linear_ref,
             "scan_max_affine": scan_kernels.max_affine_ref,
             "scan_affine2x2": scan_kernels.affine2x2_ref}[kind]
    outs = []
    for fn, dt in ((kernel, torch.float32), (plain, torch.float32),
                   (plain, torch.float64)):
        args = [torch.from_numpy(p).to("cuda", dt) for p in planes]
        if rows is not None:
            args = [a.expand(rows, a.shape[-1]) for a in args]
        args += [torch.from_numpy(v).to("cuda", dt) for v in y0s]
        y = fn(*args)
        outs.append(torch.stack(y) if isinstance(y, tuple) else y)
    torch.cuda.synchronize()
    return outs


def _drift(k, p32, p64):
    """The kernel's and the float32 plain version's largest error against
    the float64 plain version, as shares of its peak."""
    peak = p64.abs().max()
    return (float((k.double() - p64).abs().max() / peak),
            float((p32.double() - p64).abs().max() / peak))


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["scan_linear", "scan_max_affine",
                                  "scan_affine2x2"])
@pytest.mark.parametrize("ch,n,shared", [(1, 1, False), (2, 100, True),
                                         (3, 4097, False),
                                         (2, 1_000_003, True)])
def test_scan_kernels_match_plain(cuda_device, kind, ch, n, shared):
    """Each scan kernel against its plain version: its error against the
    float64 plain run at most twice the float32 plain run's, plus 1e-6 of
    the peak for lengths where both sit at rounding (chip_smoke.py
    phase 2 holds the same)."""
    planes, y0s = _scan_planes(kind, ch, n, shared_a=shared)
    before = scan_kernels.LAUNCHES[kind]
    k, p32, p64 = _run_scan(kind, planes, y0s)
    assert scan_kernels.LAUNCHES[kind] == before + 1
    assert k.shape == p32.shape and bool(torch.isfinite(k).all())
    err_k, err_p = _drift(k, p32, p64)
    print(f"{kind} C={ch} N={n}: kernel {err_k:.3g}, plain {err_p:.3g}")
    assert err_k <= 2.0 * err_p + 1e-6


_KINDS = ["scan_linear", "scan_max_affine", "scan_affine2x2"]


@pytest.mark.cuda
@pytest.mark.parametrize("kind", _KINDS)
@pytest.mark.parametrize("ch,frames,shared", [
    (1, "T-1", False), (2, "T", True), (3, "T+1", "all"), (5, "T+1", True),
    (64, "T+1", False), (64, 100_003, "all"), (1, "W-1", False),
    (2, "W", True), (3, "W+1", "all"), (5, "W+1", False),
    (1, 2 ** 25 + 3, False)])
def test_scan_kernels_around_tiles_and_windows(cuda_device, kind, ch, frames,
                                               shared):
    """Lengths around one tile (T elements) and one look-back window of
    W = 256 tiles, 1 to 64 rows, with no, the coefficient and all planes
    shared by the rows; the bound of test_scan_kernels_match_plain."""
    lib = build.load_library()
    tile = lib.flan_scan_tile(_KINDS.index(kind))
    n = frames if isinstance(frames, int) else (
        {"T": tile, "W": lib.flan_scan_window_tiles() * tile}[frames[0]]
        + int(frames[1:] or 0))
    planes, y0s = _scan_planes(kind, ch, n, shared_a=shared)
    k, p32, p64 = _run_scan(kind, planes, y0s,
                            rows=ch if shared == "all" else None)
    assert k.shape == p32.shape and bool(torch.isfinite(k).all())
    err_k, err_p = _drift(k, p32, p64)
    print(f"{kind} C={ch} N={n} shared={shared}: kernel {err_k:.3g}, "
          f"plain {err_p:.3g}")
    assert err_k <= 2.0 * err_p + 1e-6


@pytest.mark.cuda
@pytest.mark.parametrize("kind", _KINDS)
@pytest.mark.parametrize("rows,n", [(None, 28_800_000), (64, 100_003)])
def test_scan_kernels_give_the_same_bits_every_call(cuda_device, kind, rows,
                                                    n):
    """The filter path's shapes at 600 s stereo 48 kHz (the compressor's
    max-affine scan is one row), and 64 short rows, where the blocks of many
    rows wait on one window at once: the look-back composes by tile index,
    so three calls agree bit for bit."""
    ch = rows or (1 if kind == "scan_max_affine" else 2)
    planes, y0s = _scan_planes(kind, ch, n, shared_a=True)
    n_states = 2 if kind == "scan_affine2x2" else 1
    kernel = getattr(scan_kernels, kind)
    args = [torch.from_numpy(p).to(cuda_device) for p in
            planes + y0s[:n_states]]
    first = kernel(*args)
    for _ in range(2):
        again = kernel(*args)
        torch.cuda.synchronize()
        assert torch.equal(torch.stack(list(first) if isinstance(
            first, tuple) else [first]), torch.stack(list(again) if isinstance(
                again, tuple) else [again]))


@pytest.mark.cuda
def test_scan_along_a_middle_axis(cuda_device):
    """The comb's layout: chains along axis 1 of [C, blocks, t]."""
    rng = np.random.default_rng(5)
    a = torch.from_numpy(rng.uniform(0.5, 0.999, (2, 3001, 7)).astype(
        np.float32)).to(cuda_device)
    b = torch.from_numpy(rng.standard_normal((2, 3001, 7)).astype(
        np.float32)).to(cuda_device)
    got = scan.linear_recurrence(a, b, axis=1)
    want = scan_kernels.linear_ref(a.movedim(1, -1), b.movedim(1, -1),
                                   0.0).movedim(-1, 1)
    torch.cuda.synchronize()
    assert got.shape == b.shape
    assert (got - want).abs().max() <= 1e-5 * want.abs().max()


@pytest.mark.cuda
def test_linear_scan_gradient(cuda_device):
    """The kernel path's backward (the reversed recurrence through the same
    kernel) against autograd through the plain version on the card, at
    tests/test_pallas_scan.py's tolerance."""
    rng = np.random.default_rng(1)
    a0 = rng.uniform(0.9, 0.999, (2, 5000)).astype(np.float32)
    b0 = (rng.standard_normal((2, 5000)) * 0.1).astype(np.float32)
    grads = []
    for use_kernel in (True, False):
        a = torch.from_numpy(a0).to(cuda_device).requires_grad_()
        b = torch.from_numpy(b0).to(cuda_device).requires_grad_()
        y0 = torch.tensor([[0.1], [-0.2]], device=cuda_device,
                          requires_grad=True)
        y = (scan.linear_recurrence(a, b, y0) if use_kernel
             else scan_kernels.linear_ref(a, b, y0))
        grads.append(torch.autograd.grad((y * y).sum(), (a, b, y0)))
    for got, want in zip(*grads):
        assert (got - want).abs().max() <= 1e-3 * max(
            1.0, float(want.abs().max()))


def _backward_cases(device):
    """(name, run(device) -> (loss, inputs)) for the three scans whose
    backward came after the linear one's: the max-affine, 2 x 2 and k x k
    maps, coefficient planes shared by the rows as the filters pass them."""
    rng = np.random.default_rng(21)
    n = 20000
    a = rng.uniform(0.5, 0.999, (1, n)).astype(np.float32)
    th = rng.uniform(0.0, 0.2, (1, n)).astype(np.float32)
    m = rng.standard_normal((2, n)).astype(np.float32)
    A = (rng.uniform(-1, 1, (3, 3, n)) * 0.3).astype(np.float32)
    b = rng.standard_normal((2, 3, n)).astype(np.float32)

    def leaf(v):
        return torch.from_numpy(v).to(device).requires_grad_()

    def max_affine():
        t = [leaf(v) for v in (m, a)]
        y = scan.max_affine_recurrence(t[0], t[1], (1 - t[1]) * t[0])
        return (y * y).sum(), t

    def affine2x2():
        t = [leaf(v) for v in (a, th, m)]
        s1, s2 = scan.affine2x2_recurrence(
            t[0] * torch.cos(t[1]), -t[0] * torch.sin(t[1]),
            t[0] * torch.sin(t[1]), t[0] * torch.cos(t[1]), t[2], -t[2])
        return (s1 * s1 + s2).sum(), t

    def kxk():
        t = [leaf(v) for v in (A, b)]
        y = scan.affine_kxk_recurrence(t[0], t[1], 0.5)
        return (y * y).sum(), t

    return {"scan_max_affine": max_affine, "scan_affine2x2": affine2x2,
            "scan_affine_kxk": kxk}


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["scan_max_affine", "scan_affine2x2",
                                  "scan_affine_kxk"])
def test_scans_without_backward_refuse_grad(cuda_device, kind):
    """No scan refuses grad on the card any more: each backward runs the
    forward kernel on the reversed adjoint planes (the max-affine's on the
    linear kernel), and its gradients equal the CPU's, whose backward runs
    the plain versions: 1e-4 of each gradient's peak (float32 scans in two
    orders)."""
    grads = []
    for device in ("cpu", cuda_device):
        before = dict(scan_kernels.LAUNCHES)
        loss, inputs = _backward_cases(device)[kind]()
        forward = {k: scan_kernels.LAUNCHES[k] - before[k] for k in before}
        grads.append([g.cpu() for g in torch.autograd.grad(loss, inputs)])
        backward = {k: scan_kernels.LAUNCHES[k] - before[k] - forward[k]
                    for k in before}
        if device == "cpu":
            assert not any(forward.values()) and not any(backward.values())
        else:
            adjoint = "scan_linear" if kind == "scan_max_affine" else kind
            assert forward[kind] == 1 and backward[adjoint] == 1, backward
    for got, want in zip(grads[1], grads[0]):
        assert bool(torch.isfinite(got).all())
        assert (got - want).abs().max() <= 1e-4 * want.abs().max()


# ----------------------------------------------------- the k x k scan

def _kxk_planes(k, rows, n, shared, seed=31):
    """k x k maps near the multinotch's: a decay of 0.5 to 0.99999 on the
    diagonal beside weak random coupling, and inputs b; A [1 or rows, k*k,
    N], b [rows, k, N], y0 [rows, k], float32 on the card."""
    rng = np.random.default_rng(seed)
    ra = 1 if shared else rows
    A = rng.uniform(-1, 1, (ra, k, k, n)) * (0.3 / k)
    A[:, np.arange(k), np.arange(k)] = rng.uniform(0.5, 0.99999, (ra, k, n))
    b = rng.standard_normal((rows, k, n))
    y0 = rng.standard_normal((rows, k))
    return [torch.from_numpy(v.astype(np.float32)).to("cuda")
            for v in (A.reshape(ra, k * k, n), b, y0)]


def _kxk_frames(frames, k, lib):
    """A case's frames: a number, or an edge of the k x k kernel's tiling
    with an offset: "R" a sub-run, "T" a tile, "B" the 32 windows of tiles
    its look-back reads at a time (for k = 1 and 2 the one pass's tile and
    look-back window of tiles)."""
    if isinstance(frames, int):
        return frames
    tile = lib.flan_scan_kxk_tile(k)
    window = (lib.flan_scan_kxk_window_tiles() * 32 if k >= 3
              else lib.flan_scan_window_tiles())
    unit = {"R": lib.flan_scan_kxk_subrun(k) or tile, "T": tile,
            "B": window * tile}[frames[0]]
    return unit + int(frames[1:] or 0)


# the k x k kernel's cases: (rows, frames, A shared); the long row at the
# k whose plain runs over it take seconds, not minutes
_KXK_KERNEL_CASES = [(1, 1, True), (2, "R-1", True), (2, "R+1", False),
                     (2, "T-1", True), (3, "T+1", False), (2, "B+1", True),
                     (64, "T+1", True)]
_KXK_LONG_ROW = (1, 1_000_003, True)


@pytest.mark.cuda
@pytest.mark.parametrize("k,rows,frames,shared", [
    (k, *case) for k in (1, 2, 3, 4, 5, 6, 7, 8, 9, 12, 16, 20, 34, 40)
    for case in _KXK_KERNEL_CASES + ([_KXK_LONG_ROW] if k <= 8 else [])])
def test_kxk_kernel_matches_plain(cuda_device, k, rows, frames, shared):
    """The k x k kernel against its plain version at one step, around one
    sub-run and one tile, past the 32 windows of tiles its look-back reads
    at a time on 2 rows, 64 rows of one A in groups, A shared and not, a
    long row up to k = 8, and at k = 34 and 40 the instantiation whose
    maps are in the scratch: its error against the float64 plain run at
    most twice the float32 plain run's, plus 1e-6 of the peak, as the
    other scans."""
    lib = build.load_library()
    n = _kxk_frames(frames, k, lib)
    A, b, y0 = _kxk_planes(k, rows, n, shared)
    before = scan_kernels.LAUNCHES["scan_affine_kxk"]
    y = scan_kernels.scan_affine_kxk(A, b, y0)
    assert scan_kernels.LAUNCHES["scan_affine_kxk"] == before + 1
    p32 = scan_kernels.affine_kxk_ref(A, b, y0)
    p64 = scan_kernels.affine_kxk_ref(A.double(), b.double(), y0.double())
    torch.cuda.synchronize()
    assert y.shape == b.shape and bool(torch.isfinite(y).all())
    err_k, err_p = _drift(y, p32, p64)
    print(f"kxk k={k} rows={rows} N={n}: kernel {err_k:.3g}, "
          f"plain {err_p:.3g}")
    assert err_k <= 2.0 * err_p + 1e-6


@pytest.mark.cuda
@pytest.mark.parametrize("k", [3, 4, 8, 12, 16, 20, 34])
def test_kxk_kernel_gives_the_same_bits_every_call(cuda_device, k):
    """64 rows of one shared map, in groups, wait on one another's tiles
    at once; three calls agree bit for bit."""
    A, b, y0 = _kxk_planes(k, 64, 30_011, True)
    first = scan_kernels.scan_affine_kxk(A, b, y0)
    for _ in range(2):
        again = scan_kernels.scan_affine_kxk(A, b, y0)
        torch.cuda.synchronize()
        assert torch.equal(first, again)


@pytest.mark.cuda
def test_kxk_tiling_matches_the_emulation(cuda_device):
    """The (steps a tile, steps a sub-run) pairs and the window of tiles
    that tests/test_torch_scan.py emulates the kernel's order at are the
    library's."""
    lib = build.load_library()
    pairs = {3: (512, 32), 4: (512, 32), 8: (256, 16), 12: (128, 8),
             16: (64, 8), 20: (32, 8), 34: (16, 8), 40: (8, 8)}
    for k, pair in pairs.items():
        assert (lib.flan_scan_kxk_tile(k), lib.flan_scan_kxk_subrun(k)) == \
            pair, k
    assert lib.flan_scan_kxk_window_tiles() == 8


@pytest.mark.cuda
@pytest.mark.parametrize("order", [4, 6])
def test_multinotch_gradient_on_the_card(cuda_device, order):
    """The gradient of the energy through a swept 2-pole multinotch of
    order 4 and 6 (k = 8 and 12) at 1 s stereo 48 kHz, with respect to the
    signal and a 0-d base cutoff: the backward runs the k x k kernel on the
    reversed, transposed maps; card against CPU within 1e-3 of each
    gradient's peak, as chip_smoke.py holds the other gradients."""
    x = _signal(int(SR), 2)
    grads = []
    for device in ("cpu", cuda_device):
        before = scan_kernels.LAUNCHES["scan_affine_kxk"]
        v = torch.from_numpy(x).to(device).requires_grad_()
        c = torch.tensor(300.0, device=device, requires_grad=True)
        y = flan_tpu_torch.Audio.create_from_array(v, SR) \
            .filter_2pole_multinotch(order, lambda t: c * (1.0 + 2.0 * t),
                                     0.3, 0.5).data
        grads.append([g.cpu() for g in torch.autograd.grad(
            (y * y).sum(), (v, c))])
        launched = scan_kernels.LAUNCHES["scan_affine_kxk"] - before
        assert launched == (0 if device == "cpu" else 2), launched
    for got, want in zip(grads[1], grads[0]):
        assert bool(torch.isfinite(got).all())
        assert (got - want).abs().max() <= 1e-3 * want.abs().max()


@pytest.mark.cuda
def test_kxk_kernel_rejects_bad_input(cuda_device):
    A, b, y0 = _kxk_planes(3, 2, 100, False)
    with pytest.raises(ValueError, match="do not fit"):
        scan_kernels.scan_affine_kxk(A[:, :4], b, y0)
    with pytest.raises(ValueError, match="contiguous"):
        scan_kernels.scan_affine_kxk(A, b.transpose(1, 2).contiguous()
                                     .transpose(1, 2), y0)


# ------------------------------------------------ the sequential kernels

def _saturator_planes(n, two_pole, seed=41):
    rng = np.random.default_rng(seed)
    g = torch.from_numpy(rng.uniform(0.02, 0.6, n).astype(np.float32)).cuda()
    k = torch.from_numpy(rng.uniform(0.2, 0.9, n).astype(np.float32)).cuda()
    mix = torch.full((n,), 0.5, device="cuda")
    if two_pole:
        R = torch.from_numpy(rng.uniform(0.2, 0.8, n).astype(np.float32)
                             ).cuda()
        d = 1.0 / (1.0 + 2.0 * R * g + g * g)
        return (g, d * (1.0 - 2.0 * R * g + g * g), k, mix, R, d)
    return (g, g / (1.0 + g), (g - 1.0) / (g + 1.0), k, mix)


# the saturator's orders: 1 to 8 have their own instantiations, 10 runs on
# the runtime-order kernel; inv alternates with the order
SAT_ORDERS = [(1, 1.0), (2, -1.0), (3, 1.0), (4, -1.0), (5, 1.0),
              (6, -1.0), (7, 1.0), (8, -1.0), (10, 1.0)]
# lengths around one round of 32 frames; the long one on a few orders
SAT_LENGTHS = (1, 31, 32, 33, 1500)
SAT_LONG, SAT_LONG_ORDERS = 100_003, (2, 8, 10)
SAT_CASES = ([(o, inv, n) for o, inv in SAT_ORDERS for n in SAT_LENGTHS]
             + [(o, inv, SAT_LONG) for o, inv in SAT_ORDERS
                if o in SAT_LONG_ORDERS])


def _saturator_case(n, two_pole, seed=41):
    x = torch.from_numpy(_signal(max(n, 2), 2)[:, :n] * 3.0).cuda()
    return x, _saturator_planes(n, two_pole, seed)


def _saturator_loop_from(x, planes, inv, order, two_pole, s0, prev0):
    """The plain loop (the forward's step, sequential_kernels._step_*) over
    x [C, M] from the states s0 [C, nstates] and the output prev0 [C]: its
    outputs and new states."""
    step = (sequential_kernels._step_2pole if two_pole
            else sequential_kernels._step_1pole)
    s, prev = list(s0.unbind(1)), prev0
    out, states = [], []
    for t in range(x.shape[1]):
        s, prev, _ = step(s, prev, x[:, t], *(p[t] for p in planes), inv,
                          order)
        out.append(prev)
        states.append(torch.stack(s, dim=1))
    return torch.stack(out, dim=1), torch.stack(states, dim=2)


@pytest.mark.cuda
@pytest.mark.parametrize("two_pole", [False, True])
@pytest.mark.parametrize("order,inv,n", SAT_CASES)
def test_saturator_kernel_matches_plain(cuda_device, two_pole, order, inv,
                                        n):
    """The saturator kernel (orders 1 to 8 on their own instantiations, 10
    on the runtime-order one) against its plain loop, run on the CPU on the
    same inputs: output and every step's states 1e-5 of the peak (tanhf, a
    division without its range check and fused multiply-adds against
    torch's float32 ops; the Newton solve damps what they differ by); the
    same bits on three calls, with and without the states. At 100,003
    frames the loop runs the first and the last 1,000 frames, the last
    from the kernel's states and output before them."""
    x, planes = _saturator_case(n, two_pole)
    name = "saturator_2pole" if two_pole else "saturator_1pole"
    before = sequential_kernels.LAUNCHES[name]
    got, states = sequential_kernels.saturator_cuda(
        x, planes, inv, order, two_pole, keep_states=True)
    assert sequential_kernels.LAUNCHES[name] == before + 1
    cpu = [p.cpu() for p in planes]
    ns = states.shape[1]
    spans = [(0, n)] if n <= 1500 else [(0, 1000), (n - 1000, n)]
    for lo, hi in spans:
        s0 = (states[:, :, lo - 1].cpu() if lo else torch.zeros(2, ns))
        prev0 = got[:, lo - 1].cpu() if lo else torch.zeros(2)
        want, want_states = _saturator_loop_from(
            x[:, lo:hi].cpu(), [p[lo:hi] for p in cpu], inv, order,
            two_pole, s0, prev0)
        assert (got[:, lo:hi].cpu() - want).abs().max() <= \
            1e-5 * want.abs().max()
        assert (states[..., lo:hi].cpu() - want_states).abs().max() <= \
            1e-5 * want_states.abs().max()
    for _ in range(2):
        assert torch.equal(got, sequential_kernels.saturator_cuda(
            x, planes, inv, order, two_pole))
        again = sequential_kernels.saturator_cuda(x, planes, inv, order,
                                                  two_pole, keep_states=True)
        assert torch.equal(got, again[0]) and torch.equal(states, again[1])


@pytest.mark.cuda
@pytest.mark.parametrize("lo,hi", [(1, 40), (12, 120), (30000, 60000)])
def test_comb_kernel_matches_plain(cuda_device, lo, hi):
    """The swept comb kernel against its plain loop: delays from 1 (one
    step a round) to past the shared-memory ring (60000 samples: the ring
    in device memory). The arithmetic of a step is the same in both, so
    they agree to fused multiply-adds: 1e-6 of the peak; the same bits on
    three calls."""
    rng = np.random.default_rng(lo)
    n = 200_000
    d = torch.from_numpy(rng.integers(lo, hi + 1, n).astype(np.int32)).cuda()
    x = torch.from_numpy(rng.standard_normal((2, n)).astype(np.float32)
                         ).cuda()
    k = torch.from_numpy(rng.uniform(-0.7, 0.7, n).astype(np.float32)).cuda()
    a = torch.from_numpy(rng.uniform(0.0, 1.0, n).astype(np.float32)).cuda()
    ring = int(d.max())
    got = sequential_kernels.comb_swept_cuda(x, d, k, a, -1.0, ring)
    want = sequential_kernels.comb_swept_ref(x, d, k, a, -1.0)
    torch.cuda.synchronize()
    assert (got - want).abs().max() <= 1e-6 * want.abs().max()
    for _ in range(2):
        assert torch.equal(got, sequential_kernels.comb_swept_cuda(
            x, d, k, a, -1.0, ring))


def _gradients_close(got, want, tol):
    """Each gradient (the signal's, each plane's per channel) within tol of
    its own peak."""
    gx, gp = got
    wx, wp = want
    assert (gx - wx).abs().max() <= tol * wx.abs().max()
    for i in range(wp.shape[1]):
        assert (gp[:, i] - wp[:, i]).abs().max() <= \
            tol * wp[:, i].abs().max(), i


@pytest.mark.cuda
@pytest.mark.parametrize("two_pole", [False, True])
@pytest.mark.parametrize("order,inv,n", SAT_CASES)
def test_saturator_backward_kernel_matches_plain(cuda_device, monkeypatch,
                                                 two_pole, order, inv, n):
    """The saturator's backward on the card (the maps kernel, the k x k
    scan in reverse time, the read-out kernel) on the kernel forward's own
    states: each gradient (the signal's, each plane's per channel) 1e-4 of
    its peak from the step-by-step loop (saturator_backward_ref, on the
    CPU) over every frame, or at 100,003 frames over the last 400 (the
    adjoint runs from the end: they need nothing before them), and from
    the backward's plain passes (saturator_backward_plain, on the card)
    over all of them, whole and in chunks of 32 frames (so 33 and 1,500
    frames cross chunk borders) or of 32,768 at 100,003 frames
    (ADJOINT_CHUNK_BYTES); the chunked call against the loop too; the same
    bits on three calls. Counted: one launch of each kernel a chunk."""
    x, planes = _saturator_case(n, two_pole)
    y, states = sequential_kernels.saturator_cuda(x, planes, inv, order,
                                                  two_pole, keep_states=True)
    gy = torch.from_numpy(_signal(max(n, 2), 2, seed=9)[:, :n].copy()).cuda()
    args = (gy, x, planes, y, states, inv, order, two_pole)
    name = ("saturator_2pole_backward" if two_pole
            else "saturator_1pole_backward")
    chunk = 32 if n <= 1500 else 32_768
    before = dict(sequential_kernels.LAUNCHES)
    whole = sequential_kernels.saturator_backward_cuda(*args)
    for pass_ in ("maps", "readout"):
        assert sequential_kernels.LAUNCHES[f"{name}_{pass_}"] == \
            before[f"{name}_{pass_}"] + 1
    k = states.shape[1] + 1
    with monkeypatch.context() as m:
        m.setattr(sequential_kernels, "ADJOINT_CHUNK_BYTES",
                  chunk * 4 * x.shape[0] * (k * k + 2 * k))
        assert sequential_kernels.adjoint_chunk(x.shape[0], k - 1) == chunk
        chunked = sequential_kernels.saturator_backward_cuda(*args)
    assert sequential_kernels.LAUNCHES[f"{name}_maps"] == \
        before[f"{name}_maps"] + 1 + -(-n // chunk)
    # the loop over the last p frames, from the frame before them
    p = n if n < SAT_LONG else 400
    s0 = n - p - 1
    if s0 < 0:
        cut = tuple(t.cpu() for t in (gy, x)) + (
            tuple(q.cpu() for q in planes), y.cpu(), states.cpu())
        keep = slice(0, None)
    else:
        cut = (gy[:, s0:].cpu(), x[:, s0:].cpu(),
               tuple(q[s0:].cpu() for q in planes), y[:, s0:].cpu(),
               states[..., s0:].cpu())
        keep = slice(1, None)
    wx, wp = sequential_kernels.saturator_backward_ref(*cut, inv, order,
                                                       two_pole)
    loop = (wx[:, keep], wp[..., keep])
    for got in (whole, chunked):
        _gradients_close((got[0][:, n - p:].cpu(), got[1][..., n - p:].cpu()),
                         loop, 1e-4)
    plain = sequential_kernels.saturator_backward_plain(*args)
    for got in (whole, chunked):
        _gradients_close(got, plain, 1e-4)
    for _ in range(2):
        again = sequential_kernels.saturator_backward_cuda(*args)
        assert torch.equal(whole[0], again[0])
        assert torch.equal(whole[1], again[1])


@pytest.mark.cuda
@pytest.mark.parametrize("lo,hi", [(1, 40), (12, 120), (30000, 60000)])
def test_comb_backward_kernel_matches_plain(cuda_device, lo, hi):
    """The swept comb's forward with u and its backward kernel against the
    plain loops: u 1e-6 of its peak (the forward's bound), u's adjoint
    1e-5 (adjoints sent to one sample are summed in another order), with
    delays from 1 to past the shared-memory ring (device-memory
    accumulators); the same bits on three calls."""
    rng = np.random.default_rng(lo)
    n = 200_000
    d = torch.from_numpy(rng.integers(lo, hi + 1, n).astype(np.int32)).cuda()
    x, gy = (torch.from_numpy(rng.standard_normal((2, n)).astype(np.float32)
                              ).cuda() for _ in range(2))
    k = torch.from_numpy(rng.uniform(-0.7, 0.7, n).astype(np.float32)).cuda()
    a = torch.from_numpy(rng.uniform(0.0, 1.0, n).astype(np.float32)).cuda()
    ring = int(d.max())
    y, u = sequential_kernels.comb_swept_cuda(x, d, k, a, -1.0, ring,
                                              keep_u=True)
    y_ref, u_ref = sequential_kernels.comb_swept_ref(x, d, k, a, -1.0,
                                                     keep_u=True)
    assert (u - u_ref).abs().max() <= 1e-6 * u_ref.abs().max()
    assert torch.equal(y, sequential_kernels.comb_swept_cuda(
        x, d, k, a, -1.0, ring))
    before = sequential_kernels.LAUNCHES["comb_swept_backward"]
    gu = sequential_kernels.comb_swept_backward_cuda(gy, d, k, a, -1.0, ring)
    assert sequential_kernels.LAUNCHES["comb_swept_backward"] == before + 1
    want = sequential_kernels.comb_swept_backward_ref(gy, d, k, a, -1.0)
    torch.cuda.synchronize()
    assert (gu - want).abs().max() <= 1e-5 * want.abs().max()
    for _ in range(2):
        assert torch.equal(gu, sequential_kernels.comb_swept_backward_cuda(
            gy, d, k, a, -1.0, ring))


@pytest.mark.cuda
def test_sequential_kernels_refuse_grad(cuda_device):
    """The sequential kernels refuse grad no more: gradients through the
    swept comb and the saturator multinotch run their backward kernels on
    the card (one launch each; the saturator's maps kernel once) and equal
    the CPU's plain adjoints, with respect to the signal and to a parameter
    given as a 0-d tensor (the feedback, the cutoff): 1e-4 of the peak."""
    x = _signal(3000, 2) * 3.0

    def comb(a, c):
        return a.filter_comb(lambda t: 4000.0 / (torch.floor(
            12.0 + 100.0 * t) + 0.5), c, 0.5)

    def sat(a, c):
        return a.filter_2pole_multinotch(2, lambda t: c * (1.0 + t), 0.4,
                                         0.7, True, 0.5, True)
    for run, c0, kernel, n in ((comb, 0.5, "comb_swept_backward", 3000),
                               (sat, 300.0, "saturator_2pole_backward_maps",
                                300)):
        grads = []
        for device in ("cpu", cuda_device):
            before = sequential_kernels.LAUNCHES[kernel]
            v = torch.from_numpy(x[:, :n]).to(device).requires_grad_()
            c = torch.tensor(c0, device=device, requires_grad=True)
            y = run(flan_tpu_torch.Audio.create_from_array(v, 8000.0), c).data
            grads.append([g.cpu() for g in torch.autograd.grad(
                (y * y).sum(), (v, c))])
            assert sequential_kernels.LAUNCHES[kernel] - before == (
                0 if device == "cpu" else 1), kernel
        for got, want in zip(grads[1], grads[0]):
            assert bool(torch.isfinite(got).all())
            assert (got - want).abs().max() <= 1e-4 * want.abs().max(), kernel


@pytest.mark.cuda
def test_new_filters_run_on_the_card(cuda_device):
    """The multinotch filters (scan and FIR path), their saturator variant
    and the swept comb on the card against the CPU at 8 kHz: 1e-4 of the
    peak, chip_smoke.py phase 8's bound; each launches its kernel on the
    card and none on the CPU."""
    x = _signal(20000, 2)
    runs = {
        "mn1": (lambda a: a.filter_1pole_multinotch(
            4, lambda t: 200.0 + 500.0 * t, 0.5), "scan_affine_kxk"),
        "mn2": (lambda a: a.filter_2pole_multinotch(
            4, lambda t: 200.0 + 500.0 * t, 0.3, 0.5), "scan_affine_kxk"),
        "mn2_fir": (lambda a: a.filter_2pole_multinotch(
            2, 800.0, 0.35, 0.3), "scan_affine_kxk"),
        "sat2": (lambda a: a.filter_2pole_multinotch(
            2, 800.0, 0.35, 0.3, use_saturator=True), "saturator_2pole"),
        # a feedback sampled from a number is a broadcast view
        "comb": (lambda a: a.filter_comb(lambda t: 200.0 + 500.0 * t,
                                         lambda t: 0.5), "comb_swept"),
    }
    counters = {**scan_kernels.LAUNCHES, **sequential_kernels.LAUNCHES}
    for name, (run, kernel) in runs.items():
        xs = x[:, :2000] if name == "sat2" else x
        outs = []
        for device in ("cpu", cuda_device):
            before = {**scan_kernels.LAUNCHES, **sequential_kernels.LAUNCHES}
            outs.append(run(flan_tpu_torch.Audio.create_from_array(
                xs, 8000.0, device=device)).to_numpy())
            after = {**scan_kernels.LAUNCHES, **sequential_kernels.LAUNCHES}
            launched = after[kernel] - before[kernel]
            assert launched == 0 if device == "cpu" else launched >= 1, name
        want, got = outs
        assert got.shape == want.shape
        assert np.abs(got - want).max() < 1e-4 * np.abs(want).max(), name
    assert set(counters) >= {"scan_affine_kxk", "comb_swept"}


@pytest.mark.cuda
def test_probe_kernel_matches_plain(cuda_device):
    """T3 against its plain version: outputs agree modulo 1 (the probe's
    floor and mod 1 jump by 1 where rounding crosses an integer) within
    1e-4; the plain version against the TPU kernel in interpret mode reads
    9.5e-6 on the CPU (tests/test_torch_scan.py)."""
    x, w = (torch.from_numpy(a).to(cuda_device)
            for a in probe_kernels.probe_inputs())
    before = probe_kernels.LAUNCHES["probe"]
    got = probe_kernels.probe(x, w)
    want = probe_kernels.probe_ref(x, w)
    torch.cuda.synchronize()
    assert probe_kernels.LAUNCHES["probe"] == before + 1
    d = (got - want).double()
    assert float((d - d.round()).abs().max()) < 1e-4


@pytest.mark.cuda
def test_filter_path_runs_on_the_card(cuda_device):
    """The filter and compressor class path on the card against the CPU:
    swept (scan) and constant (FIR, probed on the scans) stages. Bound
    1e-4 of the peak, as chip_smoke.py phase 6, whose 10 s run at 48 kHz
    reads 4.0e-6 (H100)."""
    x = _signal(20000, 2)

    def path(device):
        before = dict(scan_kernels.LAUNCHES)
        out = (flan_tpu_torch.Audio.create_from_array(x, 8000.0,
                                                      device=device)
               .filter_2pole_lowpass(lambda t: 200.0 * 10.0 ** (t / 2.5),
                                     0.5, 2)
               .filter_1pole_highpass(lambda t: 30.0 + 20.0 * t, 3)
               .filter_2pole_highpass(60.0, 0.5, 2)
               .compress(-18.0, 4.0, 0.005, 0.1, 6.0))
        return out, {k: scan_kernels.LAUNCHES[k] - before[k]
                     for k in before}

    (cpu, cpu_launches), (gpu, gpu_launches) = (path(d) for d in
                                                ("cpu", cuda_device))
    assert not any(cpu_launches.values())
    assert all(gpu_launches[k] for k in _KINDS), gpu_launches
    want, got = cpu.to_numpy(), gpu.to_numpy()
    assert gpu.device.type == "cuda" and got.shape == want.shape
    assert np.abs(got - want).max() < 1e-4 * np.abs(want).max()


# ------------------------- the PV algorithms' scans and the streamed paths

def _regime_planes(case, frames, bins, seed=13):
    """The planes `resonate` and `perturb` hand to ops/scan.py, float32 on
    the card: (function, arguments, keyword arguments, scan axis)."""
    rng = np.random.default_rng(seed)
    dev = "cuda"
    if case == "resonate":
        m = torch.from_numpy(rng.random((2, frames, bins)).astype(
            np.float32) * 100.0).to(dev)
        m[:, frames // 2:] = 0.0          # the tail the method appends
        a = torch.from_numpy(rng.uniform(0.2, 0.999, (frames, bins)).astype(
            np.float32)).to(dev)          # one plane for both channels
        return scan.max_affine_recurrence, (m, a, 0.0), {}, 1
    accel = torch.from_numpy(rng.standard_normal((frames, bins)).astype(
        np.float32) * 0.025).to(dev)
    if case == "perturb_frames":
        return (scan.linear_recurrence, (0.99, 0.99 * accel),
                {"y0": accel[0]}, 0)
    return (scan.linear_recurrence, (0.99, 0.99 * accel),
            {"y0": accel[:, 0:1]}, 1)


def _regime_plain(fn, args, kw, axis, dtype):
    """The plain version of the same call, the scan axis moved last."""
    full = [torch.broadcast_to(torch.as_tensor(a, device="cuda"),
                               args[-1].shape if fn is scan.linear_recurrence
                               else args[0].shape).to(dtype)
            for a in args]
    moved = [t.movedim(axis, -1) for t in full]
    if fn is scan.max_affine_recurrence:
        y = scan_kernels.max_affine_ref(moved[0], moved[1], moved[2], 0.0)
    else:
        y0 = torch.as_tensor(kw["y0"], device="cuda").to(dtype)
        y0 = (y0[:, None] if axis == 0 else y0)
        y = scan_kernels.linear_ref(moved[0], moved[1], y0)
    return y.movedim(-1, axis)


@pytest.mark.cuda
@pytest.mark.parametrize("case,frames,bins", [
    ("resonate", 3001, 257), ("resonate", 1000, 2049),
    ("perturb_frames", 1000, 2049), ("perturb_frames", 22501, 129),
    ("perturb_bins", 3000, 2049), ("perturb_bins", 22501, 257)])
def test_scans_in_the_pv_algorithm_regime(cuda_device, case, frames, bins):
    """The linear and max-affine kernels where resonate and perturb put
    them: hundreds to thousands of rows shorter than one tile, a scan axis
    that is not the last (the wrapper copies the moved view), a decay plane
    shared by the channels, a start state per row. Each against its plain
    version (error against float64 at most twice the float32 plain run's
    plus 1e-6 of the peak), the same bits on three calls."""
    fn, args, kw, axis = _regime_planes(case, frames, bins)
    kind = ("scan_max_affine" if fn is scan.max_affine_recurrence
            else "scan_linear")
    before = scan_kernels.LAUNCHES[kind]
    got = fn(*args, axis=axis, **kw)
    assert scan_kernels.LAUNCHES[kind] == before + 1
    p32 = _regime_plain(fn, args, kw, axis, torch.float32)
    p64 = _regime_plain(fn, args, kw, axis, torch.float64)
    torch.cuda.synchronize()
    assert got.shape == p32.shape and bool(torch.isfinite(got).all())
    err_k, err_p = _drift(got, p32, p64)
    print(f"{case} {frames}x{bins}: kernel {err_k:.3g}, plain {err_p:.3g}")
    assert err_k <= 2.0 * err_p + 1e-6
    for _ in range(2):
        again = fn(*args, axis=axis, **kw)
        torch.cuda.synchronize()
        assert torch.equal(got, again)


def _tone_pv(seconds, device, sr=8000.0):
    x = _signal(int(seconds * sr), 2)
    return flan_tpu_torch.Audio.create_from_array(
        x, sr, device=device).convert_to_PV(512, 64, 512)


@pytest.mark.cuda
def test_resonate_and_perturb_run_on_the_card(cuda_device):
    """resonate and perturb on the card, through the scan kernels, against
    the CPU on the same PV and (perturb) the same noise. Magnitudes within
    1e-4 of the peak; resonate's frequencies follow the last frame whose
    input won, which a rounding may hand to a neighbouring frame, so at
    most 1e-3 of its cells may differ (chip_smoke.py phase 7 holds 2 s at
    48 kHz to the same)."""
    from flan_tpu_torch.pv.algorithms import _perturb_planes
    cpu = _tone_pv(1.5, "cpu")
    gpu = _tone_pv(1.5, cuda_device)
    before = dict(scan_kernels.LAUNCHES)
    decay = lambda t, f: 0.05 + 0.9 / (1.0 + f / 1000.0)  # noqa: E731
    res = [p.resonate(0.2, decay) for p in (cpu, gpu)]
    g = torch.Generator().manual_seed(2)
    na = torch.randn((cpu.num_frames, cpu.num_bins), generator=g)
    nm = torch.randn((2, cpu.num_frames), generator=g)
    per = [_perturb_planes(p, (0.05, 0.5), 0.99, na.to(p.device),
                           nm.to(p.device)) for p in (cpu, gpu)]
    torch.cuda.synchronize()
    assert scan_kernels.LAUNCHES["scan_max_affine"] \
        == before["scan_max_affine"] + 1
    assert scan_kernels.LAUNCHES["scan_linear"] == before["scan_linear"] + 2
    for want, got in (res, per):
        assert got.device.type == "cuda" and got.mag.shape == want.mag.shape
        assert (got.mag.cpu() - want.mag).abs().max() \
            <= 1e-4 * want.mag.abs().max()
    d = (per[1].freq.cpu() - per[0].freq).abs()
    assert d.max() <= 1e-4 * per[0].freq.abs().max()
    off = ((res[1].freq.cpu() - res[0].freq).abs() > 1e-3).double().mean()
    assert off <= 1e-3


@pytest.mark.cuda
@pytest.mark.parametrize("path", ["stretch_2", "stretch_1.5", "stretch_var",
                                  "repitch_1.5", "repitch_var", "morph"])
def test_streamed_pipelines_run_on_the_card(cuda_device, path):
    """The streamed pipelines on the card against the CPU at the size the
    CPU tests hold them to the JAX package (sr 8000, window 512, hop 64,
    dft 512, chunks of 32 frames): cuFFT against pocketfft, integrated into
    phase by the inverse, as test_stretch_runs_on_the_card. Read 2.7e-6 to
    8.9e-6 of the peak (H100); bound 1e-4."""
    from flan_tpu_torch import pipelines
    x = _signal(6000, 2)
    kw = dict(window_size=512, hop=64, dft_size=512, sample_rate=8000.0,
              chunk_out=32)
    run = {
        "stretch_2": lambda d: pipelines.pv_stretch_pipeline(x, 2.0,
                                                             device=d, **kw),
        "stretch_1.5": lambda d: pipelines.pv_stretch_pipeline(
            x, 1.5, device=d, **kw),
        "stretch_var": lambda d: pipelines.pv_stretch_pipeline(
            x, lambda t: 1.0 + 0.5 * t, device=d, **kw),
        "repitch_1.5": lambda d: pipelines.pv_repitch_pipeline(
            x, 1.5, device=d, **kw),
        "repitch_var": lambda d: pipelines.pv_repitch_pipeline(
            x, lambda t, f: 1.25 + 0.25 * (t > 0.3), device=d, **kw),
        "morph": lambda d: pipelines.pv_morph_pipeline(
            x, x[::-1, :4000], lambda t, f: torch.clamp(t / 0.5, 0.0, 1.0),
            device=d, **kw)}[path]
    want = run("cpu").numpy()
    got = run(cuda_device)
    assert got.device.type == "cuda"
    got = got.cpu().numpy()
    assert got.shape == want.shape
    err = np.abs(got - want).max() / np.abs(want).max()
    print(f"{path}: card vs CPU {err:.3g} of the peak")
    assert err < 1e-4
