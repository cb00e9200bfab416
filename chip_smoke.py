#!/usr/bin/env python3
"""Smoke test of flan_tpu_torch on one NVIDIA GPU.

    python3 chip_smoke.py
    python3 chip_smoke.py --time-calls [--package DIR]

Runs from the root of a checkout and needs one CUDA card and the CUDA
toolkit (nvcc). It imports nothing of JAX. With --time-calls it only builds
the library, drives the filter path and times the scan kernels and the SQPV
forward and inverse as phases 5 and 6 do (time_kernels, the profiler per
launch and inside the path), the k x k kernel on phase 8's swept
multinotch planes at k = 4, 8 and 12, the saturator's forward, backward
and gradient at 10 s stereo, the swept comb's forward and backward on
phase 8's calls at 600 s stereo, the T3 probe (with a digest of its
output) and the swept stereo delay on phase 9's calls where the package
has it; with --package DIR it takes
flan_tpu_torch from DIR, so that another commit's kernels are timed by this
script's yardstick (`git archive COMMIT flan_tpu_torch | tar -x -C
build/parent`, then --package build/parent). Phases:

  0. print the card's name and power limit; fail without a CUDA card;
  1. build the kernel library from flan_tpu_torch/csrc with nvcc (one
     process per source, all at once) and print each kernel's registers
     and spills;
  2. hold each kernel against its plain PyTorch version on the card: the
     SPV kernels over bin counts on the 16-byte and the scalar path,
     channel counts, ragged and single-frame lengths and one of 83 s; the
     SQPV kernels over bins per octave, bandwidths at 8 and 48 kHz,
     channel counts, a ragged length, odd periods, bin counts that are odd,
     a multiple of 4 and above one block's 256, and a signal shorter than
     a tile; the three scan kernels over lengths 1 to 1,000,003 (around one
     tile and around one look-back window of tiles) and 1 to 64 rows, with
     no, some and all planes shared by the rows, along the comb's middle
     axis, the three scans' backwards, and three calls on 64 rows for the
     same bits (tests/test_torch_cuda.py runs the wider grid, to 2^25 + 3);
     the T3 probe on its own inputs;
  3. drive the PV time-stretch class path at headline size (600 s stereo
     48 kHz, window 2048 / hop 128 / dft 4096, 2x) and check its output;
     time it once whole and once stage by stage;
  4. drive the SPV round trip at bench size (30 s mono 48 kHz, 512 bins)
     through the class path, which runs both kernels; then hold its SPV
     planes and each kernel against the plain versions on the same input,
     require the kernels' round-trip SNR to reach the plain one's within
     1 dB, and time each kernel against its plain version;
  5. drive the SQPV round trip and a 1.5x repitch at bench size (10 s mono
     48 kHz, 16-24000 Hz, 24 bins per octave) through the class path,
     which runs both SQPV kernels; then hold its planes and the inverse
     kernel against the plain versions on the same input, require the
     kernels' tone-fit SNR to reach the plain path's within 1 dB and the
     repitched tone to sit at 330 Hz on both paths and three calls of
     each SQPV kernel to give the same bits, and time each kernel against
     its plain version;
  6. drive the IIR filter and compressor class path at headline size
     (600 s stereo 48 kHz: a swept 2-pole lowpass, a swept 1-pole
     highpass, a constant 2-pole highpass on the FIR path, the
     compressor), twice, then once stage by stage; check its output;
     hold each scan kernel against its plain version on the planes the
     path built, the kernel's error against the float64 plain run at most
     twice the float32 plain run's, and three calls to give the same bits;
     run the path at 10 s on the card and
     on the CPU and compare; time each scan kernel and the probe against
     their plain versions;
  7. drive the streamed pipelines at headline size: the 2x stretch of
     phase 3's signal from a host array (twice), held against phase 3's
     class-path output, its length, tones and peak device memory (gated
     at the design's bound); the chunk-size sweep; kernel time per stage
     of the chunk loop and launches per chunk (torch.profiler); the 1.5x
     repitch (tones at 1.5 (f + bin width)) and a morph at 600 s, both
     held to their class forms at 60 s; then resonate and perturb on a
     60 s stereo PV: their scans' launches, each scan call against the
     float64 plain run and for the same bits, the methods on the card
     against the CPU at 2 s, the scans timed in this regime;
  8. hold the k x k scan kernel against its plain version over k = 1 (the
     linear map), 3, 4, 8, 12, 16 and 20 (the chunked kernel), lengths
     around one sub-run, one tile and past the look-back's batch of 32
     windows of tiles, 1 to 64 rows (in groups of one A), A shared and
     not, a row of 1,000,003 at k = 1, 3 and 4, three calls for the same
     bits; drive the multinotch filters at
     headline size (a swept 1-pole of order 4, k = 4; a swept 2-pole of
     order 4, k = 8; a constant 2-pole of order 2 on the FIR path, probed
     on the k x k kernel) and a swept 2-pole of order 6 (k = 12), the
     swept comb at 600 s and the saturator
     multinotch (1-pole and 2-pole, order 2) at 10 s, counted, each held
     to the CPU (at 10 s; the saturator over 2000 frames); hold the
     sequential kernels to their plain loops on the card over their first
     frames, every frame of each call to one step from the call's own
     earlier outputs (in float64), and ask three calls for the same bits;
     take the gradients through the saturators
     (their backward: a maps kernel, the k x k scan in reverse time, a
     read-out kernel, each held to its plain pass over the whole call, and
     the whole to the plain passes and, over its last frames, to the
     step-by-step loop) and the comb (its backward over its last frames
     against its loop and over every frame by one step); take the
     gradients of a swept 2-pole lowpass
     and the compressor at 10 s, and of swept 2-pole multinotch filters of
     order 4 and 6 (k = 8 and 12) at 1 s, with respect to the signal and a
     0-d cutoff on the card and the CPU (the backward's launches counted);
     drive Audio.resample 48 -> 44.1 kHz, add_moisture and convolve by a
     2 s IR at 600 s, each held to the CPU at 10 s; time the new kernels;
  9. drive the Audio effect chain at 600 s stereo 48 kHz (cut, fade,
     reverse, mono and back, the energy, repitch by 1.5 and by a swept
     factor, the stereo delays: constant, swept over 0.05-0.95 s with its
     rings in device memory, over 5-40 ms in shared memory and over a
     flanger's 0.2-0.6 ms, pan, widen, the spatialiser's moving source,
     the pinna filter, the wavelengths of one channel and the amplitude
     envelope; the host plans of repitch and the spatialiser timed), each
     held first to the CPU at 10 s; on the path's own calls, hold the
     stereo delay kernel over the first 48,000 frames to the loop step by
     step on the host and to its plain version on the card, every frame
     of each call by one step in float64, three calls for the same bits,
     and each scan kernel's calls (the constant delay's rows, the
     spatialiser's lowpass, the pinna's bandshelves) to their plain scans
     as phase 6 does; the repitched 440 Hz tone at 660 Hz;
 10. drive the PV family on phase 3's PV geometry: each call first on one
     10 s PV on the card and on the CPU (desample, smear_time,
     time_extrapolate, stretch_spline by 2 and by a ramp, modify,
     get_salience, get_contours, prism), stretch_spline also against a
     float64 dense solve of the same spline; then at 600 s stereo, counted
     (two linear scan launches a plane for each stretch_spline, one
     salience histogram), timed, its outputs finite and of the expected
     shapes, a whole get_salience call twice for the same bits;
     get_contours and prism at 30 s, counted; then on the path's own
     calls the linear scan against its float64 plain run and for the same
     bits, and the salience kernel against its plain version on the CPU
     over its first frames, over every frame against the same order on
     the card, for the same bits, timed beside its plain version and
     index_add_ + conv1d;
 11. drive the synthesis family, the granular engine, delay and the
     Wavetable at 48 kHz: each call first at 10 s on the card and on the
     CPU (psola on the card's local frequencies, the Wavetable's playback
     on the card's table); then, counted, the sine at oversample 16 at a
     constant 440 Hz and on a 220 + 2000 t / 600 Hz sweep, white noise at
     oversample 16, pink noise, synthesize_spectrum (stereo, a 2^20 table),
     granulate (stereo, 100 grains a second of 0.1 s) and texture at
     600 s, psola and a modded texture at 30 s, trainlets and delay at
     10 s, a Wavetable built from 30 s and played for 60 s (its pitch path
     launches the 2 x 2 scan, T1/T2's counterpart), each timed (wall,
     x realtime, peak memory) and finite; then on the path's own calls the
     threefry, cycle-scan and grain overlap-add kernels against their
     plain versions on the card over each whole call, bit for bit, three
     calls for the same bits, timed beside their plain versions and
     torch.rand, a float64 cumsum and index_add_.

The launch counters are zeroed just before each main path (phases 3 and 4
together, then phase 5, then phase 6, then resonate and perturb in phase 7,
then phase 8's filters, then phase 9's effect chain at full size, after its
comparisons at 10 s, then phase 10's PV family at 600 s and its contours
and prism at 30 s, after their comparisons at 10 s, then phase 11's calls,
after their comparisons at 10 s) and read just after it, before any launch
made for a comparison; the probe's counter runs over all of them (it lies
on no path). Every failed check raises, so the script exits nonzero without
printing the result line. The line before the last is one JSON object
describing the kernels (share_of_bound is bound_ms / ms; time_kernels says
what ms, ms_after_plain and ms_behind_work are); the last is the result
line.
"""
import argparse
import functools
import json
import math
import re
import subprocess
import sys
import time

import numpy as np

SR = 48000.0
GUARD_BINS = 2      # SNR guard, in units of 2*bins samples
TOL_MAG = 1e-5      # kernel vs plain, times the magnitude peak
TOL_INV = 1e-4      # kernel vs plain inverse, times the output peak
TOL_STRETCH = 2e-4  # stretch on the card vs the CPU, times the peak
SPV_SECONDS, SPV_BINS = 30.0, 512   # the SPV bench shape (mono, 48 kHz)
# phase 2 SPV cases, (bins, channels, frames): bin counts on the 16-byte
# path (multiples of 4) over two lengths (two channels at the first only:
# the plain runs on the host set this phase's time), then the smallest bin
# counts, bin counts just off a multiple of 4 (the scalar path beside the
# vector one), a single frame, lengths around one 128-frame tile, three
# channels
SPV_CASES = ([(b, c, n) for b in (16, 96, 128, 512, 1024) for c in (1, 2)
              for n in (96000, 77777) if (c, n) != (2, 77777)]
             + [(2048, 1, 96000)] +
             [(2, 1, 1), (2, 2, 300), (3, 3, 129), (510, 1, 20000),
              (514, 3, 20000), (16, 3, 127), (512, 1, 129), (128, 3, 1)])
# 83 s at 16 bins: 31,251 tiles, 123 chunks of the prefix over tiles. At
# this length float32 summation orders sit further from float64 than
# TOL_MAG: here the kernel's magnitudes read 5.65e-5 of the peak from the
# float64 plain version's and the float32 plain version's 5.53e-5, 8.2e-6
# apart (1.10e-5 apart on a tone in white noise of another seed; H100). So
# this case holds the kernel's distance from float64 to twice the plain
# one's.
SPV_LONG_CASE = (16, 1, 4_000_003)
# the SQPV bench shape (mono, 48 kHz; flan_tpu's bench.py bench_sqpv)
SQPV_SECONDS, SQPV_BAND, SQPV_BPO = 10.0, (16.0, 24000.0), 24.0
# SQPV kernel vs plain, times the peak: the readings grow with length, to
# 1.21e-5 (magnitude) and 1.00e-4 (inverse) at the bench shape (PERF.md)
TOL_SQPV_MAG = 2e-5
TOL_SQPV_INV = 2e-4
TOL_REPITCH_HZ = 2.0  # repitched 220 Hz tone, from 330 Hz (1 Hz bins)
# (sample rate, bins per octave, bandwidth, channels, frames)
SQPV_CASES = [(8000.0, 6.0, (100.0, 3000.0), 1, 16000),
              (8000.0, 12.0, (100.0, 3000.0), 2, 12345),
              (8000.0, 24.0, (100.0, 3000.0), 1, 16000),
              (48000.0, 6.0, (16.0, 24000.0), 2, 96000),
              (48000.0, 12.0, (16.0, 24000.0), 1, 77777),
              (48000.0, 24.0, (16.0, 24000.0), 2, 96000),
              # 24 bins (a multiple of 4); 59 bins (odd) and a signal
              # shorter than one 128-frame tile; 507 bins (two blocks of bins)
              (8000.0, 6.0, (100.0, 1600.0), 2, 5000),
              (8000.0, 12.0, (100.0, 3000.0), 1, 100),
              (48000.0, 48.0, (16.0, 24000.0), 1, 30000)]
# The least time of a kernel: the larger of its bytes over the card's
# memory rate and its operations over the float32 rate outside the tensor
# cores (H100 SXM data sheet). Operations per element are counted from the
# arithmetic of each plain version (the polynomial atan2 as 24, sincos as
# 20); the byte bound is the larger for all four kernels.
HBM_BYTES_PER_S = 3.35e12
NEW_KERNELS = ("scan_affine_kxk", "saturator_1pole", "saturator_2pole",
               "comb_swept", "saturator_1pole_backward_maps",
               "saturator_1pole_backward_readout",
               "saturator_2pole_backward_maps",
               "saturator_2pole_backward_readout", "comb_swept_backward")
BACKWARD_KERNELS = NEW_KERNELS[4:]
SAT_PASSES = ("maps", "readout")    # the saturator backward's own kernels
F32_OPS_PER_S = 67e12
# the scans count the sequential recurrence's arithmetic per element (an
# FMA is 2); the probe its ~50 operations per output element
OPS_PER_ELEMENT = {"spv_forward": 54, "spv_inverse": 25,
                   "sqpv_forward": 100, "sqpv_inverse": 40,
                   "scan_linear": 2, "scan_max_affine": 3,
                   "scan_affine2x2": 8, "probe": 50}
SCANS = ("scan_linear", "scan_max_affine", "scan_affine2x2")
# phase 2 scan cases, (rows, frames), with frames also given in tiles of
# the kind's T elements and look-back windows of W = 256 tiles: one
# element, around one tile, around one window, and long rows
SCAN_CASES = [(1, 1), (2, 100), (3, 4097), (1, "T-1"), (2, "T"), (3, "T+1"),
              (64, "T+1"), (1, "W-1"), (2, "W"), (5, "W+1"), (2, 1_000_003)]
# which planes one row shares with the others, in turns over the cases:
# none, the coefficients (as the filters pass them), all
SCAN_SHARING = (False, True, "all")
# rows and frames of the same-bits case of phase 2: the blocks of many rows
# wait on one look-back window at once
SCAN_MANY_ROWS = (64, 100_003)
# A scan kernel's largest error against the float64 plain run, as a share
# of its peak, may be twice the float32 plain run's. The phase-2 cases add
# this floor, for the short ones where both sit at rounding (1e-8 to 2e-7
# read there); phase 6, at full length, is held to twice alone.
SCAN_FLOOR = 1e-6
TOL_PROBE = 1e-4    # probe kernel vs plain, modulo 1 (the floor and mod 1)
FILTER_SECONDS = 600.0
FILTER_CPU_SECONDS = 10.0
TOL_FILTER_CPU = 1e-4   # the filter path, card vs CPU, times the peak
# phase 7: the streamed pipelines at 600 s; resonate and perturb on a 60 s
# PV; repitch and morph against their class forms at 60 s
STREAM_SECONDS = 600.0
ALGO_SECONDS = 60.0
# streamed vs class path on the card, times the peak. The stretch: the
# bound tests/test_torch_pipelines.py holds them to on the CPU (1.6e-7 read
# at chunks of 16 and 64 frames, 0 at 2048, and 0 at 60 s 48 kHz). Repitch
# and morph: the identity remap writes (m f) / m, an ulp off f, which the
# phase integrates; read on the CPU at 60 s 48 kHz: 6.8e-4 and 2.2e-4
TOL_STREAM_CLASS = 1e-5
TOL_IDENTITY_CLASS = 2e-3
# float32 [n_in, channels, chunk, bins] planes the streamed chunk loop may
# hold at once beyond its input and output (the design's bound; the
# complex spectra count twice, the float64 cycles twice)
STREAM_CHUNK_PLANES = 48
STREAM_CHUNK_SWEEP = (256, 512, 1024, 2048, 4096, 8192)
RESONATE_SECONDS = 0.5


def RESONATE_DECAY(t, f):
    """Per-bin decay, 0.95 at 0 Hz to 0.19 at 24 kHz, for phase 7."""
    return 0.05 + 0.9 / (1.0 + f / 4000.0)


PERTURB_STD = (0.05, 0.5)   # magnitude and frequency std of phase 7
# resonate and perturb on the card vs the CPU at 2 s, times the peak; and
# the share of resonate's frequency cells that may follow another frame
TOL_ALGO_CPU = 1e-4
TOL_RESONATE_CELLS = 1e-3


# phase 8: the k x k scan's cases, (rows, frames, A shared by the rows):
# one element, around one sub-run ("R") and one tile ("T") of the chunked
# kernel (the one pass's tile at k = 1), past the 32 windows of tiles ("B")
# its look-back reads at a time (the one pass's look-back window at k = 1)
# on 2 rows, 64 rows in groups of one A; and a long row at the k of
# KXK_LONG_ROW_KS, where its float32 and float64 plain runs take seconds
KXK_KS = (1, 3, 4, 5, 8, 12, 16, 20)
KXK_CASES = [(1, 1, True), (2, "R+1", True), (8, "T+1", False),
             (2, "B+1", True), (64, "T-1", True)]
KXK_LONG_ROW, KXK_LONG_ROW_KS = (1, 1_000_003, True), (1, 3, 4)
MULTINOTCH_SECONDS = 600.0
# the multinotch filters on the card vs the CPU: 3 s, past a look-back
# window of tiles at k = 4 (131,072 frames) and k = 8 (65,536), where the
# CPU's float32 plain scan of the k = 8 map takes seconds a second
MULTINOTCH_CPU_SECONDS = 3.0
# a 2-pole multinotch of order 6 (k = 12) at 600 s: one call; its k x k
# call then timed on the call's own planes
KXK12_ORDER = 6
# gradients through swept 2-pole multinotch filters of these orders (k = 8
# and 12), card vs CPU, at this length (the CPU's plain k x k scan over
# k*k + k leaves takes seconds a second)
MULTINOTCH_GRAD_ORDERS = (4, 6)
MULTINOTCH_GRAD_SECONDS = 1.0
SEQ_PLAIN_FRAMES = 2000     # the saturator's plain loop on the card, frames
COMB_PLAIN_SECONDS = 1.0    # the swept comb's plain loop on the card
SAT_SECONDS = 10.0          # the saturator at headline width: 480,000
# dependent steps a channel, so 10 s, where 600 s would be 28.8 M
# the backwards' plain loops on the card, over the last frames of the
# path's call (the adjoint runs in reverse time: the last frames need
# nothing before them); and the saturator's gradient, card vs CPU, over a
# short signal (the CPU's plain loops take ~4 ms a step forward and back)
SEQ_BACK_PLAIN_FRAMES = 400
SAT_GRAD_CPU_FRAMES = 500
# saturator kernel vs its plain loop on the card, times the peak: tanhf and
# fused multiply-adds against torch's float32 ops, damped by the Newton
# solve (the card tests' bound); the comb's step is the same arithmetic in
# both, to fused multiply-adds
TOL_SATURATOR = 1e-5
TOL_COMB = 1e-6
# the backward kernels vs their plain loops on the card, times each
# gradient's peak: the saturator's adjoint divides by Newton's
# denominators (float32 in two orders, the card tests' bound); the comb's
# sums the adjoints sent to one sample in another order
TOL_SATURATOR_BACK = 1e-4
TOL_COMB_BACK = 1e-5
# card vs CPU at 10 s, times the peak: add_moisture's sine takes 2 pi f
# |s|^skew cycles (up to ~190 here), where an ulp of the power turns the
# phase by ~1e-4 rad (tests/test_torch_resample.py)
TOL_MOISTURE_CPU = 1e-3
# gradients on the card vs the CPU: float32 scans in two orders, forward
# and adjoint. The lowpass's gradient is smooth: its largest difference,
# over its peak. Through the compressor the gradient jumps where the peak
# detector's max changes branch, and the two devices' forward scans (the
# CPU's plain one 18x further from float64 than the card's, phase 6) put
# a near-tie on two sides at a few dozen of 960,000 samples: 61 read at 10
# s, with the L2 norm of the difference 5.3e-3 of the gradient's and the
# cutoff's gradient 1.4e-3 apart (H100). Those are held by L2 and by the
# parameter's gradient, at about 4 and 7 times the reading.
TOL_GRAD_CPU = 1e-3
TOL_GRAD_SWITCH_L2 = 2e-2
TOL_GRAD_SWITCH_PARAM = 1e-2
IR_SECONDS = 2.0
# The sequential forwards' least time is their chain of dependent steps:
# steps (a channel's; channels run side by side) times the cycles a step
# needs at the SM's clock. The saturator's at order 2 is counted in its
# compiled code (cuobjdump -sass of saturator_forward<false, 2> and <true,
# 2>, H100): 8 Newton iterations of 23 dependent instructions (tanhf's
# MUFU.EX2 and MUFU.RCP and their selects, the guard's compare and select,
# the division's MUFU.RCP and five FMAs) and a tail of 11 (1-pole) or 17
# (2-pole: 7 a stage) through the cascade and the mix to the next step,
# each at the 4 cycles of a dependent FP32 instruction, the least any of
# them takes (the MUFU ones take longer), so a floor. The compiled chain
# alone, the forward without its loads and shuffles (spv_variants
# forward_chain_only), reads within 2% of the kernel. The comb's least
# time is its depth in the loop's order: step n reads u[n - d[n]], so at
# most the d steps from n on can run at once, and any schedule that keeps
# each step's operations needs about sum(1 / d) rounds over the call's
# own delays (the rounds of d steps a greedy schedule takes), each the
# latency of one dependent step: a ring read, the step's FMAs, a ring
# write and a barrier. Measured as the chain alone (spv_variants --source
# comb, chain_only_idle_producers: rounds of 32 steps with no round
# starts, inputs or outputs read or written and the producer warps idle;
# H100 80GB HBM3, 700 W, the SM at 1,980 MHz): 54.2-55.2 cycles a round
# forward, 91.8-92.5 backward (the forward's, with two more dependent
# float operations and the add into the slot sent to)
SAT_CHAIN_CYCLES = {False: 4 * (8 * 23 + 11), True: 4 * (8 * 23 + 17)}
COMB_STEP_CYCLES = 55
COMB_BACK_STEP_CYCLES = 92
# The swept stereo delay's the same way: its depth in the loop's order
# (stereo_delay_depth) times one dependent step measured alone (H100 80GB
# HBM3, 700 W, the SM at 1,980 MHz): spv_variants --source stereo_delay,
# chain_only, the narrow kernels' round loops rewritten as one warp on
# rounds of 32 steps, each reading the round before from rings in shared
# memory, the inputs register constants and the producer warps idle. Left
# on the forward's chain: the two ring reads, the steps' multiplies and
# adds, the ring writes and a warp barrier, 56.3-56.7 cycles a round; on
# the backward's: the sums read, the two adds and multiplies, the slots
# zeroed, the sends' adds into their slots and a warp barrier, 70.5-71.1
STEREO_DELAY_STEP_CYCLES = 56
STEREO_DELAY_BACK_STEP_CYCLES = 71
# Operations of one saturator step at order 2, counted from the source's
# arithmetic (a tanhf as 10, a division as 9, an FMA as 2): the rerun
# (the forward's step) and one adjoint (the backward's read-out; the maps
# take one a state and one for the output)
SAT_STEP_OPS = {False: 302, True: 319}
# phase 9: the effect chain at 600 s stereo 48 kHz, each call held to the
# CPU at FILTER_CPU_SECONDS
EFFECT_SECONDS = 600.0
DELAY_PLAIN_FRAMES = 48_000     # the stereo delay's plain loop on the card
# the stereo delay kernels against their plain loops and by one step, times
# the peak: the same float32 operations a step (no fused multiply-add),
# the sends to a slot in the same order
TOL_DELAY = 1e-6
TOL_DELAY_BACK = 1e-5
# card wavelengths against the CPU's: a hop is equal within 1e-3 of its
# wavelength (d''s float32 sums move a valley's vertex); a hop whose valley
# choice flips is counted, and at most this share of hops may flip
WAVELENGTH_REL = 1e-3
WAVELENGTH_FLIPS = 0.005
SAT_ADJOINT_OPS = {False: 521, True: 542}
# phase 10: the PV family (pv/modify_extra.py, pv/information.py) on phase
# 3's PV geometry (48 kHz stereo, window 2048, hop 128, dft 4096) at 600 s,
# each call first held to the CPU on one 10 s PV; get_contours and prism at
# 30 s, where their greedy loops (host Python over frames and contours, by
# the reference's design) take seconds a channel
PV_FAMILY_SECONDS = 600.0
PV_FAMILY_CPU_SECONDS = 10.0
CONTOUR_SECONDS = 30.0
# the card against the CPU on the same 10 s PV, times each plane's peak:
# the same float32 operations in the same order on both devices (0 read
# where nothing else differs), but the spline's two scans (the kernel's
# look-back against the plain doubling scan); and the salience (peak 1)
# and what is built on it, where torch's sin of the amplitude correction
# differs by an ulp between the devices (1.9e-7 read on the same peaks)
TOL_PV_CPU = 1e-5
TOL_SALIENCE_CPU = 1e-5
# a contour's pitch, in 10-cent bins: each frame's parabolic vertex through
# its salience peak and two neighbours, which turns their ulps into more
# where the peak is flat
TOL_PITCH_BINS = 1e-2
# the salience kernel against its plain version on the CPU over the path
# call's first frames (the plain version's [F, K, 20] planes at 600 s take
# tens of GB); over every frame it is held to the same order on the card
SALIENCE_PLAIN_FRAMES = 8192
# modify's chunks of quads timed at 600 s, with their peak memory
MODIFY_CHUNK_SWEEP = (1 << 21, 1 << 23, 1 << 25)
# frames of the library call's operands built at a time
SALIENCE_LIBRARY_CHUNK = 16384
# the scan kernel's rows held to its float64 plain run on stretch_spline's
# own call (every row is its own recurrence)
SPLINE_SCAN_ROWS = 64


def fail(msg: str):
    raise SystemExit(f"chip_smoke: FAIL: {msg}")


def check(cond, msg: str):
    if not cond:
        fail(msg)


def card_line() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=60)
    except FileNotFoundError:
        fail("nvidia-smi not found")
    if out.returncode != 0:
        fail(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


@functools.lru_cache(maxsize=None)
def stereo_signal(seconds: float, seed: int = 0,
                  sr: float = SR) -> np.ndarray:
    """0.4-amplitude sines at 220 and 330 Hz plus 0.1 white noise, from a
    seed (the JAX package's bench signal). Kept per argument set: phases 3
    and 6 take the same 600 s, seconds of host time to make; callers only
    read it."""
    n = int(seconds * sr)
    rng = np.random.default_rng(seed)
    t = np.arange(n, dtype=np.float32) / np.float32(sr)
    return np.stack([
        0.4 * np.sin(2 * np.pi * 220.0 * t) + 0.1 * rng.standard_normal(n),
        0.4 * np.sin(2 * np.pi * 330.0 * t) + 0.1 * rng.standard_normal(n),
    ]).astype(np.float32)


def aligned_snr_db(x: np.ndarray, y: np.ndarray, guard: int) -> float:
    """SNR of y against x after aligning by cross-correlation of the first
    4096 samples (the SPV synthesis has a group delay)."""
    xa, ya = x[guard:-guard].astype(np.float64), y[guard:-guard]
    n2 = 1 << 12
    xc = np.fft.irfft(np.fft.rfft(xa, n2).conj() * np.fft.rfft(ya, n2), n2)
    lag = int(np.argmax(xc))
    if lag > n2 // 2:
        lag -= n2
    if lag >= 0:
        xa2, ya2 = xa[:len(xa) - lag], ya[lag:lag + len(xa)]
    else:
        xa2, ya2 = xa[-lag:], ya[:len(xa) + lag]
    m = min(len(xa2), len(ya2))
    err = ((xa2[:m] - ya2[:m]) ** 2).mean()
    return float(10 * np.log10((xa2[:m] ** 2).mean() / max(err, 1e-30)))


def dominant_hz(x: np.ndarray) -> float:
    spec = np.abs(np.fft.rfft(x * np.hanning(len(x))))
    return float(np.argmax(spec) * SR / len(x))


def cuda_ms(torch, fn, reps: int) -> float:
    """Mean milliseconds per call of fn on the card, by CUDA events."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def live_rms(a, ref, live, step: int = 1 << 16, period=None) -> float:
    """RMS of a - ref in float64 over the bins where live holds, taken in
    chunks of frames so the temporaries stay small at bench size. With a
    period, each difference is first wrapped into [-period/2, period/2]."""
    total, count = 0.0, 0
    for t0 in range(0, a.shape[1], step):
        part = live[:, t0:t0 + step]
        d = (a[:, t0:t0 + step][part].double()
             - ref[:, t0:t0 + step][part].double())
        if period is not None:
            d = d - period * (d / period).round()
        total += float(d.pow(2).sum())
        count += int(part.sum())
    return math.sqrt(total / max(count, 1))


def forward_errors(mag, freq, ref_m, ref_f, m64, f64, period=None) -> dict:
    """The kernel's forward planes against the float32 plain version
    (magnitude, max abs) and the float64 one (frequency, RMS over bins
    above 1e-3 of the peak, beside the float32 plain version's own)."""
    scale = float(ref_m.abs().max())
    live = m64 > 1e-3 * scale
    return {"mag_err": float((mag - ref_m).abs().max()), "scale": scale,
            "drift_k": live_rms(freq, f64, live, period=period),
            "drift_p": live_rms(ref_f, f64, live, period=period)}


def check_forward(e: dict, tol_mag, case: str) -> None:
    """The magnitude against the float32 plain version (unless tol_mag is
    None: the caller holds it another way) and the frequency drift."""
    check(math.isfinite(e["mag_err"]) and (
        tol_mag is None or e["mag_err"] < tol_mag * e["scale"]),
          f"forward mag, {case}: {e['mag_err']} vs peak {e['scale']}")
    check(e["drift_k"] <= 2.0 * e["drift_p"] + 1e-4,
          f"forward freq, {case}: RMS drift kernel {e['drift_k']} Hz, "
          f"plain {e['drift_p']} Hz")


def phase2_kernel_vs_plain(torch, spv_kernels, dev):
    """Each kernel against its plain version on the same CUDA tensors.

    Magnitude and inverse are held to the plain float32 version with the
    tolerances of the CPU tests. The forward's frequencies are not: its
    running sum is float32 in both, associated differently, and on weak
    bins at 48 kHz two float32 orders differ by up to ~100 Hz after 2 s
    (PERF.md), while the 0.1 Hz of the CPU tests holds at 8 kHz and
    2000 samples. So the kernel's frequency error against the float64 plain
    version, RMS over bins above 1e-3 of the peak, may be at most twice the
    float32 plain version's own."""
    worst = {"spv_forward": 0.0, "spv_inverse": 0.0}
    long_x = stereo_signal(SPV_LONG_CASE[2] / SR + 1.0, seed=1)
    x_all = torch.from_numpy(np.concatenate([long_x, long_x[:1] * 0.25])).to(
        dev)
    for nbins, ch, n in SPV_CASES + [SPV_LONG_CASE]:
        x = x_all[:ch, :n].contiguous()
        mag, freq = spv_kernels.spv_forward(x, nbins, SR)
        ref_m, ref_f = spv_kernels.spv_forward_ref(x, nbins, SR)
        m64, f64 = spv_kernels.spv_forward_ref(x.double(), nbins, SR)
        out = spv_kernels.spv_inverse(ref_m, ref_f, SR)
        ref_out = spv_kernels.spv_inverse_ref(ref_m, ref_f, SR)
        torch.cuda.synchronize()
        e = forward_errors(mag, freq, ref_m, ref_f, m64, f64)
        live = m64 > 1e-3 * e["scale"]
        peak = float(ref_out.abs().max())
        err_o = float((out - ref_out).abs().max())
        # both float32 magnitudes against the float64 plain version
        mag_k64, mag_p64 = (float((m.double() - m64).abs().max())
                            for m in (mag, ref_m))
        print(json.dumps({
            "phase": 2, "bins": nbins, "channels": ch, "frames": n,
            "mag_err_rel": e["mag_err"] / e["scale"],
            "mag_err_rel_f64_kernel": mag_k64 / e["scale"],
            "mag_err_rel_f64_plain": mag_p64 / e["scale"],
            "freq_err_hz_max": (float((freq - ref_f)[live].abs().max())
                                if bool(live.any()) else 0.0),
            "freq_drift_hz_rms_kernel": e["drift_k"],
            "freq_drift_hz_rms_plain": e["drift_p"],
            "inv_err_rel": err_o / max(peak, 1e-30)}), flush=True)
        case = f"B={nbins} C={ch} N={n}"
        if (nbins, ch, n) == SPV_LONG_CASE:
            check(mag_k64 <= 2.0 * mag_p64,
                  f"forward mag, {case}: {mag_k64} from float64, plain "
                  f"{mag_p64}, peak {e['scale']}")
            check_forward(e, None, case)
        else:
            check_forward(e, TOL_MAG, case)
        check(math.isfinite(err_o) and err_o < TOL_INV * peak,
              f"inverse, {case}: {err_o} vs peak {peak}")
        worst["spv_forward"] = max(worst["spv_forward"], e["mag_err"])
        worst["spv_inverse"] = max(worst["spv_inverse"], err_o)
        del mag, freq, ref_m, ref_f, m64, f64, out, ref_out, live
    return worst


def decoded_hz(torch, pitch, positive):
    """The signed frequency +-2^pitch of SQPV planes, in float64."""
    return torch.where(positive, 1.0, -1.0).double() * torch.exp2(
        pitch.double())


def sqpv_errors(torch, planes, ref, ref64, sample_rate: float) -> dict:
    """The SQPV forward kernel's planes against the float32 plain version
    (magnitude) and the decoded frequency against the float64 one, as
    forward_errors does for the SPV, modulo the sample rate: the phase
    difference is wrapped to [-pi, pi], so on a noise bin whose advance
    sits within rounding of pi two float32 orders can land sr apart. Those
    two frequencies give the inverse the same cycle increment, frac(f/sr);
    unwrapped, one such frame out of 12 M moved the RMS from 0.2 to 14 Hz
    (48 kHz, 6 bins per octave, 2 s stereo; H100)."""
    return forward_errors(planes[0], decoded_hz(torch, *planes[1:]), ref[0],
                          decoded_hz(torch, *ref[1:]), ref64[0],
                          decoded_hz(torch, *ref64[1:]), period=sample_rate)


def phase2_sqpv(torch, sqpv_kernels, cq_geometry, dev):
    """The SQPV kernels against their plain versions on the same CUDA
    tensors, with the SPV checks: magnitude against the peak, decoded
    frequency drift against float64 at most twice the plain version's, and
    the inverse kernel on the plain planes against the plain inverse."""
    worst = {"sqpv_forward": 0.0, "sqpv_inverse": 0.0}
    odd = False
    for sr, bpo, band, ch, n in SQPV_CASES:
        odd |= bool((cq_geometry(sr, bpo, band).periods % 2 == 1).any())
        x = torch.from_numpy(stereo_signal(2.0, seed=1, sr=sr)[:ch, :n]).to(
            dev).contiguous()
        planes = sqpv_kernels.sqpv_forward_cuda(x, sr, bpo, band)
        ref = sqpv_kernels.sqpv_forward_ref(x, sr, bpo, band)
        ref64 = sqpv_kernels.sqpv_forward_ref(x.double(), sr, bpo, band)
        out = sqpv_kernels.sqpv_inverse_cuda(*ref, sr, bpo, band)
        ref_out = sqpv_kernels.sqpv_inverse_ref(*ref, sr, bpo, band)
        torch.cuda.synchronize()
        e = sqpv_errors(torch, planes, ref, ref64, sr)
        peak = float(ref_out.abs().max())
        err_o = float((out - ref_out).abs().max())
        print(json.dumps({
            "phase": 2, "kernels": "sqpv", "sample_rate": sr,
            "bins_per_octave": bpo, "band": band, "bins": ref[0].shape[2],
            "channels": ch, "frames": n,
            "mag_err_rel": e["mag_err"] / e["scale"],
            "freq_drift_hz_rms_kernel": e["drift_k"],
            "freq_drift_hz_rms_plain": e["drift_p"],
            "sign_mismatches": int((planes[2] != ref[2]).sum()),
            "inv_err_rel": err_o / peak}), flush=True)
        case = f"SQPV sr={sr} bpo={bpo} band={band} C={ch} N={n}"
        check_forward(e, TOL_SQPV_MAG, case)
        check(math.isfinite(err_o) and err_o < TOL_SQPV_INV * peak,
              f"inverse, {case}: {err_o} vs peak {peak}")
        worst["sqpv_forward"] = max(worst["sqpv_forward"], e["mag_err"])
        worst["sqpv_inverse"] = max(worst["sqpv_inverse"], err_o)
        del planes, ref, ref64, out, ref_out
    check(odd, "no SQPV case has an odd period: the quirk went untested")
    return worst


def scan_planes(kind: str, ch: int, n: int, seed: int, shared):
    """Float32 planes and start states of one scan kind, from a seed: decay
    factors spread from 0.5 to 0.99999; with `shared`, the coefficient
    planes are one row for all channels, as the filters pass them; with
    "all", every plane is (the caller expands them to ch rows, and the
    rows differ by their start states alone)."""
    rng = np.random.default_rng(seed)
    rows = 1 if shared else ch
    own = 1 if shared == "all" else ch
    a = rng.uniform(0.5, 0.99999, (rows, n))
    if kind == "scan_linear":
        planes = (a, rng.standard_normal((own, n)))
    elif kind == "scan_max_affine":
        m = rng.standard_normal((own, n))
        planes = (m, a, (1.0 - a) * m)
    else:
        th = rng.uniform(0.0, 0.2, (rows, n))
        planes = (a * np.cos(th), -a * np.sin(th), a * np.sin(th),
                  a * np.cos(th), rng.standard_normal((own, n)),
                  rng.standard_normal((own, n)))
    states = 2 if kind == "scan_affine2x2" else 1
    y0 = rng.standard_normal((states, ch, 1))
    return [np.asarray(p, np.float32) for p in planes] + list(
        y0.astype(np.float32))


def scan_frames(n, tile: int, window: int) -> int:
    """A phase-2 case's frames: a number, or "T", "W" (window * tile)
    with an offset."""
    if isinstance(n, int):
        return n
    return {"T": tile, "W": window * tile}[n[0]] + int(n[1:] or 0)


def scan_calls(scan_kernels):
    """name -> (kernel, plain version), both taking (*planes, *y0s)."""
    return {"scan_linear": (scan_kernels.scan_linear,
                            scan_kernels.linear_ref),
            "scan_max_affine": (scan_kernels.scan_max_affine,
                                scan_kernels.max_affine_ref),
            "scan_affine2x2": (scan_kernels.scan_affine2x2,
                               scan_kernels.affine2x2_ref)}


def scan_errors(torch, kernel, plain, args) -> dict:
    """One scan kernel against its plain version on the same float32
    arguments: the largest errors of the kernel and of the float32 plain
    run against the float64 plain run, as shares of its peak, and the
    kernel's largest absolute difference from the float32 plain run."""
    def stacked(y):
        return torch.stack(y) if isinstance(y, tuple) else y
    k = stacked(kernel(*args))
    p32 = stacked(plain(*args))
    p64 = stacked(plain(*(a.double() for a in args)))
    torch.cuda.synchronize()
    peak = float(p64.abs().max())
    return {"err_kernel": float((k.double() - p64).abs().max()) / peak,
            "err_plain": float((p32.double() - p64).abs().max()) / peak,
            "abs_err": float((k - p32).abs().max()), "peak": peak,
            "finite": bool(torch.isfinite(k).all())}


def check_same_bits(torch, call, case: str) -> None:
    """Three calls of a kernel on the same tensors give the same bits: the
    kernels fix their order of summation, as the JAX package's do."""
    def flat(y):
        return y if isinstance(y, tuple) else (y,)
    first = flat(call())
    for _ in range(2):
        again = flat(call())
        torch.cuda.synchronize()
        check(all(torch.equal(a, b) for a, b in zip(first, again)),
              f"{case}: two calls on the same input differ")


def check_scan(e: dict, case: str, floor: float) -> None:
    check(e["finite"] and e["err_kernel"] <= 2.0 * e["err_plain"] + floor,
          f"{case}: kernel error {e['err_kernel']} of the peak against "
          f"float64, plain {e['err_plain']}")


def scan_args(torch, name: str, ch: int, n: int, seed: int, shared, dev):
    """scan_planes on the card; with "all", one row of every plane expanded
    to ch rows, beside ch start states."""
    args = [torch.from_numpy(a).to(dev) for a in
            scan_planes(name, ch, n, seed=seed, shared=shared)]
    if shared == "all":
        args = [a.expand(ch, n) if a.shape[-1] == n else a for a in args]
    return args


def phase2_scans(torch, lib, scan_kernels, scan, dev):
    """The three scan kernels against their plain versions over lengths and
    row counts (no, the coefficient and all planes shared, in turns), three
    calls on many rows for the same bits, the comb's middle axis, and the
    linear backward against autograd through the plain version. lib is the
    kernel library, which names each kind's tile and the window. Returns
    each kernel's largest absolute error."""
    worst = {name: 0.0 for name in SCANS}
    for kind, (name, (kernel, plain)) in enumerate(
            scan_calls(scan_kernels).items()):
        for i, (ch, frames) in enumerate(SCAN_CASES):
            n = scan_frames(frames, lib.flan_scan_tile(kind),
                            lib.flan_scan_window_tiles())
            shared = SCAN_SHARING[i % 3]
            args = scan_args(torch, name, ch, n, i, shared, dev)
            e = scan_errors(torch, kernel, plain, args)
            print(json.dumps({"phase": 2, "kernel": name, "channels": ch,
                              "frames": n, "shared": shared, **e}),
                  flush=True)
            check_scan(e, f"{name} C={ch} N={n} shared={shared}", SCAN_FLOOR)
            worst[name] = max(worst[name], e["abs_err"])
            del args
        args = scan_args(torch, name, *SCAN_MANY_ROWS, 0, "all", dev)
        check_same_bits(torch, lambda: kernel(*args),
                        f"{name} on {SCAN_MANY_ROWS[0]} rows")
    rng = np.random.default_rng(7)
    a, b = (torch.from_numpy(v.astype(np.float32)).to(dev) for v in (
        rng.uniform(0.5, 0.999, (2, 100001, 24)),
        rng.standard_normal((2, 100001, 24))))
    args = [a.movedim(1, -1), b.movedim(1, -1), torch.zeros((2, 24, 1),
                                                            device=dev)]
    got = scan.linear_recurrence(a, b, axis=1).movedim(1, -1)
    e = scan_errors(torch, lambda *_: got, scan_kernels.linear_ref, args)
    print(json.dumps({"phase": 2, "kernel": "scan_linear",
                      "case": "comb axis 1 of [2, 100001, 24]", **e}),
          flush=True)
    check_scan(e, "scan_linear along axis 1", SCAN_FLOOR)
    # the backward: the reversed recurrence through the same kernel
    a0 = rng.uniform(0.9, 0.999, (2, 200000)).astype(np.float32)
    b0 = (rng.standard_normal((2, 200000)) * 0.1).astype(np.float32)
    grads = []
    for fn in (scan.linear_recurrence, scan_kernels.linear_ref):
        a, b = (torch.from_numpy(v).to(dev).requires_grad_() for v in (a0, b0))
        y0 = torch.tensor([[0.1], [-0.2]], device=dev, requires_grad=True)
        y = fn(a, b, y0)
        grads.append(torch.autograd.grad((y * y).sum(), (a, b, y0)))
    err = max(float((g - w).abs().max() / w.abs().max())
              for g, w in zip(*grads))
    print(json.dumps({"phase": 2, "kernel": "scan_linear",
                      "case": "backward [2, 200000]",
                      "grad_err_rel": err}), flush=True)
    # tests/test_pallas_scan.py's tolerance for T1/T2's gradient
    check(err < 1e-3, f"linear scan backward: {err} of the peak")
    # the other maps' backwards: the adjoint recurrences on the kernels
    # against autograd through the plain versions on the card
    m0 = rng.standard_normal((2, 200000)).astype(np.float32)
    for name, run in (
            ("scan_max_affine", lambda fn, a, b: fn(b, a, (1.0 - a) * b)),
            ("scan_affine2x2", lambda fn, a, b: torch.stack(fn(
                0.9 * a, 0.05 * a, -0.05 * a, 0.8 * a, b, -b)))):
        plain = {"scan_max_affine":
                 lambda m, a, c: scan_kernels.max_affine_ref(m, a, c, 0.0),
                 "scan_affine2x2": lambda *p: scan_kernels.affine2x2_ref(
                     *p, 0.0, 0.0)}[name]
        custom = {"scan_max_affine": scan.max_affine_recurrence,
                  "scan_affine2x2": scan.affine2x2_recurrence}[name]
        grads = []
        for fn in (custom, plain):
            a, b = (torch.from_numpy(v).to(dev).requires_grad_()
                    for v in (a0, m0))
            y = run(fn, a, b)
            grads.append(torch.autograd.grad((y * y).sum(), (a, b)))
        err = max(float((g - w).abs().max() / w.abs().max())
                  for g, w in zip(*grads))
        print(json.dumps({"phase": 2, "kernel": name,
                          "case": "backward [2, 200000]",
                          "grad_err_rel": err}), flush=True)
        check(err < 1e-3, f"{name} backward: {err} of the peak")
    return worst


def phase2_probe(torch, probe_kernels, dev) -> float:
    """T3 against its plain version on main's inputs: equal modulo 1 (the
    floor and mod 1 jump where rounding crosses an integer), and the
    carried rows equal outright. Returns the largest distance modulo 1."""
    x, w = (torch.from_numpy(a).to(dev) for a in probe_kernels.probe_inputs())
    d = (probe_kernels.probe_cuda(x, w) - probe_kernels.probe_ref(x, w))
    d = d.double()
    err = float((d - d.round()).abs().max())
    err_carry = float(d[:, -1].abs().max())
    print(json.dumps({"phase": 2, "kernel": "probe", "err_mod1": err,
                      "err_carried_rows": err_carry}), flush=True)
    check(err < TOL_PROBE and err_carry < TOL_PROBE,
          f"probe kernel vs plain: {err} modulo 1, {err_carry} carried")
    return err


def timed(torch, fn):
    """fn() and its wall milliseconds, synchronised on the card."""
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def phase3_stretch(torch, Audio, dev):
    """PV time-stretch class path: on a small input against the same path
    on the CPU, then at headline size, whole and stage by stage. Returns
    the headline output (host) and the whole call's wall seconds."""
    hop = 128

    # the size the CPU tests hold the port to the JAX package at
    small = stereo_signal(0.75, seed=2, sr=8000.0)
    want, got = (Audio.create_from_array(small, 8000.0, device=d)
                 .convert_to_PV(512, 64, 512).stretch(2.0)
                 .convert_to_audio().to_numpy() for d in ("cpu", dev))
    err = float(np.abs(got - want).max() / np.abs(want).max())
    print(json.dumps({"phase": 3, "path": "stretch_vs_cpu",
                      "stretch_8k_err_rel": err}), flush=True)
    check(got.shape == want.shape and err < TOL_STRETCH,
          f"stretch on the card vs the CPU: {got.shape} {err}")

    seconds = 600.0
    x = stereo_signal(seconds)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    out, wall_ms = timed(torch, lambda: (
        Audio.create_from_array(x, SR, device=dev)
        .convert_to_PV(2048, hop, 4096).stretch(2.0).convert_to_audio()))
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    y = out.to_numpy()
    del out
    # the same path again, synchronised after each stage
    a, ms_h2d = timed(torch, lambda: Audio.create_from_array(x, SR,
                                                             device=dev))
    pv, ms_fwd = timed(torch, lambda: a.convert_to_PV(2048, hop, 4096))
    pv2, ms_str = timed(torch, lambda: pv.stretch(2.0))
    del pv
    _, ms_inv = timed(torch, pv2.convert_to_audio)
    del a, pv2, _
    n_in = x.shape[1]
    print(json.dumps({"phase": 3, "path": "stretch_2x_600s_stereo_48k",
                      "wall_s": wall_ms / 1e3,
                      "x_realtime": seconds / (wall_ms / 1e3),
                      "peak_alloc_gb": peak_gb, "in_frames": n_in,
                      "out_frames": int(y.shape[1]),
                      "stages_ms": {"host_to_device": ms_h2d,
                                    "pv_forward": ms_fwd, "stretch": ms_str,
                                    "pv_inverse": ms_inv}}), flush=True)
    # the stretch maps num_hops = N//hop + 1 frames to twice as many, so
    # the output is 2N plus up to two hops
    check(y.shape == (2, y.shape[1]) and abs(y.shape[1] - 2 * n_in)
          <= 2 * hop, f"stretch output shape {y.shape} for {n_in} frames")
    check(bool(np.isfinite(y).all()), "stretch output not finite")
    mid = y.shape[1] // 2
    for ch, want in ((0, 220.0), (1, 330.0)):
        got = dominant_hz(y[ch, mid:mid + int(SR)])
        check(abs(got - want) <= 2.0,
              f"stretch channel {ch}: dominant {got} Hz, want {want}")
    return y, wall_ms / 1e3


def phase4_spv(torch, Audio, dev):
    """SPV round trip at bench size through the class path, which runs
    both kernels. Returns the input on the card, the SPV, the output
    audio and the wall seconds."""
    x = stereo_signal(SPV_SECONDS)[:1]
    a = Audio.create_from_array(x, SR, device=dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    spv = a.convert_to_SPV(SPV_BINS)
    y = spv.convert_to_audio().data
    torch.cuda.synchronize()
    return a.data, spv, y, time.perf_counter() - t0


def phase4_check(torch, spv_kernels, x, spv, y, wall_k):
    """The main path's SPV planes, and the inverse kernel, against the plain
    versions on the same input at the bench shape; then the round-trip SNR
    of both paths against the source. Returns the plain planes and the
    kernels' largest absolute errors."""
    t0 = time.perf_counter()
    m, f = spv_kernels.spv_forward_ref(x, SPV_BINS, SR)
    y_ref = spv_kernels.spv_inverse_ref(m, f, SR)
    torch.cuda.synchronize()
    wall_p = time.perf_counter() - t0
    m64, f64 = spv_kernels.spv_forward_ref(x.double(), SPV_BINS, SR)
    e = forward_errors(spv.mag, spv.freq, m, f, m64, f64)
    del m64, f64
    out = spv_kernels.spv_inverse(m, f, SR)
    torch.cuda.synchronize()
    peak = float(y_ref.abs().max())
    err_o = float((out - y_ref).abs().max())
    guard = GUARD_BINS * 2 * SPV_BINS
    x_np = x.cpu().numpy()[0]
    y_np, y_ref_np = y.cpu().numpy()[0], y_ref.cpu().numpy()[0]
    check(bool(np.isfinite(y_np).all()), "SPV round trip not finite")
    snr_k = aligned_snr_db(x_np, y_np, guard)
    snr_p = aligned_snr_db(x_np, y_ref_np, guard)
    print(json.dumps({"phase": 4, "path": "spv_roundtrip_30s_mono_48k_512",
                      "wall_s_kernels": wall_k, "wall_s_plain": wall_p,
                      "x_realtime_kernels": SPV_SECONDS / wall_k,
                      "x_realtime_plain": SPV_SECONDS / wall_p,
                      "mag_err_rel": e["mag_err"] / e["scale"],
                      "freq_drift_hz_rms_kernel": e["drift_k"],
                      "freq_drift_hz_rms_plain": e["drift_p"],
                      "inv_err_rel": err_o / peak,
                      "snr_db_kernels": snr_k, "snr_db_plain": snr_p}),
          flush=True)
    check_forward(e, TOL_MAG, "bench shape")
    check(math.isfinite(err_o) and err_o < TOL_INV * peak,
          f"inverse, bench shape: {err_o} vs peak {peak}")
    # one-sided, as tests/test_spv_pallas.py holds the fused TPU kernels to
    # the scan path: the kernels must reach the plain path's round-trip
    # quality (the absolute SNR is the representation's floor)
    check(snr_k >= snr_p - 1.0,
          f"SPV SNR kernels {snr_k} dB vs plain {snr_p} dB")
    check(snr_k > 10.0, f"SPV SNR {snr_k} dB")
    return m, f, {"spv_forward": e["mag_err"], "spv_inverse": err_o}


KERNEL_REPS = 10    # launches per timed turn of a kernel
FILLER_FLOATS = 1 << 26     # 256 MB: five times the card's L2


def behind_work_ms(torch, fn, filler, reps: int = 5) -> float:
    """Median milliseconds of one call of fn that is queued behind other
    work: four passes over `filler` keep the card busy while the host
    prepares the call, and leave nothing of the call's inputs in L2."""
    readings = []
    for _ in range(reps):
        for _ in range(4):
            filler.mul_(1.0)
        readings.append(cuda_ms(torch, fn, 1))
    return float(np.median(readings))


def time_kernels(torch, pairs: dict) -> dict:
    """name -> {"ms", "ms_after_plain", "ms_behind_work", "plain_ms"} for
    pairs of (kernel call, plain call), in turns plain, kernel, kernel,
    plain after a launch of the kernel (the plain versions have run at
    these shapes in the checks before), by CUDA events:

    ms_after_plain  the mean of two turns of three launches that start
                    right after the plain version's call, with the card
                    idle: the host's time to prepare a call is part of it
                    (0.15-0.3 ms a call of a scan wrapper, H100 host), and
                    so are the first, slower launches after the plain
                    version. The only reading up to commit 9ad48d3;
    ms              the mean of two turns of KERNEL_REPS launches after one
                    launch that is not timed: the steady rate of calls;
    ms_behind_work  one call at a time behind other work on the stream
                    (behind_work_ms): what a path that keeps the card busy
                    pays for the call, cold caches included."""
    filler = torch.empty(FILLER_FLOATS, device="cuda")
    times = {}
    for name, (kernel, plain) in pairs.items():
        kernel()
        p1 = cuda_ms(torch, plain, 1)
        a1 = cuda_ms(torch, kernel, 3)
        a2 = cuda_ms(torch, kernel, 3)
        kernel()
        k1 = cuda_ms(torch, kernel, KERNEL_REPS)
        k2 = cuda_ms(torch, kernel, KERNEL_REPS)
        p2 = cuda_ms(torch, plain, 1)
        times[name] = {"ms": (k1 + k2) / 2, "ms_after_plain": (a1 + a2) / 2,
                       "ms_behind_work": behind_work_ms(torch, kernel, filler),
                       "plain_ms": (p1 + p2) / 2}
    return times


def profile_launches(torch, calls: dict) -> dict:
    """Device microseconds per launch of every CUDA kernel that a call of
    each entry in `calls` launches (the mean over three calls), from
    torch.profiler, keyed by call and then by the kernel's function name.
    The profiler is information, not a check: where it records no device
    time the result is empty."""
    from torch.profiler import ProfilerActivity, profile
    split = {}
    for name, fn in calls.items():
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(3):
                fn()
            torch.cuda.synchronize()
        split[name] = {
            (re.findall(r"([A-Za-z_]\w*)(?:<[^()]*>)?\(",
                        ev.key.replace("(anonymous namespace)::", ""))
             or [ev.key])[0]:
                round(ev.device_time_total / max(ev.count, 1), 1)
            for ev in prof.key_averages()
            if ev.device_time_total > 0}
    return split


def profile_scans_in_path(torch, run) -> dict:
    """The scan kernels' launches inside one run() of a path, from
    torch.profiler: kernel name with its map -> launches and mean device
    microseconds per launch. What the path pays for them, between its other
    work."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    found = {}
    for ev in prof.key_averages():
        key = ev.key.replace("(anonymous namespace)::", "")
        if "scan_" in key and ev.device_time_total > 0:
            found[key.split("(")[0].replace("void ", "")] = {
                "launches": ev.count,
                "us_per_launch": round(ev.device_time_total / ev.count, 1)}
    return found


def tone_snr_db(y: np.ndarray, f0: float, lo: int, hi: int) -> float:
    """SNR of y[lo:hi] against the sinusoid at f0 fitted to it in amplitude
    and phase: the SQPV inverse accumulates phase from zero, so its output
    keeps each component's frequency and magnitude, not its phase. The
    signal's noise floor is part of the residual, so the bench signal
    (0.4 sine + 0.1 noise) caps this at about 9 dB."""
    t = np.arange(lo, hi, dtype=np.float64) / SR
    basis = np.stack([np.sin(2 * np.pi * f0 * t),
                      np.cos(2 * np.pi * f0 * t)], 1)
    seg = y[lo:hi].astype(np.float64)
    coef, *_ = np.linalg.lstsq(basis, seg, rcond=None)
    fit = basis @ coef
    err = seg - fit
    return float(10 * np.log10(fit @ fit / max(err @ err, 1e-30)))


def phase5_sqpv(torch, Audio, dev):
    """SQPV round trip and 1.5x repitch at bench size through the class
    path, which runs both SQPV kernels. Returns the input on the card, the
    SQPV, both outputs, the round trip's wall seconds and its peak
    device memory in GB, counted above what was allocated before it."""
    x = stereo_signal(SQPV_SECONDS)[:1]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    a = Audio.create_from_array(x, SR, device=dev)
    sq = a.convert_to_SQPV(SQPV_BAND, SQPV_BPO)
    y = sq.convert_to_audio().data
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak_gb = (torch.cuda.max_memory_allocated() - base) / 1e9
    y_up = sq.repitch(1.5).convert_to_audio().data
    torch.cuda.synchronize()
    return a.data, sq, y, y_up, wall, peak_gb


def phase5_check(torch, sqpv_kernels, SQPV, x, sq, y, y_up, wall_k, peak_gb):
    """The main path's SQPV planes, and the inverse kernel, against the
    plain versions on the same input at the bench shape; the tone-fit SNR
    of both round trips; the repitched tone on both paths. Returns the
    plain planes and the kernels' largest absolute errors."""
    args = (SR, SQPV_BPO, SQPV_BAND)
    t0 = time.perf_counter()
    ref = sqpv_kernels.sqpv_forward_ref(x, *args)
    y_ref = sqpv_kernels.sqpv_inverse_ref(*ref, *args)
    torch.cuda.synchronize()
    wall_p = time.perf_counter() - t0
    ref64 = sqpv_kernels.sqpv_forward_ref(x.double(), *args)
    e = sqpv_errors(torch, (sq.mag, sq.pitch, sq.positive), ref, ref64,
                    SR)
    del ref64
    check_same_bits(torch, lambda: sqpv_kernels.sqpv_forward_cuda(x, *args),
                    "SQPV forward, bench shape")
    check_same_bits(torch, lambda: sqpv_kernels.sqpv_inverse_cuda(*ref, *args),
                    "SQPV inverse, bench shape")
    out = sqpv_kernels.sqpv_inverse_cuda(*ref, *args)
    up = SQPV(*ref, sample_rate=SR, bins_per_octave=SQPV_BPO,
              bandwidth=SQPV_BAND).repitch(1.5)
    y_up_ref = sqpv_kernels.sqpv_inverse_ref(up.mag, up.pitch, up.positive,
                                             *args)
    torch.cuda.synchronize()
    peak = float(y_ref.abs().max())
    err_o = float((out - y_ref).abs().max())
    y_np, y_ref_np, up_np, up_ref_np = (
        t.cpu().numpy()[0] for t in (y, y_ref, y_up, y_up_ref))
    x_np = x.cpu().numpy()[0]
    check(all(bool(np.isfinite(v).all()) for v in (y_np, up_np)),
          "SQPV outputs not finite")
    # a 1 s window in the middle of the 10 s: 220 Hz, and 330 after repitch
    lo, hi = int(4.5 * SR), int(5.5 * SR)
    snr = {name: tone_snr_db(v, 220.0, lo, hi) for name, v in
           (("input", x_np), ("kernels", y_np), ("plain", y_ref_np))}
    hz_k, hz_p = (dominant_hz(v[lo:hi]) for v in (up_np, up_ref_np))
    print(json.dumps({"phase": 5, "path": "sqpv_roundtrip_10s_mono_48k_24bpo",
                      "bins": int(sq.num_bins), "frames": int(sq.num_frames),
                      "wall_s_kernels": wall_k, "wall_s_plain": wall_p,
                      "x_realtime_kernels": SQPV_SECONDS / wall_k,
                      "x_realtime_plain": SQPV_SECONDS / wall_p,
                      "peak_alloc_gb_kernels": peak_gb,
                      "mag_err_rel": e["mag_err"] / e["scale"],
                      "freq_drift_hz_rms_kernel": e["drift_k"],
                      "freq_drift_hz_rms_plain": e["drift_p"],
                      "sign_mismatches": int((sq.positive != ref[2]).sum()),
                      "inv_err_rel": err_o / peak,
                      "tone_snr_db_input": snr["input"],
                      "tone_snr_db_kernels": snr["kernels"],
                      "tone_snr_db_plain": snr["plain"],
                      "repitch_hz_kernels": hz_k, "repitch_hz_plain": hz_p}),
          flush=True)
    check(sq.mag.shape == ref[0].shape and sq.num_frames == x.shape[1]
          and y.shape == y_up.shape == x.shape,
          f"SQPV shapes {tuple(sq.mag.shape)} {tuple(y.shape)}")
    check_forward(e, TOL_SQPV_MAG, "SQPV bench shape")
    check(math.isfinite(err_o) and err_o < TOL_SQPV_INV * peak,
          f"SQPV inverse, bench shape: {err_o} vs peak {peak}")
    check(snr["kernels"] >= snr["plain"] - 1.0,
          f"SQPV tone SNR kernels {snr['kernels']} dB vs plain "
          f"{snr['plain']} dB")
    for name, hz in (("kernels", hz_k), ("plain", hz_p)):
        check(abs(hz - 330.0) <= TOL_REPITCH_HZ,
              f"SQPV repitch 1.5x on the {name} path: {hz} Hz, want 330")
    return ref, {"sqpv_forward": e["mag_err"], "sqpv_inverse": err_o}


def filter_stages(Audio, x, device):
    """The phase-6 class path as (name, step) pairs: a swept 2-pole lowpass
    (200 Hz -> 8 kHz over 600 s, two SVF stages), a swept 3rd-order 1-pole
    highpass (a 1-pole and an SVF stage), a constant 2-pole highpass (the
    FIR path, probed on the scans) and the compressor (max-affine and
    linear scans over the [N] control signal)."""
    return [
        ("host_to_device",
         lambda _: Audio.create_from_array(x, SR, device=device)),
        ("lowpass_2pole_swept", lambda a: a.filter_2pole_lowpass(
            lambda t: 200.0 * 40.0 ** (t / 600.0), 0.5, 2)),
        ("highpass_1pole_swept", lambda a: a.filter_1pole_highpass(
            lambda t: 30.0 + 0.05 * t, 3)),
        ("highpass_2pole_fir", lambda a: a.filter_2pole_highpass(
            60.0, 0.5, 2)),
        ("compress", lambda a: a.compress(-18.0, 4.0, 0.005, 0.1, 6.0)),
    ]


def filter_path(Audio, x, device):
    a = None
    for _, step in filter_stages(Audio, x, device):
        a = step(a)
    return a


def capture_calls(targets, run, keep=None):
    """run() with module.<name> for each (module, name) of targets wrapped
    to keep the arguments of each call that keep(name, args, kept) accepts
    (`kept` being that name's calls kept so far; by default the first call
    only), with no launch of their own. Returns run()'s result and name ->
    the kept argument tuples, in call order."""
    if keep is None:
        def keep(name, args, kept):
            return not kept
    captured = {name: [] for _, name in targets}
    originals = [(module, name, getattr(module, name))
                 for module, name in targets]

    def recorder(name, fn):
        def call(*args, **kwargs):
            if keep(name, args, captured[name]):
                captured[name].append(args)
            return fn(*args, **kwargs)
        return call

    try:
        for module, name, fn in originals:
            setattr(module, name, recorder(name, fn))
        out = run()
    finally:
        for module, name, fn in originals:
            setattr(module, name, fn)
    return out, captured


def phase6_filters(torch, Audio, scan, scan_kernels, dev):
    """The filter and compressor class path at headline size (600 s stereo
    48 kHz): a first call (impulse-response probe and cuFFT plans
    included), counted, then a second call, a third under the profiler for
    the scan kernels' device time inside the path, then one pass
    synchronised after each stage, which keeps each scan kernel's
    full-length inputs. Returns the output, the report, the captured inputs
    and the launch counts."""
    x = stereo_signal(FILTER_SECONDS)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    scan_kernels.reset_launch_counts()
    out, ms_first = timed(torch, lambda: filter_path(Audio, x, dev))
    launches = dict(scan_kernels.LAUNCHES)
    peak_gb = (torch.cuda.max_memory_allocated() - base) / 1e9
    del out
    out, ms_second = timed(torch, lambda: filter_path(Audio, x, dev))
    del out
    in_path = profile_scans_in_path(torch,
                                    lambda: filter_path(Audio, x, dev))

    def staged():
        a, stages = None, {}
        for name, step in filter_stages(Audio, x, dev):
            a, stages[name] = timed(torch, lambda: step(a))
        return a, stages

    # the first call of each scan at full length
    (out, stages), calls = capture_calls(
        [(scan, name) for name in SCANS], staged,
        lambda name, args, kept: not kept
        and args[0].shape[-1] == x.shape[1])
    captured = {name: kept[0] for name, kept in calls.items() if kept}
    report = {"phase": 6, "path": "filters_compress_600s_stereo_48k",
              "wall_s_first": ms_first / 1e3, "wall_s_second": ms_second / 1e3,
              "x_realtime_first": FILTER_SECONDS / (ms_first / 1e3),
              "x_realtime_second": FILTER_SECONDS / (ms_second / 1e3),
              "peak_alloc_gb": peak_gb, "frames": int(x.shape[1]),
              "stages_ms": stages, "launches": launches,
              "scans_in_path": in_path}
    return out, report, captured, launches


def phase6_check(torch, Audio, scan_kernels, y, report, captured, dev):
    """The path's output (length, finite, the 220/330 Hz tones); each scan
    kernel against its plain version on the planes the path built, at
    full length; the whole path at 10 s on the card against the CPU.
    Returns each kernel's largest absolute error and its timing inputs."""
    y_np = y.to_numpy()
    n = report["frames"]
    check(y_np.shape == (2, n), f"filter path output shape {y_np.shape}")
    check(bool(np.isfinite(y_np).all()), "filter path output not finite")
    mid = n // 2
    hz = [dominant_hz(y_np[ch, mid:mid + int(SR)]) for ch in (0, 1)]
    report["dominant_hz"] = hz
    for got, want in zip(hz, (220.0, 330.0)):
        check(abs(got - want) <= 2.0, f"filter path: dominant {got} Hz, "
              f"want {want}")
    errs = {}
    for name, (kernel, plain) in scan_calls(scan_kernels).items():
        check(name in captured, f"{name} was not called at full length")
        e = scan_errors(torch, kernel, plain, captured[name])
        report[name] = e
        check_scan(e, f"{name} on the path's planes", 0.0)
        check_same_bits(torch, lambda: kernel(*captured[name]),
                        f"{name} on the path's planes")
        errs[name] = e["abs_err"]
    x10 = stereo_signal(FILTER_CPU_SECONDS)
    want = filter_path(Audio, x10, "cpu").to_numpy()
    got = filter_path(Audio, x10, dev).to_numpy()
    err = float(np.abs(got - want).max() / np.abs(want).max())
    report["card_vs_cpu_10s_err_rel"] = err
    print(json.dumps(report), flush=True)
    check(got.shape == want.shape and err < TOL_FILTER_CPU,
          f"filter path on the card vs the CPU at 10 s: {err}")
    return errs


def stream_peak_bound(n_in: int, ch: int, out_samples: int, chunk: int,
                      nbins: int) -> int:
    """The design's bound on the streamed pipeline's device memory above
    its input, in bytes: the float32 output and STREAM_CHUNK_PLANES float32
    planes of [n_in, channels, chunk, bins], whatever the file's length."""
    return 4 * (ch * out_samples
                + STREAM_CHUNK_PLANES * n_in * ch * chunk * nbins)


STREAM_STAGES = ("_analysis", "_remap", "_synthesis", "_overlap_add")


def stream_stages(torch, streamed, run) -> dict:
    """Where one run() of a streamed pipeline spends the card's time, from
    torch.profiler: the stage functions of pipelines/streamed.py wrapped
    in record_function ranges for the run (no launch of their own), each
    stage's kernel milliseconds and calls; all kernels' milliseconds,
    launches and the wall milliseconds of the run, host clock, synchronised
    (kernel time over wall is the card's busy share). Information, not a
    check."""
    from torch.profiler import ProfilerActivity, profile, record_function
    originals = {name: getattr(streamed, name) for name in STREAM_STAGES}

    def ranged(name, fn):
        def call(*args, **kwargs):
            with record_function("streamed" + name):
                return fn(*args, **kwargs)
        return call

    try:
        for name, fn in originals.items():
            setattr(streamed, name, ranged(name, fn))
        run()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            _, wall_ms = timed(torch, run)
    finally:
        for name, fn in originals.items():
            setattr(streamed, name, fn)
    stages = {"streamed" + name: {"kernel_ms": 0.0, "calls": 0}
              for name in STREAM_STAGES}
    kernel_us, launches = 0.0, 0
    for ev in prof.events():
        on_card = str(ev.device_type).endswith("CUDA")
        if ev.name in stages and not on_card:
            stages[ev.name]["kernel_ms"] += ev.device_time_total / 1e3
            stages[ev.name]["calls"] += 1
        elif on_card and not ev.name.startswith("streamed"):
            kernel_us += ev.device_time_total
            launches += 1
    return {"stages": stages, "kernel_ms": kernel_us / 1e3,
            "launches": launches, "wall_ms": wall_ms,
            "busy_share": kernel_us / 1e3 / wall_ms}


def phase7_streamed(torch, Audio, pipelines, dev, y_class, wall_class):
    """The streamed pipelines at headline size (600 s stereo 48 kHz,
    window 2048 / hop 128 / dft 4096): the 2x stretch from host data
    (first and second call, peak memory above the input), held against
    phase 3's class-path output; the sweep of chunk sizes; launches per
    chunk; the 1.5x repitch and a morph at 600 s; repitch and morph
    against their class forms at 60 s. Returns the report."""
    x = stereo_signal(STREAM_SECONDS)
    report = {"phase": 7, "path": "streamed_stretch_2x_600s_stereo_48k",
              "chunk_out": pipelines.streamed.DEFAULT_CHUNK_OUT}
    xd = torch.from_numpy(x).to(dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    y, ms_first = timed(torch, lambda: pipelines.pv_stretch_pipeline(
        xd, 2.0, sample_rate=SR))
    peak = torch.cuda.max_memory_allocated() - base
    del y
    y, ms_second = timed(torch, lambda: pipelines.pv_stretch_pipeline(
        x, 2.0, sample_rate=SR))
    y_np = y.cpu().numpy()
    del y
    bound = stream_peak_bound(1, 2, y_np.shape[1], report["chunk_out"],
                              4096 // 2 + 1)
    err = float(np.abs(y_np - y_class).max() / np.abs(y_class).max()) \
        if y_np.shape == y_class.shape else math.inf
    mid = y_np.shape[1] // 2
    hz = [dominant_hz(y_np[ch, mid:mid + int(SR)]) for ch in (0, 1)]
    report.update({
        "wall_s_first": ms_first / 1e3, "wall_s_second": ms_second / 1e3,
        "x_realtime_second": STREAM_SECONDS / (ms_second / 1e3),
        "class_path_wall_s": wall_class,
        "class_path_x_realtime": STREAM_SECONDS / wall_class,
        "peak_alloc_gb_above_input": peak / 1e9,
        "peak_bound_gb": bound / 1e9,
        "out_frames": int(y_np.shape[1]), "vs_class_err_rel": err,
        "dominant_hz": hz})
    print(json.dumps(report), flush=True)
    check(y_np.shape == y_class.shape,
          f"streamed stretch {y_np.shape}, class path {y_class.shape}")
    check(bool(np.isfinite(y_np).all()), "streamed stretch not finite")
    check(err <= TOL_STREAM_CLASS,
          f"streamed stretch vs the class path: {err} of the peak")
    for got, want in zip(hz, (220.0, 330.0)):
        check(abs(got - want) <= 2.0, f"streamed stretch: dominant {got} "
              f"Hz, want {want}")
    check(peak <= bound, f"streamed stretch peak {peak / 1e9} GB above the "
          f"input, bound {bound / 1e9} GB")
    del y_np

    # the chunk size: wall and peak of a second call at each
    sweep = {}
    for chunk in STREAM_CHUNK_SWEEP:
        pipelines.pv_stretch_pipeline(xd[:, :int(SR)], 2.0, sample_rate=SR,
                                      chunk_out=chunk)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        y, ms = timed(torch, lambda: pipelines.pv_stretch_pipeline(
            xd, 2.0, sample_rate=SR, chunk_out=chunk))
        sweep[chunk] = {"wall_s": ms / 1e3, "peak_alloc_gb_above_input":
                        (torch.cuda.max_memory_allocated() - base) / 1e9}
        del y
    stages = stream_stages(torch, pipelines.streamed, lambda: (
        pipelines.pv_stretch_pipeline(xd, 2.0, sample_rate=SR)))
    chunks = math.ceil(2 * (x.shape[1] // 128 + 1) / report["chunk_out"])
    report_r = {"phase": 7, "chunk_sweep_600s": sweep,
                "stages_600s": stages, "chunks_600s": chunks,
                "launches_per_chunk": stages["launches"] / chunks}

    # repitch 1.5x and a morph at 600 s
    y, ms_rep = timed(torch, lambda: pipelines.pv_repitch_pipeline(
        xd, 1.5, sample_rate=SR))
    y_np = y.cpu().numpy()
    del y
    hz_rep = [dominant_hz(y_np[ch, mid // 2:mid // 2 + int(SR)])
              for ch in (0, 1)]
    # the identity map keeps num_hops = N // hop + 1 frames
    shape = (2, (x.shape[1] // 128 + 1) * 128)
    check(y_np.shape == shape and bool(np.isfinite(y_np).all()),
          f"streamed repitch {y_np.shape}, not finite or not {shape}")
    del y_np
    other = xd.flip(0)      # the channels swapped: 330 Hz, then 220 Hz
    y, ms_morph = timed(torch, lambda: pipelines.pv_morph_pipeline(
        xd, other, 0.75, sample_rate=SR))
    y_np = y.cpu().numpy()
    del y
    check(y_np.shape == shape and bool(np.isfinite(y_np).all()),
          f"streamed morph {y_np.shape}, not finite or not {shape}")
    del y_np
    report_r.update({"repitch_1p5_600s_wall_s": ms_rep / 1e3,
                     "repitch_x_realtime": STREAM_SECONDS / (ms_rep / 1e3),
                     "repitch_dominant_hz": hz_rep,
                     "morph_600s_wall_s": ms_morph / 1e3,
                     "morph_x_realtime": STREAM_SECONDS / (ms_morph / 1e3)})
    del xd, other

    # repitch and morph against their class forms at 60 s
    x60 = torch.from_numpy(stereo_signal(ALGO_SECONDS)).to(dev)
    b60 = x60.flip(0)
    amount = lambda t, f: torch.clamp(t / ALGO_SECONDS, 0.0, 1.0)  # noqa
    pv = Audio.create_from_array(x60, SR).convert_to_PV(2048, 128, 4096)
    pv_b = Audio.create_from_array(b60, SR).convert_to_PV(2048, 128, 4096)
    pairs = {
        "repitch": (pipelines.pv_repitch_pipeline(x60, 1.5, sample_rate=SR),
                    pv.repitch(1.5).convert_to_audio().data),
        "morph": (pipelines.pv_morph_pipeline(x60, b60, amount,
                                              sample_rate=SR),
                  pv.replace_amplitudes(pv_b, amount).convert_to_audio().data)}
    del pv, pv_b
    for name, (got, want) in pairs.items():
        e = float((got - want).abs().max() / want.abs().max()) \
            if got.shape == want.shape else math.inf
        report_r[f"{name}_60s_vs_class_err_rel"] = e
    print(json.dumps(report_r), flush=True)
    # the PV repitch writes factor * (f + bin_width), the reference's
    # +1-bin offset (PVModify.cpp:263-268, 287-302; golden-tested): 220 Hz
    # lands at 347.6 Hz, 330 at 512.6, not at 330 and 495
    for ch, tone in enumerate((220.0, 330.0)):
        want = 1.5 * (tone + SR / 4096)
        check(abs(hz_rep[ch] - want) <= TOL_REPITCH_HZ,
              f"streamed repitch 1.5x channel {ch}: {hz_rep[ch]} Hz, "
              f"want {want}")
    for name in pairs:
        e = report_r[f"{name}_60s_vs_class_err_rel"]
        check(e <= TOL_IDENTITY_CLASS,
              f"streamed {name} vs its class form at 60 s: {e}")
    report.update(report_r)
    return report


def phase7_algorithms(torch, Audio, scan, scan_kernels, dev):
    """resonate and perturb on a 60 s stereo PV (48 kHz, window 2048 / hop
    128 / dft 4096): their scans' launches, counted from zero, then each
    scan call held to the float64 plain run on its own planes (error at
    most twice the float32 plain run's), three calls for the same bits, the
    whole methods on the card against the CPU at 2 s. Returns the launch
    counts, each kernel's largest absolute difference from its float32
    plain run, and the captured calls (case -> (kernel, arguments))."""
    pv = Audio.create_from_array(stereo_signal(ALGO_SECONDS), SR,
                                 device=dev).convert_to_PV(2048, 128, 4096)
    torch.cuda.synchronize()
    scan_kernels.reset_launch_counts()
    (res, per), captured = capture_calls(
        [(scan, name) for name in SCANS], lambda: (
            pv.resonate(RESONATE_SECONDS, RESONATE_DECAY),
            pv.perturb(PERTURB_STD, seed=3)), lambda name, args, kept: True)
    torch.cuda.synchronize()
    launches = {"scan_linear": scan_kernels.LAUNCHES["scan_linear"],
                "scan_max_affine": scan_kernels.LAUNCHES["scan_max_affine"]}
    report = {"phase": 7, "path": "pv_resonate_perturb_60s_stereo_48k",
              "frames": pv.num_frames, "bins": pv.num_bins,
              "launches": launches}
    check(launches["scan_max_affine"] >= 1 and launches["scan_linear"] >= 2,
          f"resonate / perturb launched the scans {launches}")
    check(all(bool(torch.isfinite(t).all()) for t in
              (res.mag, res.freq, per.mag, per.freq)),
          "resonate / perturb output not finite")
    check(res.num_frames == pv.num_frames + math.ceil(
        RESONATE_SECONDS * pv.analysis_rate) and per.mag.shape ==
        pv.mag.shape, f"resonate {tuple(res.mag.shape)}, perturb "
        f"{tuple(per.mag.shape)}")
    del res, per, pv
    calls = {"resonate_max_affine": ("scan_max_affine",
                                     captured["scan_max_affine"][0]),
             "perturb_linear_frames": ("scan_linear",
                                       captured["scan_linear"][0]),
             "perturb_linear_bins": ("scan_linear",
                                     captured["scan_linear"][1])}
    kernels = scan_calls(scan_kernels)
    errs = dict.fromkeys(launches, 0.0)
    for case, (name, args) in calls.items():
        kernel, plain = kernels[name]
        shape = torch.broadcast_shapes(*(a.shape for a in args[:-1]))
        e = scan_errors(torch, kernel, plain, args)
        e["rows"], e["length"] = math.prod(shape[:-1]), shape[-1]
        report[case] = e
        check_scan(e, f"{case} on the method's planes", 0.0)
        check_same_bits(torch, lambda: kernel(*args), case)
        errs[name] = max(errs[name], e["abs_err"])

    # the methods on the card against the CPU at 2 s
    small = Audio.create_from_array(stereo_signal(2.0), SR, device="cpu") \
        .convert_to_PV(2048, 128, 4096)
    on_card = type(small)(mag=small.mag.to(dev), freq=small.freq.to(dev),
                          sample_rate=SR, hop_size=128, window_size=2048)
    for name, run in (("resonate", lambda p: p.resonate(RESONATE_SECONDS,
                                                        RESONATE_DECAY)),
                      ("perturb", None)):
        if run is None:
            # the same noise on both devices
            from flan_tpu_torch.pv.algorithms import _perturb_planes
            g = torch.Generator().manual_seed(5)
            na = torch.randn((small.num_frames, small.num_bins), generator=g)
            nm = torch.randn((2, small.num_frames), generator=g)
            run = lambda p: _perturb_planes(  # noqa: E731
                p, PERTURB_STD, 0.99, na.to(p.device), nm.to(p.device))
        want, got = run(small), run(on_card)
        d = {key: (getattr(got, key).cpu() - getattr(want, key)).abs()
             for key in ("mag", "freq")}
        report[f"{name}_2s_vs_cpu"] = {
            "mag_err_rel": float(d["mag"].max() / want.mag.abs().max()),
            "freq_err_rel": float(d["freq"].max() / want.freq.abs().max()),
            "freq_cells_off": float((d["freq"] > 1e-3).double().mean())}
    print(json.dumps(report), flush=True)
    for name in ("resonate", "perturb"):
        e = report[f"{name}_2s_vs_cpu"]
        check(e["mag_err_rel"] <= TOL_ALGO_CPU,
              f"{name} on the card vs the CPU at 2 s: {e}")
    # perturb's frequencies move by sums; resonate's follow the last frame
    # whose input won, which a rounding can hand to a neighbour
    e_p, e_r = report["perturb_2s_vs_cpu"], report["resonate_2s_vs_cpu"]
    check(e_p["freq_err_rel"] <= TOL_ALGO_CPU,
          f"perturb frequencies on the card vs the CPU: {e_p}")
    check(e_r["freq_cells_off"] <= TOL_RESONATE_CELLS,
          f"resonate frequencies on the card vs the CPU: {e_r}")
    return launches, errs, calls


def sm_clock_hz() -> float:
    """The SM's maximum clock (nvidia-smi), for the latency estimates."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm",
                          "--format=csv,noheader,nounits"],
                         capture_output=True, text=True, check=True)
    return float(out.stdout.strip().splitlines()[0]) * 1e6


def kxk_frames(n, k: int, lib) -> int:
    """A k x k case's frames: a number, or an edge of the kernel's tiling
    with an offset: "R" a sub-run, "T" a tile, "B" the 32 windows of tiles
    its look-back reads at a time (at k = 1 and 2 the one pass's tile and
    look-back window of tiles)."""
    if isinstance(n, int):
        return n
    tile = lib.flan_scan_kxk_tile(k)
    window = (lib.flan_scan_kxk_window_tiles() * 32 if k >= 3
              else lib.flan_scan_window_tiles())
    unit = {"R": lib.flan_scan_kxk_subrun(k) or tile, "T": tile,
            "B": window * tile}[n[0]]
    return unit + int(n[1:] or 0)


def kxk_planes(torch, k: int, rows: int, n: int, shared: bool, seed: int,
               dev):
    """k x k maps near the multinotch's (a decay of 0.5 to 0.99999 on the
    diagonal, weak coupling off it), inputs and start states, float32 on the
    card: A [1 or rows, k*k, N], b [rows, k, N], y0 [rows, k]."""
    rng = np.random.default_rng(seed)
    ra = 1 if shared else rows
    A = rng.uniform(-1, 1, (ra, k, k, n)).astype(np.float32) * (0.3 / k)
    A[:, np.arange(k), np.arange(k)] = rng.uniform(0.5, 0.99999, (ra, k, n))
    b = rng.standard_normal((rows, k, n)).astype(np.float32)
    y0 = rng.standard_normal((rows, k)).astype(np.float32)
    return [torch.from_numpy(v).to(dev) for v in
            (A.reshape(ra, k * k, n), b, y0)]


def phase8_kxk_cases(torch, lib, scan_kernels, dev) -> float:
    """The k x k kernel against its plain version over k (the linear map at
    k = 1, the chunked kernel above 2), lengths and rows, A shared and
    not; three calls for the same bits at each k. Returns the largest
    absolute error against the float32 plain run."""
    worst = 0.0
    for k in KXK_KS:
        cases = KXK_CASES + ([KXK_LONG_ROW] if k in KXK_LONG_ROW_KS else [])
        for i, (rows, frames, shared) in enumerate(cases):
            n = kxk_frames(frames, k, lib)
            args = kxk_planes(torch, k, rows, n, shared, 10 * k + i, dev)
            e = scan_errors(torch, scan_kernels.scan_affine_kxk,
                            scan_kernels.affine_kxk_ref, args)
            print(json.dumps({"phase": 8, "kernel": "scan_affine_kxk",
                              "k": k, "rows": rows, "frames": n,
                              "shared": shared, **e}), flush=True)
            check_scan(e, f"k x k k={k} rows={rows} N={n} shared={shared}",
                       SCAN_FLOOR)
            worst = max(worst, e["abs_err"])
            del args
        args = kxk_planes(torch, k, 64, 30_011, True, k, dev)
        check_same_bits(torch, lambda: scan_kernels.scan_affine_kxk(*args),
                        f"k x k k={k} on 64 rows")
    return worst


def kxk_sweep(t):
    return 200.0 * 10.0 ** (t / MULTINOTCH_SECONDS)   # 200 -> 2000 Hz


def comb_cut(t):
    """The comb gradient's cutoff: delays of 12 + floor(10 t) samples and a
    half (12 -> 6012 over 600 s), which no rounding moves across an
    integer."""
    return SR / (2.0 * ((12.0 + 10.0 * t).floor() + 0.5))


def multinotch_runs():
    """Phase 8's multinotch calls: (name, k, step)."""
    return [
        ("multinotch_1pole_4_swept", 4, lambda a: a.filter_1pole_multinotch(
            4, kxk_sweep, 0.5)),
        ("multinotch_2pole_4_swept", 8, lambda a: a.filter_2pole_multinotch(
            4, kxk_sweep, 0.3, 0.5)),
        ("multinotch_2pole_2_fir", 4, lambda a: a.filter_2pole_multinotch(
            2, 800.0, 0.35, 0.3)),
        ("comb_swept", None, lambda a: a.filter_comb(kxk_sweep, 0.5)),
    ]


def phase8_filters(torch, Audio, scan, scan_kernels, seq, dev, card):
    """The filters that run on the k x k and the sequential kernels, at
    headline width: the multinotch filters and the swept comb at 600 s
    stereo 48 kHz, the saturator at 10 s; counted from zero, a first call
    and a second, peak memory; each held to the CPU (the multinotch
    filters at 3 s, the comb at 10 s, the saturator over its first
    SEQ_PLAIN_FRAMES frames). Returns the launches, the report, the
    captured k x k calls (k -> arguments), the sequential kernels' calls
    (kernel -> arguments) and the first frames of their outputs (kernel ->
    (first frames as an array, every frame on the card), which
    phase8_sequential_checks holds to the plain loops and to one step."""
    x = stereo_signal(MULTINOTCH_SECONDS)
    x10 = stereo_signal(FILTER_CPU_SECONDS)
    x_mn = x10[:, :int(MULTINOTCH_CPU_SECONDS * SR)].copy()
    report = {"phase": 8, "path": "filters_on_kxk_and_sequential_kernels",
              "card": card}
    launches = {**scan_kernels.LAUNCHES, **seq.LAUNCHES}
    launches = dict.fromkeys(launches, 0)
    kxk_args, seq_args, seq_out = {}, {}, {}
    for name, k, step in multinotch_runs() + [
            ("saturator_1pole_2", None, lambda a: a.filter_1pole_multinotch(
                2, lambda t: 300.0 + 300.0 * t, 0.6, False, 0.5, True)),
            ("saturator_2pole_2", None, lambda a: a.filter_2pole_multinotch(
                2, lambda t: 300.0 + 300.0 * t, 0.4, 0.7, True, 0.5, True))]:
        seconds = SAT_SECONDS if name.startswith("saturator") else \
            MULTINOTCH_SECONDS
        xs = x if seconds == MULTINOTCH_SECONDS else stereo_signal(seconds)
        scan_kernels.reset_launch_counts()
        seq.reset_launch_counts()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        (y, ms_first), calls = capture_calls(
            [(scan, "scan_affine_kxk"), (seq, "saturator_cuda"),
             (seq, "comb_swept_cuda")],
            lambda: timed(torch, lambda: step(Audio.create_from_array(
                xs, SR, device=dev))))
        peak_gb = (torch.cuda.max_memory_allocated() - base) / 1e9
        if k is not None and calls["scan_affine_kxk"]:
            kxk_args.setdefault(k, calls["scan_affine_kxk"][0])
        if calls["saturator_cuda"]:
            seq_args[name[:15]] = calls["saturator_cuda"][0]
        if calls["comb_swept_cuda"]:
            seq_args["comb_swept"] = calls["comb_swept_cuda"][0]
        del y
        y, ms_second = timed(torch, lambda: step(Audio.create_from_array(
            xs, SR, device=dev)))
        # the path's launches: its two calls, before any comparison
        run_launches = {**scan_kernels.LAUNCHES, **seq.LAUNCHES}
        for key, count in run_launches.items():
            launches[key] += count
        y_np = y.to_numpy()
        # the sequential kernels' outputs are causal: their first frames
        # are held to the plain loops on the call's own inputs, and every
        # frame to one step from the call's own earlier outputs
        if name.startswith("saturator"):
            seq_out[name[:15]] = (y_np[:, :SEQ_PLAIN_FRAMES], y.data)
        elif name == "comb_swept":
            seq_out[name] = (y_np[:, :int(COMB_PLAIN_SECONDS * SR)], y.data)
        del y
        # the saturator's plain loop on the CPU takes ~0.5 ms a step: it is
        # compared over its first SEQ_PLAIN_FRAMES frames
        xc = (x10[:, :SEQ_PLAIN_FRAMES].copy() if name.startswith(
            "saturator") else x10 if name == "comb_swept" else x_mn)
        (want, got), cmp = capture_calls(
            [(seq, "comb_swept_ref"), (seq, "comb_swept_cuda")],
            lambda: [step(Audio.create_from_array(xc, SR, device=d)
                          ).to_numpy() for d in ("cpu", dev)])
        err = float(np.abs(got - want).max() / np.abs(want).max())
        extra = {}
        if name == "comb_swept":
            # int(sr / (2 w)) truncates: where the card's and the CPU's
            # float32 w round sr / (2 w) to two sides of an integer, the
            # two delays differ by one sample, and the comb's output with
            # them. The card is held to the CPU's plain loop on the card's
            # own delays; the CPU's own result is information.
            x_c, d_c, k_c, a_c, f_c, _ = cmp["comb_swept_cuda"][0]
            d_cpu = cmp["comb_swept_ref"][0][1]
            extra = {"delays_differ": int((d_c.cpu() != d_cpu).sum()),
                     "card_vs_cpu_own_delays_err_rel": err}
            want = seq.comb_swept_ref(x_c.cpu(), d_c.cpu(), k_c.cpu(),
                                      a_c.cpu(), f_c).numpy()
            err = float(np.abs(got - want).max() / np.abs(want).max())
        report[name] = {**extra,
            "seconds": seconds, "cpu_frames": xc.shape[1],
            "wall_s_first": ms_first / 1e3,
            "wall_s_second": ms_second / 1e3,
            "x_realtime_second": seconds / (ms_second / 1e3),
            "peak_alloc_gb": peak_gb,
            "launches": {key: n for key, n in run_launches.items() if n},
            "card_vs_cpu_err_rel": err}
        print(json.dumps({"phase": 8, "path": name, **report[name]}),
              flush=True)
        check(y_np.shape == xs.shape and bool(np.isfinite(y_np).all()),
              f"{name}: output {y_np.shape}, finite "
              f"{bool(np.isfinite(y_np).all())}")
        check(got.shape == want.shape and err < TOL_FILTER_CPU,
              f"{name} on the card vs the CPU ({xc.shape[1]} frames): {err}")
    for name in ("scan_affine_kxk", "saturator_1pole", "saturator_2pole",
                 "comb_swept"):
        check(launches[name] > 0,
              f"{name} kernel was not launched on the phase-8 path")
    check(sorted(kxk_args) == [4, 8],
          f"the k x k calls captured at full length: {sorted(kxk_args)}")
    return launches, report, kxk_args, seq_args, seq_out


def phase8_sequential_checks(torch, seq, seq_args, seq_out):
    """The sequential kernels' outputs on the path (the saturators' 10 s
    calls, the comb's 600 s call: the calls that are timed):
      - over the first frames, against the plain loops on the card, run on
        the same call's inputs cut to those frames (the loops are causal),
        and three calls of each kernel on the cut inputs for the same bits;
      - over every frame, by one step: the call run again keeping its
        states (u for the comb), its output the path's bit for bit, and
        each frame recomputed in float64 from the call's own earlier
        outputs (sequential_kernels.comb_step_errors,
        saturator_step_errors) within the same tolerance.
    Returns name -> (largest absolute error, plain ms, plain frames)."""
    out = {}
    for name, args in seq_args.items():
        want_np, full = seq_out[name]
        n = want_np.shape[1]
        if name == "comb_swept":
            x, delays, k, a, f, ring = args
            cut = (x[:, :n].contiguous(), delays[:n].contiguous(),
                   k[:n].contiguous(), a[:n].contiguous(), f)
            kernel = (lambda: seq.comb_swept_cuda(*cut, ring))
            plain = (lambda: seq.comb_swept_ref(*cut))
            again, kept = seq.comb_swept_cuda(*args, keep_u=True)
            step = seq.comb_step_errors(x, delays, k, a, f, full, kept)
            tol = TOL_COMB
        else:
            x, planes, inv, order, two_pole = args
            cut = (x[:, :n].contiguous(),
                   tuple(p[:n].contiguous() for p in planes), inv, order,
                   two_pole)
            ref = (seq.saturator_2pole_ref if two_pole
                   else seq.saturator_1pole_ref)
            kernel = (lambda: seq.saturator_cuda(*cut))
            plain = (lambda: ref(cut[0], *cut[1], inv, order))
            again, kept = seq.saturator_cuda(*args, keep_states=True)
            step = seq.saturator_step_errors(*args, full, kept)
            tol = TOL_SATURATOR
        same = torch.equal(again, full)
        del again, kept
        print(json.dumps({"phase": 8, "kernel": name, "check": "one_step",
                          "frames": int(full.shape[1]),
                          "of_frames": int(x.shape[1]),
                          "same_bits_as_path": same,
                          "err_rel": step}), flush=True)
        check(same and int(full.shape[1]) == int(x.shape[1])
              and max(step.values()) <= tol,
              f"{name} on the path, every frame by one step: same bits "
              f"{same}, {step}")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        want = plain()
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t0) * 1e3
        got = torch.from_numpy(want_np).to(want.device)
        err = float((got - want).abs().max())
        rel = err / float(want.abs().max())
        check_same_bits(torch, kernel, name)
        print(json.dumps({"phase": 8, "kernel": name, "frames": n,
                          "of_frames": int(x.shape[1]), "err_rel": rel,
                          "plain_ms": plain_ms}), flush=True)
        check(rel <= tol, f"{name} on the path vs its plain loop over the "
              f"first {n} frames: {rel}")
        out[name] = (err, plain_ms, n)
    return out


def kxk_path_call(torch, Audio, scan, scan_kernels, dev, step, k: int):
    """step() on 600 s stereo 48 kHz, once, its launches counted from zero:
    its wall and peak, its first k x k call timed inside it by CUDA events
    (the wrapper's allocations included) and kept. Returns the launches,
    the timing and the kept call's arguments."""
    x = stereo_signal(MULTINOTCH_SECONDS)
    kernel, calls = scan.scan_affine_kxk, []

    def timed_kxk(A, b, y0):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        y = kernel(A, b, y0)
        end.record()
        calls.append((start, end, (A, b, y0)))
        return y

    scan_kernels.reset_launch_counts()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    scan.scan_affine_kxk = timed_kxk
    try:
        y, ms = timed(torch, lambda: step(Audio.create_from_array(
            x, SR, device=dev)))
    finally:
        scan.scan_affine_kxk = kernel
    peak_gb = (torch.cuda.max_memory_allocated() - base) / 1e9
    launches = dict(scan_kernels.LAUNCHES)
    shape, finite = tuple(y.data.shape), bool(torch.isfinite(y.data).all())
    del y
    check(shape == x.shape and finite,
          f"the k = {k} multinotch: {shape}, finite {finite}")
    check(launches["scan_affine_kxk"] == len(calls) >= 1,
          f"the k = {k} multinotch's k x k launches: {launches}")
    start, end, args = calls[0]
    bnd = kxk_bound(args[0], args[1], k)
    timing = {"ms_in_path": start.elapsed_time(end), "bound_ms": bnd[0],
              "bound_by": bnd[1],
              "planes_gb": 4 * (args[0].numel() + 2 * args[1].numel()) / 1e9,
              "path_wall_s": ms / 1e3, "path_peak_alloc_gb": peak_gb}
    return launches, timing, args


def kxk_regime(torch, scan_kernels, args, k: int, reps: int = 3) -> dict:
    """The k x k kernel on one call's planes: the mean of `reps` launches
    by CUDA events (the path's own launch came before), its bound."""
    A, b, y0 = args
    bnd = kxk_bound(A, b, k)
    ms = cuda_ms(torch, lambda: scan_kernels.scan_affine_kxk(A, b, y0), reps)
    return {"ms": ms, "bound_ms": bnd[0], "bound_by": bnd[1],
            "share_of_bound": bnd[0] / ms,
            "planes_gb": 4 * (A.numel() + 2 * b.numel()) / 1e9}


def phase8_kxk12(torch, Audio, scan, scan_kernels, dev, card):
    """A swept 2-pole multinotch of order KXK12_ORDER (k = 12) at 600 s
    stereo 48 kHz: one call, counted from zero, its wall and peak, its k x
    k call timed inside it and then on the call's own planes (the kernel
    is held to its plain version in phase8_kxk_cases). Returns the
    launches and the timing."""
    k = 2 * KXK12_ORDER
    launches, timing, args = kxk_path_call(
        torch, Audio, scan, scan_kernels, dev,
        lambda a: a.filter_2pole_multinotch(KXK12_ORDER, kxk_sweep, 0.3,
                                            0.5), k)
    check(launches["scan_affine_kxk"] == 1,
          f"the k = {k} multinotch's k x k launches: {launches}")
    timing.update(kxk_regime(torch, scan_kernels, args, k))
    del args
    print(json.dumps({"phase": 8, "path": f"multinotch_2pole_"
                      f"{KXK12_ORDER}_swept_600s", "card": card, "k": k,
                      "launches": {key: v for key, v in launches.items()
                                   if v}, **timing}), flush=True)
    return launches, timing


def kxk_regimes(torch, Audio, scan, scan_kernels, dev) -> dict:
    """The --time-calls reading of the k x k kernel: the swept multinotch
    calls of phase 8 at 600 s stereo (1-pole order 4, k = 4; 2-pole order
    4, k = 8; 2-pole order KXK12_ORDER, k = 12), each run once and its k x
    k call then timed on its own planes (three launches)."""
    runs = [(4, lambda a: a.filter_1pole_multinotch(4, kxk_sweep, 0.5)),
            (8, lambda a: a.filter_2pole_multinotch(4, kxk_sweep, 0.3, 0.5)),
            (2 * KXK12_ORDER, lambda a: a.filter_2pole_multinotch(
                KXK12_ORDER, kxk_sweep, 0.3, 0.5))]
    out = {}
    for k, step in runs:
        _, timing, args = kxk_path_call(torch, Audio, scan, scan_kernels,
                                        dev, step, k)
        timing.update(kxk_regime(torch, scan_kernels, args, k))
        del args
        out[f"k{k}_600s_stereo"] = timing
    return out


def phase8_multinotch_gradients(torch, Audio, scan_kernels, dev, card):
    """Gradients of the energy through swept 2-pole multinotch filters of
    the orders MULTINOTCH_GRAD_ORDERS (k = 8 and 12) at 1 s stereo, with
    respect to the signal and a 0-d base cutoff, on the card and the CPU:
    the backward runs the k x k kernel on the reversed, transposed maps.
    Held within TOL_GRAD_CPU of each gradient's peak. Returns the
    backward's k x k launches."""
    x = stereo_signal(MULTINOTCH_GRAD_SECONDS)
    back_all = 0
    for order in MULTINOTCH_GRAD_ORDERS:
        grads, back = {}, 0
        for device in ("cpu", dev):
            v = torch.from_numpy(x).to(device).requires_grad_()
            c = torch.tensor(300.0, device=device, requires_grad=True)
            before = scan_kernels.LAUNCHES["scan_affine_kxk"]
            y = Audio.create_from_array(v, SR).filter_2pole_multinotch(
                order, lambda t: c * (1.0 + 2.0 * t), 0.3, 0.5).data
            loss = (y * y).sum()
            forward = scan_kernels.LAUNCHES["scan_affine_kxk"] - before
            grads[str(device)] = [g.cpu().double() for g in
                                  torch.autograd.grad(loss, (v, c))]
            back = (scan_kernels.LAUNCHES["scan_affine_kxk"] - before
                    - forward)
            check(device != "cpu" or forward + back == 0,
                  f"order {order}: the CPU launched the k x k kernel")
        (gv, gc), (wv, wc) = grads[str(dev)], grads["cpu"]
        e = {"k": 2 * order,
             "signal_grad_err_max": float((gv - wv).abs().max()
                                          / wv.abs().max()),
             "cutoff_grad_err": float((gc - wc).abs() / wc.abs()),
             "cutoff_grad_card": float(gc), "cutoff_grad_cpu": float(wc),
             "forward_launches": forward, "backward_launches": back}
        print(json.dumps({"phase": 8, "path": f"gradients_multinotch_2pole_"
                          f"{order}_1s_stereo", "card": card, **e}),
              flush=True)
        check(forward == 1 and back == 1, f"order {order}: the k x k "
              f"kernel's launches forward and back: {e}")
        check(e["signal_grad_err_max"] < TOL_GRAD_CPU
              and e["cutoff_grad_err"] < TOL_GRAD_CPU,
              f"order {order}: the gradient on the card vs the CPU: {e}")
        back_all += back
    return back_all


def saturator_pass_checks(torch, seq, args, back_args):
    """The saturator backward's passes on one backward call's inputs (args:
    saturator_backward_cuda's), each over the whole call against its plain
    version on the card: the maps kernel against the plain maps (A and b
    each within TOL_SATURATOR_BACK of its peak); the k x k scan of those
    maps in reverse time against affine_kxk_ref on the same maps (as phase
    8's k x k cases: within twice the float32 plain run's error against
    float64, plus SCAN_FLOOR); the read-out kernel on the kernel scan's
    states against the plain read-outs on the same states (each gradient
    within TOL_SATURATOR_BACK of its peak); three calls of each for the
    same bits. The maps' and read-outs' calls are kept in back_args for
    timing. Returns kernel -> (largest absolute error, plain ms, plain
    frames)."""
    from flan_tpu_torch.ops import scan_kernels
    gy, x, planes, y, states, inv, order, two_pole = args
    c, n = x.shape
    k = states.shape[1] + 1
    back = f"saturator_{2 if two_pole else 1}pole_backward"
    head, tail = (gy, x, planes, y, states), (inv, order, two_pole, 0, n)
    A, b = seq.saturator_backward_maps_cuda(*head, *tail)
    carry = torch.zeros((c, k), device=x.device)
    e = scan_errors(torch, scan_kernels.scan_affine_kxk,
                    scan_kernels.affine_kxk_ref, (A, b, carry))
    print(json.dumps({"phase": 8, "kernel": "scan_affine_kxk",
                      "path": f"{back}_reversed", "k": k, "rows": c,
                      "frames": n, "shared": False, **e}), flush=True)
    check_scan(e, f"{back}: the k x k scan (k={k}) of its maps over "
               f"{n} frames", SCAN_FLOOR)
    check_same_bits(torch, lambda: scan_kernels.scan_affine_kxk(A, b, carry),
                    f"{back}: the k x k scan of its maps")
    lam = scan_kernels.scan_affine_kxk(A, b, carry)
    gx, gp = torch.empty_like(x), x.new_empty((c, len(planes), n))
    back_args[f"{back}_maps"] = head + tail
    back_args[f"{back}_readout"] = head + (lam, carry, gx, gp) + tail

    def peaks_err(got, want):
        return max(float((g - w).abs().max() / w.abs().max().clamp(
            min=1e-30)) for g, w in zip(got, want))
    calls = {
        "maps": (lambda: seq.saturator_backward_maps_cuda(*head, *tail),
                 lambda: seq.saturator_adjoint_maps_ref(*head, *tail)),
        "readout": (
            lambda: (seq.saturator_backward_readout_cuda(
                *head, lam, carry, gx, gp, *tail), gx.clone(),
                gp.clone())[1:],
            lambda: seq.saturator_adjoint_readout_ref(*head, lam, carry,
                                                      *tail))}
    out = {}
    for part, (kernel, plain) in calls.items():
        got = kernel()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        want = plain()
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t0) * 1e3
        if part == "readout":       # each plane's gradient on its own
            got = (got[0],) + tuple(got[1].unbind(1))
            want = (want[0],) + tuple(want[1].unbind(1))
        rel = peaks_err(got, want)
        check_same_bits(torch, kernel, f"{back}_{part}")
        print(json.dumps({"phase": 8, "kernel": f"{back}_{part}",
                          "frames": n, "of_frames": n, "err_rel": rel,
                          "plain_ms": plain_ms}), flush=True)
        check(rel <= TOL_SATURATOR_BACK,
              f"{back}_{part} on the path vs its plain pass over {n} "
              f"frames: {rel}")
        out[f"{back}_{part}"] = (max(float((g - w).abs().max())
                                     for g, w in zip(got, want)),
                                 plain_ms, n)
        del got, want
    return out


def phase8_sequential_gradients(torch, Audio, seq, dev, card):
    """Gradients through the saturator multinotch (1-pole and 2-pole, order
    2) and the swept comb on the card, on their backward kernels:
      - against the CPU through the same methods: the saturators over
        SAT_GRAD_CPU_FRAMES frames with respect to the signal and the
        cutoff (their plain loops on the CPU take ~4 ms a step), the comb
        over 10 s with respect to the signal and the feedback, on delays
        of whole samples and a half (its cutoff sr / (2 (D + 1/2))), which
        no rounding moves across an integer;
      - at the forward paths' sizes (the saturators at 10 s, the comb at
        600 s), counted from zero: the backward kernel's launches, wall,
        finite gradients, and its output over the last frames against its
        plain loop on the card, run on the same call's inputs cut to those
        frames (the adjoint runs in reverse time: the last frames need
        nothing before them), and three calls on the cut inputs for the
        same bits; the comb's backward over every frame by one step from
        the call's own later adjoints (comb_backward_step_error).
    The saturator's backward is two kernels of its own with the k x k scan
    between them: each of the three is held to its plain pass (the maps,
    the scan of those maps, and the read-outs on the kernel scan's states)
    over the whole call, on the call's own inputs, and the whole call to
    the plain passes run on the card (saturator_backward_plain).
    Returns the launches (kernel -> count, the forward's and the
    backward's, the k x k scan's under scan_affine_kxk), the backward
    kernels' calls (kernel -> arguments, a whole-length call each; the
    comb's forward on the gradient's delays under
    comb_swept_gradient_forward) and name
    -> (largest absolute error, plain ms, plain frames)."""
    def sat(two_pole):
        def run(a, c):
            cut = (lambda t: c * (1.0 + t))
            if two_pole:
                return a.filter_2pole_multinotch(2, cut, 0.4, 0.7, True, 0.5,
                                                 True)
            return a.filter_1pole_multinotch(2, cut, 0.6, True, 0.5, True)
        return run

    paths = {
        "saturator_1pole": (sat(False), 300.0, SAT_GRAD_CPU_FRAMES,
                            SAT_SECONDS),
        "saturator_2pole": (sat(True), 300.0, SAT_GRAD_CPU_FRAMES,
                            SAT_SECONDS),
        "comb_swept": (lambda a, c: a.filter_comb(comb_cut, c, 0.5), 0.5,
                       int(FILTER_CPU_SECONDS * SR), MULTINOTCH_SECONDS)}
    from flan_tpu_torch.ops import scan_kernels
    launches, back_args, out = {"scan_affine_kxk": 0}, {}, {}
    for name, (run, c0, cpu_frames, seconds) in paths.items():
        back = f"{name}_backward"
        x = stereo_signal(FILTER_CPU_SECONDS)[:, :cpu_frames] * 3.0
        grads = {}
        for device in ("cpu", dev):
            v = torch.from_numpy(x).to(device).requires_grad_()
            c = torch.tensor(c0, device=device, requires_grad=True)
            y = run(Audio.create_from_array(v, SR), c).data
            grads[str(device)] = [g.cpu().double() for g in
                                  torch.autograd.grad((y * y).sum(), (v, c))]
        (gv, gc), (wv, wc) = grads[str(dev)], grads["cpu"]
        e = {"frames": cpu_frames,
             "signal_grad_err_max": float((gv - wv).abs().max()
                                          / wv.abs().max()),
             "param_grad_err": float((gc - wc).abs() / wc.abs()),
             "param_grad_card": float(gc), "param_grad_cpu": float(wc)}
        print(json.dumps({"phase": 8, "path": f"gradients_{name}_card_vs_cpu",
                          "card": card, **e}), flush=True)
        check(e["signal_grad_err_max"] < TOL_GRAD_CPU
              and e["param_grad_err"] < TOL_GRAD_CPU,
              f"{name}: gradients on the card vs the CPU: {e}")
        # the forward path's size, counted (the saturator's backward runs
        # the k x k scan between its kernels)
        xs = stereo_signal(seconds) * 3.0
        seq.reset_launch_counts()
        kxk0 = scan_kernels.LAUNCHES["scan_affine_kxk"]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        v = torch.from_numpy(xs).to(dev).requires_grad_()
        c = torch.tensor(c0, device=dev, requires_grad=True)
        back_fn = ("comb_swept" if name == "comb_swept"
                   else "saturator") + "_backward_cuda"
        (y, grad), calls = capture_calls(
            [(seq, back_fn)] + ([(seq, "comb_swept_cuda")]
                                if name == "comb_swept" else []),
            lambda: (lambda y: (y, torch.autograd.grad(
                (y * y).sum(), (v, c))))(run(Audio.create_from_array(v, SR),
                                             c).data))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counted = {k: n for k, n in seq.LAUNCHES.items() if n}
        kxk = scan_kernels.LAUNCHES["scan_affine_kxk"] - kxk0
        launches["scan_affine_kxk"] = launches.get("scan_affine_kxk",
                                                   0) + kxk
        if kxk:
            counted["scan_affine_kxk"] = kxk
        backs = ([back] if name == "comb_swept"
                 else [f"{back}_{part}" for part in SAT_PASSES])
        for key in [name] + backs:
            launches[key] = seq.LAUNCHES[key]
        finite = all(bool(torch.isfinite(g).all()) for g in grad)
        del y, grad, v
        check(all(launches[key] == 1 for key in [name] + backs) and finite
              and kxk == (0 if name == "comb_swept" else 1),
              f"{name}: {seconds} s forward and backward: launches "
              f"{counted}, finite {finite}")
        args = calls[back_fn][0]
        if name == "comb_swept":
            back_args[back] = args
            # the forward on these delays, kept for timing
            back_args["comb_swept_gradient_forward"] = \
                calls["comb_swept_cuda"][0]
        else:
            out.update(saturator_pass_checks(torch, seq, args, back_args))
        # the backward's last frames against its plain loop
        p = SEQ_BACK_PLAIN_FRAMES
        if name == "comb_swept":
            gy, delays, k, a, f, ring = args
            cut = tuple(t[..., -p:].contiguous()
                        for t in (gy, delays, k, a)) + (f,)

            def kernel():
                return seq.comb_swept_backward_cuda(*cut, ring)

            def plain():
                return seq.comb_swept_backward_ref(*cut)
            full = seq.comb_swept_backward_cuda(*args)
            # every frame by one step from the call's own later adjoints
            step = seq.comb_backward_step_error(*args[:5], full)
            print(json.dumps({"phase": 8, "kernel": back,
                              "check": "one_step",
                              "frames": int(full.shape[1]),
                              "of_frames": int(gy.shape[1]),
                              "err_rel": step}), flush=True)
            check(full.shape == gy.shape and step <= TOL_COMB_BACK,
                  f"{back} on the path, every frame by one step: {step}")
            full = full[:, -p:]
            tol = TOL_COMB_BACK
        else:
            gy, x_, planes, y_, states, inv, order, two_pole = args
            s0 = gy.shape[1] - p - 1     # the frame before: prev and states
            cut = (gy[:, s0:].contiguous(), x_[:, s0:].contiguous(),
                   tuple(q[s0:].contiguous() for q in planes),
                   y_[:, s0:].contiguous(), states[..., s0:].contiguous(),
                   inv, order, two_pole)

            def kernel():
                return seq.saturator_backward_cuda(*cut)

            def plain():
                gx, gp = seq.saturator_backward_ref(*cut)
                return torch.cat([gx[:, 1:, None], gp[..., 1:].transpose(
                    1, 2)], dim=2)
            gx, gp = seq.saturator_backward_cuda(*args)
            # the whole call against the plain passes on the card
            wx, wp = seq.saturator_backward_plain(*args)
            rel_whole = max(float((g - w).abs().max()
                                  / w.abs().max().clamp(min=1e-30))
                            for g, w in zip((gx,) + tuple(gp.unbind(1)),
                                            (wx,) + tuple(wp.unbind(1))))
            del wx, wp
            print(json.dumps({"phase": 8, "kernel": f"{back}_call",
                              "against": "saturator_backward_plain",
                              "frames": int(gx.shape[1]),
                              "err_rel": rel_whole}), flush=True)
            check(rel_whole <= TOL_SATURATOR_BACK,
                  f"{back}_call vs its plain passes over "
                  f"{gx.shape[1]} frames: {rel_whole}")
            full = torch.cat([gx[:, -p:, None],
                              gp[..., -p:].transpose(1, 2)], dim=2)
            tol = TOL_SATURATOR_BACK
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        want = plain()
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t0) * 1e3
        # each gradient (the signal's, each plane's) over its own peak
        err = (full - want).abs()
        peaks = want.abs().amax(dim=tuple(range(want.ndim - 1)),
                                keepdim=True) if want.ndim == 3 else \
            want.abs().max()
        rel = float((err / peaks.clamp(min=1e-30)).max())
        # the comb's kernel, or the saturator's whole backward (its two
        # kernels and the scan)
        key = back if name == "comb_swept" else f"{back}_call"
        check_same_bits(torch, kernel, key)
        print(json.dumps({"phase": 8, "kernel": key, "frames": p,
                          "of_frames": int(gy.shape[1]), "err_rel": rel,
                          "plain_ms": plain_ms, "wall_s_fwd_bwd": wall,
                          "launches": counted}), flush=True)
        check(rel <= tol, f"{key} on the path vs its plain loop over the "
              f"last {p} frames: {rel}")
        out[key] = (float(err.max()), plain_ms, p)
    return launches, back_args, out


def phase8_gradients(torch, Audio, scan_kernels, dev, card):
    """Gradients of the energy on the card against the CPU at 10 s stereo,
    with respect to the signal and to a cutoff given as a 0-d tensor:
    through a swept 2-pole lowpass of order 2 (the 2 x 2 scan and its
    backward), whose gradient is smooth, held by its largest difference;
    then through the lowpass and the compressor (the max-affine and linear
    scans' backwards), held by the relative L2 norm of the difference and
    by the cutoff's gradient: the compressor's peak detector takes the
    branch that wins a max, and where the two branches meet within the
    float32 rounding of two devices' scans, the two gradients part from
    that sample back over the detector's decay (TOL_GRAD_SWITCH_L2). The
    launch counters show the backward on the kernels."""
    x10 = stereo_signal(FILTER_CPU_SECONDS)
    paths = {
        "lowpass": lambda a, c: a.filter_2pole_lowpass(
            lambda t: c * (1.0 + t / 10.0), 0.5, 2),
        "lowpass_compress": lambda a, c: a.filter_2pole_lowpass(
            lambda t: c * (1.0 + t / 10.0), 0.5, 2).compress(
                -18.0, 4.0, 0.005, 0.1, 6.0)}
    report = {}
    back_all = dict.fromkeys(scan_kernels.LAUNCHES, 0)
    for name, run in paths.items():
        grads, counts = {}, {}
        for device in ("cpu", dev):
            v = torch.from_numpy(x10).to(device).requires_grad_()
            c = torch.tensor(1200.0, device=device, requires_grad=True)
            before = dict(scan_kernels.LAUNCHES)
            y = run(Audio.create_from_array(v, SR), c).data
            loss = (y * y).sum()
            forward = {k: scan_kernels.LAUNCHES[k] - before[k]
                       for k in before}
            grads[str(device)] = [g.cpu().double() for g in
                                  torch.autograd.grad(loss, (v, c))]
            counts[str(device)] = {
                "forward": forward,
                "backward": {k: scan_kernels.LAUNCHES[k] - before[k]
                             - forward[k] for k in before}}
        (gv, gc), (wv, wc) = grads[str(dev)], grads["cpu"]
        d = (gv - wv).abs()
        e = {"signal_grad_err_max": float(d.max() / wv.abs().max()),
             "signal_grad_err_l2": float((gv - wv).norm() / wv.norm()),
             "signal_samples_off": int((d > 1e-3 * wv.abs().max()).sum()),
             "cutoff_grad_err": float((gc - wc).abs() / wc.abs()),
             "cutoff_grad_card": float(gc), "cutoff_grad_cpu": float(wc),
             "launches": counts[str(dev)]}
        report[name] = e
        print(json.dumps({"phase": 8, "path": f"gradients_{name}_10s_stereo",
                          "card": card, **e}), flush=True)
        back = counts[str(dev)]["backward"]
        for k in back_all:
            back_all[k] += back[k]
        check(not any(counts["cpu"]["backward"].values()),
              f"{name}: the CPU's backward launched a kernel")
        check(back["scan_affine2x2"] >= 2, f"{name}: the backward did not "
              f"run on the 2 x 2 kernel: {back}")
        smooth = name == "lowpass"
        check(e["cutoff_grad_err"] < (TOL_GRAD_CPU if smooth
                                      else TOL_GRAD_SWITCH_PARAM),
              f"{name}: cutoff gradient on the card vs the CPU: {e}")
        check(e["signal_grad_err_max"] < TOL_GRAD_CPU if smooth
              else e["signal_grad_err_l2"] < TOL_GRAD_SWITCH_L2,
              f"{name}: signal gradient on the card vs the CPU: {e}")
    check(report["lowpass_compress"]["launches"]["backward"]["scan_linear"]
          >= 2, "the compressor's backward did not run on the linear kernel")
    return back_all


def phase8_resample_convolve(torch, Audio, dev, card):
    """Audio.resample 48 -> 44.1 kHz, add_moisture (4x oversampling: two
    resampling passes) and convolve by a 2 s stereo impulse response, at
    600 s stereo: a first call and a second, peak memory; each held to the
    CPU at 10 s."""
    x = stereo_signal(MULTINOTCH_SECONDS)
    x10 = stereo_signal(FILTER_CPU_SECONDS)
    rng = np.random.default_rng(11)
    m = int(IR_SECONDS * SR)
    ir = (rng.standard_normal((2, m)) * np.exp(-np.arange(m) / (0.3 * SR))
          ).astype(np.float32)
    runs = {
        "resample_44k1": (lambda a: a.resample(44100.0), TOL_FILTER_CPU),
        "add_moisture": (lambda a: a.add_moisture(), TOL_MOISTURE_CPU),
        "convolve_2s_ir": (lambda a: a.convolve(Audio.create_from_array(
            ir, SR, device=a.device)), TOL_FILTER_CPU)}
    report = {"phase": 8, "path": "resample_convolve_600s_stereo_48k",
              "card": card}
    for name, (run, tol) in runs.items():
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        y, ms_first = timed(torch, lambda: run(Audio.create_from_array(
            x, SR, device=dev)))
        peak_gb = (torch.cuda.max_memory_allocated() - base) / 1e9
        del y
        y, ms_second = timed(torch, lambda: run(Audio.create_from_array(
            x, SR, device=dev)))
        shape = tuple(y.data.shape)
        finite = bool(torch.isfinite(y.data).all())
        del y
        want = run(Audio.create_from_array(x10, SR, device="cpu")).to_numpy()
        got = run(Audio.create_from_array(x10, SR, device=dev)).to_numpy()
        err = float(np.abs(got - want).max() / np.abs(want).max())
        report[name] = {"wall_s_first": ms_first / 1e3,
                        "wall_s_second": ms_second / 1e3,
                        "x_realtime_second": MULTINOTCH_SECONDS
                        / (ms_second / 1e3),
                        "peak_alloc_gb": peak_gb, "shape": shape,
                        "card_vs_cpu_10s_err_rel": err}
        check(finite, f"{name}: output not finite")
        check(got.shape == want.shape and err < tol,
              f"{name} on the card vs the CPU at 10 s: {err}")
    print(json.dumps(report), flush=True)
    n = x.shape[1]
    check(report["resample_44k1"]["shape"] == (2, int(n * 44100.0 / SR))
          and report["add_moisture"]["shape"] == (2, n)
          and report["convolve_2s_ir"]["shape"] == (2, n + m),
          f"shapes {[report[k]['shape'] for k in runs]}")
    return report


def delay_sweeps():
    """Phase 9's swept stereo delays: (name, l_time, r_time): 0.05-0.55 s
    against 0.05-0.95 s (rings of ~26,400 and ~45,600 floats: in device
    memory), 5-40 ms against 5-40 ms (in shared memory), and a flanger's
    0.2-0.6 ms (10-29 samples: rounds of ~11 steps)."""
    import torch
    two_pi = 2.0 * math.pi
    return [("stereo_delay_swept",
             lambda t: 0.30 + 0.25 * torch.sin(two_pi * 0.05 * t),
             lambda t: 0.50 + 0.45 * torch.sin(two_pi * 0.07 * t)),
            ("stereo_delay_swept_short",
             lambda t: 0.0225 + 0.0175 * torch.sin(two_pi * 0.05 * t),
             lambda t: 0.0225 + 0.0175 * torch.cos(two_pi * 0.07 * t)),
            ("stereo_delay_swept_flanger",
             lambda t: 0.0004 + 0.0002 * torch.sin(two_pi * 0.25 * t),
             lambda t: 0.0004 + 0.0002 * torch.cos(two_pi * 0.3 * t))]


def effect_calls():
    """Phase 9's calls: name -> call on an Audio."""
    import torch
    two_pi = 2.0 * math.pi
    calls = {
        "cut_fade_reverse_mono_stereo": lambda a: a.cut(
            0.25, a.length - 0.25, 0.1, 0.1).fade(0.5, 0.7).reverse()
        .convert_to_mono().convert_to_stereo(),
        "repitch_constant": lambda a: a.repitch(1.5),
        "repitch_swept": lambda a: a.repitch(
            lambda t: 2.0 ** (0.5 * torch.sin(two_pi * 0.05 * t))),
        "stereo_delay_constant": lambda a: a.stereo_delay(
            a.length, 0.25, 0.4, 0.5),
        "pan_swept": lambda a: a.pan(lambda t: torch.sin(two_pi * 0.1 * t)),
        "widen": lambda a: a.widen(0.5),
        "stereo_spatialize": lambda a: a.convert_to_mono().stereo_spatialize(
            lambda t: (5.0 * math.cos(two_pi * 0.02 * t),
                       0.5 + 3.0 * math.sin(two_pi * 0.02 * t))),
        "filter_pinna": lambda a: a.filter_pinna(
            lambda t: 2.0 * torch.sin(two_pi * 0.05 * t)),
    }
    for name, lt, rt in delay_sweeps():
        calls[name] = (lambda a, lt=lt, rt=rt:
                       a.stereo_delay(a.length, lt, rt, 0.5))
    return calls


def stereo_delay_depth(el: np.ndarray, er: np.ndarray) -> float:
    """The rounds the stereo delay's loop order allows, as the comb's bound
    counts them: the sum over frames of 1 / the nearer of the frame's two
    reads (er, and el where it is not the frame's own write)."""
    d = np.minimum(er, np.where(el > 0, el, np.iinfo(np.int64).max))
    return float((1.0 / d).sum())


def phase9_effects(torch, Audio, seq, scan, scan_kernels, dev, card):
    """The effect chain at EFFECT_SECONDS stereo. First its comparisons:
    each call on a 10 s cut on the card and on the CPU (within
    TOL_FILTER_CPU of the peak) and the information's
    (phase9_information_checks). Then the path, its launch counts zeroed
    just before it and read just after it: each call once at full size on
    the card, timed (wall, x realtime, peak memory), its host plan
    (repitch's and the spatialiser's WDL loops) timed apart, then the
    wavelengths, the amplitude envelope and the energy. Then the checks on
    the path's own calls: the stereo delay kernel's (phase9_delay_checks)
    and the first call of each scan kernel in each effect call against its
    plain version (phase9_scan_checks). Returns the path's launches, the
    stereo delay's captured kernel calls, each scan kernel's largest
    absolute error and the report."""
    from flan_tpu_torch.audio import spatial, temporal
    x = stereo_signal(EFFECT_SECONDS)
    x10 = stereo_signal(FILTER_CPU_SECONDS)
    report = {"phase": 9, "path": "effect_chain_600s_stereo_48k",
              "card": card}
    calls = effect_calls()
    cpu_err = {}
    for name, run in calls.items():
        want = run(Audio.create_from_array(x10, SR, device="cpu")).to_numpy()
        got = run(Audio.create_from_array(x10, SR, device=dev)).to_numpy()
        cpu_err[name] = float(np.abs(got - want).max() / np.abs(want).max())
        check(got.shape == want.shape and cpu_err[name] < TOL_FILTER_CPU,
              f"{name} on the card vs the CPU at 10 s: {cpu_err[name]}")
    report["wavelengths_10s"] = phase9_information_checks(torch, Audio, dev,
                                                          x10)
    plan_s = {}

    def timing(module, name):
        fn = getattr(module, name)

        def call(*args, **kwargs):
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            plan_s.setdefault(name, []).append(time.perf_counter() - t0)
            return out
        return call

    plans = [(temporal, "_wdl_sinc_plan"), (spatial, "_wdl_feed_plan")]
    originals = [(m, n, getattr(m, n)) for m, n in plans]
    # the first call of the stereo delay kernel and of each scan kernel in
    # each effect call
    targets = [(seq, "stereo_delay_swept_cuda"),
               (scan, "scan_linear"), (scan, "scan_affine2x2")]
    delay_calls, scan_calls9 = [], []
    seq.reset_launch_counts()
    scan_kernels.reset_launch_counts()
    for name, run in calls.items():
        for m, n, _ in originals:
            setattr(m, n, timing(m, n))
        plan_s.clear()
        try:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            (y, kept), ms = timed(torch, lambda: capture_calls(
                targets, lambda: run(Audio.create_from_array(x, SR,
                                                             device=dev))))
        finally:
            for m, n, fn in originals:
                setattr(m, n, fn)
        if name.startswith("stereo_delay_swept"):
            delay_calls.append((name, kept["stereo_delay_swept_cuda"][0],
                                y.data, seq.VARIANTS["stereo_delay_swept"]))
        scans = [k for k in ("scan_linear", "scan_affine2x2") if kept[k]]
        scan_calls9 += [(name, k, kept[k][0]) for k in scans]
        entry = {"seconds": EFFECT_SECONDS, "wall_s": ms / 1e3,
                 "x_realtime": EFFECT_SECONDS / (ms / 1e3),
                 "peak_alloc_gb": (torch.cuda.max_memory_allocated() - base)
                 / 1e9, "shape": tuple(y.data.shape),
                 "card_vs_cpu_10s_err_rel": cpu_err[name],
                 "host_plan_s": {k: sum(v) for k, v in plan_s.items()},
                 "scans": scans}
        check(bool(torch.isfinite(y.data).all()), f"{name}: not finite")
        report[name] = entry
        print(json.dumps({"phase": 9, name: entry}), flush=True)
        del y, kept
    report.update(phase9_information(torch, Audio, dev, x))
    a = Audio.create_from_array(x, SR, device=dev)
    energy, ms = timed(torch, a.get_total_energy)
    del a
    launches = {"stereo_delay_swept": seq.LAUNCHES["stereo_delay_swept"],
                **{k: scan_kernels.LAUNCHES[k] for k in SCANS}}
    report["launches"] = launches
    check(launches["stereo_delay_swept"] == len(delay_sweeps()),
          f"the effect chain launched stereo_delay_swept "
          f"{launches['stereo_delay_swept']} times, not once a swept delay")
    check(launches["scan_linear"] > 0 and launches["scan_affine2x2"] > 0,
          f"the effect chain's scans did not both run: {launches}")
    # the energy against the CPU's
    want = Audio.create_from_array(x, SR, device="cpu").get_total_energy()
    err = float(np.abs(energy - want).max() / np.abs(want).max())
    report["get_total_energy"] = {"wall_s": ms / 1e3, "err_rel_cpu": err}
    check(err < TOL_FILTER_CPU, f"get_total_energy vs the CPU: {err}")
    # the constant repitch moves a 440 Hz tone to 660 Hz
    tone = np.sin(2 * np.pi * 440.0 * np.arange(int(2 * SR)) / SR)
    up = Audio.create_from_array(tone.astype(np.float32), SR,
                                 device=dev).repitch(1.5).to_numpy()[0]
    hz = dominant_hz(up[len(up) // 4:3 * len(up) // 4])
    report["repitch_440_hz"] = hz
    check(abs(hz - 660.0) < 2.0, f"440 Hz repitched by 1.5 sounds at {hz}")
    report["stereo_delay_checks"] = phase9_delay_checks(torch, seq,
                                                        delay_calls)
    report["scan_checks"], scan_errs = phase9_scan_checks(
        torch, scan_kernels, scan_calls9)
    print(json.dumps(report), flush=True)
    return (launches, [(n, args, y) for n, args, y, _ in delay_calls],
            scan_errs, report)


def phase9_information(torch, Audio, dev, x) -> dict:
    """get_local_wavelengths of one channel (window 2048, hop 128) and the
    amplitude envelope at EFFECT_SECONDS, timed."""
    out = {}
    a = Audio.create_from_array(x, SR, device=dev)
    wl, ms = timed(torch, lambda: a.get_local_wavelengths(0, 0, -1, 2048, 128))
    out["get_local_wavelengths"] = {"wall_s": ms / 1e3, "hops": len(wl),
                                    "x_realtime": EFFECT_SECONDS
                                    / (ms / 1e3)}
    check(np.isfinite(wl).all() and (wl > 0).mean() > 0.5,
          "wavelengths at 600 s: not finite, or mostly unvoiced")
    t = torch.arange(0, int(EFFECT_SECONDS * SR), 997, device=dev) / SR
    env, ms = timed(torch, lambda: a.get_amplitude_envelope(0.1)(t))
    out["get_amplitude_envelope"] = {"wall_s": ms / 1e3}
    check(bool(torch.isfinite(env).all()), "amplitude envelope not finite")
    return out


def phase9_information_checks(torch, Audio, dev, x10) -> dict:
    """The wavelengths (window 2048, hop 128) and the amplitude envelope at
    10 s against the CPU: d' on the card within twice the float32 CPU
    run's error against float64 (and a floor of 1e-6), the wavelengths
    equal within WAVELENGTH_REL but for the hops whose valley flips,
    counted and gated at WAVELENGTH_FLIPS; the envelope within
    TOL_FILTER_CPU."""
    from flan_tpu_torch.ops import dsp_utility
    a_card = Audio.create_from_array(x10, SR, device=dev)
    a_cpu = Audio.create_from_array(x10, SR, device="cpu")
    got = a_card.get_local_wavelengths(0, 0, -1, 2048, 128)
    want = a_cpu.get_local_wavelengths(0, 0, -1, 2048, 128)
    check(got.shape == want.shape, "wavelength hops differ")
    flips = int((np.abs(got - want) > WAVELENGTH_REL
                 * np.maximum(np.abs(want), 1.0)).sum())
    n = int(x10.shape[1])
    starts = np.arange(0, n - 2048, 128)
    win = np.stack([x10[0, s:s + 2048] for s in starts])
    d_card = dsp_utility.yin_d_prime_batched(
        torch.from_numpy(win).to(dev), window_size=2048).cpu().double()
    d32 = dsp_utility.yin_d_prime_batched(torch.from_numpy(win),
                                          window_size=2048).double()
    d64 = dsp_utility.yin_d_prime_batched(
        torch.from_numpy(win).double(), window_size=2048)
    peak = float(d64.abs().max())
    e_card = float((d_card - d64).abs().max()) / peak
    e_cpu = float((d32 - d64).abs().max()) / peak
    tg = torch.linspace(0.0, FILTER_CPU_SECONDS, 4001)
    env_card = a_card.get_amplitude_envelope(0.1)(tg.to(dev)).cpu()
    env_cpu = a_cpu.get_amplitude_envelope(0.1)(tg)
    e_env = float((env_card - env_cpu).abs().max() / env_cpu.abs().max())
    out = {"hops": len(want), "flipped_hops": flips,
           "d_prime_err_card": e_card, "d_prime_err_cpu32": e_cpu,
           "envelope_err_rel": e_env}
    check(flips <= WAVELENGTH_FLIPS * len(want),
          f"{flips} of {len(want)} wavelength hops flip between card and CPU")
    check(e_card <= 2.0 * e_cpu + 1e-6,
          f"d' on the card {e_card} of the peak from float64, CPU {e_cpu}")
    check(e_env < TOL_FILTER_CPU, f"envelope card vs CPU: {e_env}")
    return out


def delay_host_reads(name: str, n: int):
    """(dl, dr, el, er, lb, rb) of delay_sweeps' call `name` over n frames
    on the host, as the JAX package takes them (flan_tpu/audio/
    temporal.py:457-461): the float32 samples widened, times the rate,
    truncated, clamped; el and er by stereo_delay_distances."""
    from flan_tpu_torch.audio import temporal
    from flan_tpu_torch.func.function import as_function
    from flan_tpu_torch.ops import sequential_kernels as seq
    _, lt, rt = next(c for c in delay_sweeps() if c[0] == name)
    lt_s, rt_s = (np.asarray(temporal.sample_delay_times(
        as_function(f), n, SR), np.float64) for f in (lt, rt))
    lb, rb = int(lt_s.max() * SR), int(rt_s.max() * SR)
    dl = np.minimum(np.maximum((lt_s * SR).astype(np.int64), 0), lb)
    dr = np.minimum(np.maximum((rt_s * SR).astype(np.int64), 0), rb)
    return (dl, dr) + seq.stereo_delay_distances(dl, dr, lb, rb) + (lb, rb)


def phase9_delay_checks(torch, seq, delay_calls) -> dict:
    """The stereo delay kernel on the path's own swept calls: the reads'
    distances the card worked out against the host's (the JAX package's
    rule on the same samples) over every frame, and the rings; rerun
    keeping w (its output the path's bits), every frame by one step in
    float64 within TOL_DELAY; over the first DELAY_PLAIN_FRAMES frames,
    its writes and outputs against the loop itself step by step on the
    host (stereo_delay_loop on the host's delays: it shares no distance or
    round with the kernel) and against the plain version on the card, each
    within TOL_DELAY of the writes' peak; three calls for the same bits;
    the variant each took. These launches are comparisons, after the
    count."""
    out = {}
    for name, args, y, variant in delay_calls:
        x, g, el, er, lb, rb = args
        n = int(x.shape[1])
        dl, dr, el_h, er_h, lb_h, rb_h = delay_host_reads(name, n)
        reads_equal = bool((lb, rb) == (lb_h, rb_h)
                           and np.array_equal(el.cpu().numpy(), el_h)
                           and np.array_equal(er.cpu().numpy(), er_h))
        rounds = torch.zeros(1, dtype=torch.int32, device=x.device)
        got, w = seq.stereo_delay_swept_cuda(*args, keep_w=True,
                                             rounds=rounds)
        check(torch.equal(got, y), f"{name}: rerun keeping w differs")
        step = seq.stereo_delay_step_errors(x, g, el, er, lb, rb, w)
        m = DELAY_PLAIN_FRAMES
        t0 = time.perf_counter()
        want, w_want = seq.stereo_delay_ref(x[:, :m].contiguous(), g[:m],
                                            el[:m], er[:m], lb, rb,
                                            keep_w=True)
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t0) * 1e3
        t0 = time.perf_counter()
        loop, w_loop = seq.stereo_delay_loop(
            x[:, :m].cpu().numpy(), g[:m].cpu().numpy(), dl[:m], dr[:m], lb,
            rb)
        loop_s = time.perf_counter() - t0
        # the outputs are the writes shifted by the rings (zeros for their
        # first lb and rb frames): both held, to the writes' peak
        abs_err = max(float((w[:, :m] - w_want).abs().max()),
                      float((y[:, :m] - want).abs().max()))
        loop_abs = max(float(np.abs(w[:, :m].cpu().numpy() - w_loop).max()),
                       float(np.abs(y[:, :m].cpu().numpy() - loop).max()))
        err = abs_err / float(w_want.abs().max())
        loop_err = loop_abs / float(np.abs(w_loop).max())
        check_same_bits(torch, lambda: seq.stereo_delay_swept_cuda(*args),
                        name)
        out[name] = {"frames": n, "lb": lb, "rb": rb,
                     "variant": variant, "rounds": int(rounds),
                     "reads_equal_host": reads_equal,
                     "step_err": step, "plain_err": err,
                     "plain_abs_err": abs_err, "plain_ms": plain_ms,
                     "loop_err": loop_err, "loop_abs_err": loop_abs,
                     "loop_s": loop_s, "plain_frames": m}
        check(reads_equal, f"{name}: the card's reads differ from the "
              "host's")
        check(max(step.values()) <= TOL_DELAY,
              f"{name}: a frame off one step from its own writes: {step}")
        check(err <= TOL_DELAY, f"{name} vs its plain version: {err}")
        check(loop_err <= TOL_DELAY, f"{name} vs the loop: {loop_err}")
    check([v["variant"] for v in out.values()] ==
          ["wide_device", "wide_shared", "narrow_shared"],
          "the swept delays did not take the variants delay_sweeps names")
    return out


def delay_gradient(torch, Audio, x, dev, lt, rt, weight, seconds):
    """The gradient of sum(weight * y), y a swept Audio.stereo_delay of x
    (decay 0.5 as a 0-d parameter), in the signal and the decay."""
    v = torch.from_numpy(x).to(dev).requires_grad_()
    d = torch.tensor(0.5, device=dev, requires_grad=True)
    y = Audio.create_from_array(v, SR).stereo_delay(seconds, lt, rt, d).data
    return torch.autograd.grad((y * weight.to(dev)).sum(), (v, d))


def phase9_delay_gradients(torch, Audio, seq, dev) -> dict:
    """The swept stereo delays' gradients. First each at FILTER_CPU_SECONDS
    on the card against the CPU (the plain versions), within
    TOL_GRAD_CPU of each gradient's peak. Then the path, its counts zeroed
    just before it and read just after: one gradient call a sweep at
    EFFECT_SECONDS stereo, timed (wall), each launching the forward kernel
    and the backward kernel once; then the backward kernel on the path's
    own calls (phase9_backward_checks). Returns the launches, the
    backward's captured calls and the report."""
    report = {}
    x10 = stereo_signal(FILTER_CPU_SECONDS)
    w10 = torch.from_numpy(stereo_signal(FILTER_CPU_SECONDS, seed=7))
    for name, lt, rt in delay_sweeps():
        got, want = (delay_gradient(torch, Audio, x10, d, lt, rt, w10,
                                    FILTER_CPU_SECONDS) for d in (dev, "cpu"))
        errs = [float((a.cpu() - b).abs().max()
                      / b.abs().max().clamp(min=1e-30))
                for a, b in zip(got, want)]
        report[name] = {"card_vs_cpu_10s_grad_err_rel": {
            "x": errs[0], "decay": errs[1]}}
        check(max(errs) < TOL_GRAD_CPU,
              f"{name}: the gradient on the card vs the CPU at 10 s: {errs}")
    x = stereo_signal(EFFECT_SECONDS)
    weight = torch.from_numpy(stereo_signal(EFFECT_SECONDS, seed=7))
    calls = []
    seq.reset_launch_counts()
    for name, lt, rt in delay_sweeps():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        grads, kept = capture_calls(
            [(seq, "stereo_delay_swept_backward_cuda")],
            lambda: delay_gradient(torch, Audio, x, dev, lt, rt, weight,
                                   EFFECT_SECONDS))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        check(all(bool(torch.isfinite(gr).all()) for gr in grads),
              f"{name}: the gradient at 600 s is not finite")
        report[name]["gradient_wall_s"] = wall
        report[name]["variant_backward"] = seq.VARIANTS[
            "stereo_delay_swept_backward"]
        calls.append((name, kept["stereo_delay_swept_backward_cuda"][0]))
        del grads
    launches = {k: seq.LAUNCHES[k] for k in ("stereo_delay_swept",
                                             "stereo_delay_swept_backward")}
    report["launches"] = launches
    check(launches == {"stereo_delay_swept": len(delay_sweeps()),
                       "stereo_delay_swept_backward": len(delay_sweeps())},
          f"the delays' gradients launched {launches}, not one forward and "
          "one backward a sweep")
    report["backward_checks"] = phase9_backward_checks(torch, seq, calls)
    print(json.dumps({"phase": 9, "stereo_delay_gradients": report}),
          flush=True)
    return launches, calls, report


def phase9_backward_checks(torch, seq, calls) -> dict:
    """The backward kernel on the path's own gradient calls: rerun (three
    calls, the same bits), every frame by one step in float64 from its own
    later values within TOL_DELAY_BACK; over the last DELAY_PLAIN_FRAMES
    frames (the adjoint runs in reverse time: nothing before them reaches
    them) against its plain version on the card and against the adjoint
    step by step on the host (stereo_delay_backward_loop on the host's
    delays), each within TOL_DELAY_BACK of the peak."""
    out = {}
    for name, args in calls:
        args = tuple(a.detach() if torch.is_tensor(a) else a for a in args)
        gout, g, el, er, lb, rb = args
        n = int(gout.shape[1])
        rounds = torch.zeros(1, dtype=torch.int32, device=gout.device)
        gw = seq.stereo_delay_swept_backward_cuda(*args, rounds=rounds)
        step = seq.stereo_delay_backward_step_error(gout, g, el, er, lb, rb,
                                                    gw)
        m = min(DELAY_PLAIN_FRAMES, n)
        sl = slice(n - m, n)
        t0 = time.perf_counter()
        want = seq.stereo_delay_backward_ref(
            gout[:, sl].contiguous(), g[sl], el[sl], er[sl], lb, rb)
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t0) * 1e3
        dl, dr = delay_host_reads(name, n)[:2]
        t0 = time.perf_counter()
        loop = seq.stereo_delay_backward_loop(
            gout[:, sl].cpu().numpy(), g[sl].cpu().numpy(), dl[sl], dr[sl],
            lb, rb)
        loop_s = time.perf_counter() - t0
        abs_err = float((gw[:, sl] - want).abs().max())
        loop_abs = float(np.abs(gw[:, sl].cpu().numpy() - loop).max())
        err = abs_err / max(float(want.abs().max()), 1e-30)
        loop_err = loop_abs / max(float(np.abs(loop).max()), 1e-30)
        check_same_bits(torch, lambda: seq.stereo_delay_swept_backward_cuda(
            *args), f"{name} backward")
        out[name] = {"frames": n, "rounds": int(rounds),
                     "variant": seq.VARIANTS["stereo_delay_swept_backward"],
                     "step_err": step, "plain_err": err,
                     "plain_abs_err": abs_err, "plain_ms": plain_ms,
                     "loop_err": loop_err, "loop_abs_err": loop_abs,
                     "loop_s": loop_s, "plain_frames": m}
        check(max(step.values()) <= TOL_DELAY_BACK,
              f"{name} backward: a frame off one step: {step}")
        check(err <= TOL_DELAY_BACK,
              f"{name} backward vs its plain version: {err}")
        check(loop_err <= TOL_DELAY_BACK,
              f"{name} backward vs the loop: {loop_err}")
    return out


def phase9_scan_checks(torch, scan_kernels, scan_calls9):
    """The first call of each scan kernel in each effect call, on the
    path's own operands (the constant delay's rows of ceil(n / rb) frames,
    the pinna's bandshelves at full length): the kernel's error against
    the float64 plain run at most twice the float32 plain run's, plus
    SCAN_FLOOR on rows shorter than the call (where both sit at rounding,
    as phase 2's short cases), and three calls for the same bits, as phase
    6 holds the filters'. Returns the errors and each kernel's largest
    absolute difference from its float32 plain run."""
    out, errs = {}, {}
    for call, name, args in scan_calls9:
        kernel, plain = scan_calls(scan_kernels)[name]
        e = scan_errors(torch, kernel, plain, args)
        e["shape"] = tuple(torch.broadcast_shapes(*(a.shape for a in args)))
        out[f"{call}/{name}"] = e
        full = e["shape"][-1] >= int(EFFECT_SECONDS * SR)
        check_scan(e, f"{name} in {call}", 0.0 if full else SCAN_FLOOR)
        check_same_bits(torch, lambda: kernel(*args), f"{name} in {call}")
        errs[name] = max(errs.get(name, 0.0), e["abs_err"])
    return out, errs


def spline_ramp(seconds: float):
    """stretch_spline's swept expansion on a PV of `seconds`: 1 + t /
    (seconds / 2), as a multiplication (torch's CUDA division by a number
    multiplies by its rounded reciprocal, the CPU's divides)."""
    inv = 2.0 / seconds

    def ramp(t):
        return 1.0 + t * inv
    return ramp


def pv_family_calls(seconds: float) -> dict:
    """The PV family's calls on a PV of `seconds`, each a function of the
    PV: desample by a per-bin ratio, a 50 ms smear of granularity 3,
    time_extrapolate at 300 -> 310 s, 30 s on (scaled to the PV's length),
    stretch_spline by 2 and by spline_ramp, and modify by the form of
    algo_modify_warp (tests/test_algo_golden.py:133-138) scaled to the PV's
    length: u = t / length, t' = 0.8 t (1 + 0.125 u) + 1.1e-4 f u, f' = f
    (0.9 - 0.25 u) + 125 (under 600 s of output, about half a frame of time
    shift a bin). The maps multiply by reciprocals, so that both devices
    compute them alike: modify's inverse bilinear solve cancels on such
    thin quads and turns an ulp of a mapped corner into whole percents of
    a cell's weights."""
    scale = seconds / 600.0
    inv_len = 1.0 / seconds

    def ratio(t, f):
        return 0.25 + 0.5 * f * (1.0 / 24000.0)

    def warp(t, f):
        u = t * inv_len
        return (0.8 * t * (1.0 + 0.125 * u) + 1.1e-4 * f * u,
                f * (0.9 - 0.25 * u) + 125.0)
    ramp = spline_ramp(seconds)
    return {
        "desample": lambda pv: pv.desample(ratio),
        "smear_time": lambda pv: pv.smear_time(0.05, 3),
        "time_extrapolate": lambda pv: pv.time_extrapolate(
            300.0 * scale, 310.0 * scale, 30.0 * scale),
        "stretch_spline_2": lambda pv: pv.stretch_spline(2.0),
        "stretch_spline_ramp": lambda pv: pv.stretch_spline(ramp),
        "modify": lambda pv: pv.modify(warp)}


def natural_spline_matrix(xs: np.ndarray, ts: np.ndarray) -> np.ndarray:
    """W [T, F] float64 with W @ y the natural cubic spline through (xs, y)
    evaluated at ts, by a dense solve: a copy of the JAX package's
    flan_tpu/pv/modify_extra.py _natural_spline_matrix, the check of the
    port's band solve."""
    n = len(xs)
    h = np.diff(xs)
    A = np.zeros((n, n))
    B = np.zeros((n, n))
    A[0, 0] = 1.0
    A[-1, -1] = 1.0
    for i in range(1, n - 1):
        A[i, i - 1] = h[i - 1] / 6.0
        A[i, i] = (h[i - 1] + h[i]) / 3.0
        A[i, i + 1] = h[i] / 6.0
        B[i, i - 1] = 1.0 / h[i - 1]
        B[i, i] = -1.0 / h[i - 1] - 1.0 / h[i]
        B[i, i + 1] = 1.0 / h[i]
    Minv = np.linalg.solve(A, B)
    idx = np.clip(np.searchsorted(xs, ts, side="right") - 1, 0, n - 2)
    x0 = xs[idx]
    hi = xs[idx + 1] - x0
    u = (ts - x0) / hi
    W = np.zeros((len(ts), n))
    rows = np.arange(len(ts))
    W[rows, idx] += (1 - u)
    W[rows, idx + 1] += u
    W += (hi * hi / 6.0 * ((1 - u) ** 3 - (1 - u)))[:, None] * Minv[idx]
    W += (hi * hi / 6.0 * (u ** 3 - u))[:, None] * Minv[idx + 1]
    return W


def spline_expansions(torch, expansion, frames: int, rate: float):
    """Per-frame integer expansions as stretch_spline takes them: a number,
    or the function on the float32 frame times, truncated, at least 1."""
    if not callable(expansion):
        return np.full(frames, int(expansion), np.int64)
    t = torch.tensor(np.arange(frames, dtype=np.float64) / rate,
                     dtype=torch.float32)
    return np.maximum(expansion(t).numpy().astype(np.int64), 1)


def plane_errors(got, want) -> float:
    """The largest difference of two PVs' planes, as a share of each of
    want's planes' peak; inf where the shapes differ."""
    if got.mag.shape != want.mag.shape:
        return math.inf
    return max(float((a.cpu() - b.cpu()).abs().max())
               / max(float(b.abs().max()), 1e-30)
               for a, b in ((got.mag, want.mag), (got.freq, want.freq)))


def bins_apart(torch, pk, i_f, i_m, log2_min: float):
    """(contributions, of them on another bin through the card's float32
    log2 than through the float64 one the kernel and the plain version
    take) for the peaks i_f, i_m [F, K] on the card."""
    live = ((i_m > 0) & (i_f > 0))[..., None].expand(-1, -1, pk.NH)
    h = torch.arange(1, pk.NH + 1, dtype=torch.float32, device=i_f.device)
    sub = torch.clamp(i_f[..., None] / h, min=1e-9)
    f32 = torch.round(120.0 * (torch.log2(sub) - log2_min)).long()
    return (int(live.sum()),
            int((f32 != pk.subharmonic_bins(i_f, log2_min))[live].sum()))


def phase10_cpu_checks(torch, Audio, pv_from_numpy, pk, information, dev,
                       card):
    """The PV family on one 10 s PV on the card and the same planes on the
    CPU: each call within TOL_PV_CPU of the CPU's planes, get_salience
    within TOL_SALIENCE_CPU (its contributions that the card's float32
    log2 would put on another bin counted), get_contours (the same
    contours) and prism (within TOL_SALIENCE_CPU); and stretch_spline
    against the float64 dense spline (the copy of _natural_spline_matrix):
    the card's error at most twice the CPU's float32 plain run's. Prints
    the report, then fails on any check that did not hold."""
    x = stereo_signal(PV_FAMILY_CPU_SECONDS)
    pv = Audio.create_from_array(x, SR, device=dev).convert_to_PV(
        2048, 128, 4096)
    m, f = pv.to_numpy()
    cpu = pv_from_numpy(m, f, SR, 128, 2048, device="cpu")
    report = {"phase": 10, "path": "pv_family_10s_card_vs_cpu", "card": card}
    failed = []

    def expect(cond, msg):
        if not cond:
            failed.append(msg)
    outs = {}
    for name, run in pv_family_calls(PV_FAMILY_CPU_SECONDS).items():
        got, want = run(pv), run(cpu)
        err = plane_errors(got, want)
        report[name] = {"err_rel": err, "shape": tuple(got.mag.shape)}
        expect(err <= TOL_PV_CPU, f"{name} on the card vs the CPU at 10 s: "
               f"{err} (shapes {tuple(got.mag.shape)}, "
               f"{tuple(want.mag.shape)})")
        if name.startswith("stretch_spline"):
            outs[name] = (got, want)
        del got, want
    # the spline against the float64 dense solve of the same system
    for name, expansion in (("stretch_spline_2", 2.0),
                            ("stretch_spline_ramp",
                             spline_ramp(PV_FAMILY_CPU_SECONDS))):
        exp = spline_expansions(torch, expansion, pv.num_frames,
                                pv.analysis_rate)
        xs = np.concatenate([[0.0], np.cumsum(exp[:-1], dtype=np.float64)])
        w = torch.from_numpy(natural_spline_matrix(
            xs, np.arange(int(xs[-1]), dtype=np.float64))).to(dev)
        got, want = outs[name]
        errs = {}
        for plane in ("mag", "freq"):
            y64 = torch.einsum("tf,cfb->ctb", w,
                               getattr(pv, plane).double())
            peak = float(y64.abs().max())
            e_card = float((getattr(got, plane).double() - y64).abs().max())
            e_cpu = float((getattr(want, plane).double().to(dev)
                           - y64).abs().max())
            errs[plane] = {"err_card": e_card / peak, "err_plain": e_cpu
                           / peak}
            expect(e_card <= 2.0 * e_cpu + 1e-7 * peak,
                   f"{name} {plane} against float64: card {e_card / peak}, "
                   f"plain {e_cpu / peak} of the peak")
            del y64
        report[name]["float64"] = errs
        del w
    del outs
    # the salience, and the contours and prism built on it
    got, want = pv.get_salience(0), cpu.get_salience(0)
    i_f, i_m = information.salience_peaks(pv, 0)
    n_live, n_apart = bins_apart(torch, pk, i_f, i_m, math.log2(55.0))
    err = float(np.abs(got.buffer - want.buffer).max())
    report["get_salience"] = {
        "err_abs": err, "contributions": n_live,
        "bins_apart_by_float32_log2": n_apart,
        "same_bits": bool(np.array_equal(got.buffer, want.buffer))}
    expect(got.buffer.shape == want.buffer.shape
           and err <= TOL_SALIENCE_CPU,
           f"get_salience on the card vs the CPU at 10 s: {err}")
    cons = {d: p.get_contours(0) for d, p in (("card", pv), ("cpu", cpu))}
    same = len(cons["card"]) == len(cons["cpu"]) and all(
        a.start_frame == b.start_frame and a.bins.shape == b.bins.shape
        for a, b in zip(cons["card"], cons["cpu"]))
    apart = [np.abs(a.bins - b.bins).max(axis=0).tolist() for a, b in
             zip(cons["card"], cons["cpu"])] if same else None
    report["get_contours"] = {
        **{d: [(c.start_frame, len(c.bins)) for c in v]
           for d, v in cons.items()},
        "pitch_and_salience_apart": apart}
    expect(same and all(p <= TOL_PITCH_BINS and q <= TOL_SALIENCE_CPU
                        for p, q in apart),
           f"get_contours on the card vs the CPU: {report['get_contours']}")
    got, want = pv.prism(prism_octave), cpu.prism(prism_octave)
    err = plane_errors(got, want)
    report["prism"] = {"err_rel": err, "null": got.is_null()}
    expect(err <= TOL_SALIENCE_CPU, f"prism on the card vs the CPU: {err}")
    print(json.dumps(report), flush=True)
    check(not failed, "; ".join(failed))
    return report


def prism_octave(note, t, harmonic, base_freq, harmonic_mags):
    """A prism callback: every harmonic an octave up, at its magnitude."""
    return harmonic_mags[harmonic - 1], base_freq * harmonic * 2.0


def salience_rows_in_order(torch, pk, i_f, i_m, width: int,
                           log2_min: float):
    """The salience histogram's rows in the kernel's order on the card,
    without the kernel: for each peak k, then harmonic h, one index_add_
    of every frame's contribution (one a frame, so no two in a step meet
    on a cell and the step's order does not matter); then the plain
    spread. The check of the kernel over a whole call."""
    frames, k_cnt = i_f.shape
    dev = i_f.device
    alpha = torch.from_numpy(pk.alpha_powers()).to(dev)
    rows = torch.zeros(frames * width, dtype=torch.float32, device=dev)
    base = torch.arange(frames, device=dev) * width + pk.SPREAD
    for k in range(k_cnt):
        fk, mk = i_f[:, k:k + 1], i_m[:, k]
        b_c = pk.subharmonic_bins(fk, log2_min)[:, 0]       # [F, NH]
        valid = ((b_c >= 0) & (b_c < width - pk.SPREAD)
                 & (fk > 0) & (mk > 0)[:, None])
        cells = torch.where(valid, base[:, None] + b_c, 0)
        vals = torch.where(valid, alpha * mk[:, None], 0.0)
        for h in range(pk.NH):
            rows.index_add_(0, cells[:, h], vals[:, h])
    return pk.spread_ref(rows.reshape(frames, width))


def salience_library_ms(torch, pk, i_f, i_m, width: int, log2_min: float):
    """One index_add_ of every contribution into the rows and conv1d of
    the spread, on the card, with torch's defaults (index_add_ adds by
    atomics; cudnn may run the convolution in TF32): (ms, whether two
    runs gave the same bits, the contributions). The operands (flat
    indices and values, [F K 20]) are built beforehand in chunks of
    frames, outside the timing."""
    frames = i_f.shape[0]
    flat, vals = [], []
    for s in range(0, frames, SALIENCE_LIBRARY_CHUNK):
        e = min(frames, s + SALIENCE_LIBRARY_CHUNK)
        fl, co = pk.subharmonic_contributions(i_f[s:e], i_m[s:e], width,
                                              log2_min)
        flat.append((fl + s * width).reshape(-1))
        vals.append(co.reshape(-1))
        del fl, co
    flat, vals = torch.cat(flat), torch.cat(vals)
    g = torch.from_numpy(pk.spread_taps()).to(i_f.device)[None, None]
    rows = torch.zeros(frames * width, dtype=torch.float32,
                       device=i_f.device)
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = True        # torch's default

    def call():
        rows.zero_()
        rows.index_add_(0, flat, vals)
        return torch.nn.functional.conv1d(rows.reshape(frames, 1, width), g)
    try:
        first = call()
        again = call()
        same = bool(torch.equal(first, again))
        del first, again
        ms = cuda_ms(torch, call, 3)
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
    n = int(flat.numel())
    del flat, vals, rows
    return ms, same, n


def phase10_pv_family(torch, Audio, scan, scan_kernels, pk, dev, card):
    """The PV family at PV_FAMILY_SECONDS stereo on phase 3's geometry, its
    launch counts zeroed just before it and read just after it: each call
    once on the card, timed (wall, x realtime, peak memory above the
    input), its outputs finite and of the expected shapes; stretch_spline
    by 2 runs the linear scan kernel twice a plane, both spline calls 8
    times, get_salience the salience kernel once. The first linear scan
    call of stretch_spline by 2 and the salience kernel's call are kept
    (capture_calls, no launch of their own). Returns the launches, the kept
    calls and the report."""
    x = stereo_signal(PV_FAMILY_SECONDS)
    pv = Audio.create_from_array(x, SR, device=dev).convert_to_PV(
        2048, 128, 4096)
    f, b = pv.num_frames, pv.num_bins
    calls = pv_family_calls(PV_FAMILY_SECONDS)
    calls["get_salience"] = lambda p: p.get_salience(0)
    exp_ramp = spline_expansions(torch, spline_ramp(PV_FAMILY_SECONDS), f,
                                 pv.analysis_rate)
    rate = pv.analysis_rate
    frames_out = {"desample": f, "smear_time": f - 1 + 2 * int(0.05 * rate),
                  "time_extrapolate": int(PV_FAMILY_SECONDS * 310 / 600
                                          * rate)
                  + int(PV_FAMILY_SECONDS * 30 / 600 * rate),
                  "stretch_spline_2": 2 * (f - 1),
                  "stretch_spline_ramp": int(exp_ramp[:-1].sum())}
    report = {"phase": 10, "path": "pv_family_600s_stereo_48k", "card": card,
              "frames": f, "bins": b}
    kept = {}
    targets = [(scan, "scan_linear"), (pk, "salience_histogram_cuda")]
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    scan_kernels.reset_launch_counts()
    pk.reset_launch_counts()
    for name, run in calls.items():
        before = (scan_kernels.LAUNCHES["scan_linear"],
                  pk.LAUNCHES["salience_histogram"])
        torch.cuda.reset_peak_memory_stats()
        (out, got), ms = timed(torch, lambda: capture_calls(
            targets, lambda: run(pv)))
        if name == "stretch_spline_2":
            kept["scan_linear"] = got["scan_linear"][0]
        if name == "get_salience":
            kept["salience_histogram"] = got["salience_histogram_cuda"][0]
        del got
        entry = {"wall_s": ms / 1e3,
                 "x_realtime": PV_FAMILY_SECONDS / (ms / 1e3),
                 "peak_alloc_gb": (torch.cuda.max_memory_allocated() - base)
                 / 1e9,
                 "launches": {
                     "scan_linear": scan_kernels.LAUNCHES["scan_linear"]
                     - before[0],
                     "salience_histogram": pk.LAUNCHES["salience_histogram"]
                     - before[1]}}
        if name == "get_salience":
            entry["shape"] = out.buffer.shape
            check(out.buffer.shape == (f, 600)
                  and bool(np.isfinite(out.buffer).all()),
                  f"get_salience: {out.buffer.shape}, finite "
                  f"{np.isfinite(out.buffer).all()}")
        else:
            entry["shape"] = tuple(out.mag.shape)
            want = (2, frames_out.get(name, out.mag.shape[1]), b)
            check(tuple(out.mag.shape) == want
                  and bool(torch.isfinite(out.mag).all())
                  and bool(torch.isfinite(out.freq).all()),
                  f"{name}: shape {tuple(out.mag.shape)}, want {want}, or "
                  "not finite")
        report[name] = entry
        print(json.dumps({"phase": 10, name: entry}), flush=True)
        del out
    launches = {"scan_linear": scan_kernels.LAUNCHES["scan_linear"],
                "salience_histogram": pk.LAUNCHES["salience_histogram"]}
    report["launches"] = launches
    check(launches == {"scan_linear": 8, "salience_histogram": 1},
          f"the PV family launched {launches}: stretch_spline twice, two "
          "linear scans a plane each, and one salience histogram")
    report["profile_stretch_spline_us"] = profile_launches(torch, {
        "stretch_spline": lambda: pv.stretch_spline(2.0)})["stretch_spline"]
    # modify's chunk of quads against its wall and peak memory
    from flan_tpu_torch.pv import modify_extra
    chosen = modify_extra.MODIFY_CHUNK_QUADS
    sweep = {}
    try:
        for quads in MODIFY_CHUNK_SWEEP:
            modify_extra.MODIFY_CHUNK_QUADS = quads
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            _, ms = timed(torch, lambda: calls["modify"](pv))
            sweep[quads] = {"wall_s": ms / 1e3, "peak_alloc_gb": (
                torch.cuda.max_memory_allocated() - base) / 1e9}
    finally:
        modify_extra.MODIFY_CHUNK_QUADS = chosen
    report["modify_chunk_sweep"] = sweep
    # a whole get_salience call repeats its bits
    first = pv.get_salience(0).buffer
    check(np.array_equal(first, pv.get_salience(0).buffer),
          "two get_salience calls at 600 s differ")
    del pv, first
    print(json.dumps(report), flush=True)
    return launches, kept, report


def phase10_contours(torch, Audio, pk, dev, card):
    """get_contours (channel 0) and prism (every harmonic an octave up) at
    CONTOUR_SECONDS stereo, their salience launches counted: the contours
    found, the prism's planes finite and of the input's shape."""
    pv = Audio.create_from_array(stereo_signal(CONTOUR_SECONDS), SR,
                                 device=dev).convert_to_PV(2048, 128, 4096)
    pk.reset_launch_counts()
    cons, ms_c = timed(torch, lambda: pv.get_contours(0))
    out, ms_p = timed(torch, lambda: pv.prism(prism_octave))
    launches = pk.LAUNCHES["salience_histogram"]
    report = {"phase": 10, "path": "contours_prism_30s_stereo_48k",
              "card": card, "get_contours_wall_s": ms_c / 1e3,
              "contours": [(c.start_frame, len(c.bins),
                            round(c.pitch_mean, 2)) for c in cons],
              "prism_wall_s": ms_p / 1e3, "launches": launches}
    check(len(cons) > 0, "no contour in 30 s of the test signal")
    check(not out.is_null() and out.mag.shape == pv.mag.shape
          and bool(torch.isfinite(out.mag).all()),
          "prism: null, reshaped or not finite")
    check(launches == 3, f"get_contours and prism launched the salience "
          f"histogram {launches} times, not 1 + 2")
    print(json.dumps(report), flush=True)
    return launches, report


def phase10_kernel_checks(torch, scan_kernels, pk, kept):
    """The path's own kernel calls: stretch_spline's first linear scan call
    on SPLINE_SCAN_ROWS of its rows against the float64 plain run (at most
    twice the float32 plain run's error), and for the same bits over the
    whole call; the salience kernel's call against the plain version on the
    CPU over its first SALIENCE_PLAIN_FRAMES frames and over every frame
    against the same order on the card (salience_rows_in_order), the same
    bits both, and three calls for the same bits, timed with its plain
    version's and the library call's times (the contributions that the
    card's float32 log2 would have put on another bin counted). Returns the
    report, the salience kernel's largest absolute error and the scan's."""
    a, bb, y0 = kept["scan_linear"]
    n = bb.shape[-1]
    row = a[(0,) * (a.ndim - 1)] if a.stride()[0] == 0 else None
    check(row is not None, "stretch_spline's coefficient row is not shared")
    rows = SPLINE_SCAN_ROWS
    sub = (row.expand(rows, n), bb.reshape(-1, n)[:rows],
           y0.reshape(-1, 1)[:rows])
    kernel, plain = scan_calls(scan_kernels)["scan_linear"]
    e = scan_errors(torch, kernel, plain, sub)
    e["shape"] = tuple(bb.shape)
    check_scan(e, "scan_linear in stretch_spline", 0.0)
    check_same_bits(torch, lambda: kernel(a, bb, y0),
                    "scan_linear in stretch_spline")
    report = {"scan_linear": e,
              "scan_linear_ms": cuda_ms(torch, lambda: kernel(a, bb, y0), 3),
              "scan_linear_bound": bound("scan_linear",
                                         *scan_bytes((a, bb, y0), 2, 1))}
    scan_err = e["abs_err"]
    del a, bb, y0, sub
    i_f, i_m, width, log2_min = kept["salience_histogram"]
    out = pk.salience_histogram_cuda(i_f, i_m, width, log2_min)
    nf = min(SALIENCE_PLAIN_FRAMES, i_f.shape[0])
    want = pk.salience_histogram_ref(i_f[:nf].cpu(), i_m[:nf].cpu(), width,
                                     log2_min)
    n_live, n_apart = bins_apart(torch, pk, i_f, i_m, log2_min)
    err_plain = float((out[:nf].cpu() - want).abs().max())
    check(torch.equal(out[:nf].cpu(), want),
          f"salience_histogram vs its plain version over {nf} frames: "
          f"{err_plain} apart, not the same bits")
    order = salience_rows_in_order(torch, pk, i_f, i_m, width, log2_min)
    err_order = float((out - order).abs().max())
    check(torch.equal(out, order),
          f"salience_histogram vs its order on the card: {err_order}")
    check_same_bits(torch, lambda: pk.salience_histogram_cuda(
        i_f, i_m, width, log2_min), "salience_histogram")
    ms = cuda_ms(torch, lambda: pk.salience_histogram_cuda(
        i_f, i_m, width, log2_min), 3)
    plain_ms = cuda_ms(torch, lambda: pk.salience_histogram_ref(
        i_f[:nf], i_m[:nf], width, log2_min), 1)
    lib_ms, lib_same, n_contrib = salience_library_ms(torch, pk, i_f, i_m,
                                                      width, log2_min)
    nbytes = 4 * (i_f.numel() + i_m.numel() + out.numel())
    report["salience_histogram"] = {
        "shape": (tuple(i_f.shape), tuple(out.shape)),
        "plain_abs_err": err_plain, "plain_frames": nf,
        "plain_same_bits": bool(torch.equal(out[:nf].cpu(), want)),
        "contributions": n_live, "bins_apart_by_float32_log2": n_apart,
        "order_abs_err": err_order,
        "order_same_bits": bool(torch.equal(out, order)),
        "ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms,
        "library_same_bits": lib_same, "library_contributions": n_contrib,
        "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes",
        "bytes": nbytes}
    print(json.dumps({"phase": 10, "kernel_checks": report}), flush=True)
    return report, max(err_plain, err_order), scan_err


# phase 11: the synthesis family, the granular engine, Audio.delay and the
# Wavetable (ROADMAP A.14) at 48 kHz; the long calls at SYNTH_SECONDS, the
# per-grain paths at SYNTH_SHORT_SECONDS, the per-event ones at
# SYNTH_TINY_SECONDS; each against the CPU at SYNTH_CPU_SECONDS
SYNTH_SECONDS = 600.0
SYNTH_SHORT_SECONDS = 30.0
SYNTH_TINY_SECONDS = 10.0
SYNTH_CPU_SECONDS = 10.0
# a synthesis call on the card against the same call on the CPU, times the
# peak: the kernels give the same bits on both; torch's sin, cos, FFTs and
# the resampler's products differ by an ulp or so between the devices
TOL_SYNTH_CPU = 1e-4
# the card's issue rate for 32-bit integer work: four schedulers an SM each
# issuing one 32-lane instruction a cycle, 132 SMs at 1.98 GHz (the float32
# rate, 67e12, is the same issue counting an FMA as 2); threefry's
# operations a draw at the fewest instructions (csrc/random_kernels.cu: 20
# rounds of an add, a rotate and a xor; 5 key injections with the round
# constant folded in; the counter, the float's bits and its 4 float ops)
INT32_OPS_PER_S = 132 * 128 * 1.98e9
THREEFRY_OPS = 74
SYNTH_KERNELS = ("threefry_uniform", "cycle_scan", "grain_overlap_add")


def synth_sine(p):
    """The sine waveform of a phase in cycles, its CPU sin correctly
    rounded (stft.cpu_exact: torch's float32 CPU sin can be off by
    thousands of ulps in a worker thread's first call, C.17)."""
    import torch
    from flan_tpu_torch.ops.stft import cpu_exact
    return cpu_exact(torch.sin, 2.0 * math.pi * p)


def glide_signal(seconds: float, channels: int = 2) -> np.ndarray:
    """A harmonic tone gliding 110 -> 165 Hz, amplitude 0.5, a second
    channel a fifth above: material for psola's and the Wavetable's pitch
    trackers."""
    n = int(seconds * SR)
    t = np.arange(n, dtype=np.float64) / SR
    rows = []
    for ratio in (1.0, 1.5)[:channels]:
        ph = 2 * np.pi * ratio * (110.0 * t + 27.5 * t * t / seconds)
        rows.append(sum(0.5 / k * np.sin(k * ph) for k in range(1, 5)))
    return np.asarray(rows, np.float32)


def synth_calls(Audio, Wavetable, SnapMode, PitchMode, device,
                long_s: float, short_s: float, tiny_s: float) -> dict:
    """Phase 11's calls on `device`: name -> (seconds of output, run). The
    control functions multiply by reciprocals: torch's CUDA t / s is a
    reciprocal multiply, an ulp off the CPU's quotient, which the phase of
    a sweep would integrate (1.3e-3 of the peak at 10 s)."""
    x_long = Audio.create_from_array(stereo_signal(long_s), SR, device=device)
    src = x_long.cut(0.0, 0.25)
    x_tiny = Audio.create_from_array(stereo_signal(tiny_s), SR, device=device)
    glide = Audio.create_from_array(glide_signal(short_s), SR, device=device)
    mono = Audio.create_from_array(glide_signal(short_s, 1), SR,
                                   device=device)
    play = 2 * short_s

    def wavetable():
        wt = Wavetable(mono, SnapMode.ZERO, PitchMode.LOCAL)
        return wt.synthesize(play, lambda t: 110.0 + t * (50.0 / play),
                             lambda t: t * (1.0 / play))
    return {
        "waveform_const": (long_s, lambda: Audio.synthesize_waveform(
            synth_sine, long_s, 440.0, SR, 16, device=device)),
        "waveform_sweep": (long_s, lambda: Audio.synthesize_waveform(
            synth_sine, long_s, lambda t: 220.0 + t * (2000.0 / long_s),
            SR, 16, device=device)),
        "white_noise": (long_s, lambda: Audio.synthesize_white_noise(
            long_s, SR, 16, seed=1, device=device)),
        "pink_noise": (long_s, lambda: Audio.synthesize_pink_noise(
            long_s, SR, seed=2, device=device)),
        "spectrum": (long_s, lambda: Audio.synthesize_spectrum(
            long_s, lambda t: 110.0 + t * (220.0 / long_s), seed=3,
            sample_rate=SR, device=device)),
        "granulate": (long_s, lambda: x_long.granulate(
            long_s, 100.0, 0.0, lambda t: 0.9 * t, 0.1, 0.01, seed=4)),
        "texture": (long_s, lambda: src.texture(long_s, 20.0, 0.0, seed=5)),
        "psola": (short_s, lambda: glide.psola(short_s, lambda t: 0.9 * t,
                                               seed=6)),
        "texture_mod": (short_s, lambda: src.texture(
            short_s, 20.0, 0.01,
            lambda a, t: a.modify_volume(0.5 + t * (0.5 / short_s)),
            seed=7)),
        "trainlets": (tiny_s, lambda: Audio.synthesize_trainlets(
            tiny_s, 10.0, 0.01, (1.0, 0.5),
            lambda t: 1.0 - t * (0.5 / tiny_s), 150.0, 0.08,
            num_harmonics=64, chroma=0.9, impulse_harmonic_frequency=60.0,
            sample_rate=SR, seed=8, device=device)),
        "delay": (tiny_s + 5.0, lambda: x_tiny.delay(5.0, 0.25, 0.5)),
        "wavetable": (play, wavetable),
    }


def phase11_cpu_checks(torch, Audio, dev, card) -> dict:
    """Every phase-11 call at SYNTH_CPU_SECONDS on the card and on the CPU,
    within TOL_SYNTH_CPU of the peak. psola runs on the CPU on the card's
    local frequencies and the Wavetable's CPU playback on the card's table
    (convert.wavetable_from_numpy): the pitch trackers' sums are taken in
    another order on each device, which can move an event or a cycle
    start by a frame."""
    from flan_tpu_torch import PitchMode, SnapMode, Wavetable
    from flan_tpu_torch.audio import information
    from flan_tpu_torch.convert import wavetable_from_numpy
    s = SYNTH_CPU_SECONDS
    kept = {}

    def keep_freqs(fn):
        def call(*args, **kwargs):
            kept["freqs"] = fn(*args, **kwargs)
            return kept["freqs"]
        return call

    tables = []

    class CardTable(Wavetable):
        """The card's Wavetable, its table kept for the CPU's playback."""
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            tables.append(self)

    class CpuTable(Wavetable):
        """The card's table and starts, on the CPU."""
        def __new__(cls, *args, **kwargs):
            w = tables[-1]
            return wavetable_from_numpy(
                w.table.cpu().numpy(), w.waveform_starts, w.wavelength,
                w.sample_rate, "cpu", num_source_frames=w.num_source_frames)

    card_calls = synth_calls(Audio, CardTable, SnapMode, PitchMode, dev, s,
                             s, s)
    cpu_calls = synth_calls(Audio, CpuTable, SnapMode, PitchMode, "cpu", s,
                            s, s)
    report = {"phase": 11, "seconds": s, "card": card}
    orig = information.get_local_frequencies
    for name, (_, run) in card_calls.items():
        information.get_local_frequencies = keep_freqs(orig)
        try:
            got = run()
        finally:
            information.get_local_frequencies = orig
        if name == "psola":
            information.get_local_frequencies = lambda *a, **k: kept["freqs"]
        try:
            want = cpu_calls[name][1]()
        finally:
            information.get_local_frequencies = orig
        g, w = got.data.cpu().numpy(), want.data.numpy()
        check(g.shape == w.shape and np.isfinite(g).all(),
              f"phase 11 {name}: card {g.shape} against CPU {w.shape}, or "
              "not finite")
        rel = float(np.abs(g - w).max() / max(np.abs(w).max(), 1e-30))
        report[name] = {"shape": g.shape, "card_vs_cpu": rel}
        check(rel <= TOL_SYNTH_CPU, f"phase 11 {name}: card against CPU "
              f"{rel:.3e} of the peak (> {TOL_SYNTH_CPU})")
    print(json.dumps(report), flush=True)
    return report


def phase11_synthesis(torch, Audio, synth_mods, scan_kernels, dev, card):
    """Phase 11's calls on the card, their launch counts zeroed just before
    and read just after: each timed (wall, x realtime, peak memory), its
    output finite; the kernels' calls kept (capture_calls, no launch of
    their own): K1's of the white noise and the spectrum, K2's of both
    waveforms, K3's of granulate, psola and the modded texture. Returns
    the launches, the T1/T2 (2 x 2 scan) launches of the Wavetable call,
    the kept calls and the report."""
    from flan_tpu_torch import PitchMode, SnapMode, Wavetable
    from flan_tpu_torch.ops import fir
    rnd, cs, gm = synth_mods
    calls = synth_calls(Audio, Wavetable, SnapMode, PitchMode, dev,
                        SYNTH_SECONDS, SYNTH_SHORT_SECONDS,
                        SYNTH_TINY_SECONDS)
    keep_from = {"white_noise": "threefry_cuda", "spectrum": "threefry_cuda",
                 "waveform_const": "cycle_scan_cuda",
                 "waveform_sweep": "cycle_scan_cuda",
                 "granulate": "grain_overlap_add_cuda",
                 "psola": "grain_overlap_add_cuda",
                 "texture_mod": "grain_overlap_add_cuda"}
    targets = [(rnd, "threefry_cuda"), (cs, "cycle_scan_cuda"),
               (gm, "grain_overlap_add_cuda")]
    report = {"phase": 11, "card": card}
    kept = {}
    # the filters' impulse responses cached by the 10 s pass are dropped:
    # the counted pass probes them on the scans as a first call does
    fir._IR_CACHE.clear()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    rnd.reset_launch_counts()
    cs.reset_launch_counts()
    gm.reset_launch_counts()
    scan_kernels.reset_launch_counts()
    scan_wavetable = 0
    for name, (seconds, run) in calls.items():
        before = (rnd.LAUNCHES["threefry_uniform"], cs.LAUNCHES["cycle_scan"],
                  gm.LAUNCHES["grain_overlap_add"],
                  scan_kernels.LAUNCHES["scan_affine2x2"])
        torch.cuda.reset_peak_memory_stats()
        (out, got), ms = timed(torch, lambda: capture_calls(
            targets, run, keep=lambda n, a, k: not k))
        if name in keep_from:
            # the white noise's one call; the spectrum's theta (its only)
            kept[name] = got[keep_from[name]][-1]
        del got
        data = out.data
        entry = {"wall_s": ms / 1e3, "x_realtime": seconds / (ms / 1e3),
                 "peak_alloc_gb": (torch.cuda.max_memory_allocated() - base)
                 / 1e9, "shape": tuple(data.shape),
                 "launches": {
                     "threefry_uniform": rnd.LAUNCHES["threefry_uniform"]
                     - before[0],
                     "cycle_scan": cs.LAUNCHES["cycle_scan"] - before[1],
                     "grain_overlap_add": gm.LAUNCHES["grain_overlap_add"]
                     - before[2],
                     "scan_affine2x2": scan_kernels.LAUNCHES["scan_affine2x2"]
                     - before[3]}}
        check(data.numel() > 0 and bool(torch.isfinite(data).all()),
              f"phase 11 {name}: empty or not finite")
        if name == "wavetable":
            scan_wavetable = entry["launches"]["scan_affine2x2"]
        report[name] = entry
        print(json.dumps({"phase": 11, name: entry}), flush=True)
        del out, data
    launches = {"threefry_uniform": rnd.LAUNCHES["threefry_uniform"],
                "cycle_scan": cs.LAUNCHES["cycle_scan"],
                "grain_overlap_add": gm.LAUNCHES["grain_overlap_add"]}
    report["launches"] = launches
    report["scan_affine2x2_wavetable"] = scan_wavetable
    for k in SYNTH_KERNELS:
        check(launches[k] > 0, f"{k} was not launched on phase 11's path")
    check(scan_wavetable > 0, "the Wavetable's pitch path launched no 2 x 2 "
          "scan (T1/T2's counterpart)")
    print(json.dumps(report), flush=True)
    return launches, scan_wavetable, kept, report


def phase11_kernel_checks(torch, synth_mods, kept) -> dict:
    """Each kept call of K1-K3, whole: the kernel (one more launch, not
    counted) against its plain version on the card, bit for bit, and three
    calls for the same bits; then the kernel's ms on the largest call
    beside its plain version's and the nearest library call's, and its
    bound. Returns name -> the kernel line's numbers."""
    rnd, cs, gm = synth_mods
    groups = {"threefry_uniform": (("white_noise", "spectrum"),
                                   rnd.threefry_cuda, rnd.threefry_ref),
              "cycle_scan": (("waveform_const", "waveform_sweep"),
                             cs.cycle_scan_cuda, cs.cycle_scan_ref),
              "grain_overlap_add": (("granulate", "psola", "texture_mod"),
                                    gm.grain_overlap_add_cuda,
                                    gm.grain_overlap_add_ref)}
    out = {}
    for kname, (names, kernel, plain) in groups.items():
        checked = {}
        for call in names:
            args = kept[call]
            y = kernel(*args)
            (y_p, plain_ms) = timed(torch, lambda: plain(*args))
            same = bool(torch.equal(y, y_p))
            err = float((y.double() - y_p.double()).abs().max())
            check(same, f"phase 11 {kname} on {call}'s call: kernel and "
                  "plain version differ")
            check_same_bits(torch, lambda: kernel(*args), f"{kname} {call}")
            checked[call] = {"elements": int(y.numel()), "same_bits": same,
                             "max_abs_err": err, "plain_ms": plain_ms}
            del y, y_p
        main = names[0] if kname != "cycle_scan" else "waveform_sweep"
        args = kept[main]
        ms = cuda_ms(torch, lambda: kernel(*args), 3)
        out[kname] = {"ms": ms, "plain_ms": checked[main]["plain_ms"],
                      "call": main, "checked": checked,
                      "max_abs_err": max(c["max_abs_err"]
                                         for c in checked.values()),
                      **synth_bound_and_library(torch, kname, args, main)}
        print(json.dumps({"phase": 11, kname: out[kname]}), flush=True)
    return out


def synth_bound_and_library(torch, kname: str, args, call: str) -> dict:
    """bound_ms, bound_by, library_ms and their notes for one kernel on its
    call's arguments (required bytes: each input read once, each output
    written once)."""
    if kname == "threefry_uniform":
        k, n, lo, hi, dev = args
        t_bytes = 4 * n / HBM_BYTES_PER_S
        t_ops = THREEFRY_OPS * n / INT32_OPS_PER_S
        lib_ms = cuda_ms(torch, lambda: torch.rand(n, device=dev), 3)
        return {"bound_ms": max(t_bytes, t_ops) * 1e3,
                "bound_by": "operations" if t_ops > t_bytes else "bytes",
                "bound_note": f"{THREEFRY_OPS} integer operations a draw at "
                f"{INT32_OPS_PER_S / 1e12:.1f} T/s against "
                f"{4 * n / 1e9:.2f} GB written",
                "library_ms": lib_ms,
                "library_note": "torch.rand on the card (Philox: other bits "
                "than JAX's threefry)"}
    if kname == "cycle_scan":
        f, inc, in_rate, n = args[:4]
        nbytes = 4 * n + (0 if f is None else 4 * n)
        from flan_tpu_torch.ops.cycle_scan import increments
        inc_t = increments(f, in_rate)

        def library():
            return torch.frac(torch.cumsum(inc_t.double(), 0))
        lib_ms = cuda_ms(torch, library, 3)
        return {"bound_ms": nbytes / HBM_BYTES_PER_S * 1e3,
                "bound_by": "bytes",
                "bound_note": f"f read and the phase written, "
                f"{nbytes / 1e9:.2f} GB",
                "library_ms": lib_ms,
                "library_note": "torch.cumsum in float64 of the increments "
                "and torch.frac (an inclusive scan: not the same bits)"}
    x, meta, offsets, entries, out_n = args[:5]
    envp = args[5] if len(args) > 5 else None
    ch = x.shape[0] if x.ndim == 2 else x.shape[1]
    nbytes = (4 * x.numel() + 4 * meta.numel() + 8 * len(offsets)
              + 4 * len(entries) + 4 * ch * out_n
              + (0 if envp is None else 4 * envp.numel()))
    # index_add_ of the grains' 128-sample rows (random values of the same
    # shape) into the output's blocks, by the same block ids
    from flan_tpu_torch.ops.grain_mix import grain_blocks
    nblk_g = grain_blocks(int(meta[1].max()))
    q = meta[5].to(torch.int64)
    ids = (q[:, None] + torch.arange(nblk_g)[None, :]).reshape(-1).to(
        x.device)
    rows = torch.randn((ids.numel(), ch * 128), device=x.device)
    acc = torch.zeros((int(ids.max()) + 1, ch * 128), device=x.device)
    lib_ms = cuda_ms(torch, lambda: acc.index_add_(0, ids, rows), 3)
    del rows, acc
    return {"bound_ms": nbytes / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes",
            "bound_note": f"the source, the plan and the output once, "
            f"{nbytes / 1e9:.3f} GB",
            "library_ms": lib_ms,
            "library_note": "index_add_ of the grains' 128-sample rows into "
            "the output's blocks (float atomics: no fixed order)"}


def stereo_delay_bound(args, backward: bool = False):
    """(bound_ms, bound_by, note) of a stereo delay call (forward, or the
    backward): the larger of the bytes it must move (x twice, g, the two
    distances and the two rows written, 4 bytes each a frame; the
    backward's gout for x and gw for w) over the memory rate and its
    chain: the rounds of the loop's order (stereo_delay_depth) times one
    dependent step measured alone, STEREO_DELAY_STEP_CYCLES (backward:
    STEREO_DELAY_BACK_STEP_CYCLES) at 1.98 GHz."""
    x, g, el, er = args[:4]
    n = int(x.shape[1])
    depth = stereo_delay_depth(el.cpu().numpy().astype(np.int64),
                               er.cpu().numpy().astype(np.int64))
    cycles = STEREO_DELAY_BACK_STEP_CYCLES if backward else \
        STEREO_DELAY_STEP_CYCLES
    t_lat = depth * cycles / 1.98e9
    t_bytes = 7 * 4 * n / HBM_BYTES_PER_S
    note = (f"{depth:.0f} rounds in the loop's order (sum of 1 / the nearer "
            f"read) x {cycles} cycles (one dependent step, measured alone); "
            f"bytes {7 * 4 * n / 1e9:.3f} GB")
    return (max(t_lat, t_bytes) * 1e3,
            "operations" if t_lat >= t_bytes else "bytes", note)


def kxk_bound(A, b, k: int):
    """(bound_ms, bound_by) of one k x k call: A read once (one map for
    every row counts once), b read and y written per row; 2 k^2 operations
    (k^2 FMAs) an element of a row."""
    rows, _, n = b.shape
    t_bytes = 4 * (A.numel() + 2 * b.numel()) / HBM_BYTES_PER_S
    t_ops = 2 * k * k * rows * n / F32_OPS_PER_S
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def saturator_backward_bound(two_pole: bool, frames: int, part=None):
    """(bound_ms, bound_by, note) of the saturator's backward on stereo at
    order 2: the larger of its required bytes over the memory rate and its
    operations over the float32 rate. Required: gy, x, y, the states and
    the planes read once, gx and the planes' gradients written once (the
    per-step maps are the design's own traffic); operations: a rerun and
    one adjoint a step. part "maps" counts what its kernel must read and
    does (the rerun and K = nstates + 1 adjoints), "readout" what its
    kernel must write and does (the rerun and one adjoint); any other part
    the whole backward."""
    ch, planes, states = 2, (6 if two_pole else 5), (4 if two_pole else 2)
    reads = ch * (3 + states) + planes
    writes = ch * (1 + planes)
    adjoints = {"maps": states + 1}.get(part, 1)
    floats = {"maps": reads, "readout": writes}.get(part, reads + writes)
    t_bytes = 4 * frames * floats / HBM_BYTES_PER_S
    t_ops = ch * frames * (SAT_STEP_OPS[two_pole] + adjoints
                           * SAT_ADJOINT_OPS[two_pole]) / F32_OPS_PER_S
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations",
            f"{4 * frames * floats / 1e6:.1f} MB required, "
            f"{t_ops * F32_OPS_PER_S / 1e9:.2f} GFLOP")


def sequential_bound(name: str, frames: int, delays=None, clock=1.98e9):
    """(bound_ms, bound_by, note) of a sequential forward (or the comb's
    backward) on stereo at order 2: the larger of its bytes over the memory
    rate and its chain of dependent steps (SAT_CHAIN_CYCLES; the comb's
    depth in the loop's order times COMB_STEP_CYCLES or
    COMB_BACK_STEP_CYCLES); the saturator backward's passes by
    saturator_backward_bound."""
    if name.startswith("saturator") and "_backward_" in name:
        return saturator_backward_bound(name.startswith("saturator_2pole"),
                                        frames, name.rsplit("_", 1)[1])
    if name.startswith("comb_swept"):
        depth = float((1.0 / delays.double()).sum())
        per = (COMB_BACK_STEP_CYCLES if name.endswith("_backward")
               else COMB_STEP_CYCLES)
        cycles = depth * per
        # x (gy) in and y (gu) out per channel; the delays, k and a
        nbytes = 4 * frames * (2 * 2 + 3)
        note = (f"{depth:.0f} rounds (sum of 1 / d: the depth in the "
                f"loop's order) x {per} cycles (one dependent step, "
                "measured alone)")
    else:
        two = name.startswith("saturator_2pole")
        per = SAT_CHAIN_CYCLES[two]
        nbytes = 4 * frames * (2 * 2 + (6 if two else 5))
        cycles = frames * per
        note = (f"{frames} dependent steps x {per} cycles: the compiled "
                "step's dependent instructions at 4 cycles each")
    t_lat = cycles / clock
    t_bytes = nbytes / HBM_BYTES_PER_S
    return (max(t_lat, t_bytes) * 1e3, "operations", note)


def scan_bytes(args, nplanes: int, nstates: int):
    """(elements, required bytes) of one scan call: each plane read once (a
    plane broadcast over rows, as a row shared by every row or a decay
    plane shared by the channels, counts its own elements once) and each
    state written once."""
    shape = np.broadcast_shapes(*(tuple(a.shape) for a in args[:nplanes]))
    n, rows = shape[-1], math.prod(shape[:-1])
    nbytes = 4 * rows * n * nstates
    for p in args[:nplanes]:
        nbytes += 4 * math.prod(d for d, s in zip(p.shape, p.stride())
                                if s != 0)
    return rows * n, nbytes


def bound(name: str, elements: int, nbytes: int):
    """(bound_ms, bound_by) for `elements` frame-bin elements of work and
    `nbytes` of required traffic."""
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = OPS_PER_ELEMENT[name] * elements / F32_OPS_PER_S
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def start(package):
    """Phases 0 and 1: the card, torch, the port (from `package` if given)
    and its kernel library. Returns the card's line, torch, the device and
    the library."""
    card = card_line()
    print(f"card: {card}", flush=True)
    import torch
    if not torch.cuda.is_available():
        fail("torch sees no CUDA device")
    # full float32 on the card: TF32 would change the plain versions' sums
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if package is not None:
        sys.path.insert(0, package)
    from flan_tpu_torch.ops import build
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}", flush=True)
    t0 = time.perf_counter()
    path, log = build.build_library()
    lib = build.load_library()
    print(f"phase 1: built {path} in {time.perf_counter() - t0:.2f} s",
          flush=True)
    for line in log.splitlines():
        if ("registers" in line or "spill" in line or "Compiling" in line
                or line.endswith(".cu:")):
            print(f"  nvcc: {line.strip()}", flush=True)
    return card, torch, torch.device("cuda", 0), lib


def saturator_timing(torch, Audio, seq, dev) -> dict:
    """The saturator's kernels as phase 8 calls them (the 1-pole and the
    2-pole of order 2 on SAT_SECONDS stereo, phase 8's parameters), by the
    entry points every version of the port has: the forward filter call
    (ms: CUDA events over two calls after the captured one), the backward
    on its states and a gradient of one (ms, and µs a launch of each kernel
    it runs by the profiler), and the gradient through the filter call,
    forward and backward, on the host's clock (wall_s, the second of two
    calls)."""
    x = stereo_signal(SAT_SECONDS) * 3.0
    steps = {False: lambda a, c: a.filter_1pole_multinotch(
                 2, lambda t: c * (1.0 + t), 0.6, False, 0.5, True),
             True: lambda a, c: a.filter_2pole_multinotch(
                 2, lambda t: c * (1.0 + t), 0.4, 0.7, True, 0.5, True)}
    out = {}
    for two, step in steps.items():
        name = f"saturator_{2 if two else 1}pole"
        _, calls = capture_calls([(seq, "saturator_cuda")], lambda: step(
            Audio.create_from_array(x, SR, device=dev), 300.0))
        args = calls["saturator_cuda"][0]
        fwd_ms = cuda_ms(torch, lambda: seq.saturator_cuda(*args), 2)
        xk, planes, inv, order, _ = args
        y, states = seq.saturator_cuda(xk, planes, inv, order, two,
                                       keep_states=True)
        gy = torch.from_numpy(stereo_signal(SAT_SECONDS, seed=5)).to(dev)
        back = (gy, xk, planes, y, states, inv, order, two)
        seq.saturator_backward_cuda(*back)
        back_ms = cuda_ms(torch, lambda: seq.saturator_backward_cuda(*back),
                          3)
        split = profile_launches(torch, {"backward": (
            lambda: seq.saturator_backward_cuda(*back))})["backward"]
        del y, states, gy, back

        def grad():
            v = torch.from_numpy(x).to(dev).requires_grad_()
            c = torch.tensor(300.0, device=dev, requires_grad=True)
            yv = step(Audio.create_from_array(v, SR), c).data
            return torch.autograd.grad((yv * yv).sum(), (v, c))
        walls = []
        for _ in range(2):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            grad()
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
        out[name] = {"forward_ms": fwd_ms, "backward_ms": back_ms,
                     "backward_us_per_launch": split,
                     "gradient_wall_s": walls[1], "frames": x.shape[1]}
        print(json.dumps({"saturator_timing": {name: out[name]}}),
              flush=True)
    return out


def comb_timing(torch, Audio, seq, dev) -> dict:
    """The swept comb's kernels as phase 8 calls them, by the entry points
    every version of the port has: the forward on the filter call (600 s
    stereo, cutoff kxk_sweep: delays 120 -> 12), and the forward (keeping
    u) and the backward on the gradient call (600 s stereo, comb_cut:
    delays 12 -> 6012), each by CUDA events over two calls after the
    captured one; the gradient through the filter call, forward and
    backward, on the host's clock (wall_s, the second of two calls)."""
    x = stereo_signal(MULTINOTCH_SECONDS)
    _, calls = capture_calls([(seq, "comb_swept_cuda")], lambda: Audio.
                             create_from_array(x, SR, device=dev).filter_comb(
                                 kxk_sweep, 0.5))
    args = calls["comb_swept_cuda"][0]
    out = {"forward_filter_call_ms": cuda_ms(
        torch, lambda: seq.comb_swept_cuda(*args), 2)}
    del args, calls
    x = x * 3.0

    def grad():
        v = torch.from_numpy(x).to(dev).requires_grad_()
        c = torch.tensor(0.5, device=dev, requires_grad=True)
        yv = Audio.create_from_array(v, SR).filter_comb(comb_cut, c, 0.5).data
        return torch.autograd.grad((yv * yv).sum(), (v, c))
    _, calls = capture_calls([(seq, "comb_swept_cuda"),
                              (seq, "comb_swept_backward_cuda")], grad)
    fwd, back = (calls[k][0] for k in ("comb_swept_cuda",
                                       "comb_swept_backward_cuda"))
    out["forward_gradient_call_ms"] = cuda_ms(
        torch, lambda: seq.comb_swept_cuda(*fwd, keep_u=True), 2)
    out["backward_gradient_call_ms"] = cuda_ms(
        torch, lambda: seq.comb_swept_backward_cuda(*back), 2)
    del fwd, back, calls
    walls = []
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        grad()
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    out["gradient_wall_s"] = walls[1]
    out["frames"] = x.shape[1]
    print(json.dumps({"comb_timing": out}), flush=True)
    return out


def probe_timing(torch, dev) -> dict:
    """T3 on its own inputs, as phase 6 times it (time_kernels), with a
    digest of its output (two builds with the same digest gave the same
    bits)."""
    import hashlib
    from flan_tpu_torch.ops import probe_kernels
    xp, wp = (torch.from_numpy(a).to(dev)
              for a in probe_kernels.probe_inputs())
    out = time_kernels(torch, {"probe": (
        lambda: probe_kernels.probe_cuda(xp, wp),
        lambda: probe_kernels.probe_ref(xp, wp))})["probe"]
    y = probe_kernels.probe_cuda(xp, wp).cpu().numpy()
    out["sha256"] = hashlib.sha256(y.tobytes()).hexdigest()
    print(json.dumps({"probe_timing": out}), flush=True)
    return out


def stereo_delay_timing(torch, Audio, seq, dev) -> dict:
    """The swept stereo delay's kernels on phase 9's three swept calls at
    EFFECT_SECONDS stereo, by the entry points every version of the port
    has: the forward kernel on the call's own operands (captured from
    Audio.stereo_delay), by CUDA events over two calls after the captured
    one, with a digest of its output (the same digest from two builds:
    the same bits) and the rounds it ran. Where the version has them, the
    other regime's variant on the same operands, the backward kernel on
    the gradient call's own operands (timed and digested the same way) and
    the gradient through the call, forward and backward, on the host's
    clock (wall_s, the second of two calls)."""
    import hashlib
    import inspect
    x = stereo_signal(EFFECT_SECONDS)
    weight = torch.from_numpy(stereo_signal(EFFECT_SECONDS, seed=7))
    fwd = seq.stereo_delay_swept_cuda
    new = "rounds" in inspect.signature(fwd).parameters

    def digest(t):
        return hashlib.sha256(t.cpu().numpy().tobytes()).hexdigest()[:16]
    out = {}
    for name, lt, rt in delay_sweeps():
        _, calls = capture_calls([(seq, "stereo_delay_swept_cuda")],
                                 lambda: Audio.create_from_array(
                                     x, SR, device=dev).stereo_delay(
                                     EFFECT_SECONDS, lt, rt, 0.5))
        args = calls["stereo_delay_swept_cuda"][0]
        entry = {"ms": cuda_ms(torch, lambda: fwd(*args), 2),
                 "sha256_16": digest(fwd(*args))}
        if new:
            rounds = torch.zeros(1, dtype=torch.int32, device=dev)
            fwd(*args, rounds=rounds)
            variant = seq.VARIANTS["stereo_delay_swept"]
            lib = seq.load_library()
            wide = not variant.startswith("wide")
            other = ("wide" if wide else "narrow") + (
                "_shared" if lib.flan_stereo_delay_shared_bytes(
                    int(wide), *args[4:6]) <= lib.flan_max_shared_bytes()
                else "_device")
            rounds_other = torch.zeros(1, dtype=torch.int32, device=dev)
            fwd(*args, variant=other, rounds=rounds_other)
            entry.update(rounds=int(rounds), variant=variant, other_regime={
                "variant": other, "rounds": int(rounds_other),
                "ms": cuda_ms(torch, lambda: fwd(*args, variant=other), 2)})
        else:                       # rounds planned on the host (PR 12)
            entry["rounds"] = int(args[4].shape[0] - 1)
        del args, calls
        if hasattr(seq, "stereo_delay_swept_backward_cuda"):
            back = seq.stereo_delay_swept_backward_cuda

            def grad():
                v = torch.from_numpy(x).to(dev).requires_grad_()
                d = torch.tensor(0.5, device=dev, requires_grad=True)
                y = Audio.create_from_array(v, SR).stereo_delay(
                    EFFECT_SECONDS, lt, rt, d).data
                return torch.autograd.grad((y * weight.to(dev)).sum(), (v, d))
            _, calls = capture_calls([(seq, "stereo_delay_swept_backward_cuda")],
                                     grad)
            args = calls["stereo_delay_swept_backward_cuda"][0]
            rounds = torch.zeros(1, dtype=torch.int32, device=dev)
            back(*args, rounds=rounds)
            entry["backward"] = {"ms": cuda_ms(torch, lambda: back(*args), 2),
                                 "sha256_16": digest(back(*args)),
                                 "rounds": int(rounds)}
            del args, calls
            walls = []
            for _ in range(2):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                grad()
                torch.cuda.synchronize()
                walls.append(time.perf_counter() - t0)
            entry["gradient_wall_s"] = walls[1]
        # the call itself, sampling, distances and kernel (second of two)
        walls = []
        for _ in range(2):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            Audio.create_from_array(x, SR, device=dev).stereo_delay(
                EFFECT_SECONDS, lt, rt, 0.5)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
        entry["call_wall_s"] = walls[1]
        out[name] = entry
        print(json.dumps({"stereo_delay_timing": {name: entry}}), flush=True)
    return out


def time_calls(package) -> None:
    """The --time-calls mode: the scan kernels on the filter path's planes
    and the SQPV forward and inverse at their bench shape, timed as phases
    5 and 6 time them, the k x k kernel on phase 8's multinotch planes at
    k = 4, 8 and 12 (kxk_regimes), the saturator's forward, backward and
    gradient at 10 s (saturator_timing), the swept comb's forward and
    backward on phase 8's calls (comb_timing), T3 with a digest of its
    output (probe_timing) and, where the package has it, the swept stereo
    delay on phase 9's calls (stereo_delay_timing), and nothing else."""
    card, torch, dev, _ = start(package)
    from flan_tpu_torch import Audio
    from flan_tpu_torch.ops import scan, scan_kernels, sqpv_kernels
    xq = torch.from_numpy(stereo_signal(SQPV_SECONDS)[:1]).to(dev)
    args = (SR, SQPV_BPO, SQPV_BAND)
    planes = sqpv_kernels.sqpv_forward_ref(xq, *args)
    calls = {"sqpv_forward": (
        lambda: sqpv_kernels.sqpv_forward_cuda(xq, *args),
        lambda: sqpv_kernels.sqpv_forward_ref(xq, *args)),
        "sqpv_inverse": (
        lambda: sqpv_kernels.sqpv_inverse_cuda(*planes, *args),
        lambda: sqpv_kernels.sqpv_inverse_ref(*planes, *args))}
    calls["sqpv_inverse"][1]()      # the plain versions' first use
    times = time_kernels(torch, calls)
    split = profile_launches(torch, {n: k for n, (k, _) in calls.items()})
    del planes, calls
    _, report, captured, _ = phase6_filters(torch, Audio, scan, scan_kernels,
                                            dev)
    calls = {name: (lambda k=k, a=captured[name]: k(*a),
                    lambda p=p, a=captured[name]: p(*a))
             for name, (k, p) in scan_calls(scan_kernels).items()}
    for _, plain in calls.values():
        plain()
    times.update(time_kernels(torch, calls))
    split.update(profile_launches(torch, {n: k for n, (k, _) in
                                          calls.items()}))
    del captured, calls
    kxk = kxk_regimes(torch, Audio, scan, scan_kernels, dev)
    from flan_tpu_torch.ops import sequential_kernels
    sat = saturator_timing(torch, Audio, sequential_kernels, dev)
    comb = comb_timing(torch, Audio, sequential_kernels, dev)
    probe = probe_timing(torch, dev)
    delay = (stereo_delay_timing(torch, Audio, sequential_kernels, dev)
             if hasattr(sequential_kernels, "stereo_delay_swept_cuda")
             else None)
    print(f"card: {card}", flush=True)
    print(json.dumps({"package": package or ".", "kxk_regimes": kxk,
                      "saturator": sat, "comb": comb, "probe": probe,
                      "stereo_delay": delay,
                      "call_times": times,
                      "profile_us_per_launch": split,
                      "scans_in_path": report["scans_in_path"],
                      "filter_path_ms_second": report["wall_s_second"] * 1e3,
                      "filter_stages_ms": report["stages_ms"]}), flush=True)


def main() -> None:
    parser = argparse.ArgumentParser(
        description="Smoke test of flan_tpu_torch on one NVIDIA GPU.")
    parser.add_argument("--time-calls", action="store_true",
                        help="only time the scan and SQPV kernels")
    parser.add_argument("--package", metavar="DIR", default=None,
                        help="with --time-calls: take flan_tpu_torch from DIR")
    opts = parser.parse_args()
    if opts.package is not None and not opts.time_calls:
        parser.error("--package goes with --time-calls")
    if opts.time_calls:
        return time_calls(opts.package)
    seconds = {}    # wall seconds per phase
    t_phase = time.perf_counter()

    def phase_done(name: str) -> None:
        nonlocal t_phase
        now = time.perf_counter()
        seconds[name] = round(now - t_phase, 2)
        t_phase = now

    # phases 0 and 1: the card, the build
    card, torch, dev, lib = start(None)
    from flan_tpu_torch import SQPV, Audio, pipelines
    from flan_tpu_torch.ops import (probe_kernels, scan, scan_kernels,
                                    sequential_kernels, spv_kernels,
                                    sqpv_kernels)
    from flan_tpu_torch.sqpv.transform import cq_geometry
    phase_done("0-1 card, imports, build")

    # phase 2: kernel against plain
    worst = phase2_kernel_vs_plain(torch, spv_kernels, dev)
    phase_done("2 spv cases")
    worst.update(phase2_sqpv(torch, sqpv_kernels, cq_geometry, dev))
    phase_done("2 sqpv cases")
    worst.update(phase2_scans(torch, lib, scan_kernels, scan, dev))
    worst["probe"] = phase2_probe(torch, probe_kernels, dev)
    phase_done("2 scan cases, probe")

    # phases 3 and 4: the stretch and SPV main paths, counted; the probe's
    # count runs over every main path (it lies on none)
    spv_kernels.reset_launch_counts()
    probe_kernels.reset_launch_counts()
    y_class, wall_class = phase3_stretch(torch, Audio, dev)
    phase_done("3 stretch")
    x, spv, y, wall_k = phase4_spv(torch, Audio, dev)
    launches = dict(spv_kernels.LAUNCHES)
    # phase 5: the SQPV main path, counted
    sqpv_kernels.reset_launch_counts()
    xq, sq, yq, yq_up, wall_q, peak_q = phase5_sqpv(torch, Audio, dev)
    launches.update(sqpv_kernels.LAUNCHES)
    for name, count in launches.items():
        check(count > 0, f"{name} kernel was not launched on the main path")

    m, f, errs = phase4_check(torch, spv_kernels, x, spv, y, wall_k)
    del spv, y
    times = time_kernels(torch, {
        "spv_forward": (lambda: spv_kernels.spv_forward(x, SPV_BINS, SR),
                        lambda: spv_kernels.spv_forward_ref(x, SPV_BINS, SR)),
        "spv_inverse": (lambda: spv_kernels.spv_inverse(m, f, SR),
                        lambda: spv_kernels.spv_inverse_ref(m, f, SR))})
    split = profile_launches(torch, {
        "spv_forward": lambda: spv_kernels.spv_forward(x, SPV_BINS, SR),
        "spv_inverse": lambda: spv_kernels.spv_inverse(m, f, SR)})
    del m, f
    phase_done("4 spv path, checks, timing")
    ref, errs_q = phase5_check(torch, sqpv_kernels, SQPV, xq, sq, yq, yq_up,
                               wall_q, peak_q)
    errs.update(errs_q)
    del sq, yq, yq_up
    args = (SR, SQPV_BPO, SQPV_BAND)
    times.update(time_kernels(torch, {
        "sqpv_forward": (lambda: sqpv_kernels.sqpv_forward_cuda(xq, *args),
                         lambda: sqpv_kernels.sqpv_forward_ref(xq, *args)),
        "sqpv_inverse": (lambda: sqpv_kernels.sqpv_inverse_cuda(*ref, *args),
                         lambda: sqpv_kernels.sqpv_inverse_ref(*ref, *args))}))

    split.update(profile_launches(torch, {
        "sqpv_forward": lambda: sqpv_kernels.sqpv_forward_cuda(xq, *args),
        "sqpv_inverse": lambda: sqpv_kernels.sqpv_inverse_cuda(*ref, *args)}))

    # required traffic: x in and 8 bytes a frame-bin out (SPV forward), the
    # reverse (SPV inverse); x in and 9 bytes out (SQPV forward, whose work
    # runs over the w0 warm-up frames too), the reverse (SQPV inverse)
    n_spv = x.shape[1] * SPV_BINS
    nb_q = ref[0].shape[2]
    n_sqpv = xq.shape[1] * nb_q
    w0 = cq_geometry(*args).w0
    bounds = {
        "spv_forward": bound("spv_forward", n_spv, 4 * x.shape[1] + 8 * n_spv),
        "spv_inverse": bound("spv_inverse", n_spv, 8 * n_spv + 4 * x.shape[1]),
        "sqpv_forward": bound("sqpv_forward", (w0 + xq.shape[1]) * nb_q,
                              4 * xq.shape[1] + 9 * n_sqpv),
        "sqpv_inverse": bound("sqpv_inverse", n_sqpv,
                              9 * n_sqpv + 4 * xq.shape[1])}
    del ref, x, xq
    phase_done("5 sqpv path, checks, timing")

    # phase 6: the filter and compressor main path, counted
    y6, report, captured, scan_launches = phase6_filters(
        torch, Audio, scan, scan_kernels, dev)
    launches.update(scan_launches)
    launches["probe"] = probe_kernels.LAUNCHES["probe"]
    for name in SCANS:
        check(launches[name] > 0,
              f"{name} kernel was not launched on the filter path")
    errs.update(phase6_check(torch, Audio, scan_kernels, y6, report,
                             captured, dev))
    del y6
    # the scans on the path's own planes; T3, on no path, on main's inputs
    xp, wp = (torch.from_numpy(a).to(dev) for a in probe_kernels.probe_inputs())
    calls = {"probe": (lambda: probe_kernels.probe_cuda(xp, wp),
                       lambda: probe_kernels.probe_ref(xp, wp))}
    for name, (k, p) in scan_calls(scan_kernels).items():
        a = captured[name]
        calls[name] = (lambda k=k, a=a: k(*a), lambda p=p, a=a: p(*a))
        nplanes = len(a) - (2 if name == "scan_affine2x2" else 1)
        bounds[name] = bound(name, *scan_bytes(a, nplanes, len(a) - nplanes))
    # the probe reads w, and of x only row 0's first 128 columns per step
    bounds["probe"] = bound("probe", xp.numel(), 4 * (
        xp.numel() + wp.numel() + xp.shape[0] * xp.shape[1]))
    times.update(time_kernels(torch, calls))
    split.update(profile_launches(torch, {name: k for name, (k, _) in
                                          calls.items()}))
    del captured, calls
    phase_done("6 filter path, checks, timing")

    # phase 7: the streamed pipelines; resonate and perturb, counted
    phase7_streamed(torch, Audio, pipelines, dev, y_class, wall_class)
    del y_class
    phase_done("7 streamed pipelines")
    algo_launches, algo_errs, calls7 = phase7_algorithms(
        torch, Audio, scan, scan_kernels, dev)
    by_path = {name: {"filters": launches[name],
                      "pv_algorithms": algo_launches[name]}
               for name in algo_launches}
    for name, count in algo_launches.items():
        launches[name] += count
        errs[name] = max(errs[name], algo_errs[name])
    # the scans in the methods' regime: timed, profiled with the copies of
    # their callers, bounded
    regime = {}
    calls_kind = {case: name for case, (name, _) in calls7.items()}
    for case, (name, a) in calls7.items():
        k, p = scan_calls(scan_kernels)[name]
        regime[case] = time_kernels(torch, {case: (
            lambda k=k, a=a: k(*a), lambda p=p, a=a: p(*a))})[case]
        # device time per launch of the kernel and of the wrapper's copies
        split.update(profile_launches(torch, {case: lambda k=k, a=a: k(*a)}))
        nplanes = len(a) - 1
        regime[case]["bound_ms"], regime[case]["bound_by"] = bound(
            name, *scan_bytes(a, nplanes, 1))
    pv60 = Audio.create_from_array(stereo_signal(ALGO_SECONDS), SR,
                                   device=dev).convert_to_PV(2048, 128, 4096)
    split.update(profile_launches(torch, {
        "resonate": lambda: pv60.resonate(RESONATE_SECONDS, RESONATE_DECAY),
        "perturb": lambda: pv60.perturb(PERTURB_STD, seed=3)}))
    del pv60, calls7
    print(json.dumps({"phase": 7, "scans_in_regime": regime}), flush=True)
    phase_done("7 resonate, perturb, checks, timing")

    # phase 8: the k x k scan and the sequential kernels; the filters on
    # them, counted; the gradients; resampling and convolution
    worst["scan_affine_kxk"] = phase8_kxk_cases(torch, lib, scan_kernels,
                                                dev)
    phase_done("8 k x k cases")
    launches8, _, kxk_args, seq_args, seq_out = phase8_filters(
        torch, Audio, scan, scan_kernels, sequential_kernels, dev, card)
    for name in NEW_KERNELS[:4]:
        launches[name] = launches8[name]
    phase_done("8 multinotch, comb, saturator")
    kxk12_launches, kxk12_timing = phase8_kxk12(
        torch, Audio, scan, scan_kernels, dev, card)
    launches["scan_affine_kxk"] += kxk12_launches["scan_affine_kxk"]
    phase_done("8 k = 12 multinotch")
    for name, (err, plain_ms, frames) in phase8_sequential_checks(
            torch, sequential_kernels, seq_args, seq_out).items():
        worst[name], errs[name] = err, 0.0
        times[name] = {"plain_ms": plain_ms, "plain_frames": frames}
    kxk_filters = launches["scan_affine_kxk"]
    seq_grad_launches, back_args, back_checks = \
        phase8_sequential_gradients(torch, Audio, sequential_kernels, dev,
                                    card)
    kxk_saturator = seq_grad_launches.pop("scan_affine_kxk")
    launches["scan_affine_kxk"] += kxk_saturator
    for name, count in seq_grad_launches.items():
        launches[name] = launches.get(name, 0) + count
    for name, (err, plain_ms, frames) in back_checks.items():
        worst[name], errs[name] = err, 0.0
        times[name] = {"plain_ms": plain_ms, "plain_frames": frames}
    phase_done("8 sequential checks, their gradients")
    grad_launches = phase8_gradients(torch, Audio, scan_kernels, dev, card)
    for name in SCANS:
        by_path.setdefault(name, {"filters": launches[name]})
        by_path[name]["gradients_backward"] = grad_launches[name]
        launches[name] += grad_launches[name]
    kxk_back = phase8_multinotch_gradients(torch, Audio, scan_kernels, dev,
                                           card)
    by_path["scan_affine_kxk"] = {"filters": kxk_filters,
                                  "gradients_backward": kxk_back,
                                  "saturator_backward": kxk_saturator}
    launches["scan_affine_kxk"] += kxk_back
    phase_done("8 scan gradients")
    phase8_resample_convolve(torch, Audio, dev, card)
    phase_done("8 resample, add_moisture, convolve")
    # the k x k kernel on the k = 4 multinotch's planes at 600 s (its
    # float32 plain run fits the card there; at k = 8 it would hold ~70 GB
    # of leaves): each A read once, b and y per row; the recurrence's
    # k^2 FMAs an element
    A, b, y0 = kxk_args[4]
    times.update(time_kernels(torch, {"scan_affine_kxk": (
        lambda: scan_kernels.scan_affine_kxk(A, b, y0),
        lambda: scan_kernels.affine_kxk_ref(A, b, y0))}))
    errs["scan_affine_kxk"] = 0.0
    regime8 = {}
    for k, args in sorted(kxk_args.items()):
        regime8[f"k{k}_600s_stereo"] = kxk_regime(torch, scan_kernels,
                                                   args, k)
    bounds["scan_affine_kxk"] = kxk_bound(A, b, 4)
    del A, b, y0, args, kxk_args
    regime8[f"k{2 * KXK12_ORDER}_600s_stereo"] = kxk12_timing
    clock = sm_clock_hz()
    for name, args in seq_args.items():
        fn = (sequential_kernels.comb_swept_cuda if name == "comb_swept"
              else sequential_kernels.saturator_cuda)
        # each ran at this shape in the path: two launches, none untimed
        times[name]["ms"] = cuda_ms(torch, lambda: fn(*args), 2)
        times[name]["frames"] = int(args[0].shape[1])
        bounds[name] = sequential_bound(
            name, int(args[0].shape[1]),
            args[1] if name == "comb_swept" else None, clock)
    del seq_args
    backward_fns = {"comb": sequential_kernels.comb_swept_backward_cuda,
                    "maps": sequential_kernels.saturator_backward_maps_cuda,
                    "readout":
                        sequential_kernels.saturator_backward_readout_cuda}
    for name, args in back_args.items():
        if name == "comb_swept_gradient_forward":   # as the gradient runs it
            fn = functools.partial(sequential_kernels.comb_swept_cuda,
                                   keep_u=True)
            times[name] = {}
        else:
            fn = backward_fns[name.rsplit("_", 1)[1] if name.startswith(
                "saturator") else "comb"]
        # each ran at this shape in the path or in its check
        times[name]["ms"] = cuda_ms(torch, lambda: fn(*args), 2)
        times[name]["frames"] = int(args[0].shape[1])
        bounds[name] = sequential_bound(
            name, int(args[0].shape[1]),
            args[1] if name.startswith("comb_swept") else None, clock)
        if name == "comb_swept_gradient_forward":
            (times[name]["bound_ms"], _,
             times[name]["bound_note"]) = bounds.pop(name)
    # the saturator's whole backward (its two kernels and the k x k scan),
    # on the maps' call inputs
    for two in (False, True):
        name = f"saturator_{2 if two else 1}pole_backward"
        args = back_args[f"{name}_maps"][:8]
        times[f"{name}_call"]["ms"] = cuda_ms(
            torch, lambda: sequential_kernels.saturator_backward_cuda(*args),
            2)
        (times[f"{name}_call"]["bound_ms"], times[f"{name}_call"]["bound_by"],
         times[f"{name}_call"]["bound_note"]) = saturator_backward_bound(
            two, int(args[0].shape[1]))
    split.update(profile_launches(torch, {
        f"saturator_{2 if two else 1}pole_backward_call": (
            lambda a=back_args[f"saturator_{2 if two else 1}pole_backward_"
                               "maps"][:8]:
            sequential_kernels.saturator_backward_cuda(*a))
        for two in (False, True)}))
    del back_args
    print(json.dumps({"phase": 8, "card": card, "sm_clock_hz": clock,
                      "kxk_regimes": regime8,
                      "sequential_times": {n: times[n] for n in times
                                           if n.startswith(("saturator",
                                                            "comb"))}}),
          flush=True)
    phase_done("8 timing")

    # phase 9: the effect chain, counted; the stereo delay kernel and the
    # scans on its path calls; the delays' gradients, counted
    launches9, delay_calls, scan_errs9, report9 = phase9_effects(
        torch, Audio, sequential_kernels, scan, scan_kernels, dev, card)
    for name in SCANS:
        by_path[name]["effect_chain"] = launches9[name]
        launches[name] += launches9[name]
        errs[name] = max(errs[name], scan_errs9.get(name, 0.0))
    phase_done("9 effect chain, checks")
    grad_launches9, back_calls, grads9 = phase9_delay_gradients(
        torch, Audio, sequential_kernels, dev)
    by_path["stereo_delay_swept"] = {
        "effect_chain": launches9["stereo_delay_swept"],
        "gradients": grad_launches9["stereo_delay_swept"]}
    by_path["stereo_delay_swept_backward"] = {
        "gradients": grad_launches9["stereo_delay_swept_backward"]}
    launches["stereo_delay_swept"] = sum(
        by_path["stereo_delay_swept"].values())
    launches["stereo_delay_swept_backward"] = grad_launches9[
        "stereo_delay_swept_backward"]
    phase_done("9 stereo delay gradients, checks")
    checks9 = report9["stereo_delay_checks"]
    back9 = grads9["backward_checks"]
    worst["stereo_delay_swept"] = max(
        max(v["plain_abs_err"], v["loop_abs_err"]) for v in checks9.values())
    worst["stereo_delay_swept_backward"] = max(
        max(v["plain_abs_err"], v["loop_abs_err"]) for v in back9.values())
    errs["stereo_delay_swept"] = errs["stereo_delay_swept_backward"] = 0.0
    delay = {}
    for name, args, _ in delay_calls:
        delay[name] = {"ms": cuda_ms(torch, lambda: sequential_kernels
                                     .stereo_delay_swept_cuda(*args), 2),
                       "bound": stereo_delay_bound(args)}
    back = {}
    for name, args in back_calls:
        back[name] = {"ms": cuda_ms(torch, lambda: sequential_kernels
                                    .stereo_delay_swept_backward_cuda(*args),
                                    2),
                      "bound": stereo_delay_bound(args, backward=True)}
    name = delay_calls[0][0]            # the long sweep
    times["stereo_delay_swept"] = {
        "ms": delay[name]["ms"], "frames": checks9[name]["frames"],
        "plain_ms": checks9[name]["plain_ms"],
        "plain_frames": checks9[name]["plain_frames"],
        "step_cycles": STEREO_DELAY_STEP_CYCLES,
        "calls": {n: {"ms": v["ms"], "bound_ms": v["bound"][0],
                      "bound_note": v["bound"][2],
                      "rounds": checks9[n]["rounds"],
                      "variant": checks9[n]["variant"]}
                  for n, v in delay.items()}}
    times["stereo_delay_swept_backward"] = {
        "ms": back[name]["ms"], "frames": back9[name]["frames"],
        "plain_ms": back9[name]["plain_ms"],
        "plain_frames": back9[name]["plain_frames"],
        "step_cycles": STEREO_DELAY_BACK_STEP_CYCLES,
        "calls": {n: {"ms": v["ms"], "bound_ms": v["bound"][0],
                      "bound_note": v["bound"][2],
                      "rounds": back9[n]["rounds"],
                      "variant": back9[n]["variant"],
                      "gradient_wall_s": grads9[n]["gradient_wall_s"]}
                  for n, v in back.items()}}
    bounds["stereo_delay_swept"] = delay[name]["bound"]
    bounds["stereo_delay_swept_backward"] = back[name]["bound"]
    del delay_calls, back_calls
    phase_done("9 timing")

    # phase 10: the PV family, counted at 600 s and at 30 s (the contours
    # and prism); the salience kernel and stretch_spline's linear scans on
    # the path's own calls
    from flan_tpu_torch.convert import pv_from_numpy
    from flan_tpu_torch.ops import pv_info_kernels
    from flan_tpu_torch.pv import information
    phase10_cpu_checks(torch, Audio, pv_from_numpy, pv_info_kernels,
                       information, dev, card)
    phase_done("10 pv family at 10 s, card vs cpu")
    launches10, kept10, _ = phase10_pv_family(
        torch, Audio, scan, scan_kernels, pv_info_kernels, dev, card)
    by_path["scan_linear"]["pv_family"] = launches10["scan_linear"]
    launches["scan_linear"] += launches10["scan_linear"]
    phase_done("10 pv family at 600 s")
    contour_launches, _ = phase10_contours(torch, Audio, pv_info_kernels,
                                           dev, card)
    by_path["salience_histogram"] = {
        "pv_family": launches10["salience_histogram"],
        "contours_prism": contour_launches}
    launches["salience_histogram"] = sum(
        by_path["salience_histogram"].values())
    phase_done("10 contours, prism at 30 s")
    checks10, worst["salience_histogram"], scan_err10 = \
        phase10_kernel_checks(torch, scan_kernels, pv_info_kernels, kept10)
    del kept10
    errs["scan_linear"] = max(errs["scan_linear"], scan_err10)
    errs["salience_histogram"] = 0.0
    sal = checks10["salience_histogram"]
    times["salience_histogram"] = {
        k: sal[k] for k in ("ms", "plain_ms", "plain_frames",
                            "library_same_bits",
                            "bins_apart_by_float32_log2",
                            "order_same_bits", "plain_same_bits")}
    bounds["salience_histogram"] = (
        sal["bound_ms"], "bytes", "i_f and i_m read, the salience written, "
        f"{sal['bytes']} bytes at 3.35 TB/s")
    regime["stretch_spline"] = {
        "ms": checks10["scan_linear_ms"],
        "bound_ms": checks10["scan_linear_bound"][0],
        "bound_by": checks10["scan_linear_bound"][1],
        "shape": checks10["scan_linear"]["shape"]}
    calls_kind["stretch_spline"] = "scan_linear"
    phase_done("10 kernel checks, timing")

    # phase 11: the synthesis family, the granular engine, delay and the
    # Wavetable at 48 kHz, counted; K1-K3 on the path's own calls
    from flan_tpu_torch.ops import cycle_scan as cycle_mod
    from flan_tpu_torch.ops import grain_mix
    from flan_tpu_torch.ops import random as random_mod
    synth_mods = (random_mod, cycle_mod, grain_mix)
    phase11_cpu_checks(torch, Audio, dev, card)
    phase_done("11 synthesis at 10 s, card vs cpu")
    launches11, scan11, kept11, _ = phase11_synthesis(
        torch, Audio, synth_mods, scan_kernels, dev, card)
    launches.update(launches11)
    launches["scan_affine2x2"] += scan11
    by_path["scan_affine2x2"]["wavetable"] = scan11
    phase_done("11 synthesis at 600 s")
    times11 = phase11_kernel_checks(torch, synth_mods, kept11)
    del kept11
    phase_done("11 kernel checks, timing")
    print(json.dumps({"profile_us_per_launch": split}), flush=True)
    print(json.dumps({"phase_seconds": seconds,
                      "seconds": round(sum(seconds.values()), 1)}), flush=True)

    source = {"spv": "flan_tpu_torch/csrc/spv_kernels.cu",
              "sqpv": "flan_tpu_torch/csrc/sqpv_kernels.cu",
              "scan": "flan_tpu_torch/csrc/scan_kernels.cu",
              "probe": "flan_tpu_torch/csrc/probe_kernels.cu",
              "saturator": "flan_tpu_torch/csrc/sequential_kernels.cu",
              "comb": "flan_tpu_torch/csrc/sequential_kernels.cu",
              "stereo": "flan_tpu_torch/csrc/sequential_kernels.cu",
              "salience": "flan_tpu_torch/csrc/pv_info_kernels.cu"}
    replaces = {"spv_forward": "flan_tpu/ops/spv_pallas.py:93",
                "spv_inverse": "flan_tpu/ops/spv_pallas.py:239",
                "sqpv_forward": "flan_tpu/ops/sqpv_pallas.py:139",
                "sqpv_inverse": "flan_tpu/ops/sqpv_pallas.py:336",
                # T1 (tile totals) and T2 (apply) of one two-pass scan
                "scan_linear": "tools/pallas_scan_experiment.py:64,117",
                "scan_max_affine": "tools/pallas_scan_experiment.py:64,117",
                "scan_affine2x2": "tools/pallas_scan_experiment.py:64,117",
                "probe": "tools/probe_pallas_ops.py:20",
                "scan_affine_kxk": "tools/pallas_scan_experiment.py:64,117",
                # no TPU kernel: the JAX package's lax.scan loops
                "saturator_1pole": "flan_tpu/audio/filters.py:603",
                "saturator_2pole": "flan_tpu/audio/filters.py:569",
                "comb_swept": "flan_tpu/audio/filters.py:643",
                # jax.grad through those loops
                "saturator_1pole_backward_maps":
                    "flan_tpu/audio/filters.py:603",
                "saturator_1pole_backward_readout":
                    "flan_tpu/audio/filters.py:603",
                "saturator_2pole_backward_maps":
                    "flan_tpu/audio/filters.py:569",
                "saturator_2pole_backward_readout":
                    "flan_tpu/audio/filters.py:569",
                "comb_swept_backward": "flan_tpu/audio/filters.py:643",
                "stereo_delay_swept": "flan_tpu/audio/temporal.py:511",
                "stereo_delay_swept_backward":
                    "flan_tpu/audio/temporal.py:511",
                # no TPU kernel: XLA's scatter-add and convolution
                "salience_histogram": "flan_tpu/pv/information.py:121"}
    path = {"spv_forward": "spv", "spv_inverse": "spv",
            "sqpv_forward": "sqpv", "sqpv_inverse": "sqpv",
            "scan_linear": "filters, pv_algorithms, gradients, "
                           "effect chain, pv family (stretch_spline)",
            "scan_max_affine": "filters, pv_algorithms, gradients",
            "scan_affine2x2": "filters, gradients, effect chain, "
                              "wavetable (its lowpass's FIR probe)",
            "probe": None,
            "scan_affine_kxk": "multinotch filters",
            "saturator_1pole": "saturator multinotch, gradients",
            "saturator_2pole": "saturator multinotch, gradients",
            "comb_swept": "swept comb, gradients",
            "saturator_1pole_backward_maps": "gradients",
            "saturator_1pole_backward_readout": "gradients",
            "saturator_2pole_backward_maps": "gradients",
            "saturator_2pole_backward_readout": "gradients",
            "comb_swept_backward": "gradients",
            "stereo_delay_swept": "effect chain (stereo_delay), gradients",
            "stereo_delay_swept_backward": "gradients (stereo_delay)",
            "salience_histogram": "pv family (get_salience, get_contours, "
                                  "prism)"}
    errs["probe"] = 0.0     # compared in phase 2 only
    kernels = [{"name": name, "route": "cuda",
                "source": source[name.split("_")[0]],
                "replaces": replaces[name], "path": path[name],
                "launches": launches[name],
                "max_abs_err": max(worst[name], errs[name]),
                **times[name],
                "bound_ms": bounds[name][0], "bound_by": bounds[name][1],
                "share_of_bound": bounds[name][0] / times[name]["ms"],
                # no single PyTorch call computes any of these functions
                "library_ms": None}
               for name in replaces]
    for entry in kernels:
        if entry["name"] in NEW_KERNELS[1:]:
            entry["replaces_note"] = ("jax.grad through a lax.scan: no TPU "
                                      "kernel" if entry["name"] in
                                      BACKWARD_KERNELS else
                                      "a lax.scan: no TPU kernel")
            if "_backward_" in entry["name"]:
                entry["backward_call"] = times[
                    entry["name"].rsplit("_", 1)[0] + "_call"]
            entry["bound_note"] = bounds[entry["name"]][2]
        if entry["name"] in by_path:
            entry["launches_by_path"] = by_path[entry["name"]]
            entry["regimes"] = {case: t for case, t in regime.items()
                                if calls_kind[case] == entry["name"]}
        if entry["name"] == "scan_affine_kxk":
            entry["regimes"] = regime8
        if entry["name"].startswith("stereo_delay_swept"):
            entry["replaces_note"] = (
                "jax.grad through a lax.scan: no TPU kernel"
                if entry["name"].endswith("_backward")
                else "a lax.scan: no TPU kernel")
            entry["bound_note"] = bounds[entry["name"]][2]
        if entry["name"] == "salience_histogram":
            entry["replaces_note"] = ("XLA's scatter-add and HIGHEST "
                                      "convolution: no TPU kernel")
            entry["bound_note"] = bounds[entry["name"]][2]
            entry["library_ms"] = sal["library_ms"]
            entry["library_note"] = (
                "index_add_ of the precomputed contributions and conv1d, "
                "torch's defaults (float atomics, cudnn TF32 allowed)")
    synth_source = {"threefry_uniform":
                    "flan_tpu_torch/csrc/random_kernels.cu",
                    "cycle_scan": "flan_tpu_torch/csrc/synth_kernels.cu",
                    "grain_overlap_add":
                    "flan_tpu_torch/csrc/synth_kernels.cu"}
    synth_replaces = {
        "threefry_uniform": ("flan_tpu/audio/synthesis.py:74",
                             "XLA's jax.random threefry: no TPU kernel"),
        "cycle_scan": ("flan_tpu/audio/synthesis.py:57",
                       "XLA's associative_scan: no TPU kernel"),
        "grain_overlap_add": ("flan_tpu/audio/synthesis.py:709",
                              "XLA's planned gathers (scatter-add): no TPU "
                              "kernel")}
    synth_path = {"threefry_uniform": "synthesis (noise, spectrum)",
                  "cycle_scan": "synthesis (waveform, pulsars)",
                  "grain_overlap_add": "granular engine (granulate, psola, "
                                       "texture with a mod)"}
    for name in SYNTH_KERNELS:
        t = times11[name]
        kernels.append({
            "name": name, "route": "cuda", "source": synth_source[name],
            "replaces": synth_replaces[name][0],
            "replaces_note": synth_replaces[name][1],
            "path": synth_path[name], "launches": launches[name],
            "max_abs_err": t["max_abs_err"], "ms": t["ms"],
            "plain_ms": t["plain_ms"], "call": t["call"],
            "checked": t["checked"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "bound_note": t["bound_note"],
            "share_of_bound": t["bound_ms"] / t["ms"],
            "library_ms": t["library_ms"],
            "library_note": t["library_note"]})
    print(f"card: {card}", flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
