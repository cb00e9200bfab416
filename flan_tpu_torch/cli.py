"""Command-line batch processor: render files on the card (the counterpart
of flan_tpu/cli.py, with its subcommands, argument names, defaults and
exit messages).

Usage:
    python -m flan_tpu_torch stretch --factor 2.0 out_dir in1.wav in2.wav
    python -m flan_tpu_torch repitch --factor 1.5 out_dir in.wav
    python -m flan_tpu_torch morph --amount 0.5 out_dir a.wav b.wav
    python -m flan_tpu_torch filter-lowpass --cutoff 2000 --order 2 out in.wav
    python -m flan_tpu_torch resample --rate 48000 out_dir in.wav
    python -m flan_tpu_torch spectrogram out_dir in.wav     # BMP per input

Inputs are read by any codec Audio.load_from_file reads, outputs written
as WAV float32 (BMP for spectrogram). The work runs on the card; `main`
takes the device as a keyword for callers that want the CPU. Clips are
rendered one by one, each at its own length and sample rate.

Under a launcher that starts several ranks, e.g.

    python -m torch.distributed.run --standalone --nproc-per-node 4 \
        -m flan_tpu_torch stretch --factor 2.0 out_dir a.wav b.wav c.wav

stretch and repitch shard clips of one (channels, frames, sample rate)
over the ranks (parallel/batch.py map_sharded); rank 0 renders everything
else, and rank 0 alone writes and prints: the files and the printed paths
are a one-process run's.
"""
from __future__ import annotations

import argparse
import os
import sys
from typing import List

from flan_tpu_torch.core.types import DEFAULT_DEVICE


def _out_paths(out_dir: str, in_paths: List[str],
               suffix: str = ".wav") -> List[str]:
    """Collision-free output names: inputs from different directories with
    the same basename get _1, _2, ... suffixes instead of silently
    overwriting each other."""
    seen = {}
    out = []
    for p in in_paths:
        base = os.path.splitext(os.path.basename(p))[0]
        k = seen.get(base, 0)
        seen[base] = k + 1
        name = base if k == 0 else f"{base}_{k}"
        out.append(os.path.join(out_dir, name + suffix))
    return out


def _load(paths: List[str], device):
    """Decode and stage the inputs through the prefetching loader (clip
    k + 1 is decoded and copied while clip k is taken)."""
    from flan_tpu_torch.io.loader import LoadError, iter_audio_prefetched
    clips = []
    try:
        for p, c in iter_audio_prefetched(paths, device=device):
            if c.is_null():
                raise SystemExit(f"could not read {p}")
            clips.append(c)
    except LoadError as e:
        # the loader raises decode errors (unreadable or corrupt files)
        # as LoadError, a RuntimeError; surface them like the is_null path
        raise SystemExit(f"could not read: {e}") from e
    return clips


def _save_all(clips, paths, out_dir: str) -> None:
    os.makedirs(out_dir, exist_ok=True)
    for clip, q in zip(clips, _out_paths(out_dir, paths)):
        clip.save_to_file(q)
        print(q)


def _render_each(render, clips, paths, out_dir, cancel=None, mesh=None,
                 batch_fn=None) -> None:
    """Render and save the clips, polling cancel between dispatches (the
    host-side flan_CANCEL_POINT analog, utils/cancel.py). On a mesh of
    several ranks, clips of one (channels, frames, sample rate) go through
    map_sharded with batch_fn(sample_rate), a [C, N] -> [C, M] transform,
    as flan_tpu's CLI shards them over its devices (cli.py _maybe_batch);
    otherwise rank 0 (or the one process) renders each clip alone with
    render(clip). Only rank 0 saves."""
    keys = {(c.num_channels, c.num_frames, c.sample_rate) for c in clips}
    if (mesh is not None and mesh.size > 1 and batch_fn is not None
            and len(clips) > 1 and len(keys) == 1):
        from flan_tpu_torch.parallel.batch import map_sharded
        if cancel is not None:
            cancel.check()
        outs = map_sharded(batch_fn(clips[0].sample_rate),
                           [c.data for c in clips], mesh)
        rendered = [c._with(data=out) for c, out in zip(clips, outs)]
    elif mesh is not None and mesh.rank != 0:
        return
    else:
        rendered = []
        for c in clips:
            if cancel is not None:
                cancel.check()
            rendered.append(render(c))
    if mesh is None or mesh.rank == 0:
        _save_all(rendered, paths, out_dir)


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="flan_tpu_torch", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    sub = ap.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("stretch", help="PV time stretch (fused streaming)")
    p.add_argument("--factor", type=float, required=True)
    p.add_argument("out_dir")
    p.add_argument("inputs", nargs="+")

    p = sub.add_parser("repitch", help="PV pitch scale (fused streaming)")
    p.add_argument("--factor", type=float, required=True)
    p.add_argument("out_dir")
    p.add_argument("inputs", nargs="+")

    p = sub.add_parser("morph", help="spectral morph of two inputs")
    p.add_argument("--amount", type=float, default=0.5)
    p.add_argument("out_dir")
    p.add_argument("inputs", nargs=2)

    p = sub.add_parser("filter-lowpass", help="Butterworth lowpass")
    p.add_argument("--cutoff", type=float, required=True)
    p.add_argument("--order", type=int, default=2)
    p.add_argument("out_dir")
    p.add_argument("inputs", nargs="+")

    p = sub.add_parser("resample", help="rational polyphase resample")
    p.add_argument("--rate", type=float, required=True)
    p.add_argument("out_dir")
    p.add_argument("inputs", nargs="+")

    p = sub.add_parser("spectrogram", help="render spectrogram BMPs")
    p.add_argument("out_dir")
    p.add_argument("inputs", nargs="+")

    p = sub.add_parser("convolve", help="FFT convolution with an IR file")
    p.add_argument("--ir", required=True, help="impulse-response WAV")
    p.add_argument("out_dir")
    p.add_argument("inputs", nargs="+")

    p = sub.add_parser("granulate",
                       help="granular resynthesis (dense batched grains)")
    p.add_argument("--length", type=float, required=True,
                   help="output length, seconds")
    p.add_argument("--grains-per-second", type=float, default=20.0)
    p.add_argument("--grain-length", type=float, default=0.1)
    p.add_argument("--scan-rate", type=float, default=1.0,
                   help="source read rate (selection = rate * t)")
    p.add_argument("--fade", type=float, default=0.01)
    p.add_argument("--scatter", type=float, default=0.1)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("out_dir")
    p.add_argument("inputs", nargs="+")

    p = sub.add_parser(
        "eq", help="whole-signal spectral EQ (Spectrum.multiply): "
                   "brick-wall band-pass between --low and --high Hz")
    p.add_argument("--low", type=float, default=0.0)
    p.add_argument("--high", type=float, default=1e9)
    p.add_argument("out_dir")
    p.add_argument("inputs", nargs="+")

    p = sub.add_parser(
        "wavetable", help="pitch-tracked wavetable resynthesis: extract a "
                          "table from each input, replay at --freq Hz "
                          "scanning the table over the output")
    p.add_argument("--length", type=float, required=True,
                   help="output length, seconds")
    p.add_argument("--freq", type=float, default=110.0)
    p.add_argument("out_dir")
    p.add_argument("inputs", nargs="+")

    p = sub.add_parser("stereo-delay",
                       help="cross-feedback stereo delay (stereo inputs)")
    p.add_argument("--length", type=float, required=True,
                   help="output length, seconds")
    p.add_argument("--l-time", type=float, required=True)
    p.add_argument("--r-time", type=float, required=True)
    p.add_argument("--decay", type=float, default=0.5)
    p.add_argument("out_dir")
    p.add_argument("inputs", nargs="+")
    return ap


def main(argv=None, cancel=None, device=DEFAULT_DEVICE) -> int:
    """Run one subcommand. cancel: an optional utils.cancel.CancelToken
    honored between clip dispatches; device: where the work runs, the
    card unless named."""
    args = _parser().parse_args(argv)
    from flan_tpu_torch.parallel.mesh import launcher_mesh
    with launcher_mesh(device) as mesh:
        if mesh is not None and mesh.rank != 0 \
                and args.cmd not in ("stretch", "repitch"):
            return 0    # rank 0 renders what is not sharded
        return _run(args, cancel, device, mesh)


def _run(args, cancel, device, mesh) -> int:
    out_dir = args.out_dir

    def each(render, batch_fn=None):
        _render_each(render, _load(args.inputs, device), args.inputs,
                     out_dir, cancel, mesh, batch_fn)

    def streamed(pipeline):
        """(render, batch_fn) of a streamed pipeline at --factor."""
        def batch_fn(sr):
            return lambda x: pipeline(x, args.factor, sample_rate=float(sr))
        return (lambda c: c._with(data=batch_fn(c.sample_rate)(c.data)),
                batch_fn)

    if args.cmd == "stretch":
        from flan_tpu_torch.pipelines import pv_stretch_pipeline
        each(*streamed(pv_stretch_pipeline))
    elif args.cmd == "repitch":
        from flan_tpu_torch.pipelines import pv_repitch_pipeline
        each(*streamed(pv_repitch_pipeline))
    elif args.cmd == "morph":
        a, b = _load(args.inputs, device)
        if a.sample_rate != b.sample_rate:
            raise SystemExit(
                f"morph inputs must share a sample rate "
                f"({a.sample_rate:g} vs {b.sample_rate:g}); resample first")
        from flan_tpu_torch.pipelines import pv_morph_pipeline
        out = pv_morph_pipeline(a.data, b.data, args.amount,
                                sample_rate=float(a.sample_rate))
        os.makedirs(out_dir, exist_ok=True)
        q = _out_paths(out_dir, [args.inputs[0]], "_morph.wav")[0]
        a._with(data=out).save_to_file(q)
        print(q)
    elif args.cmd == "filter-lowpass":
        each(lambda c: c.filter_2pole_lowpass(args.cutoff, 0.5, args.order))
    elif args.cmd == "resample":
        each(lambda c: c.resample(args.rate))
    elif args.cmd == "spectrogram":
        clips = _load(args.inputs, device)
        os.makedirs(out_dir, exist_ok=True)
        for c, q in zip(clips, _out_paths(out_dir, args.inputs, ".bmp")):
            c.convert_to_PV().convert_to_graph().save_image(q)
            print(q)
    elif args.cmd == "convolve":
        ir = _load([args.ir], device)[0]
        each(lambda c: c.convolve(ir))
    elif args.cmd == "granulate":
        rate = args.scan_rate
        each(lambda c: c.granulate(
            args.length, args.grains_per_second, args.scatter,
            lambda t: rate * t, args.grain_length, args.fade,
            seed=args.seed))
    elif args.cmd == "eq":
        import numpy as np
        import torch
        from flan_tpu_torch.spectrum import Spectrum

        def band_pass(c):
            spec = c.convert_to_spectrum()
            n = 2 * (spec.num_bins - 1)
            f = np.arange(spec.num_bins) * (c.sample_rate / n)
            mask = ((f >= args.low) & (f <= args.high)).astype(np.complex64)
            return spec.multiply(Spectrum(
                data=torch.from_numpy(mask[None]),
                sample_rate=c.sample_rate)).convert_to_audio()
        each(band_pass)
    elif args.cmd == "wavetable":
        from flan_tpu_torch.wavetable import Wavetable

        def resynthesize(c):
            wt = Wavetable(c)
            if wt.is_null():
                raise SystemExit("wavetable extraction found no waveforms "
                                 "(input too short or unpitched)")
            # ratio is [0, 1] start-to-end of the table (Wavetable.h:81);
            # stop just short of 1: the reference's table keeps one
            # all-zero slot past the last resampled cycle and r=1 lands
            # on it (Wavetable.cpp:77-88)
            return wt.synthesize(args.length, args.freq,
                                 lambda t, _l=args.length: 0.98 * t / _l)
        each(resynthesize)
    elif args.cmd == "stereo-delay":
        def delay(c):
            out = c.stereo_delay(args.length, args.l_time, args.r_time,
                                 args.decay)
            if out.is_null():
                raise SystemExit(
                    "stereo-delay requires stereo inputs with positive "
                    "delay times")
            return out
        each(delay)
    return 0


if __name__ == "__main__":
    sys.exit(main())
