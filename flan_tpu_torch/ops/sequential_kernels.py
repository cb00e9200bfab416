"""Sequential recurrences of the filter family and the stereo delay:
Hopper kernels and plain versions.

Three per-sample loops have no parallel form: the tanh-feedback multinotch
(flan_tpu/audio/filters.py _multinotch_saturator_scan, :524-604), the
comb with a per-sample delay (filter_comb's ring buffer, :622-644) and the
swept cross-feedback stereo delay (flan_tpu/audio/temporal.py:504-528).
The JAX package runs them as lax.scan and differentiates the first two
through it; no TPU kernel stands behind them. One CUDA source,
csrc/sequential_kernels.cu, runs the saturator's forward as one warp a
channel, the comb's forward and backward as one block a channel (a warp
on the chain, three staging its tiles and computing its rounds), the
saturator's backward as a parallel job, and the stereo delay and its
backward as one block that plans its own rounds (of at most a warp, or
for the forward, where every read is far back, of up to a tile on eight
warps):

  saturator_1pole / saturator_2pole    saturator_1pole_ref, saturator_2pole_ref
  saturator_*_backward_maps            saturator_adjoint_maps_ref
  saturator_*_backward_readout         saturator_adjoint_readout_ref
  comb_swept                           comb_swept_ref
  comb_swept_backward                  comb_swept_backward_ref
  stereo_delay_swept                   stereo_delay_ref
  stereo_delay_swept_backward          stereo_delay_backward_ref

The plain versions are PyTorch loops over time, vectorised over channels,
in the JAX package's order of operations (powers by binary exponentiation,
as jax.lax.integer_pow); the saturator's backward passes are vectorised
over time. The swept comb's loops take as many steps at once as read no
output of each other (the least delay ahead), as the kernels do: each
element's arithmetic is the same whatever the step count. The kernels'
own rounds (comb_round_lengths, comb_round_starts) and the one-step
checks that hold a whole call to its own earlier outputs
(comb_step_errors, comb_backward_step_error, saturator_step_errors) are
here too.

The backward is the adjoint of each loop (SaturatorMultinotch, CombSwept,
StereoDelaySwept: torch.autograd.Functions used on both devices, plain versions on the CPU
and kernels on the card, as ops/scan.py's recurrences). The saturator's
forward keeps every step's allpass states. The adjoint it carries from
step to step is linear, so its backward (saturator_backward_plain,
saturator_backward_cuda) builds each step's map from the rerun step, runs
the affine recurrence of the maps in reverse time on the k x k scan, and
reads each step's gradients out; saturator_backward_ref, the adjoint of
the 8 Newton steps, the cascade and the feedback sum step by step in
reverse time as jax.grad takes it through lax.scan, is the tests' oracle.
The comb's forward keeps u; its backward scatters each step's adjoint back
to the step it read, u's adjoint, and the feedback's and the mix's
gradients follow from u in PyTorch.

The stereo delay's forward keeps w; its backward sends each step's
adjoints back to the values it read, in reverse time, and the decay's
gradient follows from w in PyTorch. Its distances from the delay times
(stereo_delay_frames, stereo_delay_reads: PyTorch on the call's device),
its rounds (stereo_delay_round_starts, the host's planner; the kernels'
own, stereo_delay_narrow_starts and stereo_delay_wide_starts), its
one-step checks
(stereo_delay_step_errors, stereo_delay_backward_step_error) and the loop
and its adjoint step by step on the host (stereo_delay_loop,
stereo_delay_backward_loop: the oracles, too slow for a path) are here
too.

Dispatch by device: a CPU tensor goes to the plain version, a CUDA tensor
to the kernel or the call raises. LAUNCHES counts each wrapper's kernel
launches.
"""
from __future__ import annotations

import numpy as np
import torch

from flan_tpu_torch.ops import build, scan_kernels
from flan_tpu_torch.ops.build import check_cuda, load_library, raise_on
from flan_tpu_torch.ops.scan import _on_cpu, _wants_grad

LAUNCHES = {"saturator_1pole": 0, "saturator_2pole": 0, "comb_swept": 0,
            "saturator_1pole_backward_maps": 0,
            "saturator_1pole_backward_readout": 0,
            "saturator_2pole_backward_maps": 0,
            "saturator_2pole_backward_readout": 0,
            "comb_swept_backward": 0, "stereo_delay_swept": 0,
            "stereo_delay_swept_backward": 0}


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def ipow(x, e: int):
    """x ** e for an integer e >= 0 in the order of jax.lax.integer_pow:
    binary exponentiation, the accumulator multiplied on the left."""
    if e == 0:
        return torch.ones_like(x)
    acc = None
    while e > 0:
        if e & 1:
            acc = x if acc is None else acc * x
        e >>= 1
        if e > 0:
            x = x * x
    return acc


# ------------------------------------------------------------ plain versions

def _newton_forward(u, x, k, gn, msum, inv: float):
    """The 8 Newton steps on u = x + inv tanh(k (gn u + msum)) from u, with
    the |den| < 1e-6 guard (filters.py:547-551): the iterates u_0 .. u_8,
    and each step's tanh, denominator and guard."""
    us, ts, dens, guards = [u], [], [], []
    for _ in range(8):
        t = torch.tanh(k * (gn * u + msum))
        den = inv * (1 - t * t) * k * gn - 1.0
        guard = torch.abs(den) < 1e-6
        den = torch.where(guard, 1.0, den)
        u = u - (x + inv * t - u) / den
        us.append(u)
        ts.append(t)
        dens.append(den)
        guards.append(guard)
    return us, ts, dens, guards


def _newton_backward(gu, fwd, x, k, gn, msum, inv: float):
    """The adjoint of the Newton steps: from the cotangent of u_8 to those
    of u_0 (the last output), x, k, gn and msum. A guarded denominator is
    the constant 1 and passes nothing back."""
    us, ts, dens, guards = fwd
    gx = gk = ggn = gmsum = 0.0
    for it in reversed(range(8)):
        u, t, den = us[it], ts[it], dens[it]
        r = x + inv * t - u
        gr = -gu / den
        gden = torch.where(guards[it], 0.0, gu * r / (den * den))
        sech2 = 1 - t * t
        gt = inv * gr - 2.0 * t * (gden * (inv * k * gn))
        gk = gk + gden * (inv * sech2 * gn)
        ggn = ggn + gden * (inv * sech2 * k)
        w = gt * sech2 * k
        gk = gk + gt * sech2 * (gn * u + msum)
        ggn = ggn + w * u
        gmsum = gmsum + w
        gx = gx + gr
        gu = gu - gr + w * gn
    return gu, gx, gk, ggn, gmsum


def _ipow_grad(x, e: int):
    """d(x ** e)/dx = e x ** (e - 1)."""
    return e * ipow(x, e - 1) if e > 0 else torch.zeros_like(x)


def _step_1pole(s, prev, xt, g, G_f, G_ap, k, mix, inv, order):
    """One step of the 1-pole saturator from states s and the last output:
    (new states, output, what the backward reruns)."""
    msum0 = torch.zeros_like(xt)
    for i in range(order):
        msum0 = msum0 + ipow(G_ap, i) * s[order - 1 - i]
    msum = msum0 * 2.0 / (1.0 + g)
    gn = ipow(G_ap, order)
    fwd = _newton_forward(prev, xt, k, gn, msum, inv)
    xbar = fwd[0][-1]
    y, ys, new = xbar, [], []
    for j in range(order):
        ys.append(y)
        v = G_f * (y - s[j])
        lp = v + s[j]
        new.append(lp + v)
        y = 2 * lp - y
    yv = y * inv
    out = mix * xbar + (1 - mix) * yv
    return new, out, (msum0, msum, gn, fwd, xbar, ys, yv)


def _step_2pole(s, prev, xt, g, G, k, mix, R, d, inv, order):
    """One step of the 2-pole saturator; s holds (s1, s2) of each stage in
    turn."""
    msum = torch.zeros_like(xt)
    for i in range(order):
        j = order - 1 - i
        msum = msum + ipow(G, i) * (g * s[2 * j + 1] - s[2 * j])
    gn = ipow(G, order)
    fwd = _newton_forward(prev, xt, k, gn, msum, inv)
    xbar = fwd[0][-1]
    y, ys, new = xbar, [], []
    for j in range(order):
        ys.append(y)
        g1 = 2 * R + g
        hp = (y - g1 * s[2 * j] - s[2 * j + 1]) * d
        v1 = g * hp
        bp = v1 + s[2 * j]
        v2 = g * bp
        lp = v2 + s[2 * j + 1]
        new += [bp + v1, lp + v2]
        y = lp - bp * 2 * R + hp
    yv = y * inv
    out = mix * xbar + (1 - mix) * yv
    return new, out, (msum, gn, fwd, xbar, ys, yv)


def _saturator_ref(x, planes, inv: float, order: int, two_pole: bool,
                   keep_states: bool):
    c, n = x.shape
    ns = 2 * order if two_pole else order
    s = [x.new_zeros(c) for _ in range(ns)]
    prev = x.new_zeros(c)
    out, states = [], []
    for t in range(n):
        at = [p[t] for p in planes]
        if two_pole:
            s, prev, _ = _step_2pole(s, prev, x[:, t], *at, inv, order)
        else:
            s, prev, _ = _step_1pole(s, prev, x[:, t], *at, inv, order)
        out.append(prev)
        if keep_states:
            states.append(torch.stack(s, dim=1))
    y = torch.stack(out, dim=1)
    return (y, torch.stack(states, dim=2)) if keep_states else y


def saturator_1pole_ref(x, g, G_f, G_ap, k, mix, inv: float, order: int,
                        keep_states: bool = False):
    """The 1-pole saturator multinotch (filters.py:580-604): x [C, N], the
    coefficient planes [N]. Newton starts from the last step's output, not
    from the last feedback value: the JAX package carries (states, out).
    With keep_states, also every step's new states [C, order, N]."""
    return _saturator_ref(x, (g, G_f, G_ap, k, mix), inv, order, False,
                          keep_states)


def saturator_2pole_ref(x, g, G, k, mix, R, d, inv: float, order: int,
                        keep_states: bool = False):
    """The 2-pole saturator multinotch (filters.py:530-577): x [C, N], the
    coefficient planes [N]; the carry is (states, out) as in the 1-pole.
    With keep_states, also every step's new states [C, 2 order, N], (s1,
    s2) of each stage in turn."""
    return _saturator_ref(x, (g, G, k, mix, R, d), inv, order, True,
                          keep_states)


def _back_1pole(gout, gs, s, prev, xt, g, G_f, G_ap, k, mix, inv, order):
    """The adjoint of _step_1pole: from the cotangents of the output and
    the new states to those of the old states, the last output, x and the
    planes (g, G_f, G_ap, k, mix)."""
    _, _, trace = _step_1pole(s, prev, xt, g, G_f, G_ap, k, mix, inv, order)
    return _adjoint_1pole(trace, gout, gs, s, xt, g, G_f, G_ap, k, mix, inv,
                          order)


def _adjoint_1pole(trace, gout, gs, s, xt, g, G_f, G_ap, k, mix, inv, order):
    """_back_1pole's adjoint on the step's trace (what _step_1pole
    returns third): linear in (gout, gs)."""
    msum0, msum, gn, fwd, xbar, ys, yv = trace
    gmix = gout * (xbar - yv)
    gy = gout * (1 - mix) * inv
    gGf = 0.0
    gs_in = [None] * order
    for j in reversed(range(order)):
        glp = 2 * gy + gs[j]
        gv = gs[j] + glp
        gGf = gGf + gv * (ys[j] - s[j])
        gs_in[j] = glp - gv * G_f
        gy = gv * G_f - gy
    gxbar = gout * mix + gy
    gprev, gx, gk, ggn, gmsum = _newton_backward(gxbar, fwd, xt, k, gn,
                                                 msum, inv)
    gmsum0 = gmsum * 2.0 / (1.0 + g)
    gg = -gmsum * msum0 * 2.0 / ((1.0 + g) * (1.0 + g))
    gGa = ggn * _ipow_grad(G_ap, order)
    for i in range(order):
        j = order - 1 - i
        gs_in[j] = gs_in[j] + gmsum0 * ipow(G_ap, i)
        gGa = gGa + gmsum0 * s[j] * _ipow_grad(G_ap, i)
    return gs_in, gprev, gx, (gg, gGf, gGa, gk, gmix)


def _back_2pole(gout, gs, s, prev, xt, g, G, k, mix, R, d, inv, order):
    """The adjoint of _step_2pole; the planes are (g, G, k, mix, R, d)."""
    _, _, trace = _step_2pole(s, prev, xt, g, G, k, mix, R, d, inv, order)
    return _adjoint_2pole(trace, gout, gs, s, xt, g, G, k, mix, R, d, inv,
                          order)


def _adjoint_2pole(trace, gout, gs, s, xt, g, G, k, mix, R, d, inv, order):
    """_back_2pole's adjoint on the step's trace."""
    msum, gn, fwd, xbar, ys, yv = trace
    gmix = gout * (xbar - yv)
    gy = gout * (1 - mix) * inv
    gg = gR = gd = 0.0
    gs_in = [None] * (2 * order)
    for j in reversed(range(order)):
        s1, s2 = s[2 * j], s[2 * j + 1]
        g1 = 2 * R + g
        inner = ys[j] - g1 * s1 - s2
        hp = inner * d
        v1 = g * hp
        bp = v1 + s1
        glp = gy + gs[2 * j + 1]
        gv2 = gs[2 * j + 1] + glp
        gbp = gs[2 * j] + gv2 * g - gy * 2 * R
        gR = gR - gy * 2 * bp
        gg = gg + gv2 * bp
        gv1 = gs[2 * j] + gbp
        gg = gg + gv1 * hp
        ghp = gy + gv1 * g
        gd = gd + ghp * inner
        gin = ghp * d
        gg1 = -gin * s1
        gR = gR + 2 * gg1
        gg = gg + gg1
        gs_in[2 * j] = gbp - gin * g1
        gs_in[2 * j + 1] = glp - gin
        gy = gin
    gxbar = gout * mix + gy
    gprev, gx, gk, ggn, gmsum = _newton_backward(gxbar, fwd, xt, k, gn,
                                                 msum, inv)
    gG = ggn * _ipow_grad(G, order)
    for i in range(order):
        j = order - 1 - i
        p = ipow(G, i)
        s1, s2 = s[2 * j], s[2 * j + 1]
        gs_in[2 * j + 1] = gs_in[2 * j + 1] + gmsum * p * g
        gs_in[2 * j] = gs_in[2 * j] - gmsum * p
        gg = gg + gmsum * p * s2
        gG = gG + gmsum * (g * s2 - s1) * _ipow_grad(G, i)
    return gs_in, gprev, gx, (gg, gG, gk, gmix, gR, gd)


def saturator_backward_ref(gy, x, planes, y, states, inv: float, order: int,
                           two_pole: bool):
    """The saturator's adjoint in reverse time: gy, x, y [C, N], the planes
    [N] and the forward's states [C, nstates, N]; returns the signal's
    gradient [C, N] and the planes' per channel [C, nplanes, N] (their sum
    over channels is the planes' gradient)."""
    c, n = x.shape
    ns = 2 * order if two_pole else order
    back = _back_2pole if two_pole else _back_1pole
    zero = x.new_zeros(c)
    gs = [zero] * ns
    gprev = zero
    gx = torch.empty_like(x)
    gp = x.new_empty((c, len(planes), n))
    for t in reversed(range(n)):
        s = ([states[:, i, t - 1] for i in range(ns)] if t > 0
             else [zero] * ns)
        prev = y[:, t - 1] if t > 0 else zero
        gs, gprev, gxt, gpt = back(gy[:, t] + gprev, gs, s, prev, x[:, t],
                                   *(p[t] for p in planes), inv, order)
        gx[:, t] = gxt
        for i, v in enumerate(gpt):
            gp[:, i, t] = v
    return gx, gp


# The saturator's backward as a scan: the adjoint carried from step n to
# step n - 1, lam_n = (the new states' cotangent, the output's from the
# steps after), K = nstates + 1 values, enters step n's adjoint as v_n =
# lam_n + gy_n e_K-1 and leaves it as lam_{n-1} = M_n v_n, linear in v_n
# (every operation of _adjoint_1pole / _adjoint_2pole is). So the backward
# is (a) the maps M_n, one step's rerun and K adjoints of unit vectors each,
# independent of one another; (b) the affine recurrence lam_{n-1} = M_n
# lam_n + gy_n M_n e_K-1 run in reverse time by the k x k scan; (c) each
# step's gradients from the adjoint on its own v_n. Over chunks of frames
# from the end, the carry lam between them, so that the maps of one chunk
# are in memory at a time.
ADJOINT_CHUNK_BYTES = 1 << 30   # the maps, b and the scan's states a chunk


def adjoint_chunk(channels: int, nstates: int) -> int:
    """Frames a chunk of the saturator's backward: its maps [C, K*K, L], b
    and the scan's states [C, K, L] in ADJOINT_CHUNK_BYTES."""
    k = nstates + 1
    return max(1, ADJOINT_CHUNK_BYTES // (4 * channels * (k * k + 2 * k)))


def _chunk_inputs(gy, x, planes, y, states, first: int, length: int):
    """Frames [first, first + length) of gy, x and the planes, and the old
    states and last outputs each step starts from (zeros before frame 0)."""
    sl = slice(first, first + length)

    def before(t):
        lo = max(first - 1, 0)
        prev = t[..., lo:first + length - 1]
        if first == 0:
            prev = torch.cat([torch.zeros_like(t[..., :1]), prev], dim=-1)
        return prev
    old = before(states)
    return (gy[:, sl], x[:, sl], [p[sl] for p in planes], before(y),
            [old[:, i] for i in range(old.shape[1])])


def _chunk_adjoint(gy, x, planes, y, states, inv: float, order: int,
                   two_pole: bool, first: int, length: int):
    """(K, the step's adjoint on (gout, gs), gy over the chunk): every step
    of the chunk rerun at once, vectorised over time."""
    gyc, xc, pc, prev, s = _chunk_inputs(gy, x, planes, y, states, first,
                                         length)
    step, adj = ((_step_2pole, _adjoint_2pole) if two_pole
                 else (_step_1pole, _adjoint_1pole))
    _, _, trace = step(s, prev, xc, *pc, inv, order)

    def adjoint(gout, gs):
        return adj(trace, gout, gs, s, xc, *pc, inv, order)
    return len(s) + 1, adjoint, gyc


def saturator_adjoint_maps_ref(gy, x, planes, y, states, inv: float,
                               order: int, two_pole: bool, first: int,
                               length: int):
    """(a) of the chunk [first, first + length): A [C, K*K, L], row-major,
    M_n at r = L - 1 - (n - first) (reversed in time), and b [C, K, L] =
    gy_n M_n e_K-1 there; what saturator_backward_maps writes."""
    k, adjoint, gyc = _chunk_adjoint(gy, x, planes, y, states, inv, order,
                                     two_pole, first, length)
    ns = k - 1
    zero, one = torch.zeros_like(gyc), torch.ones_like(gyc)
    cols = []
    for c in range(k):
        gs_in, gprev, _, _ = adjoint(one if c == ns else zero,
                                     [one if i == c else zero
                                      for i in range(ns)])
        cols.append(list(gs_in) + [gprev])
    A = torch.stack([cols[c][i] for i in range(k) for c in range(k)], dim=1)
    b = torch.stack([gyc * v for v in cols[ns]], dim=1)
    return A.flip(-1).contiguous(), b.flip(-1).contiguous()


def saturator_adjoint_readout_ref(gy, x, planes, y, states, lam, carry,
                                  inv: float, order: int, two_pole: bool,
                                  first: int, length: int):
    """(c) of the chunk: lam [C, K, L] from the scan of (a)'s maps (lam at
    r holds lam_{n-1} for n = first + L - 1 - r), carry [C, K] the lam of
    the chunk's last frame; returns the signal's gradient [C, L] and the
    planes' [C, nplanes, L] over the chunk."""
    k, adjoint, gyc = _chunk_adjoint(gy, x, planes, y, states, inv, order,
                                     two_pole, first, length)
    lam_n = torch.cat([lam[..., :-1].flip(-1), carry[..., None]], dim=-1)
    _, _, gx, gp = adjoint(gyc + lam_n[:, k - 1],
                           [lam_n[:, i] for i in range(k - 1)])
    return gx, torch.stack([torch.broadcast_to(v, gx.shape) for v in gp],
                           dim=1)


def _adjoint_chunks(n: int, chunk: int):
    """(first, length) of each chunk, from the end."""
    for end in range(n, 0, -chunk):
        first = max(end - chunk, 0)
        yield first, end - first


def saturator_backward_plain(gy, x, planes, y, states, inv: float,
                             order: int, two_pole: bool):
    """saturator_backward_ref's result by the backward kernels' passes in
    PyTorch: per chunk from the end, the maps (saturator_adjoint_maps_ref),
    the k x k scan's plain version from the carry (affine_kxk_ref), the
    read-outs; the carry is the scan's last state. The CPU's backward."""
    c, n = x.shape
    k = states.shape[1] + 1
    gx = torch.empty_like(x)
    gp = x.new_empty((c, len(planes), n))
    carry = x.new_zeros((c, k))
    args = (gy, x, planes, y, states)
    for first, length in _adjoint_chunks(n, adjoint_chunk(c, k - 1)):
        A, b = saturator_adjoint_maps_ref(*args, inv, order, two_pole,
                                          first, length)
        lam = scan_kernels.affine_kxk_ref(A, b, carry)
        gx[:, first:first + length], gp[..., first:first + length] = \
            saturator_adjoint_readout_ref(*args, lam, carry, inv, order,
                                          two_pole, first, length)
        carry = lam[..., -1]
    return gx, gp


# The comb kernels' rounds (csrc/sequential_kernels.cu): at most
# COMB_WIDTH steps, none crossing a tile of COMB_TILE frames (tiles from
# frame 0; the backward takes them from the last).
COMB_WIDTH, COMB_TILE = build.COMB_WIDTH, build.COMB_TILE


def _comb_rounds(d: torch.Tensor, n: int, reverse: bool, width: int = 4096,
                 tile: int = 0):
    """The comb loops' rounds: ranges of frames that read no output of each
    other, as many as the least delay among the next `width` frames
    (forward) or the `width` before (reverse), and none across a tile of
    `tile` frames (0: no tiles). The plain loops take width 4096 and no
    tiles; width COMB_WIDTH and tile COMB_TILE are the kernels' rounds."""
    pos = n - 1 if reverse else 0
    while 0 <= pos < n:
        if reverse:
            lo = max(pos - width + 1, pos - pos % tile if tile else 0)
            steps = min(int(d[lo:pos + 1].min()), pos + 1 - lo)
            yield torch.arange(pos - steps + 1, pos + 1, device=d.device)
            pos -= steps
        else:
            hi = min(pos + width, (pos // tile + 1) * tile if tile else n, n)
            steps = min(int(d[pos:hi].min()), hi - pos)
            yield torch.arange(pos, pos + steps, device=d.device)
            pos += steps


def comb_round_lengths(delays: torch.Tensor, reverse: bool,
                       w: int = COMB_WIDTH, t: int = COMB_TILE
                       ) -> torch.Tensor:
    """The kernels' round length from every frame [N] int64, as their
    producer warps compute it for a tile at once: forward, a round from
    frame p takes min(w, the least delay of frames p .. p + w - 1, the
    frames left in p's tile of t); reverse, from p down, the same over
    frames p - w + 1 .. p. The rounds a call runs are the orbit from each
    tile's first frame (comb_round_starts)."""
    d = delays.long()
    n = d.shape[0]
    tiles = -(-n // t)
    big = torch.iinfo(torch.int64).max
    dt = torch.full((tiles * t,), big, dtype=torch.int64, device=d.device)
    dt[:n] = d
    dt = dt.view(tiles, t)
    if reverse:
        dt = dt.flip(1)
    pad = torch.full((tiles, w - 1), big, dtype=torch.int64, device=d.device)
    win = torch.cat([dt, pad], 1).unfold(1, w, 1).amin(-1)
    off = torch.arange(t, device=d.device)
    if reverse:     # frames from p down to its tile's first
        win, left = win.flip(1), off + 1
    else:           # frames from p up to its tile's last, or the call's
        left = torch.minimum(t - off, n - torch.arange(
            tiles * t, device=d.device).view(tiles, t))
    return win.clamp(max=w).minimum(left).reshape(-1)[:n]


def comb_round_starts(delays: torch.Tensor, reverse: bool,
                      w: int = COMB_WIDTH, tile: int = COMB_TILE) -> list:
    """The first frame of every round the comb kernels run, in the order
    they run (reverse: each round's last frame in time, from the end): the
    orbit of comb_round_lengths from each tile's first frame (a width w
    and tiles of `tile`: the comb's, or the stereo delay's)."""
    s = comb_round_lengths(delays, reverse, w, tile).tolist()
    n = len(s)
    starts = []
    if reverse:
        for t1 in range(-(-n // tile) * tile, 0, -tile):
            p = min(t1, n) - 1
            while p >= t1 - tile:
                starts.append(p)
                p -= s[p]
    else:
        for t0 in range(0, n, tile):
            p = t0
            while p < min(t0 + tile, n):
                starts.append(p)
                p += s[p]
    return starts


def comb_swept_ref(x, delays, k, a, f: float, keep_u: bool = False):
    """u[n] = x[n] + k[n] f u[n - d[n]] (0 before the start), y[n] = a[n]
    u[n] + (1 - a[n]) f u[n - d[n]] (filters.py:622-644): x [C, N], delays
    [N] integers in [1, N], k and a [N]. Runs D steps at a time, D the
    least delay among them (a step reads only outputs before its round).
    With keep_u, returns (y, u)."""
    n = x.shape[1]
    u = torch.zeros_like(x)
    y = torch.empty_like(x)
    d = delays.long()
    for t in _comb_rounds(d, n, reverse=False):
        src = t - d[t]
        u_del = torch.where(src >= 0, u[:, src.clamp(min=0)], 0.0)
        ut = x[:, t] + k[t] * f * u_del
        u[:, t] = ut
        y[:, t] = a[t] * ut + (1 - a[t]) * f * u_del
    return (y, u) if keep_u else y


def comb_swept_backward_ref(gy, delays, k, a, f: float):
    """u's adjoint in reverse time: gu[n] = a[n] gy[n] + the adjoints that
    the steps m reading u[n] (m - d[m] = n) scatter back, each
    (1 - a[m]) f gy[m] + k[m] f gu[m]; gy [C, N]. gu is the signal's
    gradient."""
    n = gy.shape[1]
    acc = torch.zeros_like(gy)
    gu = torch.empty_like(gy)
    d = delays.long()
    for t in _comb_rounds(d, n, reverse=True):
        gut = a[t] * gy[:, t] + acc[:, t]
        gu[:, t] = gut
        gv = (1 - a[t]) * f * gy[:, t] + k[t] * f * gut
        src = t - d[t]
        ok = src >= 0
        # the later steps first, as the reversed loop adds them
        acc.index_add_(1, src[ok].flip(0), gv[:, ok].flip(1))
    return gu


def comb_param_grads(gy, gu, u, delays, f: float):
    """The feedback's and the mix's gradients per frame, summed over the
    channels: du/dk = f u[n - d[n]], dy/da = u - f u[n - d[n]]."""
    d = delays.long()
    src = torch.arange(u.shape[1], device=u.device) - d
    v = torch.where(src >= 0, u[:, src.clamp(min=0)], 0.0)
    return (f * v * gu).sum(0), ((u - f * v) * gy).sum(0)


# One-step checks over a whole call: every frame recomputed in float64 from
# the call's own earlier outputs (a step each, no chain), against the
# call's value there; each returns the largest differences over the
# recomputed values' peaks.

def _rel(got, want) -> float:
    return float((got.double() - want).abs().max()
                 / want.abs().max().clamp(min=1e-300))


def comb_step_errors(x, delays, k, a, f: float, y, u) -> dict:
    """A comb call's u[n] against x[n] + k[n] f u[n - d[n]] and its y[n]
    against a[n] u[n] + (1 - a[n]) f u[n - d[n]], each from the call's own
    u: {"u": .., "y": ..}."""
    d = delays.long()
    src = torch.arange(x.shape[1], device=x.device) - d
    u64 = u.double()
    ud = torch.where(src >= 0, u64[:, src.clamp(min=0)], 0.0)
    k64, a64 = k.double(), a.double()
    return {"u": _rel(u, x.double() + k64 * f * ud),
            "y": _rel(y, a64 * u64 + (1 - a64) * f * ud)}


def comb_backward_step_error(gy, delays, k, a, f: float, gu) -> float:
    """A comb backward call's gu[n] against a[n] gy[n] + the sum over the
    steps m that read u[n] (m - d[m] = n) of (1 - a[m]) f gy[m] + k[m] f
    gu[m], from the call's own gu (the sum by index_add)."""
    d = delays.long()
    tgt = torch.arange(gy.shape[1], device=gy.device) - d
    ok = tgt >= 0
    k64, a64, gy64 = k.double(), a.double(), gy.double()
    sent = (1 - a64) * f * gy64 + k64 * f * gu.double()
    want = a64 * gy64
    want.index_add_(1, tgt[ok], sent[:, ok])
    return _rel(gu, want)


def saturator_step_errors(x, planes, inv: float, order: int,
                          two_pole: bool, y, states) -> dict:
    """A saturator call's every step rerun from its own states and last
    output (the frame before; zeros at frame 0), as
    saturator_adjoint_maps_ref reruns them: the output's and the new
    states' largest differences, {"y": .., "states": ..}; the planes in
    the loops' order, as saturator_cuda takes them."""
    n = x.shape[1]
    c64 = [t.double() for t in (x, y, states)]
    _, xc, pc, prev, s = _chunk_inputs(c64[0], c64[0], [
        p.double() for p in planes], c64[1], c64[2], 0, n)
    step = _step_2pole if two_pole else _step_1pole
    new, out, _ = step(s, prev, xc, *pc, inv, order)
    return {"y": _rel(y, out), "states": max(
        _rel(states[:, i], v) for i, v in enumerate(new))}


# The swept stereo delay (flan_tpu/audio/temporal.py:504-528). Its loop
# keeps two rings of lb and rb floats; step t reads out_l = l_buf[t mod lb]
# and out_r = r_buf[t mod rb], writes l_buf[t mod lb] = x_l + r_buf[(t -
# dr) mod rb] g, then r_buf[t mod rb] = x_r + l_buf[(t - dl) mod lb] g,
# reading l_buf after that write. In the values w_L[t], w_R[t] that step t
# writes (0 before the start): out_l[t] = w_L[t - lb], out_r[t] = w_R[t -
# rb], w_L[t] = x_l[t] + w_R[t - er[t]] g[t], w_R[t] = x_r[t] + w_L[t -
# el[t]] g[t], with the distances el = dl mod lb (0: the step's own L
# write, for dl in {0, lb}) and er = dr, or rb for dr = 0.
#
# Its adjoint in reverse time, gout the outputs' gradient: gw_R[t] =
# gout_r[t + rb] + the sends of the later steps that read w_R[t]; g[t]
# gw_R[t] is sent to gw_L[t - el[t]] (to gw_L[t] itself at el = 0, after
# every later step's); gw_L[t] = gout_l[t + lb] + what it was sent; g[t]
# gw_L[t] is sent to gw_R[t - er[t]]. A slot's sends are summed from 0, the
# later step first, as the reversed loop adds them. gw is the signal's
# gradient; the decay's is gw_L[t] w_R[t - er[t]] + gw_R[t] w_L[t - el[t]].
STEREO_TILE = build.STEREO_TILE         # the narrow kernels' staged tiles
STEREO_WIDTH = build.STEREO_WIDTH       # narrow rounds: at most a warp
STEREO_WIDE_WIDTH = build.STEREO_WIDE_WIDTH  # wide rounds: at most a tile
# the forward takes the wide regime when every step's nearer read is at
# least this far back: on reads a constant d frames back (wide rounds of d
# steps, the fewest a call with that nearest read can take) the narrow
# kernel took 9.81 ms on 2^22 frames at every d, the wide one 12.59 at d =
# 96, 9.58 at 128 and 8.01 at 160 (spv_variants --source stereo_delay,
# H100 80GB HBM3)
STEREO_WIDE_FROM = 128
# the backward takes the wide regime from this nearest read on: on reads a
# constant d frames back the narrow backward took 22.10 ms on 2^22 frames
# at every d, the wide one 25.51 at d = 128, 20.91 at 160 and 17.51 at 192
# (the same tool, its backward cases; H100 80GB HBM3)
STEREO_BACK_WIDE_FROM = 160
# the variant each stereo delay wrapper took on its last launch
# ("narrow_shared", "narrow_device", "wide_shared" or "wide_device")
VARIANTS = {"stereo_delay_swept": None, "stereo_delay_swept_backward": None}


def stereo_delay_frames(times, sr: float, ring: int, n: int,
                        device) -> torch.Tensor:
    """A delay time in frames at each of n steps, int64 on `device`, as
    flan_tpu/audio/temporal.py:460-461 takes it: the time (a float32
    tensor [n], or a number) widened to float64, times sr, truncated,
    clamped to [0, ring]."""
    if isinstance(times, torch.Tensor):
        d = (times.to(device=device, dtype=torch.float64) * sr).long()
        return d.clamp_(0, ring)
    return torch.full((n,), min(max(int(float(times) * sr), 0), ring),
                      dtype=torch.int64, device=device)


def stereo_delay_reads(dl: torch.Tensor, dr: torch.Tensor, lb: int,
                       rb: int):
    """(el, er) int32 on dl's device: how far back each step's two ring
    reads land, for delays dl in [0, lb] and dr in [0, rb] (see above)."""
    el = torch.where(dl == lb, 0, dl).to(torch.int32)
    er = torch.where(dr == 0, rb, dr).to(torch.int32)
    return el, er


def stereo_delay_distances(dl: np.ndarray, dr: np.ndarray, lb: int, rb: int):
    """stereo_delay_reads on the host, int64 numpy (the card's oracle)."""
    dl, dr = np.asarray(dl, np.int64), np.asarray(dr, np.int64)
    return dl % lb, np.where(dr == 0, rb, dr)


def _np(v) -> np.ndarray:
    return (v.cpu().numpy() if isinstance(v, torch.Tensor)
            else np.asarray(v)).astype(np.int64)


def _round_limits(el, er) -> np.ndarray:
    """lim[t] = max(t - er[t], el[t] > 0 ? t - el[t] : -1), int64: a round
    from frame s may hold frame t while lim[t] < s."""
    el, er = _np(el), _np(er)
    t = np.arange(len(el), dtype=np.int64)
    return np.maximum(t - er, np.where(el > 0, t - el, -1))


def stereo_delay_round_starts(el, er, tile: int, width: int = 0
                              ) -> np.ndarray:
    """The first frame of every round of the stereo delay's steps, then n,
    int32: a round from frame s holds the frames after it for as long as
    each reads only values written before s (t - er[t] < s, and t - el[t]
    < s where el[t] > 0: its own L write it does first), stays in s's tile
    of `tile` frames (tiles from frame 0) and, for a width, holds at most
    `width` frames: the fewest rounds under those caps. Worked out for
    every tile at once, one frame offset at a time."""
    lim = _round_limits(el, er)
    n = len(lim)
    tiles = -(-n // tile)
    big = np.iinfo(np.int64).max
    limt = np.full(tiles * tile, big, np.int64)
    limt[:n] = lim
    limt = np.ascontiguousarray(limt.reshape(tiles, tile).T)
    base = np.arange(tiles, dtype=np.int64) * tile
    flags = np.zeros((tile, tiles), bool)
    flags[0] = True
    s = base.copy()
    for j in range(1, tile):
        # a padded frame past n starts a round too
        new = (limt[j] >= s) | ((base + j - s >= width) if width else False)
        s = np.where(new, base + j, s)
        flags[j] = new
    starts = np.nonzero(flags.T.reshape(-1)[:n])[0]
    return np.append(starts, n).astype(np.int32)


def stereo_delay_narrow_starts(el, er, reverse: bool = False) -> list:
    """The rounds the narrow kernels run (csrc/sequential_kernels.cu
    stereo_delay_narrow), in their order: the comb kernels' rule
    (comb_round_starts) on each frame's nearer read a = min(er, el > 0 ?
    el : inf), rounds of at most STEREO_WIDTH frames in tiles of
    STEREO_TILE; reverse (the backward) each round's last frame, from the
    end."""
    el, er = _np(el), _np(er)
    a = np.minimum(np.where(el > 0, np.minimum(el, er), er), 1 << 30)
    return comb_round_starts(torch.from_numpy(a), reverse, STEREO_WIDTH,
                             STEREO_TILE)


def stereo_delay_wide_starts(el, er) -> np.ndarray:
    """The rounds the wide kernel runs (stereo_delay_wide), frame by frame:
    the fewest rounds of at most STEREO_WIDE_WIDTH frames, across tiles
    (the rule of stereo_delay_round_starts, with no tiles)."""
    lim = _round_limits(el, er)
    starts, s = [0], 0
    for j in range(1, len(lim)):
        if lim[j] >= s or j - s >= STEREO_WIDE_WIDTH:
            s = j
            starts.append(j)
    return np.array(starts + [len(lim)], np.int32)


def stereo_delay_wide_back_starts(el, er) -> np.ndarray:
    """The rounds the wide backward kernel runs, planned from the end as
    its planner warp plans them: the round that ends at e (its frames s ..
    e - 1) starts at max(lo, 1 + max(lim[t] for lo < t < e)), lo = max(e -
    STEREO_WIDE_WIDTH, 0), the least s at or above lo with lim[t] < s on
    every frame of (s, e) (a frame at or below lo has lim < lo). Rounds
    that are valid stay valid cut shorter, so taking each as long as it may
    be from the end gives the fewest rounds, as many as
    stereo_delay_wide_starts' from the start. Returns every round's first
    frame in ascending order, then n, int32."""
    lim = _round_limits(el, er)
    starts, e = [], len(lim)
    while e > 0:
        lo = max(e - STEREO_WIDE_WIDTH, 0)
        s = max(lo, int(lim[lo + 1:e].max()) + 1) if e - lo > 1 else lo
        starts.append(s)
        e = s
    return np.array(starts[::-1] + [len(lim)], np.int32)


def _as_index(v, device) -> torch.Tensor:
    return (v if isinstance(v, torch.Tensor) else torch.from_numpy(
        np.asarray(v))).to(device=device, dtype=torch.int64)


def stereo_delay_ref(x, g, el, er, lb: int, rb: int, keep_w: bool = False,
                     tile: int = 4096):
    """The swept stereo delay's plain version: x [2, n] and g [n] float32
    tensors, el and er [n] the reads' distances (stereo_delay_reads, or
    numpy). Each round of stereo_delay_round_starts(.., tile) is computed
    at once, every step in the loop's operations (x + r g, no fused
    multiply-add); the outputs are w_L and w_R shifted by lb and rb. With
    keep_w, returns (out, w), w [2, n] the values each step wrote."""
    starts = stereo_delay_round_starts(el, er, tile).tolist()
    dev = x.device
    el_t, er_t = _as_index(el, dev), _as_index(er, dev)
    w = torch.zeros_like(x)
    for s, e in zip(starts[:-1], starts[1:]):
        t = torch.arange(s, e, device=dev)
        src = t - er_t[t]
        rv = torch.where(src >= 0, w[1, src.clamp(min=0)], 0.0)
        w[0, t] = x[0, t] + rv * g[t]
        src = t - el_t[t]       # el = 0: the w_L[t] just written
        lv = torch.where(src >= 0, w[0, src.clamp(min=0)], 0.0)
        w[1, t] = x[1, t] + lv * g[t]
    out = stereo_delay_outputs(w, lb, rb)
    return (out, w) if keep_w else out


def stereo_delay_loop(x, g, dl, dr, lb: int, rb: int):
    """The loop of flan_tpu/audio/temporal.py:511-527 step by step in
    float32 on the host: x [2, n] and g [n] float32, dl and dr [n] integer
    delays in [0, lb] and [0, rb], numpy arrays. Returns (out, w) [2, n]:
    the outputs and the values each step wrote into its two slots. It
    shares nothing with the distances and rounds above, so it is the
    oracle of stereo_delay_ref and the kernel; at a few microseconds a
    step it is too slow for a long call."""
    x, g = np.asarray(x, np.float32), np.asarray(g, np.float32)
    n = x.shape[1]
    lbuf, rbuf = np.zeros(lb, np.float32), np.zeros(rb, np.float32)
    out = np.zeros((2, n), np.float32)
    w = np.zeros((2, n), np.float32)
    for t in range(n):
        ll, rl = t % lb, t % rb
        out[0, t], out[1, t] = lbuf[ll], rbuf[rl]
        lbuf[ll] = x[0, t] + rbuf[(t - dr[t]) % rb] * g[t]
        rbuf[rl] = x[1, t] + lbuf[(t - dl[t]) % lb] * g[t]
        w[0, t], w[1, t] = lbuf[ll], rbuf[rl]
    return out, w


def stereo_delay_outputs(w: torch.Tensor, lb: int, rb: int) -> torch.Tensor:
    """The outputs from the values the steps wrote: [w_L shifted by lb, w_R
    by rb], zeros before."""
    n = w.shape[1]
    pad = torch.nn.functional.pad
    return torch.stack([pad(w[0], (lb, 0))[:n], pad(w[1], (rb, 0))[:n]])


def _shifted_gout(gout: torch.Tensor, lb: int, rb: int) -> torch.Tensor:
    """[gout_l[t + lb], gout_r[t + rb]], zeros past the end: each value's
    own output's gradient."""
    pad = torch.nn.functional.pad
    return torch.stack([pad(gout[0, lb:], (0, min(lb, gout.shape[1]))),
                        pad(gout[1, rb:], (0, min(rb, gout.shape[1])))])


def stereo_delay_backward_ref(gout, g, el, er, lb: int, rb: int,
                              tile: int = 4096, starts=None):
    """The adjoint's plain version (see above): gout [2, n] and g [n]
    float32, el and er as stereo_delay_ref takes them; returns gw [2, n],
    the signal's gradient. The rounds of stereo_delay_round_starts(..,
    tile), or of `starts` (every round's first frame in ascending order,
    then n: stereo_delay_wide_back_starts' or stereo_delay_narrow_starts'
    plan), from the last, each at once: gw_R, the sends to L (each step's
    own last), gw_L, the sends to R, the sends of a round to one slot added
    the later step first (index_add_ in that order). Every plan of valid
    rounds gives the same bits."""
    n = gout.shape[1]
    starts = (stereo_delay_round_starts(el, er, tile) if starts is None
              else np.asarray(starts)).tolist()
    dev = gout.device
    el_t, er_t = _as_index(el, dev), _as_index(er, dev)
    go = _shifted_gout(gout, lb, rb)
    acc = torch.zeros_like(gout)
    gw = torch.empty_like(gout)
    for s, e in reversed(list(zip(starts[:-1], starts[1:]))):
        t = torch.arange(s, e, device=dev)
        gr = go[1, t] + acc[1, t]
        s_l = g[t] * gr
        own = el_t[t] == 0
        gl = go[0, t] + torch.where(own, acc[0, t] + s_l, acc[0, t])
        s_r = g[t] * gl
        gw[0, t], gw[1, t] = gl, gr
        tg = t - el_t[t]
        ok = ~own & (tg >= 0)
        acc[0].index_add_(0, tg[ok].flip(0), s_l[ok].flip(0))
        tg = t - er_t[t]
        ok = tg >= 0
        acc[1].index_add_(0, tg[ok].flip(0), s_r[ok].flip(0))
    return gw


def stereo_delay_backward_loop(gout, g, dl, dr, lb: int, rb: int):
    """The adjoint step by step in float32 on the host, in reverse time:
    gout [2, n] and g [n] float32, dl and dr the delays as
    stereo_delay_loop takes them, numpy. Which step's value each read
    finds is followed through the loop's two rings (the writer of each
    slot), sharing nothing with the distances or the rounds; returns gw
    [2, n], the oracle of stereo_delay_backward_ref and the kernel."""
    gout, g = np.asarray(gout, np.float32), np.asarray(g, np.float32)
    n = gout.shape[1]
    lown, rown = np.full(lb, -1, np.int64), np.full(rb, -1, np.int64)
    src_l, src_r = np.empty(n, np.int64), np.empty(n, np.int64)
    for t in range(n):
        src_r[t] = rown[(t - dr[t]) % rb]
        lown[t % lb] = t
        src_l[t] = lown[(t - dl[t]) % lb]
        rown[t % rb] = t
    acc = np.zeros((2, n), np.float32)
    gw = np.empty((2, n), np.float32)
    zero = np.float32(0.0)
    for t in range(n - 1, -1, -1):
        gr = (gout[1, t + rb] if t + rb < n else zero) + acc[1, t]
        s_l = g[t] * gr
        if src_l[t] >= 0:
            acc[0, src_l[t]] += s_l     # its own w_L[t] last
        gl = (gout[0, t + lb] if t + lb < n else zero) + acc[0, t]
        if src_r[t] >= 0:
            acc[1, src_r[t]] += g[t] * gl
        gw[0, t], gw[1, t] = gl, gr
    return gw


def stereo_delay_decay_grad(gw, w, el, er) -> torch.Tensor:
    """The decay's gradient at every step [n]: gw_L[t] w_R[t - er[t]] +
    gw_R[t] w_L[t - el[t]], reads before the start 0."""
    t = torch.arange(w.shape[1], device=w.device)

    def read(row, d):
        src = t - d.long()
        return torch.where(src >= 0, w[row, src.clamp(min=0)], 0.0)
    return gw[0] * read(1, er) + gw[1] * read(0, el)


def stereo_delay_step_errors(x, g, el, er, lb: int, rb: int, w) -> dict:
    """A stereo delay call's w_L[t] against x_l[t] + g[t] w_R[t - er[t]]
    and its w_R[t] against x_r[t] + g[t] w_L[t - el[t]], each in float64
    from the call's own w: {"w_l": .., "w_r": ..}, over the peaks."""
    el, er = _as_index(el, x.device), _as_index(er, x.device)
    t = torch.arange(x.shape[1], device=x.device)
    w64, x64, g64 = w.double(), x.double(), g.double()

    def read(row, d):
        src = t - d
        return torch.where(src >= 0, w64[row, src.clamp(min=0)], 0.0)
    return {"w_l": _rel(w[0], x64[0] + read(1, er) * g64),
            "w_r": _rel(w[1], x64[1] + read(0, el) * g64)}


def stereo_delay_backward_step_error(gout, g, el, er, lb: int, rb: int,
                                     gw) -> dict:
    """A backward call's gw_R[t] against gout_r[t + rb] + the sum over the
    steps u that read w_R[t] (u - er[u] = t) of g[u] gw_L[u], and its
    gw_L[t] against gout_l[t + lb] + the sum over the steps that read
    w_L[t] (u - el[u] = t, u = t for el = 0) of g[u] gw_R[u], each in
    float64 from the call's own gw (the sums by index_add):
    {"gw_l": .., "gw_r": ..}."""
    el, er = _as_index(el, gw.device), _as_index(er, gw.device)
    t = torch.arange(gw.shape[1], device=gw.device)
    want = _shifted_gout(gout, lb, rb).double()
    g64, gw64 = g.double(), gw.double()
    tg = t - el
    ok = tg >= 0
    want[0].index_add_(0, tg[ok], (g64 * gw64[1])[ok])
    tg = t - er
    ok = tg >= 0
    want[1].index_add_(0, tg[ok], (g64 * gw64[0])[ok])
    return {"gw_l": _rel(gw[0], want[0]), "gw_r": _rel(gw[1], want[1])}


# ------------------------------------------------------------------ kernels

def _planes_on(x: torch.Tensor, name: str, planes, dtypes=None) -> None:
    check_cuda(x, f"{name} x", 2)
    for i, p in enumerate(planes):
        check_cuda(p, f"{name} plane {i}", 1,
                   torch.float32 if dtypes is None else dtypes[i])
        if p.shape[0] != x.shape[1] or p.device != x.device:
            raise ValueError(f"{name}: plane {i} of shape {tuple(p.shape)} on "
                             f"{p.device} for x {tuple(x.shape)} on "
                             f"{x.device}")


def _kernel_planes(planes, two_pole: bool):
    """(g, G, G_f or R, d or None, k, mix): the planes in the kernel's
    order."""
    if two_pole:
        g, G, k, mix, R, d = planes
        return g, G, R, d, k, mix
    g, G_f, G_ap, k, mix = planes
    return g, G_ap, G_f, None, k, mix


def _ptr(t):
    return None if t is None else t.data_ptr()


def saturator_cuda(x, planes, inv: float, order: int, two_pole: bool,
                   keep_states: bool = False):
    """The saturator kernel on float32 CUDA tensors, no autograd: x [C, N]
    and, each [N], (g, G_f, G_ap, k, mix) for the 1-pole or (g, G, k, mix,
    R, d) for the 2-pole. Orders 1 to kMaxFixedOrder (8,
    csrc/sequential_kernels.cu) run their own instantiation, any other the runtime-order one. With
    keep_states, returns (y, every step's new states [C, nstates, N])."""
    name = "saturator_2pole" if two_pole else "saturator_1pole"
    _planes_on(x, name, planes)
    lib = load_library()
    c, n = x.shape
    with torch.cuda.device(x.device):
        y = torch.empty_like(x)
        states = (x.new_empty((c, (2 if two_pole else 1) * order, n))
                  if keep_states else None)
        err = lib.flan_saturator_multinotch(
            int(two_pole), x.data_ptr(),
            *(_ptr(p) for p in _kernel_planes(planes, two_pole)),
            y.data_ptr(), _ptr(states), c, n, order, inv,
            torch.cuda.current_stream().cuda_stream)
    raise_on(err, name)
    LAUNCHES[name] += 1
    return (y, states) if keep_states else y


def _backward_checked(gy, x, planes, y, states, order: int,
                      two_pole: bool) -> str:
    """The backward's name, after checking its operands."""
    name = f"saturator_{2 if two_pole else 1}pole_backward"
    _planes_on(x, name, planes)
    for t, what in ((gy, "gy"), (y, "y")):
        check_cuda(t, f"{name} {what}", 2)
    check_cuda(states, f"{name} states", 3)
    c, n = x.shape
    if gy.shape != x.shape or y.shape != x.shape or states.shape != (
            c, (2 if two_pole else 1) * order, n):
        raise ValueError(f"{name}: gy {tuple(gy.shape)}, y {tuple(y.shape)} "
                         f"and states {tuple(states.shape)} for x "
                         f"{tuple(x.shape)} and order {order}")
    return name


def _backward_head(lib, gy, x, planes, y, states, order, two_pole, length):
    """The arguments both backward passes start with, and their work
    memory (runtime orders)."""
    c = x.shape[0]
    work = x.new_empty(lib.flan_saturator_backward_work_floats(
        int(two_pole), order, c, length))
    head = (int(two_pole), gy.data_ptr(), x.data_ptr(), y.data_ptr(),
            states.data_ptr()) + tuple(
        _ptr(p) for p in _kernel_planes(planes, two_pole))
    return head, work


def saturator_backward_maps_cuda(gy, x, planes, y, states, inv: float,
                                 order: int, two_pole: bool, first: int,
                                 length: int):
    """(a) on the card, saturator_adjoint_maps_ref's work: A [C, K*K, L]
    and b [C, K, L] of the chunk [first, first + length)."""
    name = _backward_checked(gy, x, planes, y, states, order, two_pole)
    lib = load_library()
    c, n = x.shape
    k = states.shape[1] + 1
    with torch.cuda.device(x.device):
        A, b = x.new_empty((c, k * k, length)), x.new_empty((c, k, length))
        head, work = _backward_head(lib, gy, x, planes, y, states, order,
                                    two_pole, length)
        err = lib.flan_saturator_backward_maps(
            *head, A.data_ptr(), b.data_ptr(),
            _ptr(work) if work.numel() else None, c, n, first, length, order,
            inv, torch.cuda.current_stream().cuda_stream)
    raise_on(err, f"{name}_maps")
    LAUNCHES[f"{name}_maps"] += 1
    return A, b


def saturator_backward_readout_cuda(gy, x, planes, y, states, lam, carry,
                                    gx, gp, inv: float, order: int,
                                    two_pole: bool, first: int, length: int):
    """(c) on the card, saturator_adjoint_readout_ref's work: the signal's
    and the planes' gradients over the chunk, written into gx [C, N] and gp
    [C, nplanes, N], from the scan's lam [C, K, L] and the carry [C, K]."""
    name = _backward_checked(gy, x, planes, y, states, order, two_pole)
    c, n = x.shape
    k = states.shape[1] + 1
    for t, what, shape in ((lam, "lam", (c, k, length)),
                           (carry, "carry", (c, k)), (gx, "gx", (c, n)),
                           (gp, "gp", (c, len(planes), n))):
        check_cuda(t, f"{name} {what}", len(shape))
        if t.shape != shape:
            raise ValueError(f"{name}: {what} {tuple(t.shape)}, not {shape}")
    lib = load_library()
    with torch.cuda.device(x.device):
        head, work = _backward_head(lib, gy, x, planes, y, states, order,
                                    two_pole, length)
        err = lib.flan_saturator_backward_readout(
            *head, lam.data_ptr(), carry.data_ptr(), gx.data_ptr(),
            gp.data_ptr(), _ptr(work) if work.numel() else None, c, n, first,
            length, order, inv, torch.cuda.current_stream().cuda_stream)
    raise_on(err, f"{name}_readout")
    LAUNCHES[f"{name}_readout"] += 1


def saturator_backward_cuda(gy, x, planes, y, states, inv: float,
                            order: int, two_pole: bool):
    """The saturator's backward on the card (saturator_backward_ref's
    work): per chunk from the end, the maps kernel, the k x k scan
    (scan_affine_kxk) from the carry in reverse time, the read-out kernel,
    as saturator_backward_plain does in PyTorch. Returns the signal's
    gradient [C, N] and the planes' per channel [C, nplanes, N], the planes
    in saturator_cuda's order."""
    _backward_checked(gy, x, planes, y, states, order, two_pole)
    c, n = x.shape
    k = states.shape[1] + 1
    with torch.cuda.device(x.device):
        gx = torch.empty_like(x)
        gp = x.new_empty((c, len(planes), n))
        carry = x.new_zeros((c, k))
        args = (gy, x, planes, y, states)
        for first, length in _adjoint_chunks(n, adjoint_chunk(c, k - 1)):
            A, b = saturator_backward_maps_cuda(*args, inv, order, two_pole,
                                                first, length)
            lam = scan_kernels.scan_affine_kxk(A, b, carry)
            del A, b
            saturator_backward_readout_cuda(*args, lam, carry, gx, gp, inv,
                                            order, two_pole, first, length)
            carry = lam[..., -1].contiguous()
    return gx, gp


def _comb_checked(x, delays, k, a, name: str):
    _planes_on(x, name, (delays, k, a),
               (torch.int32, torch.float32, torch.float32))


def comb_swept_cuda(x, delays, k, a, f: float, ring_len: int,
                    keep_u: bool = False):
    """The swept comb kernel: x [C, N] float32, delays [N] int32 in [1,
    ring_len], k and a [N] float32, all on one CUDA device; no autograd.
    With keep_u, returns (y, u)."""
    _comb_checked(x, delays, k, a, "comb_swept")
    lib = load_library()
    c, n = x.shape
    with torch.cuda.device(x.device):
        y = torch.empty_like(x)
        u = torch.empty_like(x) if keep_u else None
        ring = torch.empty(lib.flan_comb_swept_ring_floats(c, ring_len, 0),
                           dtype=torch.float32, device=x.device)
        err = lib.flan_comb_swept(
            x.data_ptr(), delays.data_ptr(), k.data_ptr(), a.data_ptr(),
            y.data_ptr(), _ptr(u), ring.data_ptr() if ring.numel() else None,
            c, n, ring_len, f, torch.cuda.current_stream().cuda_stream)
    raise_on(err, "comb_swept")
    LAUNCHES["comb_swept"] += 1
    return (y, u) if keep_u else y


def comb_swept_backward_cuda(gy, delays, k, a, f: float, ring_len: int):
    """The swept comb's backward kernel (comb_swept_backward_ref's work):
    u's adjoint, the signal's gradient, [C, N]."""
    _comb_checked(gy, delays, k, a, "comb_swept_backward")
    lib = load_library()
    c, n = gy.shape
    with torch.cuda.device(gy.device):
        gu = torch.empty_like(gy)
        ring = torch.empty(lib.flan_comb_swept_ring_floats(c, ring_len, 1),
                           dtype=torch.float32, device=gy.device)
        err = lib.flan_comb_swept_backward(
            gy.data_ptr(), delays.data_ptr(), k.data_ptr(), a.data_ptr(),
            gu.data_ptr(), ring.data_ptr() if ring.numel() else None, c, n,
            ring_len, f, torch.cuda.current_stream().cuda_stream)
    raise_on(err, "comb_swept_backward")
    LAUNCHES["comb_swept_backward"] += 1
    return gu


def _delay_checked(x, g, el, er, name: str) -> None:
    check_cuda(x, f"{name} x", 2)
    if x.shape[0] != 2:
        raise ValueError(f"{name} takes 2 rows, got {x.shape[0]}")
    if x.shape[1] > np.iinfo(np.int32).max - 4 * STEREO_TILE:
        raise ValueError(f"{name}: {x.shape[1]} frames is past the "
                         "kernel's 32-bit indices")
    _planes_on(x, name, (g, el, er), (torch.float32, torch.int32,
                                      torch.int32))


def _nearest_read(el, er) -> int:
    """The call's nearest read: min(er, el > 0 ? el : inf) over its steps."""
    return int(torch.where(el > 0, torch.minimum(el, er), er).min())


def _delay_kind(wide: bool, backward: bool) -> int:
    """The kernel flan_stereo_delay_shared_bytes sizes: 0 the narrow ones,
    1 the wide forward, 2 the wide backward."""
    return (2 if backward else 1) if wide else 0


def stereo_delay_variant(near: int, lb: int, rb: int,
                         backward: bool = False) -> str:
    """The kernel variant a call takes, from its nearest read (near) and
    rings: "wide" when every step's nearer read is at least
    STEREO_WIDE_FROM frames back (the backward's: STEREO_BACK_WIDE_FROM),
    else "narrow"; "_shared" when its rings fit in the card's shared
    memory, else "_device"."""
    wide = near >= (STEREO_BACK_WIDE_FROM if backward else STEREO_WIDE_FROM)
    lib = load_library()
    fits = (lib.flan_stereo_delay_shared_bytes(_delay_kind(wide, backward),
                                               lb, rb)
            <= lib.flan_max_shared_bytes())
    return ("wide" if wide else "narrow") + ("_shared" if fits
                                             else "_device")


def _delay_launch(fn, name, inp, g, el, er, lb, rb, variant, out, rounds,
                  stage=()):
    """One stereo delay kernel's launch; stage: the backward's go scratch
    ((None,) for the narrow kernel), () for the forward, which takes
    none."""
    lib = load_library()
    if variant not in ("narrow_shared", "narrow_device", "wide_shared",
                       "wide_device"):
        raise ValueError(f"{name}: no variant {variant!r}")
    wide, shared = variant.split("_")
    if rounds is not None:
        check_cuda(rounds, f"{name} rounds", 1, torch.int32)
    err = getattr(lib, fn)(
        inp.data_ptr(), g.data_ptr(), el.data_ptr(), er.data_ptr(),
        out.data_ptr(), *(_ptr(t) for t in stage), _ptr(rounds),
        inp.shape[1], lb, rb, int(wide == "wide"), int(shared == "shared"),
        torch.cuda.current_stream().cuda_stream)
    raise_on(err, name)
    LAUNCHES[name] += 1
    VARIANTS[name] = variant


def stereo_delay_swept_cuda(x, g, el, er, lb: int, rb: int,
                            keep_w: bool = False, variant: str = None,
                            rounds: torch.Tensor = None, near: int = None):
    """The swept stereo delay kernel: x [2, n] and g [n] float32, el and er
    [n] int32 (stereo_delay_reads), all on one CUDA device; no autograd.
    The variant is stereo_delay_variant's on the call's nearest read (near,
    else worked out on the card: a reduction and a sync) unless one is
    named; rounds, a [1] int32 tensor on the card, receives the rounds the
    kernel ran. Returns the outputs [2, n], with keep_w also w [2, n]."""
    _delay_checked(x, g, el, er, "stereo_delay_swept")
    with torch.cuda.device(x.device):
        if variant is None:
            near = _nearest_read(el, er) if near is None else near
            variant = stereo_delay_variant(near, lb, rb)
        w = torch.empty_like(x)
        _delay_launch("flan_stereo_delay_swept", "stereo_delay_swept", x, g,
                      el, er, lb, rb, variant, w, rounds)
    out = stereo_delay_outputs(w, lb, rb)
    return (out, w) if keep_w else out


def stereo_delay_swept_backward_cuda(gout, g, el, er, lb: int, rb: int,
                                     variant: str = None,
                                     rounds: torch.Tensor = None,
                                     near: int = None):
    """The swept stereo delay's backward kernel (stereo_delay_backward_ref's
    work) on its regime's rounds from the end: gout [2, n], the outputs'
    gradient, g, el and er as the forward takes them; returns gw [2, n],
    the signal's gradient. The variant is stereo_delay_variant's for the
    backward on the nearest read (near, the forward's; else worked out on
    the card) unless one is named; rounds as the forward's."""
    _delay_checked(gout, g, el, er, "stereo_delay_swept_backward")
    with torch.cuda.device(gout.device):
        if variant is None:
            near = _nearest_read(el, er) if near is None else near
            variant = stereo_delay_variant(near, lb, rb, backward=True)
        # the wide kernel's scratch: gout shifted by the rings, staged there
        go = torch.empty_like(gout) if variant.startswith("wide") else None
        # the device-memory variants sum in gw itself
        gw = (torch.zeros_like(gout) if variant.endswith("_device")
              else torch.empty_like(gout))
        _delay_launch("flan_stereo_delay_swept_backward",
                      "stereo_delay_swept_backward", gout, g, el, er, lb, rb,
                      variant, gw, rounds, (go,))
    return gw


# ----------------------------------------------------------------- autograd

class SaturatorMultinotch(torch.autograd.Function):
    """The saturator with its backward: the forward keeps every step's
    states, the backward runs the adjoint in reverse time (the plain loop
    on the CPU, the backward kernel on the card) and sums the planes'
    per-channel gradients."""

    @staticmethod
    def forward(ctx, x, inv, order, two_pole, *planes):
        if _on_cpu(x):
            plain = saturator_2pole_ref if two_pole else saturator_1pole_ref
            y, states = plain(x, *planes, inv, order, keep_states=True)
        else:
            y, states = saturator_cuda(x, planes, inv, order, two_pole,
                                       keep_states=True)
        ctx.save_for_backward(x, y, states, *planes)
        ctx.args = (inv, order, two_pole)
        return y

    @staticmethod
    def backward(ctx, gy):
        x, y, states, *planes = ctx.saved_tensors
        run = (saturator_backward_plain if _on_cpu(x)
               else saturator_backward_cuda)
        gx, gp = run(gy.contiguous(), x, planes, y, states, *ctx.args)
        return (gx, None, None, None) + tuple(gp.sum(0).unbind(0))


class CombSwept(torch.autograd.Function):
    """The swept comb with its backward: the forward keeps u, the backward
    scatters u's adjoint in reverse time (the plain loop on the CPU, the
    backward kernel on the card); the delays take no gradient (integers,
    as in the JAX package)."""

    @staticmethod
    def forward(ctx, x, delays, k, a, f):
        if _on_cpu(x):
            y, u = comb_swept_ref(x, delays, k, a, f, keep_u=True)
            ring = 0
        else:
            ring = int(delays.max())
            y, u = comb_swept_cuda(x, delays, k, a, f, ring, keep_u=True)
        ctx.save_for_backward(delays, k, a, u)
        ctx.args = (f, ring)
        return y

    @staticmethod
    def backward(ctx, gy):
        delays, k, a, u = ctx.saved_tensors
        f, ring = ctx.args
        gy = gy.contiguous()
        gu = (comb_swept_backward_ref(gy, delays, k, a, f) if _on_cpu(gy)
              else comb_swept_backward_cuda(gy, delays, k, a, f, ring))
        gk, ga = comb_param_grads(gy, gu, u, delays, f)
        return gu, None, gk, ga, None


class StereoDelaySwept(torch.autograd.Function):
    """The swept stereo delay with its backward: the forward keeps w, the
    backward runs the adjoint in reverse time (the plain version on the
    CPU, the backward kernel on the card) and the decay's gradient from it
    and w; the delays take no gradient (integers, as in the JAX
    package)."""

    @staticmethod
    def forward(ctx, x, g, el, er, lb, rb):
        near = None
        if _on_cpu(x):
            out, w = stereo_delay_ref(x, g, el, er, lb, rb, keep_w=True)
        else:
            near = _nearest_read(el, er)     # both directions' regime
            out, w = stereo_delay_swept_cuda(x, g, el, er, lb, rb,
                                             keep_w=True, near=near)
        ctx.save_for_backward(g, el, er, w)
        ctx.args = (lb, rb, near)
        return out

    @staticmethod
    def backward(ctx, gout):
        g, el, er, w = ctx.saved_tensors
        lb, rb, near = ctx.args
        gout = gout.contiguous()
        gw = (stereo_delay_backward_ref(gout, g, el, er, lb, rb)
              if _on_cpu(gout) else
              stereo_delay_swept_backward_cuda(gout, g, el, er, lb, rb,
                                               near=near))
        gg = (stereo_delay_decay_grad(gw, w, el, er)
              if ctx.needs_input_grad[1] else None)
        return gw, gg, None, None, None, None


# ----------------------------------------------------------------- dispatch

def saturator_multinotch(x, planes, inv: float, order: int, two_pole: bool):
    """The saturator multinotch on x [C, N] with per-frame planes [N] (see
    saturator_cuda): the plain loop on the CPU, the kernel on the card;
    differentiable on both (SaturatorMultinotch)."""
    if x.device.type != "cpu":
        # a parameter sampled from a number is a broadcast view: the kernel
        # reads dense planes
        x = x.contiguous()
        planes = tuple(p.contiguous() for p in planes)
    if _wants_grad(x, *planes):
        return SaturatorMultinotch.apply(x, inv, order, two_pole, *planes)
    if x.device.type == "cpu":
        if two_pole:
            return saturator_2pole_ref(x, *planes, inv, order)
        return saturator_1pole_ref(x, *planes, inv, order)
    return saturator_cuda(x, planes, inv, order, two_pole)


def comb_swept(x, delays, k, a, f: float):
    """The swept comb on x [C, N] with delays [N] (int32) and k, a [N]; the
    ring holds max(delays) samples, as the JAX package's does.
    Differentiable in x, k and a on both devices (CombSwept)."""
    if x.device.type != "cpu":
        x, delays, k, a = (t.contiguous() for t in (x, delays, k, a))
    if _wants_grad(x, k, a):
        return CombSwept.apply(x, delays, k, a, f)
    if x.device.type == "cpu":
        return comb_swept_ref(x, delays, k, a, f)
    return comb_swept_cuda(x, delays, k, a, f, int(delays.max()))


def stereo_delay_swept(x, g, el, er, lb: int, rb: int):
    """The swept stereo delay on x [2, n] with the decay g [n] and the
    reads' distances el, er [n] int32 (stereo_delay_reads) on x's device:
    the plain version on the CPU, the kernel on the card. Differentiable in
    x and g on both (StereoDelaySwept)."""
    if x.device.type != "cpu":
        x, g, el, er = (t.contiguous() for t in (x, g, el, er))
    if _wants_grad(x, g):
        return StereoDelaySwept.apply(x, g, el, er, lb, rb)
    if x.device.type == "cpu":
        return stereo_delay_ref(x, g, el, er, lb, rb)
    return stereo_delay_swept_cuda(x, g, el, er, lb, rb)
