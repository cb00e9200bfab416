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
saturator's backward as a parallel job, and the stereo delay as one block
whose rounds of up to 1024 steps were planned on the host:

  saturator_1pole / saturator_2pole    saturator_1pole_ref, saturator_2pole_ref
  saturator_*_backward_maps            saturator_adjoint_maps_ref
  saturator_*_backward_readout         saturator_adjoint_readout_ref
  comb_swept                           comb_swept_ref
  comb_swept_backward                  comb_swept_backward_ref
  stereo_delay_swept                   stereo_delay_ref

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

The backward is the adjoint of each loop (SaturatorMultinotch, CombSwept:
torch.autograd.Functions used on both devices, plain versions on the CPU
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

The stereo delay has no backward (the JAX package differentiates it
through lax.scan; the port's is still to come). Its rounds
(stereo_delay_round_starts), its one-step check (stereo_delay_step_errors)
and the loop itself step by step on the host (stereo_delay_loop: the
oracle, too slow for a path) are here too.

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
            "comb_swept_backward": 0, "stereo_delay_swept": 0}


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


def comb_round_lengths(delays: torch.Tensor, reverse: bool) -> torch.Tensor:
    """The kernels' round length from every frame [N] int64, as their
    producer warps compute it for a tile at once: forward, a round from
    frame p takes min(COMB_WIDTH, the least delay of frames p .. p +
    COMB_WIDTH - 1, the frames left in p's tile); reverse, from p down,
    the same over frames p - COMB_WIDTH + 1 .. p. The rounds a call runs
    are the orbit from each tile's first frame (comb_round_starts)."""
    d = delays.long()
    n, w, t = d.shape[0], COMB_WIDTH, COMB_TILE
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


def comb_round_starts(delays: torch.Tensor, reverse: bool) -> list:
    """The first frame of every round the comb kernels run, in the order
    they run (reverse: each round's last frame in time, from the end): the
    orbit of comb_round_lengths from each tile's first frame."""
    s = comb_round_lengths(delays, reverse).tolist()
    n = len(s)
    starts = []
    if reverse:
        for t1 in range(-(-n // COMB_TILE) * COMB_TILE, 0, -COMB_TILE):
            p = min(t1, n) - 1
            while p >= t1 - COMB_TILE:
                starts.append(p)
                p -= s[p]
    else:
        for t0 in range(0, n, COMB_TILE):
            p = t0
            while p < min(t0 + COMB_TILE, n):
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
STEREO_TILE = build.STEREO_TILE     # the kernel's rounds: at most a tile of
                                    # frames, none across one


def stereo_delay_distances(dl: np.ndarray, dr: np.ndarray, lb: int, rb: int):
    """(el, er) int64: how far back each step's two ring reads land, for
    delays dl in [0, lb] and dr in [0, rb] (see above)."""
    dl, dr = np.asarray(dl, np.int64), np.asarray(dr, np.int64)
    return dl % lb, np.where(dr == 0, rb, dr)


def stereo_delay_round_starts(el: np.ndarray, er: np.ndarray,
                              tile: int) -> np.ndarray:
    """The first frame of every round of the stereo delay's steps, then n,
    int32: a round from frame s holds the frames after it for as long as
    each reads only values written before s (t - er[t] < s, and t - el[t]
    < s where el[t] > 0: its own L write it does first) and it stays in
    s's tile of `tile` frames (tiles from frame 0). Worked out for every
    tile at once, one frame offset at a time."""
    n = len(el)
    t = np.arange(n, dtype=np.int64)
    lim = np.maximum(t - er, np.where(el > 0, t - el, -1))
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
        new = limt[j] >= s      # a padded frame past n starts a round too
        s = np.where(new, base + j, s)
        flags[j] = new
    starts = np.nonzero(flags.T.reshape(-1)[:n])[0]
    return np.append(starts, n).astype(np.int32)


def stereo_delay_ref(x, g, dl, dr, lb: int, rb: int, keep_w: bool = False,
                     tile: int = 4096):
    """The swept stereo delay's plain version: x [2, n] and g [n] float32
    tensors, dl and dr [n] integer delays in [0, lb] and [0, rb] on the
    host. Each round of stereo_delay_round_starts(.., tile) is computed at
    once, every step in the loop's operations (x + r g, no fused
    multiply-add); the outputs are w_L and w_R shifted by lb and rb. With
    keep_w, returns (out, w), w [2, n] the values each step wrote."""
    el, er = stereo_delay_distances(dl, dr, lb, rb)
    starts = stereo_delay_round_starts(el, er, tile).tolist()
    dev = x.device
    el_t, er_t = (torch.from_numpy(v).to(dev) for v in (el, er))
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


def stereo_delay_step_errors(x, g, dl, dr, lb: int, rb: int, w) -> dict:
    """A stereo delay call's w_L[t] against x_l[t] + g[t] w_R[t - er[t]]
    and its w_R[t] against x_r[t] + g[t] w_L[t - el[t]], each in float64
    from the call's own w: {"w_l": .., "w_r": ..}, over the peaks."""
    el, er = (torch.from_numpy(v).to(x.device)
              for v in stereo_delay_distances(dl, dr, lb, rb))
    t = torch.arange(x.shape[1], device=x.device)
    w64, x64, g64 = w.double(), x.double(), g.double()

    def read(row, d):
        src = t - d
        return torch.where(src >= 0, w64[row, src.clamp(min=0)], 0.0)
    return {"w_l": _rel(w[0], x64[0] + read(1, er) * g64),
            "w_r": _rel(w[1], x64[1] + read(0, el) * g64)}


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


def stereo_delay_swept_cuda(x, g, el, er, starts, lb: int, rb: int,
                            keep_w: bool = False):
    """The swept stereo delay kernel: x [2, n] and g [n] float32, el and er
    [n] int32 (stereo_delay_distances), starts the rounds
    (stereo_delay_round_starts(.., STEREO_TILE)) int32, all on one CUDA
    device. Returns the outputs [2, n], with keep_w also w [2, n]."""
    check_cuda(x, "stereo_delay_swept x", 2)
    if x.shape[0] != 2:
        raise ValueError(f"stereo_delay_swept takes 2 rows, got {x.shape[0]}")
    _planes_on(x, "stereo_delay_swept", (g, el, er),
               (torch.float32, torch.int32, torch.int32))
    check_cuda(starts, "stereo_delay_swept starts", 1, torch.int32)
    lib = load_library()
    n = x.shape[1]
    with torch.cuda.device(x.device):
        w = torch.empty_like(x)
        err = lib.flan_stereo_delay_swept(
            x.data_ptr(), g.data_ptr(), el.data_ptr(), er.data_ptr(),
            starts.data_ptr(), starts.shape[0] - 1, w.data_ptr(), n, lb, rb,
            torch.cuda.current_stream().cuda_stream)
    raise_on(err, "stereo_delay_swept")
    LAUNCHES["stereo_delay_swept"] += 1
    out = stereo_delay_outputs(w, lb, rb)
    return (out, w) if keep_w else out


def stereo_delay_plan(dl, dr, lb: int, rb: int, device):
    """The kernel's operands from the host delays: (el, er, starts) int32
    on `device`."""
    el, er = stereo_delay_distances(dl, dr, lb, rb)
    starts = stereo_delay_round_starts(el, er, STEREO_TILE)
    return tuple(torch.from_numpy(v.astype(np.int32)).to(device)
                 for v in (el, er, starts))


def stereo_delay_shared_ring(lb: int, rb: int) -> bool:
    """Whether the kernel keeps a call's rings (for ring sizes lb, rb) in
    shared memory, the variant it then takes, or reads device memory."""
    return bool(load_library().flan_stereo_delay_shared(lb, rb))


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


def stereo_delay_swept(x, g, dl, dr, lb: int, rb: int):
    """The swept stereo delay on x [2, n] with the decay g [n] and the host
    delays dl, dr [n] (integers in [0, lb], [0, rb]): the plain version on
    the CPU, the kernel on the card. No gradient."""
    if x.device.type == "cpu":
        return stereo_delay_ref(x, g, dl, dr, lb, rb)
    return stereo_delay_swept_cuda(x, g, *stereo_delay_plan(
        dl, dr, lb, rb, x.device), lb, rb)
