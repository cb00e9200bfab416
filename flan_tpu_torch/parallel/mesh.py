"""The port's device mesh: one process (a rank) per device on
torch.distributed (counterpart of flan_tpu/parallel/mesh.py).

JAX runs shard_map over a Mesh from one controller. PyTorch's idiom is one
process per device: every rank calls the same function on the same global
arguments, works on its own shard, and meets the others in the three
collectives the JAX code uses. This module owns them; nothing else in the
port calls torch.distributed.

  JAX                  what it carries                 here
  ppermute             halos and tails to a neighbour  shift_right, shift_left
                                                       (batch_isend_irecv)
  all_gather           per-rank totals, the results    all_gather
                                                       (all_gather_into_tensor)
  psum of a value      the last rank's tail on every   from_last (all_reduce)
  masked to one rank   rank

Ranks follow the cards. With a card for every rank the backend is NCCL and
rank r computes on cuda:r. Ranks that share a card (NCCL refuses two ranks
on one device) take gloo, and their tensors stay on the card: where gloo
cannot carry a CUDA tensor (STAGED_ON_GLOO_CUDA) the collective is staged
through pinned host memory, explicitly, and Mesh.staged names it. Compute
never leaves the rank's device. A world of one rank needs no process group;
in a group of one the collectives still run (a check of the backend).

A launcher (python -m torch.distributed.run, or spawn_ranks below) starts
the ranks; make_mesh joins the group it set up.
"""
from __future__ import annotations

import contextlib
import dataclasses
import datetime
import os
import pickle
import socket
import tempfile
import time
from typing import Callable, Optional

import torch
import torch.distributed as dist

from flan_tpu_torch.core.types import DEFAULT_DEVICE

# The collectives gloo does not run on CUDA tensors (torch.distributed's
# backend table: gloo takes CUDA tensors in all_reduce and broadcast only).
STAGED_ON_GLOO_CUDA = frozenset({"ppermute", "all_gather"})

# The device a rank started by spawn_ranks computes on, where make_mesh and
# the launcher's helpers are not told another.
RANK_DEVICE_ENV = "FLAN_TPU_TORCH_RANK_DEVICE"

# Seconds a collective may wait for the other ranks before it raises.
COLLECTIVE_TIMEOUT = 600.0


@dataclasses.dataclass
class Mesh:
    """A 1-D mesh of `size` ranks over one process group, seen from rank
    `rank`, which computes on `device`. backend: "nccl", "gloo", or "none"
    for a world of one. staged: the collectives this rank stages through
    pinned host memory. moved: bytes this rank has sent, per collective."""
    rank: int
    size: int
    device: torch.device
    axis_name: str
    backend: str
    staged: frozenset
    moved: dict = dataclasses.field(default_factory=lambda: {
        "ppermute": 0, "all_gather": 0, "all_reduce": 0})

    @property
    def shape(self) -> dict:
        """{axis name: ranks}, as jax.sharding.Mesh.shape."""
        return {self.axis_name: self.size}


def _local_rank(rank: int) -> int:
    return int(os.environ.get("LOCAL_RANK", rank))


def _named(device) -> torch.device:
    """device, or where it is None the one spawn_ranks started this rank
    with, else the card."""
    if device is None:
        device = os.environ.get(RANK_DEVICE_ENV, DEFAULT_DEVICE)
    return torch.device(device)


def choose_backend(device, ranks_per_host: int) -> str:
    """NCCL when the ranks compute on cards and every rank of this host has
    a card of its own; gloo otherwise (the CPU, or ranks sharing a card)."""
    dev = _named(device)
    if dev.type == "cuda" and torch.cuda.device_count() >= ranks_per_host:
        return "nccl"
    return "gloo"


def rank_device(device, rank: int) -> torch.device:
    """The device rank `rank` computes on: `device` (as _named reads it);
    a card without an index is the rank's own on its host, the local rank
    modulo the host's cards."""
    dev = _named(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", _local_rank(rank)
                           % max(torch.cuda.device_count(), 1))
    return dev


def init_from_env(device=None) -> None:
    """Join the process group a launcher describes in the environment
    (MASTER_ADDR, MASTER_PORT, WORLD_SIZE, RANK), unless there is none or
    this process has joined one. A launcher's world of one joins a group
    of one."""
    if "MASTER_PORT" not in os.environ or dist.is_initialized():
        return
    rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    per_host = int(os.environ.get("LOCAL_WORLD_SIZE", world))
    backend = choose_backend(device, per_host)
    dev = rank_device(device, rank)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(
        backend, init_method="env://", world_size=world, rank=rank,
        timeout=datetime.timedelta(seconds=COLLECTIVE_TIMEOUT))


def make_mesh(n_devices: Optional[int] = None, axis_name: str = "data",
              device=None) -> Mesh:
    """The 1-D mesh over every rank of the default process group (joined
    from the launcher's environment if need be), or a world of one rank
    where there is none. n_devices, where given, must be the world's size:
    a rank cannot leave the group its launcher started. device: where this
    rank computes; unless named, the device spawn_ranks started the rank
    with, else the card (the tests pass "cpu" to spawn_ranks)."""
    init_from_env(device)
    if dist.is_initialized():
        rank, size = dist.get_rank(), dist.get_world_size()
        backend = str(dist.get_backend())
    else:
        rank, size, backend = 0, 1, "none"
    if n_devices is not None and n_devices != size:
        raise ValueError(f"make_mesh({n_devices}): the launcher started "
                         f"{size} rank(s); start as many as the mesh has")
    dev = rank_device(device, rank)
    staged = (STAGED_ON_GLOO_CUDA if backend == "gloo" and dev.type == "cuda"
              else frozenset())
    return Mesh(rank, size, dev, axis_name, backend, staged)


@contextlib.contextmanager
def launcher_mesh(device=None, axis_name: str = "data"):
    """The mesh of the ranks a launcher started, for the body of the with,
    or None in a process that no launcher started. A process group joined
    here from the environment is left at the end of the body; one the
    caller joined (spawn_ranks) stays."""
    if int(os.environ.get("WORLD_SIZE", "1")) <= 1 \
            and not dist.is_initialized():
        yield None
        return
    joined = not dist.is_initialized()
    try:
        yield make_mesh(axis_name=axis_name, device=device)
    finally:
        if joined and dist.is_initialized():
            dist.destroy_process_group()


# ------------------------------------------------------------ collectives

def _pinned(x: torch.Tensor) -> torch.Tensor:
    host = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
    host.copy_(x)
    return host


def _shift(mesh: Mesh, x: torch.Tensor, step: int) -> torch.Tensor:
    x = x.contiguous()
    dst, src = mesh.rank + step, mesh.rank - step
    if not (0 <= dst < mesh.size or 0 <= src < mesh.size):
        return torch.zeros_like(x)      # no neighbour either side
    staged = "ppermute" in mesh.staged
    send = _pinned(x) if staged else x
    recv = (torch.zeros(x.shape, dtype=x.dtype, pin_memory=True) if staged
            else torch.zeros_like(x))
    ops = []
    if 0 <= dst < mesh.size:
        ops.append(dist.P2POp(dist.isend, send, dst))
        mesh.moved["ppermute"] += x.numel() * x.element_size()
    if 0 <= src < mesh.size:
        ops.append(dist.P2POp(dist.irecv, recv, src))
    for work in dist.batch_isend_irecv(ops):
        work.wait()
    return recv.to(x.device) if staged else recv


def shift_right(mesh: Mesh, x: torch.Tensor) -> torch.Tensor:
    """ppermute i -> i + 1, not cyclic: what the rank to the left sent, and
    zeros on rank 0."""
    return _shift(mesh, x, 1)


def shift_left(mesh: Mesh, x: torch.Tensor) -> torch.Tensor:
    """ppermute i -> i - 1, not cyclic: what the rank to the right sent,
    and zeros on the last rank."""
    return _shift(mesh, x, -1)


def all_gather(mesh: Mesh, x: torch.Tensor) -> torch.Tensor:
    """Every rank's x stacked in rank order: [size, *x.shape]."""
    x = x.contiguous()
    if mesh.backend == "none":
        return x[None]
    staged = "all_gather" in mesh.staged
    src = (_pinned(x) if staged else x).reshape(-1)
    out = torch.empty(mesh.size * x.numel(), dtype=x.dtype,
                      device=src.device, pin_memory=staged)
    dist.all_gather_into_tensor(out, src)
    mesh.moved["all_gather"] += x.numel() * x.element_size()
    out = out.reshape((mesh.size,) + tuple(x.shape))
    return out.to(x.device) if staged else out


def from_last(mesh: Mesh, x: torch.Tensor) -> torch.Tensor:
    """The last rank's x on every rank: the psum of x masked to the last
    rank, as the JAX code replicates its final tail (x + 0 is x)."""
    if mesh.backend == "none":
        return x
    y = (x if mesh.rank == mesh.size - 1 else torch.zeros_like(x)).clone()
    staged = "all_reduce" in mesh.staged
    buf = _pinned(y) if staged else y
    dist.all_reduce(buf)
    mesh.moved["all_reduce"] += y.numel() * y.element_size()
    return buf.to(x.device) if staged else buf


# ---------------------------------------------------- shards and gathers

def shard_batch(mesh: Mesh, x: torch.Tensor) -> torch.Tensor:
    """This rank's contiguous block of the leading axis (P("data")); the
    axis must divide by the mesh."""
    return shard_time(mesh, x, axis=0)


def gather_batch(mesh: Mesh, x: torch.Tensor) -> torch.Tensor:
    """The blocks of shard_batch put back together on every rank."""
    return gather_time(mesh, x, axis=0)


def shard_time(mesh: Mesh, x: torch.Tensor, axis: int = -1) -> torch.Tensor:
    """This rank's contiguous span of `axis` (P(None, "sp") on the time
    axis); the axis must divide by the mesh."""
    n = x.shape[axis]
    if n % mesh.size:
        raise ValueError(f"axis of {n} does not split over {mesh.size} "
                         "ranks: pad it first")
    step = n // mesh.size
    return x.narrow(axis, mesh.rank * step, step)


def gather_time(mesh: Mesh, x: torch.Tensor, axis: int = -1) -> torch.Tensor:
    """The spans of shard_time put back together on every rank."""
    return torch.cat(tuple(all_gather(mesh, x)), dim=axis)


# ------------------------------------------------------------------ ranks

def _free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _to_host(value):
    """value with every tensor in it a numpy array: what crosses back from
    a rank to the parent."""
    if isinstance(value, torch.Tensor):
        return value.detach().cpu().numpy()
    if isinstance(value, dict):
        return {k: _to_host(v) for k, v in value.items()}
    if isinstance(value, (list, tuple)):
        return type(value)(_to_host(v) for v in value)
    return value


def _rank_main(rank: int, n: int, port: int, device: str, fn: Callable,
               args: tuple, out_dir: str) -> None:
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(n),
                      LOCAL_RANK=str(rank), LOCAL_WORLD_SIZE=str(n),
                      MASTER_ADDR="localhost", MASTER_PORT=str(port),
                      **{RANK_DEVICE_ENV: device})
    init_from_env()
    try:
        value = fn(*args)
    finally:
        dist.destroy_process_group()
    with open(os.path.join(out_dir, f"{rank}.pkl"), "wb") as f:
        pickle.dump(_to_host(value), f)


def spawn_ranks(fn: Callable, n: int, *args, device=DEFAULT_DEVICE,
                timeout: float = 900.0) -> list:
    """Run fn(*args) on n ranks and return their results in rank order.

    Each rank is a process started with the spawn method (CUDA cannot be
    forked) that joins an n-rank group on a free localhost port, on the
    backend choose_backend gives `device` and n, so that make_mesh() inside
    fn sees all n ranks on `device`; fn must be importable from a module
    the ranks can import. Tensors in a result come back as numpy arrays.
    Raises with the rank's traceback when a rank fails, and ends every rank
    before it returns."""
    import torch.multiprocessing as mp
    with tempfile.TemporaryDirectory() as out_dir:
        ranks = mp.start_processes(
            _rank_main, args=(n, _free_port(), str(device), fn, args,
                              out_dir),
            nprocs=n, join=False, start_method="spawn")
        deadline = time.monotonic() + timeout
        try:
            while not ranks.join(timeout=max(deadline - time.monotonic(),
                                             0.0)):
                if time.monotonic() >= deadline:
                    raise TimeoutError(f"spawn_ranks: {n} rank(s) gave no "
                                       f"result in {timeout:g} s")
        except (mp.ProcessRaisedException, mp.ProcessExitedException) as e:
            raise RuntimeError(f"rank {e.error_index} of {n} failed:\n{e}"
                               ) from None
        finally:
            for p in ranks.processes:
                if p.is_alive():
                    p.terminate()
                    p.join()
        results = []
        for r in range(n):
            with open(os.path.join(out_dir, f"{r}.pkl"), "rb") as f:
                results.append(pickle.load(f))
    return results
