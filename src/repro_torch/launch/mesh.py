"""Process groups and device meshes: the counterpart of the JAX package's
``launch/mesh.py``.

The JAX package deals the sharded field over a device mesh's ``model``
axis; the port deals it over the ranks of a ``torch.distributed`` process
group, one shard a rank.  The named meshes of the sharding rules
(``distributed/sharding.py``) are ``DeviceMesh`` objects over the default
group's ranks, one rank a chip: :func:`make_smoke_mesh` (1 x n,
``("data", "model")``), :func:`make_production_mesh` (the JAX package's
pod shapes, which need that many ranks), :func:`chips_in`.  NCCL joins
ranks that each have their own GPU; gloo joins ranks on the CPU, or ranks
that share one GPU (NCCL refuses two ranks on one device).  Gloo's collectives and point-to-point calls take
CPU tensors, so :class:`Transport` stages a CUDA tensor through pinned host
buffers when the group's backend is gloo — a transport that follows the
group, never a fall back.

Functions only: importing this module touches no process group.
"""
from __future__ import annotations

import atexit
import datetime
import math
import os
import pickle
import shutil
import tempfile
from pathlib import Path
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from repro_torch.device import DeviceLike, resolve_device

#: how long a collective may wait for the other ranks
GROUP_TIMEOUT = datetime.timedelta(seconds=600)


def backend_for(device: torch.device) -> str:
    """The process-group backend for ranks that each own ``device``: NCCL
    for a CUDA device, gloo for the CPU."""
    return "nccl" if device.type == "cuda" else "gloo"


def _close_smoke_group(store_dir: str) -> None:
    """At exit: destroy the process group while its store still exists (an
    NCCL group left alive keeps the process from exiting for minutes), then
    remove the store."""
    if dist.is_initialized():
        dist.destroy_process_group()
    shutil.rmtree(store_dir, ignore_errors=True)


def make_smoke_group(device: DeviceLike = None):
    """The initialised default group, or, if there is none, a group of one
    rank in this process (gloo on the CPU, NCCL on CUDA) over a ``FileStore``
    in a temporary directory; at exit the group is destroyed and the
    directory removed.  ``device`` defaults to ``"cuda"`` and raises without
    CUDA."""
    if dist.is_initialized():
        return dist.group.WORLD
    device = resolve_device(device)
    store_dir = tempfile.mkdtemp(prefix="repro_torch_group_")
    atexit.register(_close_smoke_group, store_dir)
    store = dist.FileStore(os.path.join(store_dir, "store"), 1)
    dist.init_process_group(backend_for(device), store=store, rank=0,
                            world_size=1, timeout=GROUP_TIMEOUT)
    return dist.group.WORLD


def _device_mesh(shape: Tuple[int, ...], names: Tuple[str, ...], device):
    from torch.distributed.device_mesh import init_device_mesh

    return init_device_mesh(resolve_device(device).type, shape, mesh_dim_names=names)


def make_production_mesh(*, multi_pod: bool = False, device: DeviceLike = None):
    """16x16 = 256 chips per pod; 2 pods = 512 chips when multi_pod: a mesh
    over the default group, which must have exactly that many ranks (raises
    ``ValueError`` otherwise, before touching any group)."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    need = math.prod(shape)
    world = dist.get_world_size() if dist.is_initialized() else 1
    if world != need:
        raise ValueError(f"the production mesh {shape} {axes} needs {need} ranks, "
                         f"one a chip; the default process group has {world}")
    return _device_mesh(shape, axes, device)


def make_smoke_mesh(n_devices: Optional[int] = None, device: DeviceLike = None):
    """A 1 x n ``("data", "model")`` mesh over the default group's ranks (n
    defaults to the group's size), used by sharding tests; without a group,
    :func:`make_smoke_group` makes one of one rank.  ``device`` defaults to
    ``"cuda"`` and raises without CUDA."""
    make_smoke_group(device)
    return _device_mesh((1, n_devices or dist.get_world_size()), ("data", "model"),
                        device)


def chips_in(mesh) -> int:
    """The chips of a ``DeviceMesh``, or of a mesh given by its axis sizes."""
    from repro_torch.distributed.sharding import mesh_axis_sizes

    return math.prod(mesh_axis_sizes(mesh).values())


def _rank_main(rank: int, fn: Callable, n_ranks: int, workdir: str,
               args: Tuple) -> None:
    """One spawned rank: join the group, run ``fn``, leave the group, and
    write what ``fn`` returned to ``workdir/rank<r>.pkl``."""
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // n_ranks))
    store = dist.FileStore(os.path.join(workdir, "store"), n_ranks)
    dist.init_process_group("gloo", store=store, rank=rank,
                            world_size=n_ranks, timeout=GROUP_TIMEOUT)
    try:
        result = fn(rank, n_ranks, *args)
        dist.barrier()
    finally:
        dist.destroy_process_group()
    out = Path(workdir) / f"rank{rank}.pkl"
    tmp = out.with_name(out.name + ".tmp")
    with open(tmp, "wb") as f:
        pickle.dump(result, f)
    os.replace(tmp, out)


def run_ranks(fn: Callable, n_ranks: int, workdir, args: Sequence = ()) -> List:
    """Run ``fn(rank, n_ranks, *args)`` on ``n_ranks`` spawned processes, the
    ranks of a default gloo group (on the CPU, or sharing one GPU) over a
    ``FileStore`` in ``workdir`` (an empty directory of the caller's, so
    concurrent callers cannot collide), and return what each rank's ``fn``
    returned, in rank order.  ``fn`` and ``args`` must pickle; a rank that raises stops the
    others and raises here.

    The ranks run one program (SPMD), so they must hash strings alike: the
    workload trie's numbering follows Python's string hash.  They get the
    caller's ``PYTHONHASHSEED``, or 0 where it is unset (then their tries
    may number differently from the caller's: hand them compiled
    ``TrieArrays`` where the caller compares trie columns)."""
    import torch.multiprocessing as mp

    workdir = Path(workdir)
    workdir.mkdir(parents=True, exist_ok=True)
    seed = os.environ.get("PYTHONHASHSEED")
    os.environ["PYTHONHASHSEED"] = seed or "0"
    try:
        mp.spawn(_rank_main, args=(fn, n_ranks, str(workdir), tuple(args)),
                 nprocs=n_ranks, join=True)
    finally:
        if seed is None:
            del os.environ["PYTHONHASHSEED"]
    results = []
    for r in range(n_ranks):
        with open(workdir / f"rank{r}.pkl", "rb") as f:
            results.append(pickle.load(f))
    return results


class Transport:
    """Collectives of one group on tensors of one device.

    NCCL moves CUDA tensors directly.  Gloo moves CPU tensors: a CUDA tensor
    is copied to a pinned host buffer, moved, and copied back (each copy
    synchronous, so a buffer is reused only after its last copy ends); the
    buffers are kept per shape for the next call.  ``name`` says which.
    ``before``, when set, is called before each collective (a caller's
    poll, as threaded sharded serving's agreement)."""

    def __init__(self, group, device: torch.device):
        self.group = group
        self.rank = dist.get_rank(group)
        self.size = dist.get_world_size(group)
        backend = str(dist.get_backend(group))
        if backend == "nccl" and device.type != "cuda":
            raise ValueError(f"an NCCL group moves CUDA tensors, not {device}")
        self.device = device
        self.staged = backend == "gloo" and device.type == "cuda"
        self.name = backend + (" through pinned host buffers" if self.staged else "")
        self._buffers: Dict[Tuple, torch.Tensor] = {}
        self.before: Optional[Callable[[], None]] = None

    def _buffer(self, key, shape, dtype) -> torch.Tensor:
        buf = self._buffers.get((key, tuple(shape), dtype))
        if buf is None:
            buf = torch.empty(tuple(shape), dtype=dtype, pin_memory=True)
            self._buffers[(key, tuple(shape), dtype)] = buf
        return buf

    def _out(self, key, t: torch.Tensor) -> torch.Tensor:
        """``t`` where the backend can move it (staged to the host for gloo)."""
        if not self.staged:
            return t.contiguous()
        buf = self._buffer(key, t.shape, t.dtype)
        buf.copy_(t)
        return buf

    def _in(self, buf: torch.Tensor) -> torch.Tensor:
        return buf.to(self.device) if self.staged else buf

    def _peer(self, r: int) -> int:
        return dist.get_global_rank(self.group, r % self.size)

    def all_reduce(self, t: torch.Tensor, key: str = "reduce") -> torch.Tensor:
        """The sum of ``t`` over the group's ranks."""
        if self.before is not None:
            self.before()
        buf = self._out(key, t)
        dist.all_reduce(buf, group=self.group)
        return self._in(buf)

    def all_gather(self, t: torch.Tensor, key: str = "gather") -> torch.Tensor:
        """Every rank's ``t`` (of one shape), stacked in rank order."""
        if self.before is not None:
            self.before()
        buf = self._out(key, t)
        if self.staged:
            parts = [self._buffer((key, r), t.shape, t.dtype) for r in range(self.size)]
        else:
            parts = [torch.empty_like(buf) for _ in range(self.size)]
        dist.all_gather(parts, buf, group=self.group)
        return torch.stack([self._in(p) for p in parts])

    def ring(self, payloads: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        """Ring rounds ``r = 1 .. size - 1``: ``payloads[r - 1]`` goes to the
        rank ``r`` ahead, and the rank ``r`` behind sends one of the same
        shape, which is returned in its place.  All rounds are posted as one
        ``batch_isend_irecv``."""
        if not payloads:
            return []
        if self.before is not None:
            self.before()
        ops, recvs = [], []
        for r, p in enumerate(payloads, start=1):
            send = self._out(("send", r), p)
            recv = (self._buffer(("recv", r), p.shape, p.dtype) if self.staged
                    else torch.empty_like(send))
            ops.append(dist.P2POp(dist.isend, send, self._peer(self.rank + r),
                                  self.group, tag=r))
            ops.append(dist.P2POp(dist.irecv, recv, self._peer(self.rank - r),
                                  self.group, tag=r))
            recvs.append(recv)
        for req in dist.batch_isend_irecv(ops):
            req.wait()
        return [self._in(b) for b in recvs]
