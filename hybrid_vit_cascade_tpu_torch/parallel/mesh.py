"""The data axis of the JAX package's mesh (counterpart of
hybrid_vit_cascade_tpu/parallel/mesh.py), as one process per card.

The JAX trainer lays a (data × model) mesh over every device and leaves the
gradient all-reduce to XLA. Here each card runs its own process, started by
torchrun (``torchrun --standalone --nproc_per_node N -m
hybrid_vit_cascade_tpu_torch.cli train ...``), and the collectives are
NCCL's on the card and gloo's on the CPU:

- ``init_from_env`` starts the process group from torchrun's environment
  (``WORLD_SIZE``, ``RANK``, ``LOCAL_RANK``): ``nccl`` for a ``cuda``
  device (the card ``cuda:LOCAL_RANK``), ``gloo`` for ``cpu``. An NCCL init
  that fails raises; a CUDA run never falls back to gloo.
- ``data_group(batch)`` is ``Trainer._mesh_for_batch``: the first
  gcd(batch, world) ranks take a stage's global batch, the rest sit idle.
- ``use_data_group(group)`` makes a group the ambient one for the code it
  wraps, as ``with mesh:`` does in JAX; the train-mode BatchNorm, the TV
  loss and the optimizer's gradient hook read it (``ambient_group``). It is
  process state, not thread-local: autograd runs a CUDA backward, and the
  recomputes of activation checkpointing, in threads of its own.
- ``all_reduce_mean`` (plain, or differentiable for statistics whose
  backward must also carry the other ranks' terms), ``all_reduce_grads``,
  ``broadcast_module``, ``broadcast_object``, ``barrier``.

Without a process group every function here is the identity and costs
nothing: a plain ``python -m ... train`` runs one process, no collective. Not
ported: the model axis (``shard_tokens``, ``shard_spatial_d``,
``gather_model_axis``) and multi-host training.
"""

from __future__ import annotations

import contextlib
import math
import os
from dataclasses import dataclass
from pathlib import Path
from typing import Any, Callable, Iterable, Iterator, Optional

import torch
import torch.distributed as dist
import torch.nn as nn

TORCHRUN_ENV = ("WORLD_SIZE", "RANK", "LOCAL_RANK")


@dataclass(frozen=True)
class DataGroup:
    """The ranks that share one stage's global batch: ``size`` of them, this
    rank at position ``index`` (-1: it idles this stage). ``pg`` is their
    process group, None when no process group runs."""

    size: int
    index: int
    pg: Any = None

    @property
    def active(self) -> bool:
        return self.index >= 0

    @property
    def synced(self) -> bool:
        """Whether a statistic over the batch needs the other ranks' terms."""
        return self.pg is not None and self.size > 1


SOLO = DataGroup(1, 0)
_ambient: Optional[DataGroup] = None
# the groups of the first k < world ranks, made once a process group; a group
# of one is None, so its collectives are the identity
_subgroups: dict = {}


def init_from_env(device: str | torch.device = "cuda",
                  init_method: str = "env://") -> torch.device:
    """Start the process group when torchrun's environment is present and
    return this rank's device (``cuda:LOCAL_RANK`` for a ``cuda`` device
    without an index). Without that environment, or once the group runs,
    nothing is started."""
    dev = torch.device(device)
    if not all(k in os.environ for k in TORCHRUN_ENV):
        return dev
    world_size, rank_, local = (int(os.environ[k]) for k in TORCHRUN_ENV)
    if dev.type == "cuda":
        backend = "nccl"
        if dev.index is None:
            dev = torch.device("cuda", local)
    elif dev.type == "cpu":
        backend = "gloo"
    else:
        raise ValueError(f"no collective backend for device {dev}")
    if dist.is_initialized():
        if dist.get_backend() != backend:
            raise RuntimeError(f"a {dist.get_backend()} process group runs; device {dev} "
                               f"needs {backend}")
        return dev
    if backend == "nccl":
        if not dist.is_nccl_available() or torch.cuda.device_count() <= dev.index:
            raise RuntimeError(f"rank {rank_} needs {dev} and NCCL; this machine has "
                               f"{torch.cuda.device_count()} card(s), NCCL "
                               f"{'available' if dist.is_nccl_available() else 'absent'}")
        torch.cuda.set_device(dev)
        # device_id makes the NCCL communicator start now, so a failure raises here
        dist.init_process_group("nccl", init_method=init_method, world_size=world_size,
                                rank=rank_, device_id=dev)
    else:
        dist.init_process_group("gloo", init_method=init_method, world_size=world_size,
                                rank=rank_)
    return dev


def shutdown() -> None:
    """Destroy the process group, if one runs."""
    if dist.is_initialized():
        dist.destroy_process_group()
    _subgroups.clear()


def rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def world() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def is_main() -> bool:
    return rank() == 0


def barrier() -> None:
    if dist.is_initialized():
        dist.barrier()


def data_axis(batch_size: int, n: int) -> int:
    """How many of ``n`` ranks share a global batch: the largest count that
    divides it, gcd(batch, n) (JAX ``Trainer._mesh_for_batch``)."""
    return math.gcd(batch_size, n)


def data_group(batch_size: int) -> DataGroup:
    """The ranks that train a stage of global batch ``batch_size``: the first
    ``data_axis(batch, world)``, as JAX's ``_mesh_for_batch`` takes the first
    devices; the others idle. Every rank must call it (a smaller group is
    made collectively, once for each k)."""
    if not dist.is_initialized():
        return SOLO
    n = world()
    k = data_axis(batch_size, n)
    if k == n:
        pg = dist.group.WORLD
    else:
        if is_main():
            print(f"[trainer] batch {batch_size} % {n} devices != 0 -> using {k} "
                  f"devices, {n - k} idle (raise batch or drop device count to avoid)")
        if k not in _subgroups:  # every rank asks for the same k in the same order
            _subgroups[k] = dist.new_group(list(range(k))) if k > 1 else None
        pg = _subgroups[k]
    r = rank()
    return DataGroup(k, r if r < k else -1, pg)


@contextlib.contextmanager
def use_data_group(group: DataGroup) -> Iterator[DataGroup]:
    """Make ``group`` the ambient data group inside the block."""
    global _ambient
    outer, _ambient = _ambient, group
    try:
        yield group
    finally:
        _ambient = outer


def ambient_group() -> Optional[DataGroup]:
    return _ambient


class _AllReduceSum(torch.autograd.Function):
    """Σ over the group's ranks; the backward sums the ranks' gradients, so
    each rank's input gets the gradient of every rank's use of the sum."""

    @staticmethod
    def forward(ctx, t: torch.Tensor, pg) -> torch.Tensor:
        ctx.pg = pg
        out = t.clone()
        dist.all_reduce(out, group=pg)
        return out

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        g = g.clone()
        dist.all_reduce(g, group=ctx.pg)
        return g, None


def all_reduce_mean(t: torch.Tensor, group: Optional[DataGroup],
                    differentiable: bool = False) -> torch.Tensor:
    """The mean of ``t`` over the group's ranks (``t`` itself without a
    process group). ``differentiable=True`` for a statistic inside the
    forward (BatchNorm's moments): its backward sums every rank's gradient."""
    if group is None or group.pg is None:
        return t
    if differentiable:
        return _AllReduceSum.apply(t, group.pg) / group.size
    out = t.detach().clone()
    dist.all_reduce(out, group=group.pg)
    return out / group.size


def all_reduce_grads(params: Iterable[torch.Tensor], group: Optional[DataGroup]) -> None:
    """Average the gradients of ``params`` over the group: one flat bucket
    per dtype, in the order given (the same on every rank). A parameter
    without a gradient on this rank adds zeros and then holds the average."""
    if group is None or group.pg is None:
        return
    buckets: dict = {}
    for p in params:
        buckets.setdefault(p.dtype, []).append(p)
    for ps in buckets.values():
        flat = torch.cat([(p.grad if p.grad is not None else torch.zeros_like(p)).reshape(-1)
                          for p in ps])
        dist.all_reduce(flat, group=group.pg)
        flat.div_(group.size)
        offset = 0
        for p in ps:
            g = flat[offset:offset + p.numel()].view_as(p)
            offset += p.numel()
            if p.grad is None:
                p.grad = g
            else:
                p.grad.copy_(g)


def broadcast_module(module: nn.Module, src: int = 0) -> None:
    """Send rank ``src``'s parameters and buffers to every rank."""
    if not dist.is_initialized():
        return
    with torch.no_grad():
        for t in [*module.parameters(), *module.buffers()]:
            dist.broadcast(t.data, src)


def broadcast_object(obj: Any, src: int = 0) -> Any:
    """Rank ``src``'s ``obj`` (picklable) on every rank."""
    if not dist.is_initialized():
        return obj
    box = [obj]
    dist.broadcast_object_list(box, src)
    return box[0]


def _spawned(local: int, fn: Callable, world_size: int, device: str, rendezvous: str,
             args: tuple) -> None:
    os.environ.update(WORLD_SIZE=str(world_size), RANK=str(local), LOCAL_RANK=str(local))
    dev = init_from_env(device, init_method=f"file://{rendezvous}")
    try:
        fn(dev, *args)
    finally:
        shutdown()


def spawn(fn: Callable, world_size: int, device: str, workdir: str | Path,
          *args) -> None:
    """Run ``fn(device, *args)`` on ``world_size`` ranks of this host, each in a fresh
    process (``spawn``) with torchrun's environment set and the process
    group started by ``init_from_env`` over a file rendezvous under
    ``workdir`` (no port). Raises when a rank fails."""
    import torch.multiprocessing as mp

    rendezvous = Path(workdir) / "rendezvous"
    rendezvous.unlink(missing_ok=True)
    mp.start_processes(_spawned, args=(fn, world_size, device, str(rendezvous.absolute()), args),
                       nprocs=world_size, join=True, start_method="spawn")
