"""Data-parallel ranks: port of attngan_tpu/parallel/mesh.py.

The JAX package shards every step's batch over a device mesh and lets XLA
insert the collectives under SPMD: the gradients' sum, the BatchNorm
statistics of the global batch, the gathers of the sharded DAMSM loss.
Here each rank is one process, launched by ``torchrun`` (one per card, or
several sharing a card), and the collectives are explicit:

- ``init_distributed`` starts the process group from torchrun's
  ``RANK`` / ``WORLD_SIZE`` / ``LOCAL_RANK``; without them the world is
  one process and no group exists. The backend is NCCL where every rank
  of the host has a card of its own, gloo where ranks share a card (NCCL
  refuses two ranks on one GPU) or run on the CPU.
- ``make_mesh`` takes ``mesh_size_for_batch`` ranks, JAX's
  ``make_mesh_for_batch`` arithmetic: an explicit 1-D or 2-D shape must
  divide the global batch and fit the world; with none, the most ranks
  that divide the batch. Ranks beyond the mesh take no part (they get
  None), as JAX leaves the other devices idle.
- A 2-D ``(slice, data)`` shape shards the batch over both axes in
  slice-major rank order and reduces over the whole mesh at once: XLA's
  hierarchical (ICI, then DCN) reduction of the same sum is not
  reproduced.

Every collective here is an ``all_reduce`` of a sum, the one that gloo
takes on CPU and CUDA tensors alike and NCCL takes too: a gather is the
sum of each rank's rows placed in a zero buffer of the whole batch (exact:
every element is one rank's value plus zeros). The one other is the int8
calibration's maximum (``all_reduce_max``). The tensors stay on their
device; gloo moves CUDA tensors through the host itself.
"""

from __future__ import annotations

import contextlib
import os
from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist


def init_distributed(device: str | torch.device | None = None
                     ) -> Optional[torch.device]:
    """Start the process group of a ``torchrun`` launch, once per process,
    and return this rank's device: its own card (``LOCAL_RANK``) where the
    host has a card for every local rank, else the card they share, or the
    CPU where ``device`` says so. Without torchrun's environment nothing
    starts and ``device`` comes back as given."""
    if "WORLD_SIZE" not in os.environ or "RANK" not in os.environ:
        return None if device is None else torch.device(device)
    dev = torch.device("cuda" if device is None else device)
    local_rank = int(os.environ.get("LOCAL_RANK", 0))
    local_world = int(os.environ.get("LOCAL_WORLD_SIZE",
                                     os.environ["WORLD_SIZE"]))
    backend = "gloo"
    if dev.type == "cuda":
        cards = torch.cuda.device_count()
        if cards == 0:
            raise RuntimeError("no CUDA device is available; pass "
                               "--device cpu to run the ranks on the CPU")
        own_card = local_world <= cards
        dev = torch.device("cuda", local_rank if own_card else 0)
        torch.cuda.set_device(dev)
        backend = "nccl" if own_card else "gloo"
    if not dist.is_initialized():
        kwargs = {"device_id": dev} if backend == "nccl" else {}
        dist.init_process_group(backend, **kwargs)
        if dist.get_rank() == 0:
            print(f"process group: backend {backend}, world "
                  f"{dist.get_world_size()} ({local_world} ranks on this "
                  f"host, device {dev})", flush=True)
    return dev


@contextlib.contextmanager
def launched(device: str | torch.device | None = None):
    """An entry point's span: ``init_distributed``'s device, and the
    process group it started (if any) ended on the way out."""
    started = not dist.is_initialized()
    dev = init_distributed(device)
    try:
        yield dev
    finally:
        if started and dist.is_initialized():
            dist.destroy_process_group()


def global_rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def mesh_size_for_batch(batch: int, world: int,
                        shape: Tuple[int, ...] = ()) -> int:
    """The ranks a mesh for a global ``batch`` takes out of ``world``
    (attngan_tpu/parallel/mesh.py::make_mesh_for_batch): an explicit
    ``shape`` of 1 or 2 axes exactly, if it fits the world and divides the
    batch; with none, the most ranks that divide the batch."""
    if shape:
        if len(shape) > 2:
            raise ValueError(f"unsupported mesh shape {shape} (max 2-D)")
        n = 1
        for axis in shape:
            n *= axis
        if n > world:
            raise ValueError(f"mesh shape {shape} needs {n} devices, "
                             f"have {world}")
        if batch % n:
            raise ValueError(f"global batch {batch} not divisible by "
                             f"mesh size {n} (shape {shape})")
        return n
    n = world
    while n > 1 and batch % n:
        n -= 1
    return n


@dataclass(frozen=True)
class Mesh:
    """The ranks that share each global batch, row-sharded over every axis
    in rank order. ``group`` is the process group of the mesh's ranks
    (None in a process without one: a mesh of 1)."""

    shape: Tuple[int, ...]
    rank: int
    group: Optional[dist.ProcessGroup] = None
    device: torch.device = torch.device("cpu")

    @property
    def size(self) -> int:
        n = 1
        for axis in self.shape:
            n *= axis
        return n

    @property
    def is_main(self) -> bool:
        """Rank 0: the one that writes files and prints."""
        return self.rank == 0

    def __deepcopy__(self, memo):
        return self   # holds a process group, which is not copied

    def rows(self, batch: int) -> slice:
        """This rank's rows of a global batch of ``batch``."""
        b = batch // self.size
        return slice(self.rank * b, (self.rank + 1) * b)

    def barrier(self) -> None:
        """Wait for every rank of the mesh (a summed scalar read back on
        the host, which NCCL's asynchronous collectives need)."""
        if self.group is not None:
            flag = torch.zeros(1, device=self.device)
            dist.all_reduce(flag, group=self.group)
            flag.item()


def make_mesh(batch: int, shape: Tuple[int, ...] = (),
              device: str | torch.device = "cpu") -> Optional[Mesh]:
    """The mesh of a run with global batch ``batch`` over the process
    group's ranks (a mesh of 1 without a process group); None on a rank
    outside it. Every rank of the world must call it: the subgroup of the
    first n ranks is made collectively."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    n = mesh_size_for_batch(batch, world, tuple(shape))
    shape = tuple(shape) or (n,)
    device = torch.device(device)
    if not dist.is_initialized():
        return Mesh(shape, 0, None, device)
    group = dist.new_group(list(range(n))) if n < world else dist.group.WORLD
    rank = dist.get_rank()
    if rank >= n:
        print(f"rank {rank} is outside the {n}-rank mesh {shape}: it idles",
              flush=True)
        return None
    if rank == 0 and n > 1:
        print(f"data parallel over {n} ranks (mesh shape {shape})",
              flush=True)
    return Mesh(shape, rank, group, device)


def shard_rows(x, mesh: Optional[Mesh]):
    """This rank's rows of ``x``, a tensor or array of the global batch."""
    if mesh is None or mesh.size == 1:
        return x
    return x[mesh.rows(x.shape[0] if hasattr(x, "shape") else len(x))]


def _sum(t: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    dist.all_reduce(t, group=mesh.group)
    return t


def _gather(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    b = x.shape[0]
    out = x.new_zeros((b * mesh.size, *x.shape[1:]))
    out[mesh.rank * b:(mesh.rank + 1) * b] = x
    return _sum(out, mesh)


class _AllGatherRows(torch.autograd.Function):
    """Forward: every rank's rows, in rank order. Backward: the cotangents
    of every rank summed, this rank's rows of the sum."""

    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        ctx.rows = x.shape[0]
        return _gather(x.contiguous(), mesh)

    @staticmethod
    def backward(ctx, g):
        mesh, b = ctx.mesh, ctx.rows
        g = _sum(g.contiguous().clone(), mesh)
        return g[mesh.rank * b:(mesh.rank + 1) * b], None


class _AllReduceSum(torch.autograd.Function):
    """Forward: the sum over ranks. Backward: the cotangents summed."""

    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return _sum(x.clone(), mesh)

    @staticmethod
    def backward(ctx, g):
        return _sum(g.contiguous().clone(), ctx.mesh), None


def all_gather_rows(x: torch.Tensor, mesh: Optional[Mesh]) -> torch.Tensor:
    """The global batch of ``x`` (each rank's rows, in rank order),
    differentiable: the gradient of a rank's rows is the sum over ranks
    of the cotangents of those rows. Integer and bool tensors gather
    outside autograd."""
    if mesh is None or mesh.size == 1:
        return x
    if x.dtype == torch.bool:
        return _gather(x.to(torch.uint8), mesh).bool()
    if not x.is_floating_point():
        return _gather(x.contiguous(), mesh)
    return _AllGatherRows.apply(x, mesh)


def all_reduce_sum(x: torch.Tensor, mesh: Optional[Mesh]) -> torch.Tensor:
    """The sum of ``x`` over the ranks, differentiable (the cotangents of
    every rank summed)."""
    if mesh is None or mesh.size == 1:
        return x
    return _AllReduceSum.apply(x, mesh)


def all_reduce_max(x: torch.Tensor, mesh: Optional[Mesh]) -> torch.Tensor:
    """The elementwise maximum of ``x`` over the ranks (not differentiable:
    the int8 calibration's activation maxima)."""
    if mesh is None or mesh.size == 1:
        return x
    x = x.clone()
    dist.all_reduce(x, op=dist.ReduceOp.MAX, group=mesh.group)
    return x


def all_reduce_mean_(tensors: Sequence[Optional[torch.Tensor]],
                     mesh: Optional[Mesh]) -> None:
    """Average ``tensors`` (gradients) over the ranks in place, through
    one flat buffer; None entries are skipped."""
    if mesh is None or mesh.size == 1:
        return
    ts: List[torch.Tensor] = [t for t in tensors if t is not None]
    if not ts:
        return
    flat = torch.cat([t.reshape(-1) for t in ts])
    _sum(flat, mesh).div_(mesh.size)
    offset = 0
    for t in ts:
        n = t.numel()
        t.copy_(flat[offset:offset + n].view_as(t))
        offset += n


def mean_metrics(metrics: dict, mesh: Optional[Mesh]) -> dict:
    """Each 0-d metric averaged over the ranks, through one collective."""
    if mesh is None or mesh.size == 1 or not metrics:
        return metrics
    keys = list(metrics)
    flat = torch.stack([metrics[k].float().reshape(()) for k in keys])
    _sum(flat, mesh).div_(mesh.size)
    return dict(zip(keys, flat.unbind()))


def sync_batch_norm_(module: torch.nn.Module, mesh: Optional[Mesh]) -> None:
    """Take the train-mode statistics of every port BatchNorm in
    ``module`` over the global batch (ops/layers.py::BatchNorm)."""
    from attngan_torch.ops.layers import BatchNorm

    for m in module.modules():
        if isinstance(m, BatchNorm):
            m.mesh = mesh if mesh is not None and mesh.size > 1 else None
