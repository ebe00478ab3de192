"""Process groups and the collectives of data-parallel training: the
port's counterpart of ``tpudet/parallel/mesh.py``.

tpudet runs one SPMD program over a ``data`` mesh axis: the batch is
sharded, the state replicated, and XLA inserts every collective, so each
sum or mean over the batch (BatchNorm's statistics, every loss
denominator) is global and the gradient is that of the global loss. The
port reaches the same numbers with explicit collectives, one process per
device:

- ``init_distributed`` opens the process group (``nccl`` on the card,
  ``gloo`` on the CPU, or ``gloo`` with CUDA tensors where the caller asks
  for it) and names each rank's device;
- ``global_sum`` all-reduces a count (a loss denominator, a batch size),
  so that each rank's loss is its share of the global loss;
- ``models/layers.BatchNorm2d`` all-reduces its statistics while a group
  is open (SyncBN with flax's biased running variance);
- ``all_reduce_grads`` sums the ranks' gradients in one flat buffer, once
  per optimizer step: the sum of the shares' gradients is the gradient of
  the global loss;
- ``broadcast_`` makes every rank start from rank 0's tensors.

tpudet's ``make_mesh``, ``data_sharding``, ``replicated_sharding``,
``mesh_process_count``, ``shard_batch``, ``replicate`` and
``jit_train_step`` have no counterpart: a rank's loader yields its own
shard of the batch (rank-strided, ``data/loader.py``), which stays on the
rank's device, and the state lives in each rank's model. In particular
nothing decides by an array's leading size which arrays are split
(tpudet's ``shard_batch`` does); the loaders document their batch keys,
and every one of them is per-image.

With no group open every function here is the identity and the model
runs as on one device.
"""
from __future__ import annotations

import datetime
import socket
from typing import Dict, Iterable, List, Optional, Sequence, Union

import torch
import torch.distributed as dist

# a rank waits this long for the others at the rendezvous and in each
# collective before it raises
DEFAULT_TIMEOUT = datetime.timedelta(minutes=30)


def is_distributed() -> bool:
    """Whether a process group is open (of any size): the synced code
    paths run exactly while it is."""
    return dist.is_available() and dist.is_initialized()


def process_index() -> int:
    """This process's rank; 0 with no group open."""
    return dist.get_rank() if is_distributed() else 0


def process_count() -> int:
    """The number of processes; 1 with no group open."""
    return dist.get_world_size() if is_distributed() else 1


def shared_devices(placements: Sequence[str]) -> List[List[int]]:
    """The groups of ranks that ``placements`` (one ``host/device``
    string a rank) put on one device, each with more than one rank."""
    by_place: Dict[str, List[int]] = {}
    for rank, place in enumerate(placements):
        by_place.setdefault(place, []).append(rank)
    return [ranks for ranks in by_place.values() if len(ranks) > 1]


def _store(coordinator: str, num_processes: int, process_id: int,
           timeout: datetime.timedelta):
    """The rendezvous: ``file://PATH`` (a file every process can reach) or
    ``HOST:PORT``, where process 0 listens."""
    if coordinator.startswith('file://'):
        return dist.FileStore(coordinator[len('file://'):], num_processes)
    host, port = coordinator.rsplit(':', 1)
    return dist.TCPStore(host, int(port), num_processes,
                         is_master=process_id == 0, timeout=timeout)


def init_distributed(coordinator: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None,
                     backend: Optional[str] = None,
                     device: Union[str, torch.device] = 'cuda',
                     timeout: datetime.timedelta = DEFAULT_TIMEOUT
                     ) -> torch.device:
    """Open the process group of a multi-process run and return this
    process's device; with ``num_processes`` of 1 or none, open nothing
    (tpudet's ``init_distributed`` is a no-op there too) and return
    ``device``.

    ``coordinator`` is ``HOST:PORT`` (process 0 listens there) or
    ``file://PATH``; ``process_id`` is this process's rank. On ``cuda``
    rank ``r`` computes on ``cuda:(r % device_count)``; ``device='cpu'``
    keeps every rank on the CPU. ``backend`` defaults to ``nccl`` on the
    card and ``gloo`` on the CPU; ``gloo`` on the card reduces CUDA
    tensors through the host, the only layout in which two ranks may
    share one card. ``nccl`` with two ranks on one device raises
    ``ValueError`` before NCCL starts.
    """
    from ..utils.device import resolve_device
    device = resolve_device(device)
    if num_processes is None or num_processes <= 1:
        return device
    if coordinator is None or process_id is None:
        raise ValueError('a multi-process run needs --coordinator and '
                         '--process-id')
    if not 0 <= process_id < num_processes:
        raise ValueError(f'process id {process_id} is not in [0, '
                         f'{num_processes})')
    if device.type == 'cuda':
        device = torch.device('cuda', process_id % torch.cuda.device_count())
        torch.cuda.set_device(device)
    backend = backend or ('nccl' if device.type == 'cuda' else 'gloo')
    store = _store(coordinator, num_processes, process_id, timeout)
    # every rank's device, through the store: NCCL refuses two ranks on
    # one device, and says so only at its first collective
    store.set(f'tpudet_torch/device/{process_id}',
              f'{socket.gethostname()}/{device}')
    placements = [store.get(f'tpudet_torch/device/{r}').decode()
                  for r in range(num_processes)]
    shared = shared_devices(placements)
    if backend == 'nccl' and shared:
        raise ValueError(
            f'nccl cannot put ranks {shared} on one device '
            f'({placements}); give each rank its own card, or ask for the '
            f"'gloo' backend, which reduces CUDA tensors through the host")
    if backend == 'nccl' and device.type != 'cuda':
        raise ValueError("the nccl backend needs CUDA devices; use 'gloo' "
                         'on the CPU')
    dist.init_process_group(backend, store=store, rank=process_id,
                            world_size=num_processes, timeout=timeout)
    return device


def close_distributed() -> None:
    """Close the process group, if one is open."""
    if is_distributed():
        dist.destroy_process_group()


def barrier() -> None:
    """Wait for every rank; nothing with no group open."""
    if is_distributed():
        dist.barrier()


def global_sum(t: torch.Tensor) -> torch.Tensor:
    """``t`` summed over the ranks (a new tensor; no gradient flows
    through it), or ``t`` itself with no group open. A count that divides
    a loss goes through here, so that each rank's loss is its share of
    the global loss."""
    if not is_distributed():
        return t
    out = t.detach().clone()
    dist.all_reduce(out)
    return out


def global_count(n: float, device) -> torch.Tensor:
    """A local count ``n`` (images in this rank's batch, say) summed over
    the ranks: an fp32 0-d tensor on ``device``."""
    return global_sum(torch.tensor(float(n), device=device))


def _flat(tensors: Sequence[torch.Tensor], dtype: torch.dtype
          ) -> torch.Tensor:
    return torch.cat([t.detach().reshape(-1).to(dtype) for t in tensors])


def _unflatten_into(flat: torch.Tensor, tensors: Sequence[torch.Tensor]
                    ) -> None:
    offset = 0
    with torch.no_grad():
        for t in tensors:
            n = t.numel()
            t.copy_(flat[offset:offset + n].view(t.shape))
            offset += n


def all_reduce_grads(params: Iterable[torch.Tensor]) -> None:
    """Sum every parameter's ``.grad`` over the ranks, in place, with one
    all-reduce of one flat fp32 buffer. A parameter without a gradient
    takes part as zeros (every rank reduces the same layout) and gets the
    sum. Nothing with no group open."""
    if not is_distributed():
        return
    params = list(params)
    for p in params:
        if p.grad is None:
            p.grad = torch.zeros_like(p)
    grads = [p.grad for p in params]
    flat = _flat(grads, torch.float32)
    dist.all_reduce(flat)
    _unflatten_into(flat, grads)


def broadcast_(tensors: Iterable[torch.Tensor], src: int = 0) -> None:
    """Overwrite ``tensors`` with rank ``src``'s, in place: one broadcast
    of a flat buffer per dtype. Nothing with no group open."""
    if not is_distributed():
        return
    by_dtype: Dict[torch.dtype, List[torch.Tensor]] = {}
    for t in tensors:
        by_dtype.setdefault(t.dtype, []).append(t)
    for dtype, group in by_dtype.items():
        flat = _flat(group, dtype)
        dist.broadcast(flat, src)
        _unflatten_into(flat, group)


def all_gather_object(obj) -> list:
    """Every rank's ``obj``, in rank order (pickled through the group's
    own devices); ``[obj]`` with no group open."""
    if not is_distributed():
        return [obj]
    out = [None] * dist.get_world_size()
    dist.all_gather_object(out, obj)
    return out
