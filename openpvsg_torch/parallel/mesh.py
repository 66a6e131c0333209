"""Device mesh, replication and process-group helpers, the port of
``openpvsg_tpu/parallel/mesh.py:22-47``.

JAX's mesh is single-controller: one process drives every local device
and XLA inserts the collectives. The port keeps that shape. A ``Mesh`` is
a grid of local ``torch.device``s with axes ``("data", "time")``; an
executor holds one replica of its module per device, copied once at
construction (there is no module-level cache: a cache served stale
weights), runs each shard on its own device and gathers onto the first.
The same device may appear more than once: two replicas on one card run
one after the other.

Several processes appear only where JAX runs several: the rank-strided work
list of the CLIs and lockstep segmenter training, one process per device
under ``torch.distributed`` (``init_distributed``; NCCL on the GPU, gloo
on the CPU).
"""
from __future__ import annotations

import copy
import datetime
from typing import Any, List, Optional, Sequence

import torch
import torch.distributed as dist

AXES = ("data", "time")


class Mesh:
    """A ``(data, time)`` grid of torch devices: ``devices[d][t]``, and
    ``shape`` {'data': n_data, 'time': n_time} as JAX's mesh gives it."""

    axis_names = AXES

    def __init__(self, devices: Sequence[Sequence[torch.device]]):
        self.devices = [[torch.device(d) for d in row] for row in devices]
        n_time = len(self.devices[0]) if self.devices else 0
        if n_time == 0 or any(len(r) != n_time for r in self.devices):
            raise ValueError("a mesh is a non-empty rectangular grid of devices")
        self.shape = {"data": len(self.devices), "time": n_time}

    @property
    def size(self) -> int:
        return self.shape["data"] * self.shape["time"]

    @property
    def first(self) -> torch.device:
        """Where executors gather their results."""
        return self.devices[0][0]

    def axis_devices(self, axis: Optional[str]) -> List[torch.device]:
        """The devices along 'data' (the first time column), or every device
        row-major for None."""
        if axis == "data":
            return [row[0] for row in self.devices]
        if axis is None:
            return [d for row in self.devices for d in row]
        raise ValueError(f"mesh axis {axis!r}: 'data' or None")


def make_mesh(n_data: Optional[int] = None, n_time: int = 1,
              devices: Optional[Sequence] = None) -> Mesh:
    """A (n_data, n_time) mesh over ``devices`` (row-major), by default every
    visible GPU, which raises without one: a CPU mesh names its devices,
    e.g. ``devices=["cpu"] * 8``. ``n_data`` defaults to len(devices) //
    n_time (``make_mesh``, ``openpvsg_tpu/parallel/mesh.py:22``)."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device: a mesh runs on the GPUs unless "
                               "the caller names its devices (e.g. ['cpu'] * n)")
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    devices = [torch.device(d) for d in devices]
    if n_data is None:
        n_data = len(devices) // n_time
    if n_data < 1 or n_time < 1 or n_data * n_time > len(devices):
        raise ValueError(f"a ({n_data}, {n_time}) mesh needs {n_data * n_time} "
                         f"devices; {len(devices)} given")
    for d in devices:
        if d.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(f"device {d} requested but CUDA is not available")
    return Mesh([devices[i * n_time:(i + 1) * n_time] for i in range(n_data)])


def replicate(module: torch.nn.Module, mesh: Mesh, axis: Optional[str] = "data"
              ) -> List[torch.nn.Module]:
    """One replica of ``module`` per device along ``axis`` (``Mesh.axis_devices``):
    the first is ``module`` itself, moved to the first device; the others are
    copies of its weights, made once."""
    devices = mesh.axis_devices(axis)
    first = module.to(devices[0])
    return [first] + [copy.deepcopy(first).to(d) for d in devices[1:]]


def _to(x: Any, device: torch.device):
    if torch.is_tensor(x):
        return x.to(device)
    return torch.as_tensor(x).to(device)


def split_blocks(batch, k: int, devices: Optional[Sequence[torch.device]] = None
                 ) -> List[Any]:
    """Split dim 0 of every leaf of ``batch`` (a dict, tuple, list, tensor
    or array) into ``k`` contiguous blocks: JAX's ``P('data')`` layout, and
    a rank's block of the global batch. With ``devices`` (k of them) block
    i goes to device i as a tensor. Dim 0 must divide evenly."""

    def split(x):
        if isinstance(x, dict):
            parts = {key: split(v) for key, v in x.items()}
            return [{key: p[i] for key, p in parts.items()} for i in range(k)]
        if isinstance(x, (list, tuple)):
            parts = [split(v) for v in x]
            return [type(x)(p[i] for p in parts) for i in range(k)]
        n = x.shape[0]
        if n % k:
            raise ValueError(f"dim 0 of size {n} does not divide into {k} blocks")
        b = n // k
        blocks = [x[i * b:(i + 1) * b] for i in range(k)]
        return blocks if devices is None else [_to(x, d) for x, d in zip(blocks, devices)]

    return split(batch)


def shard_batch(mesh: Mesh, batch, axis: str = "data") -> List[Any]:
    """``split_blocks`` over the devices along ``axis``, each block on its
    device: JAX's ``P(axis)`` placement."""
    devices = mesh.axis_devices(axis)
    return split_blocks(batch, len(devices), devices)


# ---------------------------------------------------------------------------
# process groups
# ---------------------------------------------------------------------------

def rank(group=None) -> int:
    """This process's rank, 0 without a process group."""
    return dist.get_rank(group) if dist.is_available() and dist.is_initialized() else 0


def world(group=None) -> int:
    """The number of processes, 1 without a process group."""
    return (dist.get_world_size(group)
            if dist.is_available() and dist.is_initialized() else 1)


def init_distributed(init_method: str, world_size: Optional[int] = None,
                     rank: Optional[int] = None, device=None,
                     backend: Optional[str] = None, local_rank: Optional[int] = None,
                     timeout_s: float = 1800.0) -> torch.device:
    """Join the default process group and return this process's device.

    ``init_method`` is torch's (``tcp://host:port`` with ``world_size`` and
    ``rank``, or ``env://``, which reads them from the environment as
    ``torchrun`` sets it). ``device="cpu"`` runs on the CPU with gloo;
    otherwise the process takes GPU ``local_rank`` (default: its rank modulo
    the visible GPUs), makes it current and uses NCCL, or ``backend`` when
    given: gloo where several ranks share one GPU, which NCCL refuses."""
    if device is not None and torch.device(device).type == "cpu":
        dev = torch.device("cpu")
        backend = backend or "gloo"
    else:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device: a distributed run takes one GPU per "
                               "process unless the caller passes device='cpu'")
        if device is not None:
            dev = torch.device(device)
        else:
            if local_rank is None:
                if rank is None:
                    raise ValueError("init_distributed needs the rank or the local "
                                     "rank to pick this process's GPU")
                local_rank = rank % torch.cuda.device_count()
            dev = torch.device("cuda", local_rank)
        torch.cuda.set_device(dev)
        backend = backend or "nccl"
    kwargs = {}
    if world_size is not None:
        kwargs.update(world_size=world_size, rank=rank)
    dist.init_process_group(backend, init_method=init_method,
                            timeout=datetime.timedelta(seconds=timeout_s), **kwargs)
    return dev


def all_reduce_sum(tensors: Sequence[torch.Tensor], group=None) -> None:
    """Sum each tensor over the process group, in place, through one flat
    buffer per dtype. Under gloo a CUDA buffer goes through a host copy:
    gloo's collectives of CUDA tensors are not to be relied on."""
    by_dtype = {}
    for t in tensors:
        by_dtype.setdefault(t.dtype, []).append(t)
    for group_ts in by_dtype.values():
        flat = torch.cat([t.reshape(-1) for t in group_ts])
        if flat.is_cuda and dist.get_backend(group) == "gloo":
            host = flat.cpu()
            dist.all_reduce(host, group=group)
            flat.copy_(host)
        else:
            dist.all_reduce(flat, group=group)
        offset = 0
        for t in group_ts:
            n = t.numel()
            t.copy_(flat[offset:offset + n].view(t.shape))
            offset += n


def broadcast_(tensors: Sequence[torch.Tensor], src: int = 0, group=None) -> None:
    """Overwrite each tensor with rank ``src``'s, in place (the gloo host copy
    as in ``all_reduce_sum``)."""
    for t in tensors:
        if t.is_cuda and dist.get_backend(group) == "gloo":
            host = t.cpu()
            dist.broadcast(host, src, group=group)
            t.copy_(host)
        else:
            dist.broadcast(t, src, group=group)
