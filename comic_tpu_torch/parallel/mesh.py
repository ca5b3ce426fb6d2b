"""The data-parallel mesh and its batch helpers; counterpart of
comic_tpu/parallel/mesh.py.

comic_tpu runs one process per host over a 1-D mesh of the host's devices
and lets XLA insert the gradient all-reduce. The port maps that onto
PyTorch in two ways:

- serving and the checkpoint sweep run in one process whose ``Mesh`` is
  the list of cards it drives: each card takes a contiguous block of the
  batch, with its own copy of the parameters, and the ids come back
  concatenated in block order (inference.make_serve_fn);
- training runs one process per card in a torch.distributed job
  (distributed.py): each rank holds the same parameters (``replicate``
  broadcasts rank 0's), takes its contiguous block of every global batch,
  and sums the gradients with one coalesced ``all_reduce_grads`` after
  the backward pass.

The unit of a job is the host, as in comic_tpu: a job of W ranks spans
``host_count()`` hosts of ``ranks_per_host()`` ranks each, and a host's
ranks stand in for one comic_tpu process's chips. An XE step's global
batch is ``batch_size_train`` rows a host; on one host whose ranks do not
divide a batch, ``make_mesh_for_batch`` keeps the first n ranks that do
(the mesh's ``processes``) and the others idle, as comic_tpu shrinks its
mesh to the chips that divide the batch; across hosts the batch must
divide every rank.

A batch that spans the job is held by each rank as a ``ProcessBlock``:
its rows and their place in the global batch, which ``local_batch`` and
``local_batch_start`` read back with comic_tpu's guards. An idle rank
holds an empty block placed at the end of the batch. Outside a job the
helpers are the identity, as comic_tpu's are in one process.
"""

from __future__ import annotations

import os
from typing import Any, Iterable, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from .. import DeviceLike, resolve_device

DATA_AXIS = "data"


class Mesh(NamedTuple):
    """A 1-D data mesh: the ``devices`` this process drives (one block of
    the batch each) in each of the job's ``processes`` that take a block
    (1 outside a job; in a job each process drives one device, and ranks
    ``processes`` on, if any, idle)."""

    devices: Tuple[torch.device, ...]
    processes: int = 1

    @property
    def size(self) -> int:
        """Blocks of the global batch: the devices over every process."""
        return len(self.devices) * self.processes


class Sharding(NamedTuple):
    """How a batch lies on a mesh: split into contiguous blocks along its
    rows over the data axis (``axis`` DATA_AXIS), or the same on every
    device (``axis`` None)."""

    mesh: Optional[Mesh]
    axis: Optional[str]


def batch_sharding(mesh: Mesh) -> Sharding:
    """Leading axis split across the data axis."""
    return Sharding(mesh, DATA_AXIS)


def replicated(mesh: Optional[Mesh]) -> Sharding:
    return Sharding(mesh, None)


def in_job() -> bool:
    """Whether this process is a rank of a torch.distributed job."""
    return dist.is_available() and dist.is_initialized()


def process_count() -> int:
    return dist.get_world_size() if in_job() else 1


def process_index() -> int:
    return dist.get_rank() if in_job() else 0


def ranks_per_host() -> int:
    """The job's ranks on one host: torchrun's LOCAL_WORLD_SIZE where it is
    set; else, under NCCL, the host's visible cards (at most the world: a
    job smaller than one host's cards runs on one host); else 1 (gloo on
    the CPU: each rank a host of its own). Outside a job 1."""
    if not in_job():
        return 1
    local = os.environ.get("LOCAL_WORLD_SIZE")
    if local:
        return int(local)
    if torch.cuda.is_available() and dist.get_backend() == "nccl":
        return min(torch.cuda.device_count(), process_count())
    return 1


def host_count() -> int:
    """The job's hosts, comic_tpu's ``jax.process_count()``: the world over
    ``ranks_per_host()``, which must divide it. Outside a job 1."""
    world, local = process_count(), ranks_per_host()
    if local < 1 or world % local:
        raise ValueError(
            f"a job of {world} ranks does not split into hosts of {local} "
            "ranks (LOCAL_WORLD_SIZE, or the host's cards).")
    return world // local


def process_device() -> torch.device:
    """The device of this rank's collectives: its card under NCCL, the CPU
    under gloo."""
    if dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def available_devices(device: DeviceLike = None) -> List[torch.device]:
    """The devices one process can drive from ``device``: every visible
    card for a CUDA device without an index (None: the card), else
    ``device`` alone (one card, or the CPU)."""
    device = resolve_device(device)
    if device.type == "cuda" and device.index is None:
        return [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    return [device]


def make_mesh(num_devices: Optional[int] = None,
              devices: Optional[Sequence[torch.device]] = None) -> Mesh:
    """The 1-D data mesh: in a job, this process's device in each of the
    job's processes; else the first ``num_devices`` of ``devices``
    (default: every visible card)."""
    if in_job():
        return Mesh((process_device(),), process_count())
    if devices is None:
        devices = available_devices()
    devices = list(devices)
    if num_devices is not None:
        devices = devices[:num_devices]
    return Mesh(tuple(torch.device(d) for d in devices))


def _fit_batches(n: int, batch_sizes: Sequence[int], limit: int
                 ) -> Tuple[int, int]:
    """(the largest count <= ``n``, capped by ``limit`` > 0, that divides
    every batch size; the capped count)."""
    if limit and limit > 0:
        n = min(n, int(limit))
    capped = n
    while n > 1 and any(b % n for b in batch_sizes):
        n -= 1
    return n, capped


def job_ranks(*batch_sizes: int, limit: int = 0) -> Tuple[int, int]:
    """(the job's ranks that take a block of every batch, the ranks that
    could): comic_tpu's mesh rule with a host's ranks in the place of its
    chips. On one host the first n ranks work, n the largest count up to
    the world (and ``limit`` > 0) that divides every batch size; across
    hosts every rank works, and a global batch that does not divide them,
    or a ``limit`` that would leave some out, raises. Outside a job
    (1, 1)."""
    if not in_job():
        return 1, 1
    world, hosts = process_count(), host_count()
    if hosts > 1:
        # a shrunk mesh would leave whole hosts out: fail loudly instead
        bad = [b for b in batch_sizes if b % world]
        if bad:
            raise ValueError(
                f"multi-process mesh: global batch size(s) {bad} must "
                f"divide the {world} global devices.")
        if limit and 0 < limit < world:
            raise ValueError(
                "num_data_shards cannot shrink a multi-process mesh "
                f"({limit} < {world} devices spanning {hosts} processes).")
        return world, world
    return _fit_batches(world, batch_sizes, limit)


def _warn_idle(n: int, capped: int, batch_sizes: Sequence[int]) -> None:
    # every dropped device is idle silicon: say so loudly
    idle = capped - n
    hints = sorted({max(round(b / capped), 1) * capped for b in batch_sizes})
    print(
        f"WARNING: batch size(s) {sorted(set(batch_sizes))} are not "
        f"divisible by {capped} devices; using a {n}-device mesh "
        f"({idle} device{'s' if idle != 1 else ''} IDLE). Choose a "
        f"batch divisible by {capped} (nearby: {hints}) to use the "
        "full slice.")


def make_mesh_for_batch(*batch_sizes: int, limit: int = 0,
                        devices: Optional[Sequence[torch.device]] = None
                        ) -> Mesh:
    """The mesh over the largest device count that divides every batch
    size, so blocks are exact (no padding). ``limit`` > 0 caps its size
    (config.num_data_shards; 0 = every divisible device). ``devices``:
    the candidates outside a job (default: every visible card).

    In a job the devices are the ranks (``job_ranks``): on one host the
    mesh keeps the first ranks that divide every batch and the rest idle,
    with the same warning (printed by rank 0); across hosts it spans every
    rank, and a global batch that does not divide them raises, as does a
    ``limit`` that would leave ranks out."""
    if in_job():
        n, capped = job_ranks(*batch_sizes, limit=limit)
        if n < capped and process_index() == 0:
            _warn_idle(n, capped, batch_sizes)
        return Mesh((process_device(),), n)
    if devices is None:
        devices = available_devices()
    n, capped = _fit_batches(len(devices), batch_sizes, limit)
    if n < capped:
        _warn_idle(n, capped, batch_sizes)
    return make_mesh(n, devices)


def takes_part(mesh: Optional[Mesh]) -> bool:
    """Whether this rank takes a block of the batch on ``mesh`` (None:
    every rank does)."""
    return mesh is None or process_index() < mesh.processes


def shard_batch(mesh: Mesh, x) -> List[torch.Tensor]:
    """This process's rows (numpy or tensor) -> one contiguous block on
    each of its mesh devices, in order."""
    x = torch.as_tensor(x)
    n = len(mesh.devices)
    if x.shape[0] % n:
        raise ValueError(f"shard_batch: batch of {x.shape[0]} does not "
                         f"divide across {n} devices.")
    return [blk.to(dev, non_blocking=True)
            for blk, dev in zip(x.chunk(n), mesh.devices)]


def _tensors(tree) -> List[torch.Tensor]:
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        tree = tree.values()
    return [t for sub in tree for t in _tensors(sub)]


def _coalesced(tensors: Iterable[torch.Tensor], collective) -> None:
    """Run ``collective`` on one flat buffer per dtype that holds every
    tensor, then copy the result back into the tensors (in place)."""
    by_dtype = {}
    for t in tensors:
        by_dtype.setdefault(t.dtype, []).append(t)
    for group in by_dtype.values():
        flat = torch.cat([t.detach().reshape(-1) for t in group])
        collective(flat)
        with torch.no_grad():
            for t, v in zip(group, flat.split([t.numel() for t in group])):
                t.copy_(v.view_as(t))


def replicate(mesh: Mesh, tree: Any) -> Any:
    """Every process takes rank 0's values of ``tree`` (nested dicts,
    lists or tuples of tensors on this rank's device), in place; returns
    the tree. Outside a job the identity."""
    if in_job():
        _coalesced(_tensors(tree), lambda flat: dist.broadcast(flat, 0))
    return tree


def all_reduce_grads(leaves: Sequence[torch.Tensor],
                     values: Optional[torch.Tensor] = None
                     ) -> Optional[torch.Tensor]:
    """Sum the gradients of ``leaves`` over the job's ranks, in place, with
    one all_reduce of a flat buffer that also holds the 1-D float32
    ``values`` (e.g. the step's local loss parts); returns the summed
    ``values``. A leaf without a gradient contributes zeros. Counts its
    calls in ``all_reduce_grads.calls``. Outside a job the identity."""
    if not in_job():
        return values
    for v in leaves:
        if v.grad is None:
            v.grad = torch.zeros_like(v)
    values = None if values is None else values.detach().clone()
    parts = [v.grad for v in leaves] + ([] if values is None else [values])
    all_reduce_grads.calls += 1
    _coalesced(parts, dist.all_reduce)
    return values


all_reduce_grads.calls = 0


def all_gather_ints(values: Sequence[int]) -> np.ndarray:
    """(W, len(values)) int64: every rank's ``values`` (one collective, on
    this rank's collective device). Outside a job one row."""
    if not in_job():
        return np.asarray([values], np.int64)
    local = torch.tensor(list(values), dtype=torch.int64,
                         device=process_device())
    out = [torch.empty_like(local) for _ in range(process_count())]
    dist.all_gather(out, local)
    return torch.stack(out).cpu().numpy()


def all_reduce_sum(x: torch.Tensor) -> torch.Tensor:
    """The sum of ``x`` over the job's ranks (a new tensor on ``x``'s
    device). Outside a job ``x``."""
    if not in_job():
        return x
    out = x.detach().clone()
    dist.all_reduce(out)
    return out


def barrier() -> None:
    """Wait for every rank of the job. Outside a job a no-op."""
    if in_job():
        if dist.get_backend() == "nccl":
            dist.barrier(device_ids=[torch.cuda.current_device()])
        else:
            dist.barrier()


class HostCopy:
    """A device->host copy into pinned memory started now and read later
    (``numpy()``), so the host works on batch i while the card runs batch
    i+1. A CPU tensor is read as it is."""

    def __init__(self, x: torch.Tensor):
        if x.device.type == "cuda":
            self.host = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
            self.host.copy_(x, non_blocking=True)
            self.done = torch.cuda.Event()
            self.done.record()
        else:
            self.host, self.done = x, None

    def numpy(self) -> np.ndarray:
        if self.done is not None:
            self.done.synchronize()
        return self.host.numpy()


def start_host_fetch(*arrays: torch.Tensor) -> List[HostCopy]:
    """Start the device->host copies of ``arrays``; read each with
    ``.numpy()``."""
    return [HostCopy(a) for a in arrays]


# --- a batch that spans the job ----------------------------------------------

class ProcessBlock(NamedTuple):
    """This process's contiguous block of a batch that spans the job: its
    rows ``data`` (tensor or numpy) are rows [start, start + n) of a global
    batch of ``size`` rows along ``axis``, split into equal blocks over the
    first ``parts`` ranks (None: every rank). An idle rank's block is empty
    and starts at ``size``."""

    data: Any
    start: int
    size: int
    axis: int = 0
    parts: Optional[int] = None

    @property
    def shape(self) -> Tuple[int, ...]:
        """The global batch's shape."""
        shape = list(self.data.shape)
        shape[self.axis] = self.size
        return tuple(shape)

    @property
    def idle(self) -> bool:
        """Whether this rank takes no rows of the batch."""
        return self.data.shape[self.axis] == 0 and self.start == self.size

    def like(self, data, axis: int = 0, scale: int = 1) -> "ProcessBlock":
        """``data``, this block's rows along ``axis`` (``scale`` rows a row:
        e.g. the hypotheses of its images), placed as this block is."""
        return ProcessBlock(data, self.start * scale, self.size * scale,
                            axis, self.parts)


def _numpy(x) -> np.ndarray:
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def block_count(mesh: Optional[Mesh]) -> int:
    """The ranks that take a block on ``mesh`` (None: every rank)."""
    return process_count() if mesh is None else mesh.processes


def local_batch(x, axis: int = 0) -> np.ndarray:
    """This process's rows of a batch that spans the job, as numpy (in one
    process: the whole array). ``axis`` matters for beam-major layouts
    like (beam, batch, time).

    Raises instead of returning duplicated or misplaced rows where ``x``
    is not a disjoint block of the job's batch: a plain array in a job
    (every rank holds all rows: replicated), or a block off the ranks'
    block boundaries. An idle rank's empty block is returned as it is."""
    if process_count() == 1:
        return _numpy(x.data if isinstance(x, ProcessBlock) else x)
    if not isinstance(x, ProcessBlock):
        x = ProcessBlock(x, 0, x.shape[axis], axis)
    if x.idle:
        return _numpy(x.data)
    parts = process_count() if x.parts is None else x.parts
    rows = x.data.shape[axis]
    expect = x.size // parts
    if rows != expect:
        raise ValueError(
            f"local_batch: process holds {rows} of {x.size} rows along "
            f"axis {axis}, expected a disjoint 1/{parts} block of "
            f"{expect}; the array is probably replicated — feed it through "
            "global_batch or feed_global.")
    if x.start % expect:
        raise ValueError(
            f"local_batch: non-contiguous blocks along axis {axis}: this "
            f"block starts at row {x.start}, not at a boundary of the "
            f"{expect}-row blocks of the ranks.")
    return _numpy(x.data)


def local_batch_start(x, axis: int = 0) -> int:
    """Global index of this process's first row along ``axis``."""
    return int(x.start) if isinstance(x, ProcessBlock) else 0


def global_batch(mesh: Optional[Mesh], x_local, axis: int = 0):
    """Inverse of local_batch: this process's rows along ``axis`` as its
    block of the job's batch (rank r holds block r of the ranks that take
    part on ``mesh``; None: every rank). The identity in one process. An
    idle rank has no block to place: it raises."""
    if process_count() == 1:
        return x_local
    parts, rank = block_count(mesh), process_index()
    if rank >= parts:
        raise ValueError(
            f"global_batch: rank {rank} takes no block of a batch split "
            f"over {parts} ranks.")
    n = x_local.shape[axis]
    return ProcessBlock(x_local, rank * n, n * parts, axis, parts)


def feed_global(mesh: Optional[Mesh], x, axis: int = 0):
    """The full batch, the same on every process (e.g. an eval or SCST
    pipeline that is not split), -> this process's contiguous block of it,
    placed in the job's batch: the batch splits over the ranks that take
    part on ``mesh`` (None: every rank), and an idle rank takes an empty
    block. The identity in one process."""
    if process_count() == 1:
        return x
    parts, rank = block_count(mesh), process_index()
    size = x.shape[axis]
    if size % parts:
        raise ValueError(
            f"feed_global: batch axis {axis} of size {size} does not "
            f"divide across {parts} processes.")
    blk = size // parts
    lo = min(rank * blk, size)
    hi = lo + blk if rank < parts else size
    sl = [slice(None)] * x.ndim
    sl[axis] = slice(lo, hi)
    return ProcessBlock(x[tuple(sl)], lo, size, axis, parts)
