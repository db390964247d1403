"""Process groups, device lists and collectives — counterpart of
``mpgan_tpu/parallel/mesh.py``.

The JAX package builds one 1-D ``data`` mesh over every chip and lets XLA
insert the collectives inside ``jit``. The port trains in the idiom of
``torch.distributed``: one process (rank) per card, NCCL between cards and
gloo on the CPU, state replicated on every rank, and one all-reduce of the
flattened gradients between ``backward`` and each optimizer step (JAX's
``psum``; :func:`all_reduce_mean`). Nothing is wrapped in
``DistributedDataParallel``: the lazy R1 penalty takes a double backward,
and a train step updates G, Ds and Dt with separate optimizers.

Inference needs no process group: a *device list* (:func:`make_mesh`)
splits a slice stack over cards from one process
(:func:`mpgan_torch.infer.assemble.apply_sliced`). A device list may name
one device several times, as the JAX tests run on 8 virtual CPU devices:
``[cpu] * 4`` on the CPU, ``[cuda:0] * 2`` on one card.

Without :func:`init_distributed` every helper sees a world of one.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.distributed as dist


def canonical(device) -> torch.device:
    """``device`` with its index: ``cuda`` is the current card."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return dev


def backend_for(device: torch.device) -> str:
    """The collective backend of a rank whose tensors live on ``device``:
    NCCL on a card, gloo on the CPU."""
    return "gloo" if torch.device(device).type == "cpu" else "nccl"


def init_distributed(coordinator: str, num_processes: int, process_id: int,
                     backend: str | None = None) -> None:
    """Join this process as rank ``process_id`` of ``num_processes``
    (JAX ``:32-45``). ``coordinator`` is the lead's ``host:port`` (or an
    init URL, ``tcp://…`` or ``file://…``). ``backend`` defaults to NCCL:
    the port runs on the card unless asked otherwise; a rank on the CPU,
    or ranks that share one card, pass ``"gloo"``. Call before any
    collective; a CUDA rank sets its device first."""
    if dist.is_initialized():
        raise RuntimeError("this process already joined a process group")
    if not 0 <= process_id < num_processes:
        raise ValueError(f"processId {process_id} is not in [0, "
                         f"{num_processes})")
    url = coordinator if "://" in coordinator else f"tcp://{coordinator}"
    dist.init_process_group(backend or "nccl", init_method=url,
                            world_size=num_processes, rank=process_id)


def shutdown() -> None:
    """Leave the process group (no effect outside one)."""
    if dist.is_initialized():
        dist.destroy_process_group()


def distributed() -> bool:
    """True inside a process group (of any size, one included)."""
    return dist.is_available() and dist.is_initialized()


def backend() -> str | None:
    """The process group's backend (``"nccl"``, ``"gloo"``); None outside
    one."""
    return dist.get_backend() if distributed() else None


def world() -> int:
    return dist.get_world_size() if distributed() else 1


def rank() -> int:
    return dist.get_rank() if distributed() else 0


def is_lead() -> bool:
    """Rank 0 writes files; every rank computes."""
    return rank() == 0


def make_mesh(n_devices: int | None = None,
              devices: Sequence | None = None) -> list[torch.device]:
    """The device list over every visible card (or the first ``n``).

    Raises rather than truncating when fewer than ``n_devices`` are given
    or visible (JAX ``:47-66``), and when no card is visible and no list
    is given: there is no CPU fallback."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "make_mesh: no CUDA card is visible; pass devices=[cpu] * n "
                "to split over the CPU")
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    devices = [canonical(d) for d in devices]
    if n_devices is not None:
        if len(devices) < n_devices:
            plat = devices[0].type if devices else "none"
            raise RuntimeError(
                f"make_mesh: requested {n_devices} devices but only "
                f"{len(devices)} available (platform={plat}); CUDA_VISIBLE_"
                "DEVICES limits the cards, and a list may repeat a device")
        devices = devices[:n_devices]
    return devices


def row_range(n: int, n_ranks: int | None = None,
              at: int | None = None) -> tuple[int, int]:
    """Rank ``at``'s rows ``[lo, hi)`` of ``n`` global rows: contiguous
    blocks, the first ``n % n_ranks`` ranks one row longer (the split of
    ``torch.tensor_split``)."""
    n_ranks = world() if n_ranks is None else n_ranks
    at = rank() if at is None else at
    if n < n_ranks:
        raise ValueError(f"{n} rows cannot give each of {n_ranks} ranks one")
    q, r = divmod(n, n_ranks)
    lo = at * q + min(at, r)
    return lo, lo + q + (1 if at < r else 0)


def shard_rows(tree, n_ranks: int | None = None, at: int | None = None):
    """This rank's rows of a global batch: a tensor or a dict of tensors
    sharing the leading axis (JAX ``shard_batch``/``constrain_batch``)."""
    if isinstance(tree, dict):
        return {k: shard_rows(v, n_ranks, at) for k, v in tree.items()}
    lo, hi = row_range(tree.shape[0], n_ranks, at)
    return tree[lo:hi]


def _flat_groups(tensors: Sequence[torch.Tensor]):
    """Tensors grouped by (device, dtype), each group with one flat buffer."""
    groups: dict = {}
    for t in tensors:
        groups.setdefault((t.device, t.dtype), []).append(t)
    for ts in groups.values():
        yield ts, torch.cat([t.reshape(-1) for t in ts])


def _scatter_back(ts: Sequence[torch.Tensor], flat: torch.Tensor) -> None:
    off = 0
    for t in ts:
        n = t.numel()
        t.copy_(flat[off:off + n].view_as(t))
        off += n


def all_reduce_mean(tensors: Sequence[torch.Tensor],
                    share: float | None = None) -> None:
    """In place, every tensor becomes its mean over the ranks, through one
    all-reduce of a flattened buffer per dtype. With ``share`` (this
    rank's fraction of the global batch; the shares sum to 1) it becomes
    the share-weighted sum instead, which is the global-batch mean of a
    per-row mean when ranks hold unequal rows."""
    if not distributed():
        return
    scale = share if share is not None else 1.0 / world()
    with torch.no_grad():
        for ts, flat in _flat_groups(list(tensors)):
            flat.mul_(scale)
            dist.all_reduce(flat)
            _scatter_back(ts, flat)


def replicate(tensors: Sequence[torch.Tensor]) -> None:
    """Make every rank's ``tensors`` rank 0's (a broadcast of one flat
    buffer per dtype), then check that the ranks agree bit for bit
    (:func:`check_replicated`)."""
    if not distributed():
        return
    tensors = list(tensors)
    with torch.no_grad():
        for ts, flat in _flat_groups(tensors):
            dist.broadcast(flat, src=0)
            _scatter_back(ts, flat)
    check_replicated(tensors)


def check_replicated(tensors: Sequence[torch.Tensor]) -> None:
    """Raise ``RuntimeError`` unless every rank holds the same values: the
    elementwise maximum and minimum over the ranks must be equal."""
    if not distributed():
        return
    with torch.no_grad():
        for ts, flat in _flat_groups(list(tensors)):
            flat = flat.to(torch.float64)
            hi, lo = flat.clone(), flat.clone()
            dist.all_reduce(hi, op=dist.ReduceOp.MAX)
            dist.all_reduce(lo, op=dist.ReduceOp.MIN)
            if not torch.equal(hi, lo):
                raise RuntimeError(
                    f"ranks disagree on {int((hi != lo).sum())} of "
                    f"{flat.numel()} replicated {ts[0].dtype} values")


def broadcast_int(value: int) -> int:
    """Rank 0's ``value`` on every rank (a run-dir index, a checkpoint
    number)."""
    if not distributed():
        return int(value)
    dev = (torch.device("cuda", torch.cuda.current_device())
           if backend() == "nccl" else torch.device("cpu"))
    t = torch.tensor([int(value)], dtype=torch.int64, device=dev)
    dist.broadcast(t, src=0)
    return int(t.item())


def barrier() -> None:
    if distributed():
        dist.barrier()
