"""Process groups: initialisation, the collectives, and rank launching.

Counterpart of ``takzero_tpu/parallel/multihost.py``.  The reference scales
by running many one-GPU processes over a shared filesystem
(README.md:128-135); the JAX package adds in-job scale-out, one program
over the chips of a slice.  The port maps that onto ``torch.distributed``
with one rank per device and every rank a process.  Every rank runs the
same driver loop on its rows of the batch; rank 0 (the coordinator) owns
every file write, reads that must agree (target-file tails, seeds) are
broadcast from it, and what the host needs from the device is gathered,
so every rank takes the same host decisions.

Without an initialised process group every collective here is the
identity of a world of one rank.

Under gloo the collectives stage their tensors through the host; under
NCCL they run on the rank's card.  NCCL cannot put two ranks on one card,
so ranks that share a card take gloo.
"""

from __future__ import annotations

import os
import pickle
import shutil
import tempfile

import torch
import torch.distributed as dist

_I32 = 2**31


def active() -> bool:
    """Whether a process group is initialised in this process."""
    return dist.is_available() and dist.is_initialized()


def initialize(coordinator_address: str | None = None, num_processes: int | None = None,
               process_id: int | None = None, backend: str = "gloo") -> None:
    """``torch.distributed.init_process_group`` from a coordinator address.

    ``coordinator_address`` is ``HOST:PORT`` (a TCP rendezvous) or a
    ``file://`` URL; with none of the three arguments the group reads
    torchrun's environment (``MASTER_ADDR``, ``MASTER_PORT``,
    ``WORLD_SIZE``, ``RANK``).  Call once per process, before any
    collective.
    """
    if coordinator_address is None and num_processes is None and process_id is None:
        dist.init_process_group(backend=backend, init_method="env://")
        return
    if None in (coordinator_address, num_processes, process_id):
        raise ValueError("pass --coordinator, --num-processes and --process-id together (or none of them)")
    url = coordinator_address if "://" in coordinator_address else f"tcp://{coordinator_address}"
    dist.init_process_group(backend=backend, init_method=url, world_size=num_processes, rank=process_id)


def rank() -> int:
    return dist.get_rank() if active() else 0


def world_size() -> int:
    return dist.get_world_size() if active() else 1


def global_world(device="cuda"):
    """The :class:`~takzero_torch.parallel.mesh.World` of this process's
    rank in the initialised group, on ``device`` (see ``mesh.rank_device``)."""
    from .mesh import World, rank_device

    return World(rank=rank(), size=world_size(), device=rank_device(device), active=active())


def is_coordinator() -> bool:
    """Rank 0 owns every file write (checkpoints, target and replay
    appends, metrics, buffer lengths); the other ranks run the same
    collective compute and stay silent, so shared files are written once."""
    return rank() == 0


def _staged(x: torch.Tensor) -> torch.Tensor:
    """``x`` on the device the group's backend reduces on: the host under
    gloo, the tensor's own card under NCCL."""
    return x.cpu() if dist.get_backend() == "gloo" else x


def broadcast_scalar(value) -> int:
    """The coordinator's integer scalar (a flag, a seed) on every rank.

    Collective: every rank calls it at the same point.  Values must fit
    int32, as in the JAX package (whose x64 is off); both uses, read-gate
    flags and 31-bit seeds, do.
    """
    value = int(value)
    if not -_I32 <= value < _I32:
        raise OverflowError(f"broadcast_scalar: {value} does not fit int32")
    if not active():
        return value
    t = torch.tensor([value], dtype=torch.int64)
    if dist.get_backend() != "gloo":
        t = t.cuda()
    dist.broadcast(t, src=0)
    return int(t.item())


def broadcast_lines(lines: list[str] | None) -> list[str]:
    """The coordinator's text lines on every rank.

    A file being appended to shows each rank another prefix, so only the
    coordinator tails the target files and the lines are broadcast: every
    rank's buffer, batch draw and therefore parameters stay identical.
    Two collectives for each call, one length and one payload, however
    many lines.  Other ranks pass anything (``None``).
    """
    if not active():
        return list(lines or [])
    payload = "\n".join(lines).encode("utf-8") if lines and is_coordinator() else b""
    n = broadcast_scalar(len(payload) if is_coordinator() else 0)
    if n == 0:
        return []
    buf = torch.frombuffer(bytearray(payload), dtype=torch.uint8) if is_coordinator() \
        else torch.zeros(n, dtype=torch.uint8)
    if dist.get_backend() != "gloo":
        buf = buf.cuda()
    dist.broadcast(buf, src=0)
    return bytes(buf.cpu().numpy()).decode("utf-8").split("\n")


def process_batch_slice(global_batch: int) -> tuple[int, int]:
    """``(per-rank batch, offset)``: this rank's rows of a batch split
    evenly over the ranks."""
    n, i = world_size(), rank()
    per = global_batch // n
    assert per * n == global_batch, f"global batch {global_batch} must be a multiple of the {n} ranks"
    return per, i * per


def all_gather_rows(x: torch.Tensor, dim: int = 0) -> torch.Tensor:
    """Every rank's ``x`` concatenated along ``dim`` in rank order (the
    global batch from each rank's rows), on ``x``'s device."""
    if not active():
        return x
    src = _staged(x.contiguous())
    if x.dtype == torch.bool:
        src = src.to(torch.uint8)
    parts = [torch.empty_like(src) for _ in range(world_size())]
    dist.all_gather(parts, src)
    return torch.cat(parts, dim=dim).to(x.device, x.dtype)


def _summed(x: torch.Tensor) -> torch.Tensor:
    y = _staged(x.detach()).clone()
    dist.all_reduce(y)
    return y.to(x.device)


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return _summed(x)

    @staticmethod
    def backward(ctx, grad):
        return _summed(grad)


def all_reduce_sum(x: torch.Tensor) -> torch.Tensor:
    """The sum of ``x`` over the ranks, differentiable: the backward pass
    sums the incoming gradients over the ranks too (as
    ``torch.distributed.nn.functional.all_reduce`` does), so a loss that
    is the sum of every rank's part gets its full gradient."""
    return _AllReduceSum.apply(x) if active() else x


def all_reduce_flat(tensors: list[torch.Tensor]) -> None:
    """Sum ``tensors`` over the ranks in place, as ONE flat buffer (one
    collective for every parameter's gradient together, never one per
    tensor).  The reduction gives every rank the same bits."""
    if not active() or not tensors:
        return
    flat = _staged(torch.cat([t.reshape(-1) for t in tensors]))
    dist.all_reduce(flat)
    flat = flat.to(tensors[0].device)
    offset = 0
    for t in tensors:
        t.copy_(flat[offset : offset + t.numel()].view_as(t))
        offset += t.numel()


def all_reduce_mean(x: torch.Tensor) -> torch.Tensor:
    """The mean of ``x`` over the ranks (JAX's ``pmean``), not differentiable."""
    return _summed(x) / world_size() if active() else x


# ---------------------------------------------------------------------------
# Launching ranks
# ---------------------------------------------------------------------------


def _rank_entry(local_rank: int, target, argv, init_method: str, world_size: int, offset: int, backend: str,
                out_dir: str, threads: int | None) -> None:
    """One spawned rank: join the group, run ``target(argv)``, keep its result."""
    os.environ["LOCAL_RANK"] = str(local_rank)
    if threads:
        torch.set_num_threads(threads)
    initialize(init_method, world_size, offset + local_rank, backend)
    try:
        result = target(argv)
    finally:
        dist.destroy_process_group()
    with open(os.path.join(out_dir, f"rank{local_rank}.pt"), "wb") as f:
        torch.save(_portable(result), f, pickle_protocol=pickle.HIGHEST_PROTOCOL)


def _portable(obj):
    """``obj`` with every tensor and module moved to the host, to cross a
    process boundary."""
    if isinstance(obj, (torch.Tensor, torch.nn.Module)):
        return obj.cpu()
    if isinstance(obj, dict):
        return {k: _portable(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)) and not hasattr(obj, "_fields"):
        return type(obj)(_portable(v) for v in obj)
    return obj


def run_ranks(target, argv, n: int, backend: str, init_method: str | None = None, world_size: int | None = None,
              offset: int = 0, threads: int | None = None) -> list:
    """Run ``target(argv)`` as ranks ``offset .. offset + n - 1`` of a group
    of ``world_size`` ranks (default ``n``); returns each local rank's result,
    its tensors and modules moved to the host.

    One rank runs in this process.  Several are spawned processes, each
    with ``LOCAL_RANK`` set and, given ``threads``, that many CPU threads;
    if one fails, the others are stopped and the failure is raised here.
    Without ``init_method`` the ranks meet at a ``file://`` rendezvous in a
    temporary directory.
    """
    world_size = n if world_size is None else world_size
    tmp = tempfile.mkdtemp(prefix="takzero_ranks_")
    try:
        init_method = init_method or f"file://{os.path.join(tmp, 'rendezvous')}"
        if n == 1:
            # In-process: the caller's logging and return value stay as they are.
            initialize(init_method, world_size, offset, backend)
            try:
                return [target(argv)]
            finally:
                dist.destroy_process_group()
        import torch.multiprocessing as mp

        mp.start_processes(_rank_entry, args=(target, argv, init_method, world_size, offset, backend, tmp,
                                              threads), nprocs=n, start_method="spawn")
        out = []
        for i in range(n):
            with open(os.path.join(tmp, f"rank{i}.pt"), "rb") as f:
                out.append(torch.load(f, weights_only=False))
        return out
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
