"""Ranks of a data-parallel job, and each rank's rows.

Counterpart of ``takzero_tpu/parallel/mesh.py``, whose 1-D ``dp`` mesh
shards the batch over local chips under GSPMD.  In the port the mesh is a
world of ranks, one process per device (``parallel/multihost.py``):

* learner: every rank holds the whole bundle and optimizer state, built
  from one broadcast seed, and trains on its rows of the target batch;
  BatchNorm takes its statistics over the global batch and the gradients
  are summed over the ranks, so every rank applies the same update;
* actors: the game (or position) batch is split over the ranks, every
  rank draws the random numbers of the whole batch and keeps its rows,
  and the per-move host buffer is gathered, so world N plays the games
  of world 1;
* novelty seen-set: each rank hashes its rows and the indices are
  gathered before ``bitset_set``, so the bitset stays identical.

JAX's ``replicate`` has no counterpart: ranks build identical weights from
one seed.
"""

from __future__ import annotations

import os
from dataclasses import dataclass

import torch

from ..device import resolve_device
from . import multihost


@dataclass(frozen=True)
class World:
    """This process's place in the job: rank ``rank`` of ``size`` on
    ``device``.  ``active``: a process group runs, so the collectives go
    through it (also at size 1).  ``launch``: this process has no rank
    yet and must start ``size`` of them (``multihost.run_ranks``)."""

    rank: int = 0
    size: int = 1
    device: torch.device | None = None
    active: bool = False
    launch: bool = False

    @property
    def coordinator(self) -> bool:
        return self.rank == 0

    def rows(self, x, dim: int = 0):
        """This rank's rows of ``x`` along ``dim``."""
        return shard_rows(x, self.rank, self.size, dim)

    def gather(self, x: torch.Tensor, dim: int = 0) -> torch.Tensor:
        """Every rank's rows of ``x`` in rank order: the global batch."""
        return multihost.all_gather_rows(x, dim) if self.active else x

    def at_global_shape(self, fn):
        """``fn(x, *args)`` on this rank's rows ``x``, run at the global
        batch's shape: ``x`` written at its global offset ``rank * rows``
        of a zero tensor ``size`` times as long, and only this rank's rows
        of each output (a tensor or a tuple of them) kept.

        The library picks a convolution's algorithm, and so its order of
        summation, by the batch's shape: at the global shape every row
        goes through the launch it has in world 1, at the place it has
        there, so a bf16 network gives world 1's bits."""
        if self.size == 1:
            return fn

        def run(x: torch.Tensor, *args):
            b = x.shape[0]
            full = x.new_zeros((b * self.size,) + tuple(x.shape[1:]))
            full[self.rank * b : (self.rank + 1) * b] = x
            out = fn(full, *args)
            if isinstance(out, tuple):
                return tuple(self.rows(o) for o in out)
            return self.rows(out)

        return run


def shard_rows(x, rank: int, world: int, dim: int = 0):
    """Rows ``[rank * B / world, (rank + 1) * B / world)`` of ``x`` along
    ``dim`` (a tensor, an array or a NamedTuple of them; ``dim=1`` for the
    learner's stacked [K, B, ...] chunks)."""
    if isinstance(x, tuple):  # a NamedTuple of tensors (a Batch, a TakState)
        return type(x)(*(shard_rows(v, rank, world, dim) for v in x))
    b = x.shape[dim]
    if b % world:
        raise ValueError(f"batch {b} not divisible by {world} ranks")
    per = b // world
    index = [slice(None)] * dim + [slice(rank * per, (rank + 1) * per)]
    return x[tuple(index)]


def backend_for(device) -> str:
    """NCCL for ranks on cards, gloo on the CPU."""
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def rank_device(device="cuda") -> torch.device:
    """A rank's device: ``cuda`` with no index means ``cuda:LOCAL_RANK``
    (0 when unset); a named device (``cuda:0``, ``cpu``) is taken as it
    is, so ranks that share a card name it.  The card becomes current."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0")))
    dev = resolve_device(dev)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    return dev


def make_world(n: int, device="cuda") -> list[torch.device]:
    """The devices of ``n`` ranks started from this process, one per card
    of ``device``'s type (``cuda:0 .. cuda:n-1``) or ``n`` times the CPU.

    Raises when fewer than ``n`` cards are visible, and, inside a running
    group, when ``n`` is not the group's size: every rank of the job must
    take part in the collectives.
    """
    if multihost.active():
        if n != multihost.world_size():
            raise ValueError(
                f"--devices {n} != {multihost.world_size()} global ranks; in multihost mode the world "
                "must span every rank (omit --devices or pass the global count)"
            )
        return [rank_device(device)]
    dev = torch.device(device)
    if dev.type == "cpu":
        return [dev] * n
    if dev.index is not None:
        raise ValueError(f"--devices {n} takes cards 0..{n - 1}: pass --device cuda, not {device}")
    visible = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if visible < n:
        raise ValueError(f"--devices {n} but only {visible} visible")
    return [torch.device("cuda", i) for i in range(n)]


def driver_world(parser, n_devices: int | None, batch: int, log, what: str, device="cuda") -> World:
    """The ``--devices`` plumbing of the driver CLIs: the divisibility
    check (a parser error), the device checks of :func:`make_world`, one
    log line.

    Inside a running group (a rank, or the multihost launcher) it returns
    this rank's :class:`World`.  Otherwise ``--devices N`` returns a world
    to launch (``launch``) and no ``--devices`` the one-device world.
    """
    running = multihost.active()
    if not running and int(os.environ.get("WORLD_SIZE", "1")) > 1:
        # torchrun started this process as one of several: without a group
        # each would run alone and write the shared files.
        raise RuntimeError(f"WORLD_SIZE={os.environ['WORLD_SIZE']} but no process group: launch the driver "
                           "through python -m takzero_torch.drivers.multihost")
    if not running and n_devices is None:
        return World(device=resolve_device(device))
    n = multihost.world_size() if running and n_devices is None else n_devices
    if batch % n:
        parser.error(f"{what} {batch} not divisible by --devices {n}")
    devices = make_world(n, device)
    if running:
        world = multihost.global_world(device)
        log.info("%s %d sharded over %d ranks: rank %d/%d on %s", what, batch, n, world.rank, n, world.device)
        return world
    log.info("%s %d sharded over %d ranks: %s", what, batch, n, ", ".join(map(str, devices)))
    return World(size=n, device=devices[0], launch=True)


def launch(main, argv, world: World, device) -> list:
    """Start ``world.size`` ranks, each running the driver ``main(argv)``
    with its own process group (NCCL on cards, gloo on the CPU; on the CPU
    each rank gets at most two threads); returns their results."""
    import sys

    argv = sys.argv[1:] if argv is None else list(argv)
    threads = None
    if torch.device(device).type == "cpu":
        threads = max(1, min(2, torch.get_num_threads() // world.size))
    return multihost.run_ranks(main, argv, world.size, backend_for(device), threads=threads)
