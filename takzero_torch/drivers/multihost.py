"""Multihost launcher: a ``torch.distributed`` process group in front of a driver.

Counterpart of ``takzero_tpu/drivers/multihost.py``.  The reference scales
by launching many one-GPU processes (README.md:128-135); here one driver
runs as a group of ranks, one per device (SURVEY.md §2.5/§5.8): every rank
runs the same loop on its rows of the batch, rank 0 owns the file writes
and broadcasts its reads, and the gathers and gradient sums keep the
ranks in lockstep (``parallel/multihost.py``).

Usage (per host)::

    python -m takzero_torch.drivers.multihost \\
        [--coordinator HOST:PORT --num-processes P --process-id I] \\
        [--local-ranks D] [--backend nccl|gloo] \\
        learn -- --directory /shared/run --net net6_simhash ...

Process I of P starts D ranks (``I * D`` to ``I * D + D - 1`` of ``P * D``),
each with ``LOCAL_RANK`` set; with D = 1 the process is the rank.  Without
the three topology flags the group reads torchrun's environment
(``MASTER_ADDR``, ``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``, ``LOCAL_RANK``).
Each rank takes ``cuda:LOCAL_RANK`` unless the driver's ``--device`` names
a device (``cuda:0`` for ranks that share a card, or ``cpu``).

The backend is NCCL when the driver's ``--device`` is a card and gloo on
the CPU, unless ``--backend`` says otherwise.  NCCL cannot put two ranks on
one card: ranks that share one take ``--backend gloo``.
"""

from __future__ import annotations

import argparse
import functools
import importlib
import os

DRIVERS = ("learn", "selfplay", "reanalyze")


def driver_device(rest: list[str]) -> str:
    """The driver's ``--device`` (its last occurrence; default ``cuda``)."""
    device = "cuda"
    for i, a in enumerate(rest):
        if a == "--device" and i + 1 < len(rest):
            device = rest[i + 1]
        elif a.startswith("--device="):
            device = a.split("=", 1)[1]
    return device


def main(argv=None, rank_hook=None) -> list:
    """Run the driver as this process's ranks; returns their results.

    ``rank_hook(driver_main, argv)``, when given, runs in each rank in place
    of ``driver_main(argv)`` (a tool that reads each rank's state after the
    driver, such as its kernel launch counters); spawned ranks need it
    picklable.
    """
    parser = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--coordinator", default=None,
                        help="rendezvous HOST:PORT (or a file:// URL); omit all three topology flags under torchrun")
    parser.add_argument("--num-processes", type=int, default=None)
    parser.add_argument("--process-id", type=int, default=None)
    parser.add_argument("--local-ranks", type=int, default=1, help="ranks this process starts (default 1)")
    parser.add_argument("--backend", choices=("nccl", "gloo"), default=None,
                        help="default: nccl when the driver's --device is a card, gloo on the CPU")
    parser.add_argument("driver", choices=DRIVERS)
    parser.add_argument("rest", nargs=argparse.REMAINDER, help="driver arguments (prefix with --)")
    args = parser.parse_args(argv)

    from ..parallel import multihost
    from ..parallel.mesh import backend_for

    rest = args.rest[1:] if args.rest[:1] == ["--"] else args.rest
    backend = args.backend or backend_for(driver_device(rest))
    mod = importlib.import_module(f".{args.driver}", __package__)
    target = mod.main if rank_hook is None else functools.partial(rank_hook, mod.main)
    topology = (args.coordinator, args.num_processes, args.process_id)
    if topology == (None, None, None):
        if args.local_ranks != 1:
            parser.error("--local-ranks needs --coordinator, --num-processes and --process-id")
        multihost.initialize(backend=backend)
        try:
            return [target(rest)]
        finally:
            multihost.dist.destroy_process_group()
    if None in topology:
        parser.error("pass --coordinator, --num-processes and --process-id together (or none of them)")
    d = args.local_ranks
    if d == 1 and "LOCAL_RANK" not in os.environ:
        # One rank per process: the process's place among its host's cards.
        import torch

        os.environ["LOCAL_RANK"] = str(args.process_id % max(1, torch.cuda.device_count()))
    return multihost.run_ranks(target, rest, d, backend, init_method=args.coordinator,
                               world_size=args.num_processes * d, offset=args.process_id * d)


if __name__ == "__main__":
    main()
