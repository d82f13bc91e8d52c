"""Multi-process set-up: one process (rank) per device.

The counterpart of ``c2dsr_tpu/parallel/distributed.py:27-58``.  A JAX
process is a host that drives all its devices; here a process drives one
device, so the world is the mesh's ``mesh_data * mesh_model`` ranks, and
a rank uses the card of its index among its host's ranks (on one host,
rank r uses ``cuda:(r % torch.cuda.device_count())``).  The JAX flags keep
their names: ``--coordinator_address host:port`` is the rendezvous
``tcp://host:port``, ``--num_processes`` the world size and
``--process_id`` the rank.

    from c2dsr_tpu_torch.parallel import distributed
    distributed.initialize("10.0.0.1:8476", num_processes=4, process_id=r)
    device = distributed.device_of_rank("cuda")

The backend is NCCL where every host has a card for each of its ranks, and
gloo otherwise (one backend for the whole group).  NCCL refuses two ranks
on one device, so ranks that share a card (or run on the CPU) talk over
gloo, which takes CUDA tensors (``parallel/comm.py``); the kernels still
run on the card in every rank.  The ranks learn which of them share a host,
and its cards, by publishing their host name and card count in the
rendezvous store before the group is made, so the choice holds for every
way of starting them (a tcp:// address, or ``env://`` as a launcher such as
torchrun sets it, on one host or several), and a rank's card is its index
among its host's ranks (``device_of_rank``).
"""

from __future__ import annotations

import datetime
import socket
from typing import Optional, Tuple

import torch
import torch.distributed as dist

DEFAULT_TIMEOUT = datetime.timedelta(seconds=600)

# (this rank's index among the ranks on its host, their number), set by
# initialize
_local = (0, 1)


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None, *,
               device="cuda", backend: Optional[str] = None,
               timeout: datetime.timedelta = DEFAULT_TIMEOUT) -> None:
    """``init_process_group`` for this rank.  With no address, the
    environment's rendezvous (``env://``).  ``device`` is where the ranks
    compute: "cuda" takes NCCL when every host has a card for each of its
    ranks, else gloo.  ``timeout`` bounds the rendezvous and every
    collective, so that a rank that dies cannot hang the others forever."""
    global _local
    init_method = ("env://" if coordinator_address is None
                   else f"tcp://{coordinator_address}")
    store, rank, world = next(dist.rendezvous(
        init_method, -1 if process_id is None else int(process_id),
        -1 if num_processes is None else int(num_processes),
        timeout=timeout))
    store.set_timeout(timeout)
    device = torch.device(device)
    cards = torch.cuda.device_count() if device.type == "cuda" else 0
    index, count, fits = host_layout(dist.PrefixStore("hosts", store), rank,
                                     world, socket.gethostname(), cards)
    _local = (index, count)
    if backend is None:
        backend = "nccl" if fits else "gloo"
    dist.init_process_group(backend, store=store, rank=rank,
                            world_size=world, timeout=timeout)


def host_layout(store, rank: int, world: int, host: str,
                cards: int) -> Tuple[int, int, bool]:
    """(this rank's index among the ranks of ``host``, their number, whether
    every host has a card for each of its ranks), from the host name and
    card count that every rank publishes in ``store``."""
    store.set(f"host/{rank}", f"{cards} {host}")
    ranks_of, cards_of = {}, {}
    for r in range(world):
        n, h = store.get(f"host/{r}").decode().split(" ", 1)
        ranks_of.setdefault(h, []).append(r)
        cards_of[h] = int(n)
    fits = all(len(rs) <= cards_of[h] for h, rs in ranks_of.items())
    return ranks_of[host].index(rank), len(ranks_of[host]), fits


def device_of_rank(device="cuda") -> torch.device:
    """This rank's device: ``cuda:(local index % device_count)``, the local
    index being the rank's among its host's ranks, or the CPU."""
    device = torch.device(device)
    if device.type != "cuda":
        return device
    if not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass device='cpu' to run "
                           "the plain PyTorch versions on the CPU")
    return torch.device("cuda", _local[0] % torch.cuda.device_count())


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def shutdown() -> None:
    global _local
    if dist.is_initialized():
        dist.destroy_process_group()
    _local = (0, 1)
