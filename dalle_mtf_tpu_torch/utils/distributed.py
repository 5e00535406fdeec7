"""Multi-process setup (port of ``dalle_mtf_tpu/utils/distributed.py``).

A run with more than one process is started by ``torch.distributed.run``
(``python -m torch.distributed.run --standalone --nproc_per_node N -m
dalle_mtf_tpu_torch.train_dalle ...``), which sets ``RANK``, ``WORLD_SIZE``,
``LOCAL_RANK``, ``LOCAL_WORLD_SIZE``, ``MASTER_ADDR`` and ``MASTER_PORT``.
``init_distributed`` reads them, picks the rank's device and joins the
process group. The backend follows from the layout, not from a try:

- ``nccl`` when every local rank has a card of its own;
- ``gloo`` when ranks share a card (NCCL refuses two ranks on one device),
  or on the CPU. gloo reduces and broadcasts CUDA tensors, and
  ``ops/ring_attention.py`` stages its sends through host memory.

Nothing falls back to the CPU: a CUDA device that does not exist raises.
"""

from __future__ import annotations

import logging
import os
from typing import NamedTuple

import torch
import torch.distributed as dist

logger = logging.getLogger(__name__)


class Process(NamedTuple):
    device: torch.device
    rank: int
    world: int
    backend: str | None  # None for a single process


def model_device(device: torch.device | str) -> torch.device:
    """``device`` as a torch.device; a CUDA device where there is none raises,
    so a model built on the default device never carries on on the CPU."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"no CUDA device for {device}: pass device='cpu' to run on the CPU")
    return device


def rank_device(gpu_ids, device: str, local_rank: int = 0,
                local_world: int = 1) -> torch.device:
    """The device of local rank ``local_rank`` of ``local_world``: with
    ``device`` "cpu", the CPU; else card ``cards[local_rank * len(cards) //
    local_world]`` of ``--gpu_ids`` (all visible cards when not given), so
    ranks share cards evenly when there are fewer cards than ranks. Raises
    without a CUDA device."""
    if not gpu_ids and not device.startswith("cuda"):
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            f"no CUDA device for {gpu_ids or device}: pass --device cpu to train on the CPU")
    cards = _cards(gpu_ids, device)
    return torch.device(f"cuda:{cards[local_rank * len(cards) // local_world]}")


def _cards(gpu_ids, device: str) -> list:
    """The cards the ranks share: ``--gpu_ids``, else the one ``device``
    names, else every visible card."""
    if gpu_ids:
        return [int(i) for i in gpu_ids]
    if device != "cuda":
        return [torch.device(device).index]
    return list(range(torch.cuda.device_count()))


def backend_for(device: torch.device, local_world: int, n_cards: int) -> str:
    """``nccl`` when each of the ``local_world`` ranks has one of the
    ``n_cards`` cards to itself, else ``gloo``."""
    return "nccl" if device.type == "cuda" and local_world <= n_cards else "gloo"


def init_distributed(gpu_ids=None, device: str = "cuda") -> Process:
    """Join the process group ``torch.distributed.run`` describes (a single
    process when ``WORLD_SIZE`` is unset or 1) and return this process's
    device, rank, world size and backend. A group that is already up is
    reused."""
    world = int(os.environ.get("WORLD_SIZE", "1"))
    if world == 1:
        return Process(rank_device(gpu_ids, device), 0, 1, None)
    rank = int(os.environ["RANK"])
    local_rank = int(os.environ.get("LOCAL_RANK", rank))
    local_world = int(os.environ.get("LOCAL_WORLD_SIZE", world))
    dev = rank_device(gpu_ids, device, local_rank, local_world)
    backend = backend_for(dev, local_world, len(_cards(gpu_ids, device)))
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    if not dist.is_initialized():
        dist.init_process_group(backend, rank=rank, world_size=world)
    elif dist.get_backend() != backend:
        raise RuntimeError(f"the process group runs {dist.get_backend()}, not {backend}")
    logger.info("rank %d/%d on %s over %s", rank, world, dev, backend)
    return Process(dev, rank, world, backend)
