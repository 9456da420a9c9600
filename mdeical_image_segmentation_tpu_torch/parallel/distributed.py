"""The process group of a data-parallel run (the JAX package's
``parallel/distributed.py``).

The JAX package brings each host into one global runtime with
``jax.distributed.initialize`` and trains one program over every device.
The port runs one process per device, joined by a ``torch.distributed``
process group: NCCL between cards, gloo on the CPU.  Launch one process
per card, each with its own ``PROCESS_ID``::

    COORDINATOR_ADDRESS=host0:1234 NUM_PROCESSES=2 PROCESS_ID=0 python ...

and call ``initialize()`` in each before building the trainer.  With no
coordinator given or in the environment, ``torchrun``'s variables
(``MASTER_ADDR``, ``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``) are read.
"""

from __future__ import annotations

import os
from typing import Optional

import torch
import torch.distributed as dist

from ..logging_utils import get_logger

logger = get_logger("distributed")


def _init_method(coordinator_address: Optional[str]) -> str:
    if coordinator_address is None:
        return "env://"
    if "://" in coordinator_address:
        return coordinator_address
    return f"tcp://{coordinator_address}"


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None, *,
               device: str = "cuda", backend: Optional[str] = None) -> None:
    """Join this process to the process group; a second call does nothing.

    ``coordinator_address`` (``host:port`` or a ``tcp://`` URL),
    ``num_processes`` and ``process_id`` fall back to the environment's
    ``COORDINATOR_ADDRESS``, ``NUM_PROCESSES`` and ``PROCESS_ID``.  On the
    card (``device="cuda"``, the default) the backend is NCCL and this
    process drives the card ``LOCAL_RANK`` names, or ``process_id`` modulo
    the cards of the host; ``device="cpu"`` takes gloo.  ``backend="gloo"``
    on the card carries the collectives of CUDA tensors through the host,
    for processes that share one card (NCCL refuses two ranks on one
    device).  Nothing falls back: without a card, or without NCCL where it
    is asked for, this raises."""
    if dist.is_initialized():
        logger.info("torch.distributed already initialized; skipping")
        return
    device = torch.device(device).type
    if device not in ("cuda", "cpu"):
        raise ValueError(f"device {device!r}: 'cuda' or 'cpu'")
    backend = backend or ("nccl" if device == "cuda" else "gloo")
    if backend not in ("nccl", "gloo"):
        raise ValueError(f"backend {backend!r}: 'nccl' or 'gloo'")
    if device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("initialize(device='cuda') needs a CUDA card and "
                           "none is available; pass device='cpu' for gloo "
                           "on the CPU")
    if backend == "nccl" and (device != "cuda" or not dist.is_nccl_available()):
        raise RuntimeError("NCCL needs a CUDA card and a torch built with "
                           "NCCL")
    coordinator_address = (coordinator_address
                           or os.environ.get("COORDINATOR_ADDRESS"))
    if num_processes is None and "NUM_PROCESSES" in os.environ:
        num_processes = int(os.environ["NUM_PROCESSES"])
    if process_id is None and "PROCESS_ID" in os.environ:
        process_id = int(os.environ["PROCESS_ID"])
    kwargs = {}
    if num_processes is not None:
        kwargs["world_size"] = num_processes
    if process_id is not None:
        kwargs["rank"] = process_id
    dist.init_process_group(backend=backend,
                            init_method=_init_method(coordinator_address),
                            **kwargs)
    if device == "cuda":
        local = os.environ.get("LOCAL_RANK")
        torch.cuda.set_device(int(local) if local is not None else
                              dist.get_rank() % torch.cuda.device_count())
    logger.info(f"process group up ({backend}): process {dist.get_rank()}/"
                f"{dist.get_world_size()} on {device}")


def is_primary() -> bool:
    """True on the process that writes checkpoints and logs: rank 0, or the
    only process when there is no process group."""
    return not dist.is_initialized() or dist.get_rank() == 0


def process_info() -> dict:
    """This process's place in the group, with the JAX package's keys; the
    port runs one device per process."""
    index = dist.get_rank() if dist.is_initialized() else 0
    count = dist.get_world_size() if dist.is_initialized() else 1
    return {"process_index": index, "process_count": count,
            "local_devices": 1, "global_devices": count}
