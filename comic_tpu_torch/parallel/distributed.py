"""Multi-process bootstrap: torch.distributed wiring; counterpart of
comic_tpu/parallel/distributed.py.

Every process of a data-parallel job runs the same command and drives one
device: rank r takes card r of its host (its local rank), or the CPU when
the caller asks for it. The job is configured by the environment, as in
comic_tpu:

  COMIC_COORDINATOR   the rendezvous address host:port (its presence turns
                      the job on); ``auto`` takes torchrun's env://
                      variables (MASTER_ADDR, MASTER_PORT, WORLD_SIZE,
                      RANK, LOCAL_RANK) instead
  COMIC_NUM_PROCESSES the number of processes (the world size)
  COMIC_PROCESS_ID    this process's rank

The backend follows the device: NCCL between cards, gloo only where the
caller asks for the CPU, so no card tensor ever goes through gloo. A
failing NCCL init raises; it never falls back.
"""

from __future__ import annotations

import datetime
import os
from typing import Optional

import torch
import torch.distributed as dist

from .. import DeviceLike, resolve_device

# the rendezvous and every collective give up after this long, so a rank
# that died leaves the others with an error instead of a hang
TIMEOUT = datetime.timedelta(minutes=10)


def _env_int(name: str) -> Optional[int]:
    value = os.environ.get(name)
    return int(value) if value else None


def maybe_initialize_distributed(coordinator: Optional[str] = None,
                                 num_processes: Optional[int] = None,
                                 process_id: Optional[int] = None,
                                 device: DeviceLike = None) -> bool:
    """Join the job when one is configured; returns True if this process
    is in a job (it joined now or earlier).

    A no-op that returns False when no coordinator is configured, so a
    single-process run never touches torch.distributed. ``device`` (None:
    the card) picks the backend: NCCL on the card this rank drives, gloo
    on the CPU."""
    coordinator = coordinator or os.environ.get("COMIC_COORDINATOR")
    if not coordinator:
        return False
    if dist.is_initialized():
        return True
    device = resolve_device(device)
    if coordinator == "auto":
        init_method = "env://"
        num_processes = int(os.environ["WORLD_SIZE"])
        process_id = int(os.environ["RANK"])
    else:
        init_method = f"tcp://{coordinator}"
        if num_processes is None:
            num_processes = _env_int("COMIC_NUM_PROCESSES")
        if process_id is None:
            process_id = _env_int("COMIC_PROCESS_ID")
        if num_processes is None or process_id is None:
            raise ValueError(
                "COMIC_COORDINATOR is set: COMIC_NUM_PROCESSES and "
                "COMIC_PROCESS_ID must be set too (or pass num_processes "
                "and process_id).")
    kwargs = {}
    if device.type == "cuda":
        local = _env_int("LOCAL_RANK")
        if local is None:
            local = process_id % torch.cuda.device_count()
        device = torch.device("cuda", local)
        torch.cuda.set_device(device)
        # binds the communicator to the rank's card and creates it now,
        # so a failing NCCL init raises here
        kwargs["device_id"] = device
    dist.init_process_group(
        "nccl" if device.type == "cuda" else "gloo",
        init_method=init_method, world_size=num_processes, rank=process_id,
        timeout=TIMEOUT, **kwargs)
    return True
