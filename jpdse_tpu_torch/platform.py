"""Device selection and the process group for the port's entry points."""

from __future__ import annotations

import torch

from jpdse_tpu_torch.parallel import distributed


def init_distributed(device="cuda") -> bool:
    """Join the process group that the environment describes (JAX's
    ``JPDSE_COORDINATOR`` / ``JPDSE_NUM_PROCESSES`` / ``JPDSE_PROCESS_ID``
    or ``torchrun``'s; ``parallel/distributed.py``), NCCL on the card and
    gloo on the CPU. Returns True for a run of several processes, False
    where the environment asks for none; a failed rendezvous raises."""
    return distributed.initialize(device=torch.device(device).type)


def resolve_device(device="cuda") -> torch.device:
    """The torch.device an entry point runs on. The default is the card,
    ``cuda:LOCAL_RANK`` under a process group; asking for CUDA where there
    is none raises instead of carrying on quietly on the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "jpdse_tpu_torch: CUDA is not available; pass device='cpu' to "
            "run on the CPU"
        )
    if dev.type == "cuda" and dev.index is None and distributed.active():
        dev = torch.device("cuda", distributed.local_rank())
    return dev
