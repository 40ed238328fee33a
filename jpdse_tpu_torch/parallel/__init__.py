"""Multi-process data-parallel runs on ``torch.distributed``, the port of
``jpdse_tpu/parallel/`` (``distributed.py``: the process group and the
collectives; ``mesh.py``: the data axis over it)."""
