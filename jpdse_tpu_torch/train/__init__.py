"""Training of the port: losses, the GAN state and step, the lr schedule,
checkpoints (``checkpoint``) and the entry point (``run``, ``python -m
jpdse_tpu_torch.train``)."""
