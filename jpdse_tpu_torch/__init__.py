"""PyTorch / CUDA port of jpdse_tpu for NVIDIA Hopper GPUs.

The JAX package ``jpdse_tpu`` is the reference; this package mirrors its
module layout and names (``config``, ``ops/``, ``models/``, ``data/``) so
each port module sits beside its counterpart. It imports ``torch``,
``numpy``, PIL and the standard library: no JAX and nothing of
``jpdse_tpu``.

Public tensors are NHWC, as in the JAX package. Entry points run on the
card (``device="cuda"``) unless the caller asks for the CPU. Every TPU
kernel on a ported path is a hand-written CUDA kernel under ``csrc/``, built
with ``nvcc`` at first use (``ops/build.py``); on CPU tensors the wrappers
take the kernel's plain PyTorch version.

Ported so far: the flagship learned codec's serving path — encode to
binary codes and decode from those codes (``serve.CodecServer``) — through
the s2d fast path or the standard modules, in the default configuration
and in the JAX package's kernel configuration, with all four TPU kernels
(K1-K4) in CUDA; and the eval and deploy entry points over it
(``python -m jpdse_tpu_torch.test`` / ``.compress`` / ``.decompress``)
with the config, flags, data pipeline, metrics and eval harness; training
(``python -m jpdse_tpu_torch.train``), on one device or data-parallel over
a process group (``parallel/``); and the import of the reference's
``net_*.pth`` checkpoints (``convert/``).
"""
