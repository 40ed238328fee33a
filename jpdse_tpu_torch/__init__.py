"""PyTorch / CUDA port of jpdse_tpu for NVIDIA Hopper GPUs.

The JAX package ``jpdse_tpu`` is the reference; this package mirrors its
module layout and names (``config``, ``ops/``, ``models/``) so each port
module sits beside its counterpart. It imports ``torch`` and ``numpy`` only:
no JAX and nothing of ``jpdse_tpu``.

Public tensors are NHWC, as in the JAX package. Entry points run on the
card (``device="cuda"``) unless the caller asks for the CPU. Every TPU
kernel on a ported path is a hand-written CUDA kernel under ``csrc/``, built
with ``nvcc`` at first use (``ops/build.py``); on CPU tensors the wrappers
take the kernel's plain PyTorch version.

Ported so far: the flagship learned codec's serving path — s2d fast-path
encode to binary codes and decode from those codes (``serve.CodecServer``).
"""
