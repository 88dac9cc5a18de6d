"""
PyTorch/CUDA port of the on-device augment→fbank path of :mod:`lhotse_tpu`.

The module paths and public names mirror the JAX package, so
``lhotse_tpu/ops/augment.py`` has its counterpart in
``lhotse_tpu_torch/ops/augment.py``. The port imports ``torch`` and numpy
only: never ``jax`` and never ``lhotse_tpu``. The few numpy builders it
shares with the JAX package are copied, and the tests hold each copy equal
to its original.

The one hand-written kernel is the fused log-mel fbank
(:mod:`lhotse_tpu_torch.ops.fbank_cuda`, CUDA C++ in ``csrc/fbank.cu``),
built with ``nvcc`` at first use. A CPU tensor takes the kernel's plain
PyTorch version; a CUDA tensor launches the kernel or raises.
"""
