"""uit_mobile_tpu_torch — the PyTorch/CUDA port of uit_mobile_tpu for NVIDIA Hopper.

A second package beside the JAX reference ``uit_mobile_tpu``; it imports
``torch`` and nothing of JAX or of the JAX package. Entry points run on the
card (``device="cuda"``) unless the caller asks for ``"cpu"``.

Layout:
  frontend/   plain PyTorch log-mel reference (rfft)
  ops/        the fused log-mel CUDA kernel's wrapper, build and forward policy
  csrc/       CUDA C++ sources (sm_90a), built with nvcc at first use
  models/     UiT family (eval), parameter names mirror the JAX pytree
  ckpt/       npz checkpoints (same format as the JAX package), weight carry
  data/       wav I/O and the bundled label index
  serve/      the batching TaggingService
  cli/        the CLIs (infer, train, evaluate, serve, stream, prep, ...)
  tools/      the synthetic accuracy gate
"""

__version__ = "0.1.0"
