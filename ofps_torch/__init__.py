"""PyTorch/CUDA port of ``ofps_tpu``.

The package mirrors ``ofps_tpu``'s layout module for module.  Plain tensor
code is PyTorch; the flow-refine and warp kernels that ``ofps_tpu`` wrote in
Pallas are hand-written CUDA C++ for Hopper (``csrc/``), bound with ctypes
(``kernels/``).  A wrapper launches its kernel for CUDA tensors and runs its
plain PyTorch version for CPU tensors; nothing falls back silently.  The
entry points (``parallel.stream.StreamPipeline``, ``decoders.cv``) run on
the CUDA card unless the caller names another device.
"""

from ofps_torch.device import resolve_device

__all__ = ["resolve_device"]
