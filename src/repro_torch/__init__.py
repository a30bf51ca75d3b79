"""repro_torch — the PyTorch/CUDA port of the HAF AI-RAN scheduler.

The package mirrors :mod:`repro` module for module.  It imports ``torch``
and ``numpy`` only; kernels written in Pallas for the reference are CUDA
C++ kernels here (:mod:`repro_torch.kernels`), built at first use.
"""
