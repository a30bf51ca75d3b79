"""Hand-written Hopper kernels of the port, their wrappers and plain versions.

  csrc/*.cu   the kernels (CUDA C++ for sm_90a, plain C interface)
  _build      compiles the sources with nvcc at first use, binds with ctypes
  ops         wrappers: dtype / contiguity / device checks, launch, counts
  ref         plain torch versions (what the CPU tests and the eager
              ``"torch"`` engine run; what the kernels are held against)

Importing this package builds nothing and needs no compiler; a kernel is
compiled the first time a wrapper is handed a CUDA tensor.
"""
