"""Hand-written Hopper kernels of the port, one package per TPU kernel.

Each ``<name>/`` package holds ``kernel.py`` (the wrapper: checks its
inputs, launches the CUDA kernel from ``csrc/`` on a CUDA tensor, runs the
plain version on a CPU tensor, counts its launches), ``ref.py`` (the plain
PyTorch version) and ``ops.py`` (the tensor code around the kernel).
``_build.py`` compiles ``csrc/*.cu`` with ``nvcc`` at first use.
"""
