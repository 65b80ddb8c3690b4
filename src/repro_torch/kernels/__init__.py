"""Hand-written Hopper kernels (``csrc/``), their wrappers and plain versions.

Importing this package builds nothing; ``build.build()`` compiles the
sources with nvcc and each wrapper loads its library at first CUDA call.
"""
