"""Hand-written CUDA kernels of the port and their plain PyTorch versions.

Importing this package builds nothing: each kernel is compiled by ``nvcc``
at its first launch (:mod:`repro_torch.kernels._build`).
"""
