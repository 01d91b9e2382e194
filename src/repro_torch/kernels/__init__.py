"""The port's hand-written CUDA kernels, their plain PyTorch versions and
the routing between them (``dispatch``)."""
