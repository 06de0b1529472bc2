"""Build and load the port's CUDA kernels (see ``build``)."""
