"""Tensor ops of the port: plain PyTorch glue plus the CUDA kernel wrappers
(``*_cuda.py``). Modules are imported by name; this package imports nothing
at load time so that importing one op never builds or loads a kernel."""
