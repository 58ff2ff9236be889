"""Hand-written Hopper kernels of the port, each beside its plain PyTorch
version.  A wrapper takes the plain version only for tensors on the CPU;
for a CUDA tensor it launches its kernel (built from ``csrc/`` by
``build.py``) or raises, and counts the launch in its ``launches``
attribute."""
