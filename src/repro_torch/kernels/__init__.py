"""Kernels of the port: hand-written CUDA (sources in ``../csrc``) behind
``ops``, each with its plain torch version in ``ref``."""
