"""PyTorch/CUDA port of the Checkmate reproduction (``repro`` is the JAX
reference). Module names follow the JAX package so each counterpart is easy
to find. The port imports neither JAX nor anything of ``repro``.
"""
