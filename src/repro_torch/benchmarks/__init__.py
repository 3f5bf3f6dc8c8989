"""The paper's benchmarks on the port, one module per table or figure: the
twins of the JAX package's ``benchmarks/`` folder, run as
``python -m repro_torch.benchmarks.run`` (see `repro_torch.benchmarks.run`).

Each module's ``run()`` prints ``name,us_per_call,derived`` CSV rows under
the JAX module's row names and returns them. Every module that touches a
device runs on the card unless ``device="cpu"`` is given, and raises where
CUDA is asked for and absent.
"""
