"""The README's entry points on the port, the twins of the JAX package's
``examples/``: ``python -m repro_torch.examples.<name> [--device cpu]``.
Each runs on the card unless ``--device cpu`` is given, at its JAX
counterpart's sizes, prints the same facts and returns them from
``main(argv)``; a fact that does not hold raises."""
