"""Entry points of the port (the port of ``repro.launch``): the training
CLI ``python -m repro_torch.launch.train``."""
