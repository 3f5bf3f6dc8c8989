"""Entry points of the port (the port of ``repro.launch``): the training
CLI ``python -m repro_torch.launch.train``, the serving CLI ``python -m
repro_torch.launch.serve``, and the roofline at the H100's peaks
(`repro_torch.launch.roofline`)."""
