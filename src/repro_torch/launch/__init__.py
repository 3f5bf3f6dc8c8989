"""Entry points of the port (the port of ``repro.launch``): the training
CLI ``python -m repro_torch.launch.train``, the serving CLI ``python -m
repro_torch.launch.serve``, the dry run ``python -m
repro_torch.launch.dryrun`` (`launch.mesh`'s production meshes in a fake
world, `launch.step_analysis` in place of the reference's HLO walk), and
the roofline at the H100's peaks (`repro_torch.launch.roofline`)."""
