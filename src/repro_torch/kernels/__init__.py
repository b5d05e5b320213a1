"""Hand-written Hopper kernels of the serving path, each beside its plain
PyTorch version and a launch counter (counterpart of ``repro.kernels``)."""
