"""repro_torch.core — quantizers, transforms, CAT, calibration, RTN and
the PTQ pipeline, in PyTorch (counterpart of ``repro.core``)."""
