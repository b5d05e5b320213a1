from repro_torch.models.model import Model, build, to_device  # noqa: F401
