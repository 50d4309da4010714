"""Command-line entry points of the port (``python -m
temporalstereo_tpu_torch.cli.<name>``)."""
