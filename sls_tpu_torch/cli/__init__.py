"""Command-line entry points of the port (``python -m sls_tpu_torch.cli.<name>``)."""
