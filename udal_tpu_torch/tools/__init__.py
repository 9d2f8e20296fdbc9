"""Microbench entry points of the port (run as ``python -m udal_tpu_torch.tools.<name>``)."""
