"""Data-conversion entry points, each run as `python -m
pulse_tpu_torch.scripts.<name>`; see the module docstrings."""
