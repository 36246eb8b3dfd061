"""See the module docstrings; each mirrors its pulse_tpu counterpart."""
