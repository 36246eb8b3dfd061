"""The entry-point scripts (data conversion, the live demo, recording,
sampling, playback, asset inspection, skinning), each run as
`python -m pulse_tpu_torch.scripts.<name>`; see the module docstrings."""
