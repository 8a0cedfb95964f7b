"""Data: the NIfTI codec, the upload decoder, the deterministic
preprocessing chain on the device and the synthetic generators."""
