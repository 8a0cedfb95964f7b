"""Data: the NIfTI codec, the datasets, the preprocessing chain and its
augmentation on the device, the loader and the synthetic generators."""
