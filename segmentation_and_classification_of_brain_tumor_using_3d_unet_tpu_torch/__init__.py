"""PyTorch/CUDA port of the brain-tumor segmentation framework.

The JAX package ``segmentation_and_classification_of_brain_tumor_using_3d_unet_tpu``
beside this one is the reference: every function here is held against
its counterpart there (``tests/test_torch_*.py``). The port imports no
JAX and no module of that package. Entry points run on the CUDA device
unless the caller passes ``device="cpu"``; on the CPU each hand-written
kernel (``csrc/``) is replaced by its plain PyTorch version.
"""
