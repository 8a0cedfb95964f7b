"""Data: the NIfTI codec, the datasets, the preprocessing chain and its
augmentation on the device, the loader and the synthetic generators."""

from . import data_utils, nifti
from .dataset import BraTS2024Dataset, BrainTumorDataset, load_any_volume
from .pipeline import (DeviceDataLoader, create_brats_data_loaders,
                       get_data_loader)
from .preprocess import (augment_pair, create_data_transforms,
                         preprocess_batch, preprocess_image,
                         preprocess_multimodal, preprocess_segmentation)
from .synthetic import (create_enhanced_synthetic_data,
                        create_synthetic_data, synthesize_volume)

__all__ = [
    "nifti", "BraTS2024Dataset", "BrainTumorDataset", "load_any_volume",
    "DeviceDataLoader", "create_brats_data_loaders", "get_data_loader",
    "augment_pair", "preprocess_batch", "preprocess_image",
    "preprocess_multimodal", "preprocess_segmentation",
    "create_enhanced_synthetic_data", "create_synthetic_data",
    "synthesize_volume",
]
