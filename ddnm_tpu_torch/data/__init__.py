"""Data layer of the port: PNG IO, resampling and crops, value transforms,
metrics, datasets, measurement noise."""

from ddnm_tpu_torch.data.datasets import (
    FolderDataset,
    ImageNetManifestDataset,
    get_dataset,
    iterate_batches,
)
from ddnm_tpu_torch.data.io import load_image, load_mask, save_image
from ddnm_tpu_torch.data.metrics import psnr, ssim
from ddnm_tpu_torch.data.noise import NOISE_TYPES, add_noise
from ddnm_tpu_torch.data.transforms import data_transform, inverse_data_transform

__all__ = [
    "FolderDataset", "ImageNetManifestDataset", "get_dataset", "iterate_batches",
    "load_image", "load_mask", "save_image", "psnr", "ssim", "NOISE_TYPES", "add_noise",
    "data_transform", "inverse_data_transform",
]
