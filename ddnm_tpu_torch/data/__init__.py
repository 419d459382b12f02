"""Data layer of the port: PNG IO, value transforms, metrics, folders."""

from ddnm_tpu_torch.data.datasets import FolderDataset, get_dataset, iterate_batches
from ddnm_tpu_torch.data.io import load_image, load_mask, save_image
from ddnm_tpu_torch.data.metrics import psnr, ssim
from ddnm_tpu_torch.data.transforms import data_transform, inverse_data_transform

__all__ = [
    "FolderDataset", "get_dataset", "iterate_batches", "load_image", "load_mask",
    "save_image", "psnr", "ssim", "data_transform", "inverse_data_transform",
]
