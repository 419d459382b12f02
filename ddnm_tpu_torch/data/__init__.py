"""Data layer of the port: image IO (PNG, JPEG, WebP, BMP, PNM decoded in
numpy, in PIL's modes; PNG writes), resampling and crops,
value transforms, metrics, datasets (folders, ImageNet, CelebA, LSUN),
the checkpoint registry, measurement noise."""

from ddnm_tpu_torch.data.checkpoints import CHECKPOINTS, fetch, md5sum
from ddnm_tpu_torch.data.datasets import (
    FolderDataset,
    ImageNetManifestDataset,
    get_dataset,
    iterate_batches,
)
from ddnm_tpu_torch.data.extra_datasets import (
    LSUN_CATEGORIES,
    CelebADataset,
    LSUNDataset,
    LSUNMulti,
    celeba_crop,
)
from ddnm_tpu_torch.data.io import (
    convert,
    decode_image,
    decode_rgb8,
    load_image,
    load_mask,
    read_rgb8,
    save_image,
)
from ddnm_tpu_torch.data.jpeg import decode_jpeg
from ddnm_tpu_torch.data.webp import decode_webp
from ddnm_tpu_torch.data.metrics import psnr, ssim
from ddnm_tpu_torch.data.noise import NOISE_TYPES, add_noise
from ddnm_tpu_torch.data.transforms import data_transform, inverse_data_transform

__all__ = [
    "CHECKPOINTS", "fetch", "md5sum",
    "FolderDataset", "ImageNetManifestDataset", "get_dataset", "iterate_batches",
    "LSUN_CATEGORIES", "CelebADataset", "LSUNDataset", "LSUNMulti", "celeba_crop",
    "convert", "decode_image", "decode_rgb8", "decode_jpeg", "decode_webp", "load_image", "load_mask", "read_rgb8", "save_image",
    "psnr", "ssim", "NOISE_TYPES", "add_noise", "data_transform", "inverse_data_transform",
]
