"""The port's own readers against the libraries they replace (the port's
machine has neither PIL nor yaml; this host has both), and the port's data
layer against the JAX package's."""

import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml
from PIL import Image

from ddnm_tpu.data import metrics as jmetrics
from ddnm_tpu.data import transforms as jtransforms
from ddnm_tpu.data.datasets import FolderDataset as JFolderDataset
from ddnm_tpu_torch.config import parse_yaml
from ddnm_tpu_torch.data import io as tio
from ddnm_tpu_torch.data import metrics as tmetrics
from ddnm_tpu_torch.data import transforms as ttransforms
from ddnm_tpu_torch.data.datasets import FolderDataset, get_dataset, iterate_batches

REPO = Path(__file__).resolve().parents[1]
PNGS = sorted((REPO / "exp" / "datasets").rglob("*.png"))
CONFIGS = sorted((REPO / "configs").glob("*.yml"))


def test_png_decoder_bit_equal_to_pil():
    assert len(PNGS) >= 60
    for p in PNGS:
        ours = tio.decode_png(p.read_bytes())
        ref = np.asarray(Image.open(p))
        assert ours.shape == ref.shape and ours.dtype == ref.dtype, p
        assert np.array_equal(ours, ref), p
        rgb = np.asarray(Image.open(p).convert("RGB"), np.float32) / 255.0
        assert np.array_equal(tio.load_image(p), rgb), p


@pytest.mark.parametrize("shape", [(5, 7), (9, 4, 3), (3, 6, 4), (2, 3, 2)])
def test_png_encoder_round_trips(shape, tmp_path):
    arr = np.random.default_rng(0).integers(0, 256, shape, dtype=np.uint8)
    data = tio.encode_png(arr)
    assert np.array_equal(tio.decode_png(data), arr)
    path = tmp_path / "x.png"
    path.write_bytes(data)
    assert np.array_equal(np.asarray(Image.open(path)), arr)


def test_save_image_quantises_like_jax(tmp_path):
    from ddnm_tpu.data.io import save_image as j_save

    img = np.random.default_rng(1).uniform(-0.1, 1.1, (6, 5, 3)).astype(np.float32)
    tio.save_image(img, tmp_path / "ours.png")
    j_save(img, tmp_path / "ref.png")
    assert np.array_equal(tio.decode_png((tmp_path / "ours.png").read_bytes()),
                          np.asarray(Image.open(tmp_path / "ref.png")))


def test_png_decoder_rejects_what_it_does_not_read(tmp_path):
    """A palette PNG, once refused, decodes to PIL's mode "P" (its palette
    expanded); what is not a PNG, or a PNG with an unknown critical chunk,
    is still refused."""
    pal = Image.new("P", (4, 4))
    pal.putpalette(list(range(48)))
    pal.putpixel((1, 2), 5)
    pal.save(tmp_path / "pal.png")
    arr, mode = tio.decode_image((tmp_path / "pal.png").read_bytes())
    assert mode == "P"
    assert np.array_equal(tio.convert(arr, mode, "RGB"),
                          np.asarray(Image.open(tmp_path / "pal.png").convert("RGB")))
    with pytest.raises(ValueError, match="not a PNG"):
        tio.decode_png(b"GIF89a")
    data = tio.encode_png(np.zeros((2, 2), np.uint8))
    bogus = data[:33] + tio._chunk(b"ABCD", b"") + data[33:]
    with pytest.raises(ValueError, match="unsupported PNG chunk"):
        tio.decode_png(bogus)


@pytest.mark.parametrize("path", CONFIGS, ids=lambda p: p.name)
def test_yaml_reader_equals_safe_load(path):
    text = path.read_text(encoding="utf-8")
    assert parse_yaml(text) == yaml.safe_load(text)


def test_yaml_reader_scalars_and_flow():
    text = ("\ufeff# c\na: 1.0e-4\nb: 1e-4\nc: [1, 2, {d: 'x # y', e: \"z\"}]\n"
            "f: {g: yes, h: ~, i: -7}\nj:\n  k: Off\n  l: ''\nm: 0x1f\n")
    assert parse_yaml(text) == yaml.safe_load(text)
    with pytest.raises(ValueError):
        parse_yaml("a:\n  - 1\n  - 2\n")


def test_transforms_and_metrics_match_jax():
    rng = np.random.default_rng(3)
    a = rng.uniform(0, 1, (2, 16, 16, 3)).astype(np.float32)
    b = np.clip(a + rng.normal(0, 0.05, a.shape), 0, 1).astype(np.float32)
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    fwd = ttransforms.data_transform(ta).numpy()
    np.testing.assert_array_equal(fwd, np.asarray(jtransforms.data_transform(jnp.asarray(a))))
    back = ttransforms.inverse_data_transform(torch.from_numpy(fwd * 1.2)).numpy()
    np.testing.assert_allclose(
        back, np.asarray(jtransforms.inverse_data_transform(jnp.asarray(fwd * 1.2))),
        atol=1e-7)
    for kw in (dict(rescaled=False, logit_transform=True),
               dict(rescaled=False, logit_transform=False)):
        np.testing.assert_allclose(
            ttransforms.data_transform(ta, **kw).numpy(),
            np.asarray(jtransforms.data_transform(jnp.asarray(a), **kw)), atol=1e-5)
        np.testing.assert_allclose(
            ttransforms.inverse_data_transform(torch.from_numpy(fwd), **kw).numpy(),
            np.asarray(jtransforms.inverse_data_transform(jnp.asarray(fwd), **kw)),
            atol=1e-6)
    np.testing.assert_allclose(tmetrics.psnr(ta, tb).numpy(),
                               np.asarray(jmetrics.psnr(jnp.asarray(a), jnp.asarray(b))),
                               rtol=1e-5)
    np.testing.assert_allclose(tmetrics.ssim(ta, tb).numpy(),
                               np.asarray(jmetrics.ssim(jnp.asarray(a), jnp.asarray(b))),
                               atol=1e-5)


@pytest.mark.parametrize("seed", [2019, None])
def test_folder_dataset_order_and_pixels_match_jax(seed):
    root = REPO / "exp" / "datasets" / "toy32"
    ours = FolderDataset(root, 32, shuffle_seed=seed)
    ref = JFolderDataset(root, 32, shuffle_seed=seed)
    assert ours.paths == ref.paths
    for i in (0, len(ours) - 1):
        assert np.array_equal(ours[i][0], ref[i][0])
    batches = list(iterate_batches(ours, 3))
    assert [v for _, _, v in batches] == [3, 3, 2]
    assert batches[-1][0].shape == (3, 32, 32, 3)


MANIFEST = "00003.png 17\n00000.png 951\n\nmissing.png 3\n00005.png\n00001.png 2\n"


def _assert_pixels_close(a: np.ndarray, b: np.ndarray):
    """Within 1 uint8 level, at most 0.1% of the values differing (PIL's
    fixed-point resampler against the port's; tests/test_torch_resize.py)."""
    assert a.shape == b.shape and a.dtype == b.dtype == np.float32
    diff = np.abs(np.rint(a * 255) - np.rint(b * 255))
    assert diff.max() <= 1 and (diff > 0).mean() <= 1e-3


@pytest.mark.parametrize("image_size", [256, 64])
@pytest.mark.parametrize("name,manifest,ood", [("ImageNet", False, False),
                                               ("ImageNet", True, False),
                                               ("LSUN", False, True)])
def test_get_dataset_matches_jax(tmp_path, name, manifest, ood, image_size):
    """Paths, labels and pixels of the ImageNet branches (folder:
    center_crop_arr; manifest: labels, short-edge crop + BILINEAR) and the
    ood LSUN folder, whole and with a subset, against the JAX package's
    get_dataset on exp/datasets/imagenet."""
    from ddnm_tpu.data.datasets import get_dataset as j_get_dataset

    root = REPO / "exp" / "datasets" / "imagenet"
    kw = dict(root=root, image_size=image_size, out_of_dist=ood)
    if manifest:
        (tmp_path / "val.txt").write_text(MANIFEST)
        kw["manifest"] = tmp_path / "val.txt"
    for subset in (None, (1, 3)):
        ours = get_dataset(name, subset=subset, **kw)
        ref = j_get_dataset(name, subset=subset, **kw)
        assert ours.paths == ref.paths and len(ours) == (2 if subset else 4 if manifest else 8)
        assert getattr(ours, "labels", None) == getattr(ref, "labels", None)
        for i in range(len(ours)):
            (a, la), (b, lb) = ours[i], ref[i]
            assert la == lb
            _assert_pixels_close(a, b)
    if manifest:
        assert get_dataset(name, **kw).labels == [17, 951, 0, 2]


@pytest.mark.parametrize("name,ood", [("LSUN", False), ("CELEBA", False), ("cifar", False)])
def test_get_dataset_refuses_what_is_not_ported(name, ood, tmp_path, monkeypatch):
    """What get_dataset cannot build it refuses as the JAX package's does: an
    unknown name (ValueError), the LSUN lmdb without the lmdb package
    (ImportError; neither machine has it) and a CelebA root without images
    (FileNotFoundError)."""
    from ddnm_tpu.data.datasets import get_dataset as j_get_dataset

    monkeypatch.setitem(sys.modules, "lmdb", None)  # import lmdb raises ImportError
    exc = {"cifar": ValueError, "LSUN": ImportError, "CELEBA": FileNotFoundError}[name]
    for fn in (get_dataset, j_get_dataset):
        with pytest.raises(exc):
            fn(name, root=tmp_path / "empty", out_of_dist=ood)
