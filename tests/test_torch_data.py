"""The port's own readers against the libraries they replace (the port's
machine has neither PIL nor yaml; this host has both), and the port's data
layer against the JAX package's."""

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
from ddnm_tpu_torch.data.datasets import FolderDataset, iterate_batches

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
    Image.new("P", (4, 4)).save(tmp_path / "pal.png")
    with pytest.raises(ValueError, match="unsupported"):
        tio.decode_png((tmp_path / "pal.png").read_bytes())
    with pytest.raises(ValueError, match="not a PNG"):
        tio.decode_png(b"GIF89a")


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
