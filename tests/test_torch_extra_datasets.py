"""The port's data long tail against the JAX package on the same trees:
CelebA and LSUN (ddnm_tpu_torch/data/extra_datasets.py), get_dataset's
CELEBA and LSUN branches, the hq pair loader's centre crop, the
dequantizations, the checkpoint registry and a JPEG upload through the
server's decoder (the cases of tests/test_datasets_extra.py carried over).

Tolerances: names, labels, targets, keys and errors equal; pixels equal
where both sides decode PNG or WebP, within 1 uint8 level where they decode JPEG
(the port's numpy decoder against PIL; equal on this host's Pillow);
dequantized values equal for the same numpy Generator. The lmdb package
is absent on both machines: LSUN runs on an in-memory stand-in that has
the three calls the datasets make (open, begin, stat / cursor / get)."""

import io
import pickle
import sys
import types
from pathlib import Path

import numpy as np
import pytest
from PIL import Image

from ddnm_tpu.data import checkpoints as jck
from ddnm_tpu.data import extra_datasets as jx
from ddnm_tpu.data.datasets import get_dataset as j_get_dataset
from ddnm_tpu.data.inpaint_pairs import InpaintPairs as JInpaintPairs
from ddnm_tpu.data.io import save_image as j_save_image
from ddnm_tpu.data.transforms import data_transform as j_data_transform
from ddnm_tpu_torch.data import checkpoints as tck
from ddnm_tpu_torch.data import extra_datasets as tx
from ddnm_tpu_torch.data.datasets import get_dataset
from ddnm_tpu_torch.data.inpaint_pairs import InpaintPairs
from ddnm_tpu_torch.data.transforms import data_transform

NAMES = [f"{i:06d}.jpg" for i in range(4)]


def _close(a, b, levels: int = 0):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    assert a.shape == b.shape
    assert np.abs(a - b).max() <= levels / 255.0 + 1e-6


def _same_items(ours, ref, levels: int):
    assert len(ours) == len(ref)
    for i in range(len(ref)):
        (a, ta), (b, tb) = ours[i], ref[i]
        _close(a, b, levels)
        if isinstance(tb, tuple):
            assert len(ta) == len(tb)
            for x, y in zip(ta, tb):
                np.testing.assert_array_equal(x, y)
        else:
            np.testing.assert_array_equal(ta, tb)


def _celeba_tree(root: Path, meta: bool = True):
    d = root / "img_align_celeba"
    d.mkdir()
    rng = np.random.default_rng(0)
    for n in NAMES:  # JPEGs: PIL picks the format from the suffix
        j_save_image(rng.uniform(size=(218, 178, 3)).astype(np.float32), d / n)
    (root / "list_eval_partition.txt").write_text(
        "000000.jpg 0\n000001.jpg 2\n000002.jpg 2\n000003.jpg 1\n")
    if not meta:
        return
    (root / "list_attr_celeba.txt").write_text(
        "4\nSmiling Young\n"
        "000000.jpg -1 1\n000001.jpg 1 -1\n000002.jpg -1 -1\n000003.jpg 1 1\n")
    (root / "identity_CelebA.txt").write_text(
        "000000.jpg 11\n000001.jpg 22\n000002.jpg 33\n000003.jpg 44\n")
    (root / "list_bbox_celeba.txt").write_text(
        "4\nimage_id x_1 y_1 width height\n"
        + "".join(f"{n} {i} {i + 1} 10 20\n" for i, n in enumerate(NAMES)))
    (root / "list_landmarks_align_celeba.txt").write_text(
        "4\nlefteye_x lefteye_y righteye_x righteye_y nose_x nose_y "
        "leftmouth_x leftmouth_y rightmouth_x rightmouth_y\n"
        + "".join(f"{n} " + " ".join(str(i * 10 + j) for j in range(10)) + "\n"
                  for i, n in enumerate(NAMES)))


def test_celeba_crop_geometry():
    img = np.random.default_rng(0).uniform(size=(218, 178, 3)).astype(np.float32)
    out = tx.celeba_crop(img)
    assert out.shape == (128, 128, 3)
    np.testing.assert_array_equal(out, jx.celeba_crop(img))


@pytest.mark.parametrize("kw", [
    dict(split="test"), dict(split=None, image_size=128), dict(split="train"),
    dict(split="test", image_size=32, target_type=["attr", "identity", "bbox", "landmarks"]),
    dict(split="test", image_size=32, target_type="identity"),
], ids=["test64", "all128", "train64", "targets", "one_target"])
def test_celeba_dataset_matches_jax(kw, tmp_path):
    """Partition, crop, BICUBIC resize (none at 128), targets: attr {-1, 1}
    -> {0, 1}, rows in the partition's order, a str target bare."""
    _celeba_tree(tmp_path)
    ours, ref = tx.CelebADataset(tmp_path, **kw), jx.CelebADataset(tmp_path, **kw)
    assert [p.name for p in ours.paths] == [p.name for p in ref.paths]
    assert ours.attr_names == ref.attr_names
    _same_items(ours, ref, levels=1)
    if kw.get("target_type") == "identity":
        assert int(ours[0][1][0]) == 22


def test_celeba_refusals_match_jax(tmp_path):
    _celeba_tree(tmp_path, meta=False)
    for kw, exc in ((dict(target_type="bogus"), ValueError), (dict(split="bogus"), ValueError),
                    (dict(target_type="attr"), FileNotFoundError)):
        with pytest.raises(exc) as ours:
            tx.CelebADataset(tmp_path, **kw)
        with pytest.raises(exc) as ref:
            jx.CelebADataset(tmp_path, **kw)
        assert str(ours.value).split(" needs ")[0] == str(ref.value).split(" needs ")[0]
    with pytest.raises(FileNotFoundError, match="no CelebA images"):
        tx.CelebADataset(tmp_path / "img_align_celeba" / "nothing_here")


def _encoded(color, fmt: str, size=(10, 8)) -> bytes:
    buf = io.BytesIO()
    rng = np.random.default_rng(sum(color))
    arr = np.clip(np.asarray(color, np.float64) + rng.normal(0, 20, size[::-1] + (3,)), 0, 255)
    Image.fromarray(arr.astype(np.uint8)).save(buf, format=fmt)
    return buf.getvalue()


def _install_fake_lmdb(monkeypatch, dbs):
    """An in-memory lmdb: open(path) -> env.begin() -> txn.stat / cursor /
    get over `dbs[<lmdb dir name>]`, an ordered {key: value bytes}."""

    class _Txn:
        def __init__(self, store):
            self._s = store

        def stat(self):
            return {"entries": len(self._s)}

        def cursor(self):
            return iter(self._s.items())

        def get(self, k):
            return self._s[k]

        def __enter__(self):
            return self

        def __exit__(self, *a):
            return False

    class _Env:
        def __init__(self, store):
            self._s = store

        def begin(self, write=False):
            return _Txn(self._s)

    mod = types.ModuleType("lmdb")

    def _open(path, **kw):
        name = Path(path).name
        if name not in dbs:
            raise FileNotFoundError(path)
        return _Env(dbs[name])

    mod.open = _open
    monkeypatch.setitem(sys.modules, "lmdb", mod)


def test_lsun_requires_lmdb(tmp_path, monkeypatch):
    monkeypatch.setitem(sys.modules, "lmdb", None)  # import lmdb raises ImportError
    with pytest.raises(ImportError) as ours:
        tx.LSUNDataset(tmp_path, "bedroom")
    with pytest.raises(ImportError) as ref:
        jx.LSUNDataset(tmp_path, "bedroom")
    assert str(ours.value) == str(ref.value)


@pytest.mark.parametrize("fmt,levels", [("PNG", 0), ("JPEG", 1)])
def test_lsun_key_cache_matches_jax(fmt, levels, tmp_path, monkeypatch):
    """Keys enumerated once and pickled next to the lmdb directory; a cache
    there wins over enumeration; use_key_cache=False ignores it; items
    (short-edge crop, BICUBIC) equal to JAX's on PNG and JPEG values."""
    store = {f"k{i}".encode(): _encoded((i * 40, 10, 200 - i * 30), fmt) for i in range(3)}
    _install_fake_lmdb(monkeypatch, {"bedroom_val_lmdb": store})
    ours = tx.LSUNDataset(tmp_path, "bedroom", "val", image_size=8)
    cache = tmp_path / "_cache_bedroom_val_lmdb"
    assert pickle.loads(cache.read_bytes()) == list(store)
    ref = jx.LSUNDataset(tmp_path, "bedroom", "val", image_size=8)
    assert len(ours) == 3 and ours.keys == ref.keys
    _same_items(ours, ref, levels)
    cache.write_bytes(pickle.dumps(list(reversed(list(store)))))
    ours2 = tx.LSUNDataset(tmp_path, "bedroom", "val", image_size=8)
    assert ours2.keys == list(reversed(list(store)))
    _same_items(ours2, jx.LSUNDataset(tmp_path, "bedroom", "val", image_size=8), levels)
    ours3 = tx.LSUNDataset(tmp_path, "bedroom", "val", image_size=6, use_key_cache=False)
    assert ours3.keys == list(store)
    _same_items(ours3, jx.LSUNDataset(tmp_path, "bedroom", "val", image_size=6,
                                      use_key_cache=False), levels)


def test_lsun_multi_matches_jax(tmp_path, monkeypatch):
    dbs = {"bedroom_train_lmdb": {f"a{i}".encode(): _encoded((200, 0, 0), "PNG")
                                  for i in range(2)},
           "church_outdoor_train_lmdb": {f"b{i}".encode(): _encoded((0, 200, 0), "JPEG")
                                         for i in range(3)}}
    _install_fake_lmdb(monkeypatch, dbs)
    classes = ["bedroom_train", "church_outdoor_train"]
    ours = tx.LSUNMulti(tmp_path, classes, image_size=8)
    ref = jx.LSUNMulti(tmp_path, classes, image_size=8)
    assert ours.indices == ref.indices == [2, 5] and len(ours) == 5
    _same_items(ours, ref, levels=1)
    assert [ours[i][1] for i in range(5)] == [0, 0, 1, 1, 1]


def test_lsun_webp_value_refused(tmp_path, monkeypatch):
    """LSUN's own export stores WebP (lossy, as the LSUN tools write it):
    once refused, the port's items now equal the JAX LSUNDataset's on the
    same lmdb, byte for byte (the numpy VP8 decoder against PIL's libwebp)."""
    store = {f"w{i}".encode(): _encoded((i * 60, 90, 30), "WEBP", size=(37, 29))
             for i in range(3)}
    _install_fake_lmdb(monkeypatch, {"cat_val_lmdb": store})
    ours = tx.LSUNDataset(tmp_path, "cat", "val", image_size=16)
    ref = jx.LSUNDataset(tmp_path, "cat", "val", image_size=16)
    assert len(ours) == 3 and ours.keys == ref.keys
    _same_items(ours, ref, levels=0)


def test_lsun_classes_validation_matches_jax():
    for arg in ("test", "train", "val", ["cat_val"], ["church_outdoor_val"]):
        assert tx._verify_lsun_classes(arg) == jx._verify_lsun_classes(arg)
    assert tx.LSUN_CATEGORIES == jx.LSUN_CATEGORIES
    for arg, word in ((["office_train"], "LSUN class"), (["bedroom_dev"], "postfix"),
                      ("dev", "Unknown value"), ([3], "type")):
        with pytest.raises(ValueError, match=word) as ours:
            tx._verify_lsun_classes(arg)
        with pytest.raises(ValueError) as ref:
            jx._verify_lsun_classes(arg)
        assert str(ours.value) == str(ref.value)


def test_get_dataset_celeba_and_lsun_branches(tmp_path, monkeypatch):
    """CELEBA: the test split of the tree; LSUN (not ood):
    <root parent>/<root name>_val_lmdb; both against JAX's get_dataset."""
    (tmp_path / "celeba").mkdir()
    _celeba_tree(tmp_path / "celeba", meta=False)
    kw = dict(root=tmp_path / "celeba", image_size=64)
    ours, ref = get_dataset("CelebA", **kw), j_get_dataset("CelebA", **kw)
    assert isinstance(ours, tx.CelebADataset)
    assert [p.name for p in ours.paths] == [p.name for p in ref.paths] == NAMES[1:3]
    _same_items(ours, ref, levels=1)
    store = {f"k{i}".encode(): _encoded((50 * i, 60, 70), "JPEG", (12, 9)) for i in range(2)}
    _install_fake_lmdb(monkeypatch, {"church_outdoor_val_lmdb": store})
    kw = dict(root=tmp_path / "datasets" / "church_outdoor", image_size=8)
    (tmp_path / "datasets").mkdir()
    ours, ref = get_dataset("LSUN", **kw), j_get_dataset("LSUN", **kw)
    assert isinstance(ours, tx.LSUNDataset) and ours.keys == ref.keys
    _same_items(ours, ref, levels=1)


@pytest.mark.parametrize("fmt,levels", [("png", 0), ("jpg", 1)])
def test_inpaint_pairs_crop_any_size_as_jax(fmt, levels, tmp_path):
    """300 x 280 gts and masks (not at image_size) centre-cropped to 128 as
    JAX crops them (BICUBIC to the short edge, then the centre)."""
    rng = np.random.default_rng(1)
    (tmp_path / "gts").mkdir()
    (tmp_path / "masks").mkdir()
    for i in range(2):
        j_save_image(rng.uniform(size=(280, 300, 3)).astype(np.float32),
                     tmp_path / "gts" / f"im{i}.{fmt}")
        m = (rng.uniform(size=(280, 300, 3)) > 0.5).astype(np.float32)
        j_save_image(m, tmp_path / "masks" / f"im{i}.{fmt}")
    ours = InpaintPairs(tmp_path / "gts", tmp_path / "masks", image_size=128)
    ref = JInpaintPairs(tmp_path / "gts", tmp_path / "masks", image_size=128)
    assert len(ours) == len(ref) == 2
    for i in range(2):
        a, b = ours[i], ref[i]
        assert a["GT"].shape == (128, 128, 3) and a["GT_name"] == b["GT_name"] == f"im{i}.{fmt}"
        _close((a["GT"] + 1) / 2, (b["GT"] + 1) / 2, levels)
        # a mask thresholded from values within a level may flip only where
        # JAX's value sits within a level of 0.5
        flip = a["gt_keep_mask"] != b["gt_keep_mask"]
        assert flip.mean() <= (0.0 if levels == 0 else 0.01)


@pytest.mark.parametrize("kw", [dict(uniform_dequantization=True),
                                dict(gaussian_dequantization=True),
                                dict(uniform_dequantization=True, gaussian_dequantization=True)],
                         ids=["uniform", "gaussian", "both"])
def test_dequantizations_equal_jax_for_the_same_rng(kw):
    x = np.random.default_rng(4).uniform(size=(2, 8, 8, 3)).astype(np.float32)
    ours = data_transform(x, rng=np.random.default_rng(9), **kw)
    ref = j_data_transform(x, rng=np.random.default_rng(9), **kw)
    np.testing.assert_array_equal(ours.numpy(), np.asarray(ref))
    import torch

    on_tensor = data_transform(torch.from_numpy(x), rng=np.random.default_rng(9), **kw)
    np.testing.assert_array_equal(on_tensor.numpy(), np.asarray(ref))
    # the default generator when none is given
    np.testing.assert_array_equal(data_transform(x, **kw).numpy(),
                                  np.asarray(j_data_transform(x, **kw)))


def test_checkpoint_registry_and_errors_match_jax(tmp_path):
    assert tck.CHECKPOINTS == jck.CHECKPOINTS
    f = tmp_path / "blob.bin"
    f.write_bytes(b"ddnm" * 100000)
    assert tck.md5sum(f) == jck.md5sum(f)
    for mod in (tck, jck):
        with pytest.raises(KeyError, match="unknown checkpoint"):
            mod.fetch("nope", tmp_path)
        with pytest.raises(FileNotFoundError, match="place it at"):
            mod.fetch("ema_lsun_cat", tmp_path, allow_download=False)
    # the port never downloads: the error names the URL and the target path
    url, _, fname = tck.CHECKPOINTS["ema_lsun_cat"]
    with pytest.raises(FileNotFoundError) as e:
        tck.fetch("ema_lsun_cat", tmp_path)
    assert url in str(e.value) and str(tmp_path / fname) in str(e.value)
    (tmp_path / fname).write_bytes(b"not the checkpoint")
    for mod in (tck, jck):
        with pytest.raises(IOError, match="md5"):
            mod.fetch("ema_lsun_cat", tmp_path, allow_download=False)
    (tmp_path / "celeba_hq.ckpt").write_bytes(b"x")  # no md5 in the registry
    assert tck.fetch("celeba_hq", tmp_path) == jck.fetch("celeba_hq", tmp_path,
                                                         allow_download=False)


@pytest.mark.parametrize("mode", ["RGB", "L"])
def test_server_decodes_a_jpeg_upload_as_pil(mode):
    """serve_torch's upload decoder (data/io.py decode_image) takes a JPEG:
    no alpha, gray or RGB, the pixels serve.py's PIL would see (RGB, L)
    within a level."""
    from ddnm_tpu_torch.data.io import convert, decode_image, has_alpha

    rgb = np.random.default_rng(6).integers(0, 256, (24, 40, 3), dtype=np.uint8)
    buf = io.BytesIO()
    Image.fromarray(rgb).convert(mode).save(buf, "JPEG", quality=90)
    img, img_mode = decode_image(buf.getvalue(), "upload")
    pil = Image.open(io.BytesIO(buf.getvalue()))
    assert img_mode == pil.mode and not has_alpha(img_mode)
    assert "A" not in pil.getbands()
    _close(convert(img, img_mode, "RGB"), np.asarray(pil.convert("RGB")), 1)
    _close(convert(img, img_mode, "L"), np.asarray(pil.convert("L")), 1)
