"""tiling._images on a read-only numpy array: no torch warning (a tensor
over memory numpy marks non-writable), the same values as on a writable
copy, and no aliasing of the caller's array. Exact equality."""

import warnings

import numpy as np
import torch

from ddnm_tpu_torch.tiling import _images


def test_images_copies_a_read_only_array():
    x = np.random.default_rng(0).uniform(-1, 1, (2, 8, 8, 3)).astype(np.float32)
    ro = x.copy()
    ro.flags.writeable = False
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        got = _images(ro, torch.device("cpu"))
        single = _images(ro[0], torch.device("cpu"))
    want = _images(x.copy(), torch.device("cpu"))
    assert torch.equal(got, want) and torch.equal(single, want[:1])
    assert got.shape == (2, 8, 8, 3) and single.shape == (1, 8, 8, 3)
    got.add_(1.0)  # writing the tensor leaves the caller's array alone
    np.testing.assert_array_equal(ro, x)
