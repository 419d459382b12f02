"""Port parity: the simplified-mode degradation operators of
ddnm_tpu_torch against ddnm_tpu's, all 7 tasks, their context forms and
`compose`, on the same random NHWC inputs (fp32, exact arithmetic up to
summation order: 1e-6)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ddnm_tpu.operators import functional as jf
from ddnm_tpu_torch.operators import functional as tf

TASKS = ["colorization", "denoising", "sr_averagepooling", "inpainting", "sr_color",
         "mask_color_sr", "diy"]


def _inputs(seed=0, size=16):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((2, size, size, 3)).astype(np.float32)
    mask = (rng.uniform(size=(size, size)) > 0.4).astype(np.float32)
    ctx = (rng.uniform(size=(2, size, size, 1)) > 0.5).astype(np.float32)
    return x, mask, ctx


def _close(a, b):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b, np.float32), atol=1e-6, rtol=0)


@pytest.mark.parametrize("deg", TASKS)
def test_operator_matches_jax(deg):
    x, mask, ctx = _inputs()
    jop = jf.build_functional_operator(deg, image_size=16, deg_scale=4.0, mask=mask)
    top = tf.build_functional_operator(deg, image_size=16, deg_scale=4.0, mask=mask)
    assert top.name == jop.name and top.has_ctx == jop.has_ctx
    tx, jx = torch.from_numpy(x), jnp.asarray(x)
    y = top.A(tx)
    _close(y.numpy(), jop.A(jx))
    _close(top.Ap(y).numpy(), jop.Ap(jop.A(jx)))
    _close(top.project(tx, y * 0.5).numpy(), jop.project(jx, jop.A(jx) * 0.5))
    if top.has_ctx:
        tc, jc = torch.from_numpy(ctx), jnp.asarray(ctx)
        _close(top.range_ctx(tx, tc).numpy(), jop.range_ctx(jx, jc))


def test_compose_matches_jax():
    x, mask, _ = _inputs(1)
    names = ("inpainting", "colorization", "sr_averagepooling")
    jop = jf.compose(*(jf.build_functional_operator(n, image_size=16, deg_scale=4.0,
                                                    mask=mask) for n in names))
    top = tf.compose(*(tf.build_functional_operator(n, image_size=16, deg_scale=4.0,
                                                    mask=mask) for n in names))
    assert top.name == jop.name
    tx, jx = torch.from_numpy(x), jnp.asarray(x)
    _close(top.A(tx).numpy(), jop.A(jx))
    _close(top.Ap(top.A(tx)).numpy(), jop.Ap(jop.A(jx)))


def test_operator_errors_match_jax():
    for deg in ("inpainting", "mask_color_sr", "diy"):
        with pytest.raises(ValueError):
            tf.build_functional_operator(deg)
    with pytest.raises(NotImplementedError):
        tf.build_functional_operator("sr_bicubic")
    with pytest.raises(ValueError):
        tf.compose()
    with pytest.raises(ValueError):
        tf.as_mask(np.zeros((4, 4, 2)))
