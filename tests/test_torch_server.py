"""The port's RestorationService (ddnm_tpu_torch/server.py) against the JAX
package's: its output against the JAX sampler, its per-task decisions
against the JAX RestorationService on the same operators, its refusals,
and its serving invariants: the parity on the trained toy32 DDPM, the
invariants on tests/test_server.py's random 32 px DDPM (3-4 steps).

Tolerances:
  - against the JAX sampler on the converted toy32 weights under the
    zero-noise protocol (the service's noise_fn hook returns zeros; x_T is
    the service's own, from each request's STREAM_INIT generator, handed
    to JAX): max |ours - JAX| <= 1e-3 in [0, 1] for a simplified, a
    ctx-masked and an SVD (cs_walshhadamard) task, the bound of the port's
    sampler parity tests (tests/test_torch_sampling.py,
    tests/test_torch_svd_sampling.py);
  - per-task decisions (tasks, ctx_tasks, y_shape, is_svd,
    ctx_degraded_ok, requires_ctx): equal;
  - batch-composition invariance: bit for bit; a degraded upload against
    the gt path: 1e-6 (as tests/test_server.py:74-83).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ddnm_tpu import schedules as jsch
from ddnm_tpu.operators import build_functional_operator as j_build_op
from ddnm_tpu.operators import build_svd_operator as j_build_svd
from ddnm_tpu.sampling import build_schedule as j_build_schedule
from ddnm_tpu.sampling import sample_simplified as j_sample
from ddnm_tpu.sampling import sample_svd as j_sample_svd
from ddnm_tpu.server import RestorationService as JRestorationService
from ddnm_tpu_torch.operators import build_functional_operator, build_svd_operator
from ddnm_tpu_torch.parallel import make_mesh
from ddnm_tpu_torch.sampling import build_schedule
from ddnm_tpu_torch.sampling.rng import STREAM_INIT, default_noise, image_generators
from ddnm_tpu_torch.server import RestorationService
from tests._golden import TOY32
from tests._torch_port import jax_model, one_torch_thread, port_model, zero_noise_torch  # noqa: F401

RES = 32
SEED = 1234
BETAS = jsch.get_beta_schedule("linear", beta_start=1e-4, beta_end=0.02,
                               num_diffusion_timesteps=1000).astype(np.float32)
T_SAMPLING = 4


def _gt_images(n, seed=7):
    return np.random.default_rng(seed).uniform(0.2, 0.8, (n, RES, RES, 3)).astype(np.float32)


def _masks(n, seed=17):
    return (np.random.default_rng(seed).random((n, RES, RES, 1)) > 0.4).astype(np.float32)


def _port_ops():
    ones = np.ones((RES, RES, 1), np.float32)
    return {
        "sr_averagepooling": build_functional_operator("sr_averagepooling", image_size=RES,
                                                       deg_scale=4),
        "colorization": build_functional_operator("colorization", image_size=RES),
        "inpainting": build_functional_operator("inpainting", image_size=RES, mask=ones),
        "mask_color_sr": build_functional_operator("mask_color_sr", image_size=RES,
                                                   deg_scale=4, mask=ones),
        "sr_color": build_functional_operator("sr_color", image_size=RES, deg_scale=4),
        "denoising": build_functional_operator("denoising", image_size=RES),
    }


def _jax_ops():
    ones = np.ones((RES, RES, 1), np.float32)
    return {
        "sr_averagepooling": j_build_op("sr_averagepooling", image_size=RES, deg_scale=4),
        "colorization": j_build_op("colorization", image_size=RES),
        "inpainting": j_build_op("inpainting", image_size=RES, mask=ones),
        "mask_color_sr": j_build_op("mask_color_sr", image_size=RES, deg_scale=4, mask=ones),
        "sr_color": j_build_op("sr_color", image_size=RES, deg_scale=4),
        "denoising": j_build_op("denoising", image_size=RES),
    }


SVD_TASKS = (("cs_walshhadamard", 0.25), ("deblur_gauss", 4.0), ("colorization", 4.0),
             ("sr_averagepooling", 4.0), ("inpainting", 4.0), ("denoising", 4.0),
             ("cs_blockbased", 0.25))


def _svd_kw(deg, scale):
    mask = np.ones((RES, RES), np.float32) if deg == "inpainting" else None
    return dict(image_size=RES, deg_scale=scale, seed=7, mask=mask)


def _model_fn(p, x, t):
    return p["model"](x, t)


@pytest.fixture(scope="module")
def model():
    return port_model(TOY32)


@pytest.fixture(scope="module")
def service():
    """The set-up of tests/test_server.py:33-52: a random 32 px DDPM UNet
    (ch 32, ch_mult (1, 2)), a 100-step linear schedule, 3 steps,
    max_batch 4."""
    from ddnm_tpu_torch import schedules
    from ddnm_tpu_torch.models import DDPMUNet

    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)
        net = DDPMUNet(ch=32, ch_mult=(1, 2), num_res_blocks=1, attn_resolutions=(16,),
                       resolution=RES).eval()
    betas = schedules.get_beta_schedule("linear", beta_start=1e-4, beta_end=0.02,
                                        num_diffusion_timesteps=100).astype(np.float32)
    ops = {k: v for k, v in _port_ops().items() if k in ("sr_averagepooling", "colorization")}
    return RestorationService(_model_fn, {"model": net}, build_schedule(betas=betas, t_sampling=3),
                              ops, image_size=RES, max_batch=4, base_seed=SEED)


def _x_init(seqs, max_batch):
    seqs = list(seqs) + [0] * (max_batch - len(seqs))
    return default_noise(image_generators(SEED, seqs, STREAM_INIT, "cpu"),
                         (max_batch, RES, RES, 3)).numpy()


def test_service_matches_the_jax_sampler_under_zero_noise(model):
    """Simplified sr_averagepooling, ctx-masked inpainting and SVD
    cs_walshhadamard through the service, against sample_simplified /
    sample_svd of the JAX package on the same x_T, y and weights."""
    ops = dict(_port_ops(), cs_walshhadamard=build_svd_operator(
        "cs_walshhadamard", **_svd_kw("cs_walshhadamard", 0.25)))
    svc = RestorationService(_model_fn, {"model": model},
                             build_schedule(betas=BETAS, t_sampling=T_SAMPLING), ops,
                             image_size=RES, max_batch=2, base_seed=SEED,
                             noise_fn=zero_noise_torch)
    fn, params = jax_model(TOY32)
    sched = j_build_schedule(betas=BETAS, t_sampling=T_SAMPLING)
    zero = lambda k, s: jnp.zeros(s)
    gts = _gt_images(2, seed=3)
    xg = jnp.asarray(2.0 * gts - 1.0)
    masks = _masks(2, seed=5)
    seqs = [4, 9]
    x_init = jnp.asarray(_x_init(seqs, 2))
    to01 = lambda a: np.clip((np.asarray(a) + 1.0) / 2.0, 0.0, 1.0)

    jop = j_build_op("sr_averagepooling", image_size=RES, deg_scale=4)
    ref, _ = j_sample(fn, x_init, jop.A(xg), jop, sched, jax.random.PRNGKey(0),
                      noise_fn=zero, params=params, loop="host")
    ours = svc.restore(gts, "sr_averagepooling", seqs, input_kind="gt")
    assert float(np.abs(ours - to01(ref)).max()) <= 1e-3

    jop = j_build_op("inpainting", image_size=RES, mask=np.ones((RES, RES, 1), np.float32))
    ctx = jnp.asarray(masks)
    ref, _ = j_sample(fn, x_init, jop.A_ctx(xg, ctx), jop, sched, jax.random.PRNGKey(0),
                      noise_fn=zero, params=params, loop="host", op_ctx=ctx)
    ours = svc.restore(gts, "inpainting", seqs, input_kind="gt", ctxs=masks)
    assert float(np.abs(ours - to01(ref)).max()) <= 1e-3

    jop = j_build_svd("cs_walshhadamard", **_svd_kw("cs_walshhadamard", 0.25))
    y = jop.A(jnp.transpose(xg, (0, 3, 1, 2)).reshape(2, -1))
    ref, _ = j_sample_svd(fn, x_init, y, jop, sched, jax.random.PRNGKey(0),
                          noise_fn=zero, params=params, loop="host")
    ours = svc.restore(gts, "cs_walshhadamard", seqs, input_kind="gt")
    assert float(np.abs(ours - to01(ref)).max()) <= 1e-3


@pytest.mark.parametrize("family", ["functional", "svd"])
def test_per_task_decisions_equal_the_jax_service(family):
    """tasks, ctx_tasks and per task y_shape, is_svd, ctx_degraded_ok and
    requires_ctx: the JAX service's (jax.eval_shape and its ctx probe)
    against the port's (A on a zero tensor, the same numpy probe)."""
    sched = build_schedule(betas=BETAS, t_sampling=3)
    if family == "functional":
        ours_ops, jax_ops = _port_ops(), _jax_ops()
        req = ("inpainting", "mask_color_sr")
    else:
        ours_ops = {d: build_svd_operator(d, **_svd_kw(d, s)) for d, s in SVD_TASKS}
        jax_ops = {d: j_build_svd(d, **_svd_kw(d, s)) for d, s in SVD_TASKS}
        req = ()
    ours = RestorationService(_model_fn, {}, sched, ours_ops, image_size=RES, max_batch=2,
                              require_ctx=req)
    ref = JRestorationService(lambda p, x, t: x, {}, j_build_schedule(betas=BETAS,
                                                                      t_sampling=3),
                              jax_ops, image_size=RES, max_batch=2, require_ctx=req)
    assert ours.tasks == ref.tasks and ours.ctx_tasks == ref.ctx_tasks
    for t in ref.tasks:
        want = ref.y_shape(t)
        assert ours.y_shape(t) == (None if want is None else tuple(want)), t
        assert ours.is_svd(t) == ref.is_svd(t), t
        assert ours.ctx_degraded_ok(t) == ref.ctx_degraded_ok(t), t
        assert ours.requires_ctx(t) == ref.requires_ctx(t), t
    assert ours.class_cond is ref.class_cond is False
    assert ours.num_classes is ref.num_classes is None


def test_restore_validates(service, model):
    """The refusals of tests/test_server.py:85-97 and of the masks', SVD
    and class paths, with the JAX service's exception types and texts."""
    gts = _gt_images(1)
    with pytest.raises(KeyError):
        service.restore(gts, "deblur_gauss", [0], input_kind="gt")
    with pytest.raises(ValueError, match="degraded input"):
        service.restore(gts, "sr_averagepooling", [0], input_kind="degraded")
    with pytest.raises(ValueError, match="group size"):
        service.restore(np.repeat(gts, 5, axis=0), "sr_averagepooling", list(range(5)),
                        input_kind="gt")
    with pytest.raises(ValueError, match="one sequence number"):
        service.restore(gts, "sr_averagepooling", [0, 1], input_kind="gt")
    with pytest.raises(ValueError, match="input_kind"):
        service.restore(gts, "sr_averagepooling", [0], input_kind="nope")
    with pytest.raises(ValueError, match="not class-conditional"):
        service.restore(gts, "sr_averagepooling", [0], input_kind="gt", classes=[1])
    with pytest.raises(ValueError, match="per-request masks"):
        service.restore(gts, "sr_averagepooling", [0], input_kind="gt", ctxs=_masks(1))
    assert service.y_shape("sr_averagepooling") == (RES // 4, RES // 4, 3)
    assert service.y_shape("colorization") == (RES, RES, 3)

    sched = build_schedule(betas=BETAS, t_sampling=3)
    ops = _port_ops()
    svc = RestorationService(_model_fn, {"model": model}, sched, ops, image_size=RES,
                             max_batch=2, require_ctx=("inpainting",))
    with pytest.raises(ValueError, match="without a static mask"):
        svc.restore(gts, "inpainting", [0], input_kind="gt")
    with pytest.raises(ValueError, match="ctxs must be"):
        svc.restore(gts, "inpainting", [0], input_kind="gt", ctxs=_masks(1)[:, :16])
    with pytest.raises(ValueError, match="degraded masked"):
        svc.restore(gts, "mask_color_sr", [0], input_kind="degraded", ctxs=_masks(1))
    with pytest.raises(ValueError, match="require_ctx names unknown"):
        RestorationService(_model_fn, {}, sched, ops, image_size=RES, require_ctx=("x",))
    with pytest.raises(ValueError, match="auto|host|scan"):
        RestorationService(_model_fn, {}, sched, ops, image_size=RES, loop="vectorized")
    with pytest.raises(ValueError, match="must divide over the 3-device mesh"):
        RestorationService(_model_fn, {}, sched, ops, image_size=RES,
                           mesh=make_mesh(3, device="cpu"))
    svd = RestorationService(_model_fn, {"model": model}, sched, {
        "cs_walshhadamard": build_svd_operator("cs_walshhadamard",
                                               **_svd_kw("cs_walshhadamard", 0.25))},
        image_size=RES, max_batch=2)
    with pytest.raises(ValueError, match="not an image"):
        svd.restore(gts, "cs_walshhadamard", [0], input_kind="degraded")


def test_batch_composition_invariance(service):
    """Alone vs coalesced vs padded: the same seq gives the same bits; a
    different seq another stream."""
    gts = _gt_images(3)
    together = service.restore(gts, "sr_averagepooling", [10, 11, 12], input_kind="gt")
    alone = service.restore(gts[1:2], "sr_averagepooling", [11], input_kind="gt")
    np.testing.assert_array_equal(together[1], alone[0])
    other = service.restore(gts[1:2], "sr_averagepooling", [99], input_kind="gt")
    assert not np.array_equal(other[0], alone[0])
    assert together.dtype == np.float32 and together.shape == (3, RES, RES, 3)


def test_served_over_a_mesh(service):
    """The service over a CPU mesh of 2 (serve_torch.py --dp 2): a reply
    alone and coalesced in a group are bit-identical, and every reply
    equals the unsharded service's to 1e-5 (each entry runs a batch of 2,
    the unsharded service one of 4: CPU convolutions may round them apart
    by ~1e-7)."""
    sharded = RestorationService(
        service._model_fn, service._params, service._sched, service._operators,
        image_size=RES, max_batch=4, base_seed=SEED, mesh=make_mesh(2, device="cpu"))
    gts = _gt_images(3)
    together = sharded.restore(gts, "sr_averagepooling", [10, 11, 12], input_kind="gt")
    for i in range(3):
        alone = sharded.restore(gts[i:i + 1], "sr_averagepooling", [10 + i], input_kind="gt")
        np.testing.assert_array_equal(together[i], alone[0])
    single = service.restore(gts, "sr_averagepooling", [10, 11, 12], input_kind="gt")
    np.testing.assert_allclose(together, single, atol=1e-5)
    assert np.abs(together - 0.5).max() > 0.1


def test_degraded_equals_gt_path(service):
    """A(gt) sent as the degraded observation reproduces the gt path."""
    gts = _gt_images(2, seed=9)
    via_gt = service.restore(gts, "sr_averagepooling", [3, 4], input_kind="gt")
    y01 = gts.reshape(2, RES // 4, 4, RES // 4, 4, 3).mean(axis=(2, 4))
    via_y = service.restore(y01.astype(np.float32), "sr_averagepooling", [3, 4],
                            input_kind="degraded")
    np.testing.assert_allclose(via_y, via_gt, atol=1e-6)


def test_per_request_masks_stay_in_their_lane(model):
    """Different per-request masks share one group; lane 0 is unchanged
    when lane 1's mask changes; a masked degraded upload equals the gt path
    for the pure mask projection."""
    svc = RestorationService(_model_fn, {"model": model},
                             build_schedule(betas=BETAS, t_sampling=3), _port_ops(),
                             image_size=RES, max_batch=4)
    assert svc.ctx_tasks == ("inpainting", "mask_color_sr")
    assert svc.ctx_degraded_ok("inpainting") and not svc.ctx_degraded_ok("mask_color_sr")
    gts, m = _gt_images(2, seed=11), _masks(2)
    out_ab = svc.restore(gts, "inpainting", [5, 6], input_kind="gt", ctxs=m)
    out_aa = svc.restore(gts, "inpainting", [5, 6], input_kind="gt",
                         ctxs=np.stack([m[0], m[0]]))
    np.testing.assert_array_equal(out_ab[0], out_aa[0])
    assert not np.array_equal(out_ab[1], out_aa[1])
    destroyed = (gts * m + (1 - m) * 0.5).astype(np.float32)
    via_deg = svc.restore(destroyed, "inpainting", [5, 6], input_kind="degraded", ctxs=m)
    np.testing.assert_allclose(via_deg, out_ab, atol=1e-6)
