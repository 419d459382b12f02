"""The port's PosteriorRestorationService, the encoder-cache services and
the SVD-mode service (ddnm_tpu_torch/server.py), on the CPU at toy size:
the trained toy32 ADM (toy_adm32.pt) guided by the trained toy32
classifier (toy_clf32.pt, 4 classes, scale 2.0) toward each request's
label on a respacing-4 posterior schedule; tests/test_server.py's random
32 px DDPM for the simplified encoder cache and SVD tasks (3-4 steps).

Gates (as tests/test_server.py:783-1314): lanes independent and
alone == coalesced bit for bit; a label, a mask or the cache changes the
output; a service reply equals the direct sample_posterior call on the
same generators bit for bit; an SVD degraded upload equals the gt path
within 1e-5; the refusals' types and texts."""

from __future__ import annotations

import numpy as np
import pytest
import torch

import chip_smoke
from ddnm_tpu_torch import schedules
from ddnm_tpu_torch.models import DDPMUNet, classifier_guidance_fn
from ddnm_tpu_torch.operators import build_functional_operator, build_svd_operator
from ddnm_tpu_torch.sampling import build_schedule
from ddnm_tpu_torch.sampling.accel import adm_split_fns, ddpm_split_fns
from ddnm_tpu_torch.sampling.ddnm import _nhwc_to_vec
from ddnm_tpu_torch.sampling.posterior import build_posterior_tables, sample_posterior
from ddnm_tpu_torch.sampling.rng import (
    STREAM_INIT,
    STREAM_SAMPLE,
    default_noise,
    image_generators,
)
from ddnm_tpu_torch.server import PosteriorRestorationService, RestorationService
from tests._torch_port import one_torch_thread  # noqa: F401

RES = 32
ONES = np.ones((RES, RES, 1), np.float32)


def _gt_images(n, seed=7):
    return np.random.default_rng(seed).uniform(0.2, 0.8, (n, RES, RES, 3)).astype(np.float32)


def _masks(n, seed=17):
    return (np.random.default_rng(seed).random((n, RES, RES, 1)) > 0.4).astype(np.float32)


def _tables(respacing=4):
    return build_posterior_tables(
        betas=schedules.named_beta_schedule("linear", 1000, use_scale=True),
        timestep_respacing=str(respacing),
        schedule_jump_params=dict(t_T=respacing, n_sample=1, jump_length=1, jump_n_sample=1))


def _guidance(p, x, t, at=None):
    return classifier_guidance_fn(p["classifier"], p["classes"], 2.0)(x, t, at)


@pytest.fixture(scope="module")
def toy():
    return chip_smoke.toy_adm("cpu"), chip_smoke.toy_classifier("cpu")


def _posterior(toy, **kw):
    model, clf = toy
    ops = {"inpainting": build_functional_operator("inpainting", image_size=RES, mask=ONES),
           "sr_averagepooling": build_functional_operator("sr_averagepooling", image_size=RES,
                                                          deg_scale=4)}
    return PosteriorRestorationService(
        lambda p, x, t: p["model"](x, t), {"model": model, "classifier": clf}, _tables(),
        ops, image_size=RES, max_batch=4, guidance_fn=_guidance, class_cond=True,
        num_classes=4, **kw)


@pytest.fixture(scope="module")
def posterior_service(toy):
    return _posterior(toy)


def test_posterior_service_classes_and_masks(posterior_service):
    svc = posterior_service
    assert svc.class_cond and svc.num_classes == 4 and not svc.is_svd("inpainting")
    gts = _gt_images(2, seed=53)
    out_13 = svc.restore(gts, "sr_averagepooling", [1, 2], input_kind="gt", classes=[1, 3])
    out_11 = svc.restore(gts, "sr_averagepooling", [1, 2], input_kind="gt", classes=[1, 1])
    np.testing.assert_array_equal(out_13[0], out_11[0])  # lane 0 untouched
    assert not np.array_equal(out_13[1], out_11[1])      # the label steers the guidance
    alone = svc.restore(gts[1:2], "sr_averagepooling", [2], input_kind="gt", classes=[3])
    np.testing.assert_array_equal(out_13[1], alone[0])
    m = _masks(2, seed=59)
    out_ab = svc.restore(gts, "inpainting", [3, 4], input_kind="gt", ctxs=m, classes=[1, 2])
    out_aa = svc.restore(gts, "inpainting", [3, 4], input_kind="gt",
                         ctxs=np.stack([m[0], m[0]]), classes=[1, 2])
    np.testing.assert_array_equal(out_ab[0], out_aa[0])
    assert not np.array_equal(out_ab[1], out_aa[1])
    with pytest.raises(ValueError, match="class-conditional"):
        svc.restore(gts, "sr_averagepooling", [1, 2], input_kind="gt")
    with pytest.raises(ValueError, match="out of range"):
        svc.restore(gts, "sr_averagepooling", [1, 2], input_kind="gt", classes=[1, 4])
    with pytest.raises(ValueError, match="one class label"):
        svc.restore(gts, "sr_averagepooling", [1, 2], input_kind="gt", classes=[1])


def test_posterior_reply_equals_direct_sample_posterior(toy, posterior_service):
    """A padded group (2 requests at max_batch 4) against sample_posterior
    on the same generators (pad lanes: lane 0 and sequence number 0), the
    same labels, A+y and guidance: bit for bit."""
    model, clf = toy
    op = posterior_service._operators["sr_averagepooling"]
    gts, seqs, labels = _gt_images(2, seed=61), [5, 6], [2, 0]
    out = posterior_service.restore(gts, "sr_averagepooling", seqs, input_kind="gt",
                                    classes=labels)
    y = op.A(2.0 * torch.from_numpy(gts) - 1.0)
    y = torch.cat([y, y[:1].expand(2, *y.shape[1:])])
    lanes = seqs + [0, 0]
    x_init = default_noise(image_generators(1234, lanes, STREAM_INIT, "cpu"), (4, RES, RES, 3))
    x, _ = sample_posterior(lambda z, t: model(z, t), x_init, op.Ap(y), op, _tables(),
                            image_generators(1234, lanes, STREAM_SAMPLE, "cpu"),
                            guidance_fn=classifier_guidance_fn(clf, torch.tensor(labels + [0, 0]),
                                                               2.0))
    np.testing.assert_array_equal(out, torch.clamp((x[:2] + 1) / 2, 0, 1).numpy())


def test_posterior_service_rejects_svd_ops(toy):
    with pytest.raises(ValueError, match="functional operators only"):
        PosteriorRestorationService(
            lambda p, x, t: None, {"model": toy[0]}, _tables(),
            {"deblur_gauss": build_svd_operator("deblur_gauss", image_size=RES)},
            image_size=RES)


def _ddpm():
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)
        net = DDPMUNet(ch=32, ch_mult=(1, 2), num_res_blocks=1, attn_resolutions=(16,),
                       resolution=RES).eval()
    betas = schedules.get_beta_schedule("linear", beta_start=1e-4, beta_end=0.02,
                                        num_diffusion_timesteps=100).astype(np.float32)
    return net, build_schedule(betas=betas, t_sampling=4)


def _ddpm_split():
    return (lambda p, x, t: ddpm_split_fns(p["model"])[0](x, t),
            lambda p, cache, x, t: ddpm_split_fns(p["model"])[1](cache, x, t))


def _cached(ops, interval=2, policy="uniform", **kw):
    net, sched = _ddpm()
    return RestorationService(lambda p, x, t: p["model"](x, t), {"model": net}, sched, ops,
                              image_size=RES, max_batch=4, encoder_cache=interval,
                              encoder_cache_policy=policy, split_fns=_ddpm_split(), **kw)


def test_cached_service_invariance_and_masks():
    """The serving invariant through the cached sampler (alone ==
    coalesced; the cached trajectory differs from the exact one), and a
    per-request mask equal to a baked static mask gives the same bits."""
    sr = build_functional_operator("sr_averagepooling", image_size=RES, deg_scale=4)
    cached = _cached({"sr_averagepooling": sr,
                      "inpainting": build_functional_operator("inpainting", image_size=RES,
                                                              mask=ONES)})
    gts = _gt_images(3, seed=31)
    together = cached.restore(gts, "sr_averagepooling", [10, 11, 12], input_kind="gt")
    alone = cached.restore(gts[1:2], "sr_averagepooling", [11], input_kind="gt")
    np.testing.assert_array_equal(together[1], alone[0])
    net, sched = _ddpm()
    exact = RestorationService(lambda p, x, t: p["model"](x, t), {"model": net}, sched,
                               {"sr_averagepooling": sr}, image_size=RES, max_batch=4)
    ref = exact.restore(gts[1:2], "sr_averagepooling", [11], input_kind="gt")
    assert not np.array_equal(ref[0], alone[0])
    m = _masks(1, seed=41)
    static = _cached({"inpainting": build_functional_operator("inpainting", image_size=RES,
                                                              mask=m[0])})
    g = _gt_images(1, seed=43)
    np.testing.assert_array_equal(
        cached.restore(g, "inpainting", [5], input_kind="gt", ctxs=m),
        static.restore(g, "inpainting", [5], input_kind="gt"))


def test_cached_service_construction_validates():
    net, sched = _ddpm()
    ops = {"sr_averagepooling": build_functional_operator("sr_averagepooling", image_size=RES,
                                                          deg_scale=4)}
    mf = lambda p, x, t: p["model"](x, t)
    with pytest.raises(ValueError, match="split_fns"):
        RestorationService(mf, {"model": net}, sched, ops, image_size=RES, encoder_cache=2)
    with pytest.raises(ValueError, match="SVD"):
        RestorationService(mf, {"model": net}, sched,
                           dict(ops, deblur_gauss=build_svd_operator("deblur_gauss",
                                                                     image_size=RES)),
                           image_size=RES, encoder_cache=2, split_fns=_ddpm_split())
    with pytest.raises(ValueError, match="host-driven"):
        RestorationService(mf, {"model": net}, sched, ops, image_size=RES, loop="scan",
                           encoder_cache=2, split_fns=_ddpm_split())


def test_posterior_cached_service_classes_and_invariance(toy):
    """The posterior service through the cached sampler (end_dense): labels
    and guidance still ride params, lanes stay independent, a label changes
    the output and the cached trajectory differs from the exact one."""
    split = (lambda p, x, t: adm_split_fns(p["model"])[0](x, t),
             lambda p, cache, x, t: adm_split_fns(p["model"])[1](cache, x, t))
    cached = _posterior(toy, encoder_cache=2, encoder_cache_policy="end_dense",
                        split_fns=split)
    exact = _posterior(toy)
    gts = _gt_images(2, seed=61)
    pair = cached.restore(gts, "sr_averagepooling", [1, 2], input_kind="gt", classes=[1, 3])
    alone = cached.restore(gts[:1], "sr_averagepooling", [1], input_kind="gt", classes=[1])
    np.testing.assert_array_equal(pair[0], alone[0])
    other = cached.restore(gts[:1], "sr_averagepooling", [1], input_kind="gt", classes=[0])
    assert not np.array_equal(other[0], alone[0])
    ref = exact.restore(gts[:1], "sr_averagepooling", [1], input_kind="gt", classes=[1])
    assert not np.array_equal(ref[0], alone[0])


@pytest.fixture(scope="module")
def svd_service():
    net, sched = _ddpm()
    ops = {"deblur_gauss": build_svd_operator("deblur_gauss", image_size=RES),
           "cs_walshhadamard": build_svd_operator("cs_walshhadamard", image_size=RES,
                                                  deg_scale=0.25, seed=7),
           "colorization": build_svd_operator("colorization", image_size=RES)}
    return RestorationService(lambda p, x, t: p["model"](x, t), {"model": net}, sched, ops,
                              image_size=RES, max_batch=4)


def test_svd_service_shapes_and_invariance(svd_service):
    svc = svd_service
    assert all(svc.is_svd(t) for t in svc.tasks) and svc.ctx_tasks == ()
    assert svc.y_shape("deblur_gauss") == (RES, RES, 3)
    assert svc.y_shape("colorization") == (RES, RES, 1)
    assert svc.y_shape("cs_walshhadamard") is None
    gts = _gt_images(3, seed=41)
    out = svc.restore(gts, "deblur_gauss", [1, 2, 3], input_kind="gt")
    assert out.shape == (3, RES, RES, 3) and np.isfinite(out).all()
    alone = svc.restore(gts[1:2], "deblur_gauss", [2], input_kind="gt")
    np.testing.assert_array_equal(out[1], alone[0])
    assert svc.restore(gts[:1], "cs_walshhadamard", [4], input_kind="gt").shape == (1, RES,
                                                                                    RES, 3)


def test_svd_service_degraded_uploads(svd_service):
    """An image-shaped measurement uploaded directly (the blurred RGB, the
    grayscale) against the gt path that computes y on the device."""
    svc = svd_service
    gts = _gt_images(2, seed=43)
    xg = torch.from_numpy(2.0 * gts - 1.0)
    y = svc._operators["deblur_gauss"].A(_nhwc_to_vec(xg)).numpy()
    y_img = np.transpose(y.reshape(2, 3, RES, RES), (0, 2, 3, 1))
    np.testing.assert_allclose(
        svc.restore(((y_img + 1) / 2).astype(np.float32), "deblur_gauss", [9, 10],
                    input_kind="degraded"),
        svc.restore(gts, "deblur_gauss", [9, 10], input_kind="gt"), atol=1e-5)
    yg = svc._operators["colorization"].A(_nhwc_to_vec(xg)).numpy().reshape(2, RES, RES, 1)
    np.testing.assert_allclose(
        svc.restore(((yg + 1) / 2).astype(np.float32), "colorization", [11, 12],
                    input_kind="degraded"),
        svc.restore(gts, "colorization", [11, 12], input_kind="gt"), atol=1e-5)
    with pytest.raises(ValueError, match="not an image"):
        svc.restore(gts, "cs_walshhadamard", [0, 1], input_kind="degraded")
    with pytest.raises(ValueError, match="per-request masks"):
        svc.restore(gts, "deblur_gauss", [0, 1], input_kind="gt", ctxs=_masks(2))
