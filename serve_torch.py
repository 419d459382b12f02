#!/usr/bin/env python
"""Online restoration server of the PyTorch/CUDA port (serve.py's flags
plus --device).

Loads a model as main_torch.py (--config: simplified and SVD-mode tasks on
the DDPM or ADM UNet) or as hq_main_torch.py (--hq_conf: the respaced
posterior loop on the ADM UNet, per-request ?class=N for class-conditional
models, classifier guidance where the conf sets classifier_scale > 0) and
serves DDNM restoration over HTTP with micro-batching
(ddnm_tpu_torch/server.py). The service runs on the card unless --device
cpu is given; a guided --hq_conf service sets cudnn.deterministic, so that
the guidance gradient (cuDNN's backward) gives the same bits in any group.
On the card:

  python serve_torch.py --config configs/celeba_hq.yml \\
      --ckpt tests/fixtures/flag_ddpm256.pt --dtype bfloat16 \\
      --degs sr_averagepooling,inpainting --deg_scale 4 --port 8000

  curl -X POST --data-binary @low_res.png \\
      "http://localhost:8000/restore?deg=sr_averagepooling" -o restored.png

On the CPU, at a toy size:

  python serve_torch.py --config configs/toy32.yml \\
      --ckpt tests/fixtures/toy_ddpm32.pt --degs sr_averagepooling \\
      --t_sampling 4 --max_batch 2 --device cpu --port 8000

SIGTERM drains (pending requests get 503s) and exits 0; SIGHUP rebuilds
the service from --ckpt and swaps its weights in between two groups.
--dp N shards each group over N devices (the first N cards, or N shards
of the CPU with --device cpu; --max_batch must divide by N; the shards
launch in turn from the worker thread, each a graph replay on its own
card's stream). --loop picks the samplers'
driver, as serve.py's does: auto (the default) and scan replay one CUDA
graph of a group's whole trajectory a task (captured by the warm-up or the
first group), one a shard under --dp; host runs the eager loop. With
--encoder_cache > 1 auto is host, and scan raises.
"""

from __future__ import annotations

import argparse
import logging
import sys
import threading
import time
from pathlib import Path

REPO_ROOT = Path(__file__).resolve().parent
if str(REPO_ROOT) not in sys.path:
    sys.path.insert(0, str(REPO_ROOT))

from ddnm_tpu_torch.runtime import device_arg  # noqa: E402

SIMPLIFIED_DEGS = ("colorization", "denoising", "sr_averagepooling",
                   "inpainting", "sr_color", "mask_color_sr", "diy")
SVD_DEGS = ("cs_walshhadamard", "cs_blockbased", "inpainting", "denoising",
            "colorization", "sr_averagepooling", "sr_bicubic", "deblur_uni",
            "deblur_gauss", "deblur_aniso")
HQ_DEGS = ("sr_averagepooling", "colorization", "sr_color", "inpainting",
           "mask_color_sr")


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="DDNM restoration server (PyTorch/CUDA port)")
    p.add_argument("--config", type=str, default=None,
                   help="main-pipeline config (simplified/SVD serving)")
    p.add_argument("--hq_conf", type=str, default=None,
                   help="hq-pipeline config (configs/hq/*.yml): serve the "
                        "respaced posterior DDNM loop instead; class-"
                        "conditional models take per-request ?class=N")
    p.add_argument("--classifier_ckpt", type=str, default=None,
                   help="(--hq_conf) classifier weights for guidance when "
                        "the conf sets classifier_scale > 0")
    p.add_argument("--ckpt", type=str, default=None,
                   help="torch checkpoint (.pt) to load")
    p.add_argument("--random_init", action="store_true",
                   help="random weights from --seed (smoke mode; no checkpoint)")
    p.add_argument("--degs", type=str, default="sr_averagepooling",
                   help=f"comma-separated tasks from {SIMPLIFIED_DEGS}")
    p.add_argument("--svd_degs", type=str, default="",
                   help="comma-separated SVD-mode tasks from "
                        f"{SVD_DEGS}; served under their own names "
                        "(a name cannot appear in both lists)")
    p.add_argument("--deg_scale", type=float, default=4.0)
    p.add_argument("--sigma_y", type=float, default=0.0)
    p.add_argument("--eta", type=float, default=0.85)
    p.add_argument("--seed", type=int, default=1234)
    p.add_argument("--mask_path", type=str, default=None,
                   help="mask for the inpainting-family tasks")
    p.add_argument("--dtype", type=str, default="float32",
                   choices=["float32", "bfloat16"])
    p.add_argument("--t_sampling", type=int, default=None)
    p.add_argument("--dp", type=int, default=1,
                   help="shard each served batch over this many chips "
                        "(1-D data mesh; max_batch must divide by it)")
    p.add_argument("--host", type=str, default="127.0.0.1")
    p.add_argument("--port", type=int, default=8000)
    p.add_argument("--max_batch", type=int, default=8)
    p.add_argument("--max_wait_ms", type=float, default=20.0)
    p.add_argument("--queue_size", type=int, default=64,
                   help="pending-request cap; submits beyond it shed with "
                        "503 'queue full' (backpressure)")
    p.add_argument("--request_timeout_s", type=float, default=600.0,
                   help="handler wait budget; timed-out requests are "
                        "cancelled before device work")
    p.add_argument("--encoder_cache", type=int, default=1,
                   help=">1: reuse UNet encoder features across this many "
                        "model calls (approximate; ddnm_tpu_torch/sampling/accel.py). "
                        "Simplified and posterior tasks only; SVD-mode tasks need a "
                        "separate exact service")
    p.add_argument("--encoder_cache_policy", type=str, default="uniform",
                   choices=["uniform", "end_dense"],
                   help="key-step placement for --encoder_cache")
    p.add_argument("--loop", type=str, default="auto",
                   choices=("auto", "host", "scan"),
                   help="the trajectory's loop driver: auto and scan replay one CUDA "
                        "graph a task and group shape (one a shard under --dp), host runs "
                        "the eager loop; auto is host with --encoder_cache > 1, where scan "
                        "raises (as serve.py refuses scan with the cache)")
    p.add_argument("--no_warmup", action="store_true")
    p.add_argument("--device", type=device_arg, default="cuda",
                   help="cuda (default; raises without a card) or cpu")
    return p.parse_args(argv)


def _data_mesh(ns, dev, mesh=None):
    """The service's mesh: `mesh` as given, else --dp devices of the
    service's kind (serve.py), else None."""
    if mesh is not None or getattr(ns, "dp", 1) <= 1:
        return mesh
    from ddnm_tpu_torch.parallel import make_mesh

    return make_mesh(ns.dp, device=dev)


def _tasks(spec: str) -> list[str]:
    return [d.strip() for d in spec.split(",") if d.strip()]


def build_hq_service(ns, mesh=None):
    """A PosteriorRestorationService from an hq config: hq_main_torch.py's
    single-tile flow online (ADM UNet with the learned-range head, respaced
    posterior DDNM with time-travel, optional classifier guidance,
    per-request masks and class labels). `mesh` overrides --dp's."""
    import numpy as np
    import torch

    from hq_main_torch import build_adm_from_hq, build_classifier_from_hq
    from ddnm_tpu_torch.config import load_hq_config
    from ddnm_tpu_torch.data.io import load_mask
    from ddnm_tpu_torch.models import cast_torso, classifier_guidance_fn
    from ddnm_tpu_torch.models.unet_adm import init_like_flax
    from ddnm_tpu_torch.operators import build_functional_operator
    from ddnm_tpu_torch.runner import load_checkpoint
    from ddnm_tpu_torch.runtime import resolve_device
    from ddnm_tpu_torch.sampling.posterior import build_posterior_tables
    from ddnm_tpu_torch.schedules import named_beta_schedule
    from ddnm_tpu_torch.server import PosteriorRestorationService

    dev = resolve_device(ns.device)
    cfg_path = Path(ns.hq_conf)
    if not cfg_path.exists():
        cfg_path = REPO_ROOT / ns.hq_conf
    conf = load_hq_config(cfg_path)
    size = int(conf.image_size or 256)
    class_cond = bool(conf.class_cond)

    model = build_adm_from_hq(conf, dev)
    ckpt = ns.ckpt or conf.model_path
    if ckpt and Path(ckpt).exists():
        load_checkpoint(model, ckpt)
    elif ns.random_init:
        logging.warning("random-init hq model — smoke mode")
        init_like_flax(model, ns.seed)
    else:
        raise SystemExit("pass --ckpt (torch .pt) or --random_init")
    model = model.eval().requires_grad_(False)
    if ns.dtype == "bfloat16":
        cast_torso(model, torch.bfloat16)

    run_params = {"model": model}
    if class_cond:
        def model_fn(p, x, t):
            return p["model"](x, t, p["classes"])
    else:
        def model_fn(p, x, t):
            return p["model"](x, t)

    guidance_fn = None
    cckpt = ns.classifier_ckpt or conf.classifier_path
    if class_cond and float(conf.classifier_scale or 0) > 0:
        clf = build_classifier_from_hq(conf, dev)
        if cckpt and Path(cckpt).exists():
            load_checkpoint(clf, cckpt)
        elif ns.random_init:
            init_like_flax(clf, ns.seed)
        else:
            raise SystemExit(
                f"classifier_scale > 0 but no classifier checkpoint at "
                f"{cckpt!r}; pass --classifier_ckpt or --random_init")
        clf = clf.eval().requires_grad_(False)
        if ns.dtype == "bfloat16":
            cast_torso(clf, torch.bfloat16)
        run_params["classifier"] = clf
        scale = float(conf.classifier_scale)
        # cuDNN's default backward-data algorithms are not deterministic on
        # the card (the guidance gradient's bits move between two calls), which
        # would break the service's contract that a request's reply does not
        # depend on the group it rode in
        torch.backends.cudnn.deterministic = True

        # per-request labels ride p["classes"] (server.py)
        def guidance_fn(p, x, t, at=None):
            return classifier_guidance_fn(p["classifier"], p["classes"], scale)(x, t, at)

    tables = build_posterior_tables(
        betas=named_beta_schedule(str(conf.noise_schedule or "linear"),
                                  int(conf.diffusion_steps or 1000), use_scale=True),
        timestep_respacing=str(conf.timestep_respacing or "100"),
        sigma_y=ns.sigma_y,
        schedule_jump_params=dict(conf.schedule_jump_params or {}),
        time_shift=(1 if conf.inpa_inj_time_shift is None else int(conf.inpa_inj_time_shift)),
    )

    mask = load_mask(ns.mask_path) if ns.mask_path else None
    operators = {}
    require_ctx = []
    for deg in _tasks(ns.degs):
        if deg not in HQ_DEGS:
            raise SystemExit(f"unknown hq task {deg!r}; choose from {HQ_DEGS}")
        needs_mask = deg in ("inpainting", "mask_color_sr")
        op_mask = mask
        if needs_mask and op_mask is None:
            # no --mask_path: no meaningful static mask, so every request must
            # bring its own (RGBA upload); a maskless request would otherwise
            # be a silent no-op restore under all-ones
            op_mask = np.ones((size, size, 1), np.float32)
            require_ctx.append(deg)
        operators[deg] = build_functional_operator(
            deg, image_size=size, deg_scale=ns.deg_scale,
            mask=op_mask if needs_mask else None, device=dev)
    split_fns = None
    if getattr(ns, "encoder_cache", 1) > 1:
        # the ADM's encode / decode halves over the same params model_fn
        # takes: per-request classes keep riding p["classes"]
        def _cls(p):
            return p["classes"] if class_cond else None

        def encode_fn(p, x, t):
            return p["model"](x, t, _cls(p), mode="encode")

        def decode_fn(p, cache, x, t):
            return p["model"](x, t, _cls(p), mode="decode", cache=cache)

        split_fns = (encode_fn, decode_fn)
    return PosteriorRestorationService(
        model_fn, run_params, tables, operators, image_size=size,
        max_batch=ns.max_batch, base_seed=ns.seed, mesh=_data_mesh(ns, dev, mesh),
        guidance_fn=guidance_fn, class_cond=class_cond,
        num_classes=1000 if class_cond else None, require_ctx=require_ctx,
        encoder_cache=getattr(ns, "encoder_cache", 1),
        encoder_cache_policy=getattr(ns, "encoder_cache_policy", "uniform"),
        split_fns=split_fns, loop=getattr(ns, "loop", "auto"),
    )


def build_service(ns, mesh=None):
    """A RestorationService from main_torch.py-style config / ckpt flags.
    `mesh` overrides --dp's (a mesh that repeats a card, say)."""
    import numpy as np

    from ddnm_tpu_torch.config import load_config
    from ddnm_tpu_torch.data.io import load_mask
    from ddnm_tpu_torch.operators import build_functional_operator, build_svd_operator
    from ddnm_tpu_torch.runner import RunArgs, Runner
    from ddnm_tpu_torch.server import RestorationService

    cfg_path = Path(ns.config)
    if not cfg_path.exists():
        cfg_path = REPO_ROOT / "configs" / ns.config
    config = load_config(cfg_path)
    if ns.t_sampling is not None:
        config.time_travel.T_sampling = ns.t_sampling

    args = RunArgs(
        config=str(cfg_path), simplified=True, seed=ns.seed,
        ckpt=ns.ckpt, random_init=ns.random_init, dtype=ns.dtype,
        batch_size=ns.max_batch, eta=ns.eta, sigma_y=ns.sigma_y,
        device=ns.device, loop=ns.loop,
    )
    runner = Runner(args, config)
    dev = runner.device
    run_params = {"model": runner.build_model()}

    def model_fn(p, x, t):
        return runner.model_fn(p["model"])(x, t)

    size = config.data.image_size
    mask = load_mask(ns.mask_path) if ns.mask_path else None
    operators = {}
    require_ctx = []
    for deg in _tasks(ns.degs):
        if deg not in SIMPLIFIED_DEGS:
            raise SystemExit(f"unknown task {deg!r}; choose from {SIMPLIFIED_DEGS}")
        needs_mask = deg in ("inpainting", "mask_color_sr", "diy")
        op_mask = mask
        if needs_mask and op_mask is None:
            # no --mask_path: every request must bring its own (RGBA upload)
            op_mask = np.ones((size, size, 1), np.float32)
            require_ctx.append(deg)
        operators[deg] = build_functional_operator(
            deg, image_size=size, deg_scale=ns.deg_scale,
            mask=op_mask if needs_mask else None, device=dev)
    for deg in _tasks(ns.svd_degs):
        if deg not in SVD_DEGS:
            raise SystemExit(f"unknown SVD task {deg!r}; choose from {SVD_DEGS}")
        if deg in operators:
            raise SystemExit(
                f"{deg!r} appears in both --degs and --svd_degs; a served "
                "name is bound to exactly one sampler mode")
        needs_mask = deg == "inpainting"
        svd_mask = mask
        if needs_mask and svd_mask is None:
            svd_mask = np.ones((size, size), np.float32)
        operators[deg] = build_svd_operator(
            deg, image_size=size, deg_scale=ns.deg_scale, seed=ns.seed,
            mask=svd_mask if needs_mask else None, device=dev)
    split_fns = None
    if getattr(ns, "encoder_cache", 1) > 1:
        if ns.svd_degs.strip():
            raise SystemExit(
                "--encoder_cache has no SVD-mode sampler; serve --svd_degs "
                "tasks from a separate exact service")

        # the runner's family-correct encode / decode halves of p["model"]
        def encode_fn(p, x, t):
            return runner._split_fns(p["model"])[0](x, t)

        def decode_fn(p, cache, x, t):
            return runner._split_fns(p["model"])[1](cache, x, t)

        split_fns = (encode_fn, decode_fn)
    return RestorationService(
        model_fn, run_params, runner.sched, operators,
        image_size=size, max_batch=ns.max_batch, eta=ns.eta,
        sigma_y=ns.sigma_y, base_seed=ns.seed, mesh=_data_mesh(ns, dev, mesh),
        require_ctx=require_ctx,
        encoder_cache=getattr(ns, "encoder_cache", 1),
        encoder_cache_policy=getattr(ns, "encoder_cache_policy", "uniform"),
        split_fns=split_fns, loop=getattr(ns, "loop", "auto"),
    )


def main(argv=None):
    ns = parse_args(argv)
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s - %(levelname)s - %(message)s")

    from ddnm_tpu_torch.runtime import resolve_device
    from ddnm_tpu_torch.server import RestorationServer

    if ns.hq_conf and ns.config:
        raise SystemExit("pass --config OR --hq_conf, not both")
    if not ns.hq_conf and not ns.config:
        raise SystemExit("pass --config (main pipeline) or --hq_conf (hq)")
    if ns.hq_conf and ns.svd_degs:
        raise SystemExit("--svd_degs is a main-pipeline option")
    resolve_device(ns.device)  # fail before building anything
    from ddnm_tpu_torch.parallel import multihost

    if multihost.maybe_init_distributed():  # a multi-process launch: one card a rank
        ns.device = str(multihost.local_device(ns.device))
    service = build_hq_service(ns) if ns.hq_conf else build_service(ns)
    if not ns.no_warmup:
        logging.info("warming up %s ...", service.tasks)
        t0 = time.time()
        service.warmup()
        logging.info("warmup done in %.1fs", time.time() - t0)
    server = RestorationServer(
        service, host=ns.host, port=ns.port, max_wait_ms=ns.max_wait_ms,
        queue_size=ns.queue_size, request_timeout_s=ns.request_timeout_s,
    )
    server.start()
    logging.info("serving %s on http://%s:%d (max_batch=%d)",
                 service.tasks, *server.address, service.max_batch)

    # graceful drain on SIGTERM (the supervisor's stop signal): pending
    # requests get explicit 503s instead of connection resets; SIGHUP
    # rebuilds the weights from --ckpt and swaps them in between groups
    import signal

    stop_requested = threading.Event()
    reload_requested = threading.Event()
    signal.signal(signal.SIGTERM, lambda *_: stop_requested.set())
    signal.signal(signal.SIGHUP, lambda *_: reload_requested.set())
    try:
        while not stop_requested.wait(timeout=1.0):
            if reload_requested.is_set():
                reload_requested.clear()
                if not ns.ckpt:
                    logging.warning("SIGHUP: no --ckpt to reload from")
                    continue
                try:
                    t0 = time.time()
                    fresh = build_hq_service(ns) if ns.hq_conf else build_service(ns)
                    service.swap_params(fresh._params)
                    logging.info("SIGHUP: reloaded %s in %.1fs (applied before the "
                                 "next group)", ns.ckpt, time.time() - t0)
                except Exception:
                    logging.exception("SIGHUP reload failed; serving the "
                                      "previous weights")
    except KeyboardInterrupt:
        pass
    logging.info("shutting down")
    server.stop()


if __name__ == "__main__":
    main()
