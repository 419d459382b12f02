#!/usr/bin/env python
"""hq pipeline CLI of the PyTorch/CUDA port: arbitrary-size DDNM
restoration with Mask-Shift tiling on the ADM UNet, with classifier
guidance where the config asks for it (class_cond and classifier_scale > 0:
the ADM classifier from --classifier_ckpt or the config's classifier_path,
or random weights from --seed under --random_init).

Takes hq_main.py's flags plus --device (default cuda; without a card it
raises unless --device cpu is given). Single-image mode restores --path_y
(with --resize_y it is the low-resolution measurement); sweep mode runs
the conf's data.eval dataset (or --gt_path + --mask_path_dir) and writes
the srs / lrs / gts / gt_keep_masks tree with PSNR and SSIM. The tile is
the config's image_size and the stride half of it. Example on the card:

  python hq_main_torch.py --config configs/hq/inet256.yml --path_y in.png \\
      --deg sr_averagepooling --scale 4 --resize_y --class 950 \\
      --random_init --dtype bfloat16 -i exp/hq_out_torch

Not ported yet (each raises NotImplementedError): --solver multistep,
--encoder_cache > 1, --sp / --dp > 1 and --resume.
"""

from __future__ import annotations

import argparse
import logging
import sys
import time
from pathlib import Path

REPO_ROOT = Path(__file__).resolve().parent
if str(REPO_ROOT) not in sys.path:
    sys.path.insert(0, str(REPO_ROOT))


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="DDNM hq (Mask-Shift) restoration "
                                            "(PyTorch/CUDA port)")
    p.add_argument("--config", type=str, default="configs/hq/inet256.yml")
    p.add_argument("--deg", type=str, required=True,
                   help="sr_averagepooling | inpainting | mask_color_sr | colorization | sr_color")
    p.add_argument("--sigma_y", type=float, default=0.0)
    p.add_argument("-i", "--image_folder", type=str, default="exp/hq_out")
    p.add_argument("--scale", type=int, default=4)
    p.add_argument("--resize_y", action="store_true",
                   help="treat --path_y as the low-res measurement and upsample it")
    p.add_argument("--path_y", type=str, default=None, help="input image (single-image mode)")
    p.add_argument("--class", dest="class_label", type=int, default=None)
    p.add_argument("--mask_path", type=str, default=None)
    p.add_argument("--gt_path", type=str, default=None,
                   help="directory of ground-truth images (sweep mode; overrides the "
                        "conf's data.eval entry)")
    p.add_argument("--mask_path_dir", type=str, default=None,
                   help="directory of keep-masks paired with --gt_path by file name")
    p.add_argument("--max_len", type=int, default=None,
                   help="cap the number of gt/mask pairs in sweep mode")
    p.add_argument("--sweep_batch", type=int, default=1,
                   help="batch this many single-tile sweep images into one sampler call "
                        "(equal per image to the per-image sweep)")
    p.add_argument("--seed", type=int, default=1234)
    p.add_argument("--ckpt", type=str, default=None, help="torch checkpoint (.pt) to load")
    p.add_argument("--classifier_ckpt", type=str, default=None,
                   help="torch checkpoint (.pt) of the guidance classifier (default: the "
                        "config's classifier_path)")
    p.add_argument("--random_init", action="store_true",
                   help="random weights from --seed (no checkpoint)")
    p.add_argument("--dtype", type=str, default="float32", choices=["float32", "bfloat16"],
                   help="model torso dtype (GroupNorm stays fp32). The config's use_fp16 "
                        "is read and ignored, as hq_main.py ignores it: the dtype comes "
                        "from this flag")
    p.add_argument("--parallel_tiles", action="store_true",
                   help="batch independent wavefront tiles into one sampler call; "
                        "implies --fresh_tile_init")
    p.add_argument("--fresh_tile_init", action="store_true",
                   help="start every tile from its own noise instead of the reference's "
                        "carried state")
    p.add_argument("--solver", type=str, default="ddim", choices=["ddim", "multistep"],
                   help="multistep is not ported yet: raises")
    p.add_argument("--encoder_cache", type=int, default=1,
                   help="> 1 is not ported yet: raises")
    p.add_argument("--sp", type=int, default=1, help="> 1 is not ported yet: raises")
    p.add_argument("--dp", type=int, default=1, help="> 1 is not ported yet: raises")
    p.add_argument("--resume", action="store_true", help="not ported yet: raises")
    p.add_argument("--device", type=str, default="cuda", choices=["cuda", "cpu"],
                   help="cuda (default; raises without a card) or cpu")
    return p.parse_args(argv)


def build_adm_from_hq(conf, device="cpu"):
    """ADM UNet from a flat hq config (channel_mult by size as the
    reference's create_model), built on `device` with torch's default
    init (the caller loads or draws the weights)."""
    import torch

    from ddnm_tpu_torch.models import ADMUNet
    from ddnm_tpu_torch.models.unet_adm import parse_attention_resolutions, parse_channel_mult

    size = int(conf.image_size or 256)
    with torch.device(device):
        return ADMUNet(
            image_size=size,
            model_channels=int(conf.num_channels),
            num_res_blocks=int(conf.num_res_blocks),
            attention_resolutions=parse_attention_resolutions(conf.attention_resolutions, size),
            channel_mult=parse_channel_mult(str(conf.channel_mult or ""), size),
            num_heads=int(conf.num_heads or 4),
            num_head_channels=int(conf.num_head_channels or 64),
            use_scale_shift_norm=bool(conf.use_scale_shift_norm),
            resblock_updown=bool(conf.resblock_updown),
            use_new_attention_order=bool(conf.use_new_attention_order),
            out_channels=6 if conf.learn_sigma else 3,
            num_classes=1000 if conf.class_cond else None,
        )


def build_classifier_from_hq(conf, device="cpu"):
    """The ADM classifier of a flat hq config (hq_main.py
    build_classifier_from_hq): the reference's create_classifier sizes
    (channel_mult by image size), or the config's classifier_channel_mult
    for toy and test sizes; built on `device` with torch's default init."""
    import torch

    from ddnm_tpu_torch.models import ADMClassifier

    size = int(conf.image_size or 256)
    with torch.device(device):
        if not conf.classifier_channel_mult:
            return ADMClassifier.from_config(conf, image_size=size)
        return ADMClassifier(
            image_size=size,
            model_channels=int(conf.classifier_width),
            num_res_blocks=int(conf.classifier_depth),
            attention_resolutions=tuple(
                size // int(r) for r in str(conf.classifier_attention_resolutions).split(",")),
            channel_mult=tuple(int(m) for m in str(conf.classifier_channel_mult).split(",")),
            use_scale_shift_norm=bool(conf.classifier_use_scale_shift_norm),
            resblock_updown=bool(conf.classifier_resblock_updown),
            pool=str(conf.classifier_pool),
        )


def _not_ported(ns, conf):
    if ns.solver == "multistep":
        raise NotImplementedError("--solver multistep is not ported yet (ROADMAP.md "
                                  "Queue 1 D: solvers and acceleration)")
    if ns.encoder_cache > 1:
        raise NotImplementedError("--encoder_cache > 1 is not ported yet (ROADMAP.md "
                                  "Queue 1 D: solvers and acceleration)")
    if ns.sp > 1 or ns.dp > 1:
        raise NotImplementedError("--sp / --dp > 1 (the device mesh) are not ported yet "
                                  "(ROADMAP.md Queue 1 F: multi-device and serving)")
    if ns.resume:
        raise NotImplementedError("--resume is not ported yet (ROADMAP.md Queue 1 C: the "
                                  "rest of the hq CLI)")


def main(argv=None):
    ns = parse_args(argv)
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s - %(levelname)s - %(message)s")
    logger = logging.getLogger("ddnm_tpu_torch")

    import numpy as np
    import torch

    from ddnm_tpu_torch.config import load_hq_config
    from ddnm_tpu_torch.data.io import load_image, load_mask, save_image
    from ddnm_tpu_torch.data.metrics import ssim
    from ddnm_tpu_torch.models import cast_torso, classifier_guidance_fn
    from ddnm_tpu_torch.models.unet_adm import init_like_flax
    from ddnm_tpu_torch.runner import load_checkpoint
    from ddnm_tpu_torch.runtime import resolve_device
    from ddnm_tpu_torch.sampling.posterior import build_posterior_tables, n_model_calls
    from ddnm_tpu_torch.schedules import named_beta_schedule
    from ddnm_tpu_torch.tiling import batched_tile_sample, mask_shift_sample

    dev = resolve_device(ns.device)  # fail before touching anything
    cfg_path = Path(ns.config)
    if not cfg_path.exists():
        cfg_path = REPO_ROOT / ns.config
    conf = load_hq_config(cfg_path)
    _not_ported(ns, conf)

    size = int(conf.image_size or 256)
    tile, stride = size, size // 2  # the model's native tile, 2:1 overlap
    model = build_adm_from_hq(conf, dev)
    ckpt = ns.ckpt or conf.model_path
    if ckpt and Path(ckpt).exists():
        logger.info("loading checkpoint %s", ckpt)
        load_checkpoint(model, ckpt)
    elif ns.random_init:
        logger.warning("random-init model: smoke mode")
        init_like_flax(model, ns.seed)
    else:
        raise FileNotFoundError("pass --ckpt (torch .pt) or --random_init")
    model = model.eval()
    if ns.dtype == "bfloat16":
        cast_torso(model, torch.bfloat16)

    if conf.class_cond:
        label = ns.class_label if ns.class_label is not None else 0

        def model_fn(x, t):
            # batch-agnostic: wavefront groups vary in size
            return model(x, t, torch.full((x.shape[0],), label, dtype=torch.long,
                                          device=x.device))
    else:
        label = None

        def model_fn(x, t):
            return model(x, t)

    # classifier guidance (hq_main.py:241-262): its weights from the seed of
    # the model's under --random_init, as the JAX CLI draws both from one key
    guidance_fn = None
    cckpt = ns.classifier_ckpt or conf.classifier_path
    if conf.class_cond and float(conf.classifier_scale or 0) > 0:
        classifier = build_classifier_from_hq(conf, dev)
        if cckpt and Path(cckpt).exists():
            logger.info("loading classifier checkpoint %s", cckpt)
            load_checkpoint(classifier, cckpt)
        elif ns.random_init:
            init_like_flax(classifier, ns.seed)
        else:
            raise FileNotFoundError(
                "classifier_scale > 0 but no classifier checkpoint at "
                f"{cckpt!r}; pass --classifier_ckpt or --random_init")
        if ns.dtype == "bfloat16":
            cast_torso(classifier, torch.bfloat16)
        guidance_fn = classifier_guidance_fn(classifier, label,
                                             float(conf.classifier_scale))

    tables = build_posterior_tables(
        betas=named_beta_schedule(str(conf.noise_schedule or "linear"),
                                  int(conf.diffusion_steps or 1000), use_scale=True),
        timestep_respacing=str(conf.timestep_respacing or "100"),
        sigma_y=ns.sigma_y,
        schedule_jump_params=dict(conf.schedule_jump_params or {}),
        time_shift=(1 if conf.inpa_inj_time_shift is None else int(conf.inpa_inj_time_shift)),
    )
    calls = n_model_calls(tables)
    out_dir = Path(ns.image_folder)
    to01 = lambda a: np.clip((a + 1.0) / 2.0, 0.0, 1.0)
    tile_init = "fresh" if (ns.parallel_tiles or ns.fresh_tile_init) else "carry"

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    tiles_done = []

    def run_one(gt, mask, image_index, tiles_dir):
        """One Mask-Shift restoration; the tiling output dict."""
        tiles_dir.mkdir(parents=True, exist_ok=True)

        def progress(t, x0_np):
            i, j = t.index
            save_image(to01(x0_np[0]), tiles_dir / f"{i}_{j}.png")
            tiles_done.append(t.index)

        return mask_shift_sample(
            model_fn, gt, ns.deg, tables, ns.seed, image_index=image_index,
            scale=ns.scale, resize_y=ns.resize_y, mask=mask, parallel=ns.parallel_tiles,
            progress_fn=progress, tile_init=tile_init, tile=tile, stride=stride,
            guidance_fn=guidance_fn, device=dev)

    # --- sweep mode (conf-declared eval dataset or --gt_path) -------------
    # an explicit --path_y always means single-image mode
    eval_ds = None
    data_eval = conf.pget("data.eval")
    if isinstance(data_eval, dict) and data_eval and ns.gt_path is None and ns.path_y is None:
        eval_ds = dict(data_eval[next(iter(data_eval))] or {})
    if ns.gt_path is not None:
        if ns.mask_path_dir is None:
            raise SystemExit("--gt_path needs --mask_path_dir (filename-paired)")
        eval_ds = {"gt_path": ns.gt_path, "mask_path": ns.mask_path_dir,
                   "image_size": size, "max_len": ns.max_len}

    if eval_ds is not None:
        from ddnm_tpu_torch.data.inpaint_pairs import InpaintPairs

        pair_size = int(eval_ds.get("image_size") or size)
        pairs = InpaintPairs(
            eval_ds["gt_path"], eval_ds["mask_path"], image_size=pair_size,
            max_len=ns.max_len if ns.max_len is not None else eval_ds.get("max_len"))
        paths = dict(eval_ds.get("paths") or {})
        tree = {k: Path(paths.get(k) or out_dir / k)
                for k in ("srs", "lrs", "gts", "gt_keep_masks")}
        for p in tree.values():
            p.mkdir(parents=True, exist_ok=True)
        psnrs, ssims = [], []

        def write_outputs(idx, name, gt, mask, final, apy):
            final01, gt01 = to01(final), to01(gt)
            save_image(final01, tree["srs"] / name)
            save_image(to01(apy), tree["lrs"] / name)
            save_image(gt01, tree["gts"] / name)
            save_image(mask, tree["gt_keep_masks"] / name)
            mse = float(np.mean((final01 - gt01) ** 2))
            p = 10.0 * np.log10(1.0 / max(mse, 1e-12))
            s = float(ssim(torch.from_numpy(final01[None]), torch.from_numpy(gt01[None]))[0])
            psnrs.append(p)
            ssims.append(s)
            logger.info("[%d/%d] %s PSNR %.2f SSIM %.3f", idx + 1, len(pairs), name, p, s)

        sweep_batch = max(1, int(ns.sweep_batch))
        if sweep_batch > 1 and (ns.resize_y or pair_size != tile):
            logger.warning("--sweep_batch needs single-tile %dpx canvases: falling back "
                           "to the per-image sweep", tile)
            sweep_batch = 1
        items = list(pairs)
        t0 = time.perf_counter()
        for c0 in range(0, len(items), sweep_batch):
            chunk = items[c0:c0 + sweep_batch]
            masks = [it["gt_keep_mask"][..., 0] for it in chunk]
            if sweep_batch > 1:
                out = batched_tile_sample(
                    model_fn, np.stack([it["GT"] for it in chunk]), ns.deg, tables,
                    ns.seed, range(c0, c0 + len(chunk)), scale=ns.scale, masks=masks,
                    tile=tile, guidance_fn=guidance_fn, device=dev)
            else:
                out = run_one(chunk[0]["GT"][None], masks[0], c0,
                              out_dir / "tiles" / Path(chunk[0]["GT_name"]).stem)
            for i, it in enumerate(chunk):
                write_outputs(c0 + i, it["GT_name"], it["GT"], masks[i],
                              out["final"][i], out["apy"][i])
        sync()
        wall = time.perf_counter() - t0
        logger.info("sweep done: %d pairs, avg PSNR %.2f, avg SSIM %.3f, %.2f s",
                    len(psnrs), float(np.mean(psnrs)), float(np.mean(ssims)), wall)
        return {"psnr": psnrs, "ssim": ssims, "tree": tree, "wall_seconds": wall}

    # --- single-image mode ----------------------------------------------------
    if ns.path_y is None:
        raise SystemExit("pass --path_y (single image) or --gt_path + --mask_path_dir / "
                         "a conf data.eval entry (sweep)")
    gt = (load_image(ns.path_y) * 2.0 - 1.0)[None]
    mask = load_mask(ns.mask_path) if ns.mask_path else None
    t0 = time.perf_counter()
    out = run_one(gt, mask, 0, out_dir / "tiles")
    sync()
    wall = time.perf_counter() - t0
    save_image(to01(out["final"][0]), out_dir / "final.png")
    save_image(to01(out["apy"][0]), out_dir / "Apy.png")
    save_image(to01(out["y"][0]), out_dir / "y.png")
    n_tiles = len(tiles_done)
    out["stats"] = {"wall_seconds": wall, "tiles": n_tiles, "model_calls": calls * n_tiles,
                    "seconds_per_tile": wall / max(n_tiles, 1),
                    "model_calls_per_second": calls * n_tiles / wall}
    logger.info("wrote %s: %d tiles x %d model calls in %.2f s", out_dir / "final.png",
                n_tiles, calls, wall)
    return out


if __name__ == "__main__":
    main()
