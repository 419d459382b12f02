#!/usr/bin/env python
"""hq pipeline CLI of the PyTorch/CUDA port: arbitrary-size DDNM
restoration with Mask-Shift tiling on the ADM UNet, with classifier
guidance where the config asks for it (class_cond and classifier_scale > 0:
the ADM classifier from --classifier_ckpt or the config's classifier_path,
or random weights from --seed under --random_init).

Takes hq_main.py's flags plus --device (default cuda; without a card it
raises unless --device cpu is given) and --loop (the samplers' driver).
Single-image mode restores --path_y (with --resize_y it is the
low-resolution measurement); sweep mode runs the conf's data.eval dataset
(or --gt_path + --mask_path_dir) and writes the srs / lrs / gts /
gt_keep_masks tree with PSNR and SSIM. The tile is the config's
image_size and the stride half of it. Example on the card:

  python hq_main_torch.py --config configs/hq/inet256.yml --path_y in.png \\
      --deg sr_averagepooling --scale 4 --resize_y --class 950 \\
      --random_init --dtype bfloat16 -i exp/hq_out_torch

--solver multistep (second-order, noise-free; set a short respacing in
the config), --encoder_cache N [--encoder_cache_policy end_dense] (the
ADM's encoder features reused across N model calls of a tile) and
--resume (the canvas checkpointed under the tiles folder after every tile
group; a restart with the same flags goes on at the next group) run as in
hq_main.py. --dp N shards each tile group (a batched sweep's images, a
wavefront's tiles) over N devices, the model and classifier replicated
(the first N cards; on the CPU, N shards of it); a group N does not
divide runs on the first. The shards launch in turn from one thread,
each a graph replay on its own card's stream (PERF.md §6: a mesh of 2
cards 1.72-1.73x one card on the main path under the scan).

Each tile group's trajectory runs as one CUDA graph (--loop auto, the
default, or scan; sampling/graphs.py): one graph a group size, captured at
its first group and replayed across tiles and images, dropped when the run
ends, as JAX's scan reuses one executable. Under --dp each shard's
trajectory is a graph of its own; under --sp each rank's, its NCCL
collectives inside. --loop host runs the eager loop. Host-driven whatever
--loop says: --encoder_cache > 1, and --sp over gloo on one card (every
rank on --device cuda:0), where --loop scan raises naming gloo.

--sp S > 1 (spatial partitioning) runs as dp * sp processes, one per
(data index, spatial rank), each holding S-th of every tile's rows in the
UNet (ddnm_tpu_torch/parallel/spatial.py):

  torchrun --nproc_per_node D*S hq_main_torch.py ... --dp D --sp S

one card a rank (cuda:LOCAL_RANK), or --device cuda:0 for every rank on
one card (its spatial groups then use gloo; NCCL where each rank of a
group has its own card). S must divide the 256 px tile (hq_main.py's
check) and the model's lowest grid. The data rows split a tile group
(single-image mode) or the sweep's images (sweep mode); spatial rank 0 of
each data row writes the images and the --resume state, the other ranks
write nothing. Guidance shards the classifier over the same rows: its
gradient is taken through the sharded classifier (the halo, GroupNorm and
attention exchanges carry it back) and gathered whole on every rank; S
must then divide the classifier's lowest grid too (8 rows for inet256).
--solver multistep and --encoder_cache run guided under --sp as at S = 1.
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

from ddnm_tpu_torch.runtime import device_arg  # noqa: E402


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
                   help="posterior transition: ddim (the reference's stochastic update) "
                        "or multistep (second-order, deterministic, noise-free only; for "
                        "respacing budgets of ~10 calls)")
    p.add_argument("--encoder_cache", type=int, default=1,
                   help="> 1: reuse the UNet's encoder features across this many model "
                        "calls of a tile (approximate)")
    p.add_argument("--encoder_cache_policy", type=str, default="uniform",
                   choices=["uniform", "end_dense"],
                   help="key-step placement of --encoder_cache")
    p.add_argument("--sp", type=int, default=1,
                   help="spatial partitioning: shard each tile's rows over this many "
                        "processes (launch dp * sp ranks with torchrun)")
    p.add_argument("--dp", type=int, default=1,
                   help="data parallelism: shard each tile group over this many devices")
    p.add_argument("--resume", action="store_true",
                   help="checkpoint the canvas after every tile group under the tiles "
                        "folder of -i and go on from there (same seed and flags)")
    p.add_argument("--device", type=device_arg, default="cuda",
                   help="cuda (default; raises without a card) or cpu")
    p.add_argument("--loop", type=str, default="auto", choices=("auto", "host", "scan"),
                   help="the samplers' loop driver: auto and scan capture each tile group's "
                        "trajectory as one CUDA graph (a shard's or a rank's under --dp / "
                        "--sp); host runs the eager loop; auto is host with --encoder_cache "
                        "> 1 and on --sp over gloo on one card, where scan raises")
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


def main(argv=None):
    """Run the CLI; returns the run's outputs (single-image mode: the
    canvases and "stats"; sweep mode: PSNR, SSIM, the tree, wall seconds).
    The graphs the run captures are dropped when it ends."""
    from ddnm_tpu_torch.sampling import graphs

    with graphs.scope():
        return _main(argv)


def _main(argv):
    ns = parse_args(argv)
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s - %(levelname)s - %(message)s")
    logger = logging.getLogger("ddnm_tpu_torch")

    import numpy as np
    import torch

    from ddnm_tpu_torch.config import load_hq_config
    from ddnm_tpu_torch.data.io import load_image, load_mask, save_image
    from ddnm_tpu_torch.data.metrics import ssim
    from ddnm_tpu_torch.models import cast_torso, classifier_guidance_fn, shard_spatially
    from ddnm_tpu_torch.models.unet_adm import init_like_flax
    from ddnm_tpu_torch.parallel import make_mesh_2d, multihost, replicate_all
    from ddnm_tpu_torch.parallel.spatial import lowest_rows
    from ddnm_tpu_torch.runner import load_checkpoint
    from ddnm_tpu_torch.runtime import resolve_device
    from ddnm_tpu_torch.sampling.accel import adm_split_fns
    from ddnm_tpu_torch.sampling.posterior import build_posterior_tables, n_model_calls
    from ddnm_tpu_torch.schedules import named_beta_schedule
    from ddnm_tpu_torch.tiling import batched_tile_sample, mask_shift_sample

    dev = resolve_device(ns.device)  # fail before touching anything
    if multihost.maybe_init_distributed():  # as hq_main.py; one card a rank
        dev = multihost.local_device(dev)
    cfg_path = Path(ns.config)
    if not cfg_path.exists():
        cfg_path = REPO_ROOT / ns.config
    conf = load_hq_config(cfg_path)
    guided = bool(conf.class_cond) and float(conf.classifier_scale or 0) > 0
    if ns.sp > 1:
        if 256 % ns.sp != 0:  # hq_main.py:299-303
            raise SystemExit(f"--sp {ns.sp} must divide the 256-px tile height "
                             "(use 2, 4, 8, ...)")

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
    mesh = grid = None
    if ns.sp > 1:
        lowest_rows(model, size, ns.sp)  # ValueError where sp does not divide it
        mesh = grid = make_mesh_2d(ns.dp, ns.sp, device=dev)
        shard_spatially(model, grid.spatial)
    elif ns.dp > 1:
        mesh = make_mesh_2d(ns.dp, 1, device=dev)
    # who writes files: spatial rank 0 of a data row (of data row 0 in
    # single-image mode, where the data rows share one canvas)
    writes = grid is None or grid.writer

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

    # the encoder cache's halves (mode="encode" / "decode"), built once
    encode_fn, decode_fn = adm_split_fns(model, label=label)

    # classifier guidance (hq_main.py:241-262): its weights from the seed of
    # the model's under --random_init, as the JAX CLI draws both from one key
    guidance_fn = None
    cckpt = ns.classifier_ckpt or conf.classifier_path
    if guided:
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
        if grid is not None:  # the classifier's rows over the UNet's spatial group
            lowest_rows(classifier, size, ns.sp)
            shard_spatially(classifier, grid.spatial)
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
    if mesh is not None and grid is None:
        # one copy of the model (and classifier) a device, as hq_main.py
        # replicates run_params
        model_fn, guidance_fn, encode_fn, decode_fn = replicate_all(
            mesh, model_fn, guidance_fn, encode_fn, decode_fn)
    out_dir = Path(ns.image_folder)
    to01 = lambda a: np.clip((a + 1.0) / 2.0, 0.0, 1.0)
    tile_init = "fresh" if (ns.parallel_tiles or ns.fresh_tile_init) else "carry"

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    tiles_done = []
    accel = dict(solver=ns.solver, encoder_cache=ns.encoder_cache,
                 encoder_cache_policy=ns.encoder_cache_policy, encode_fn=encode_fn,
                 decode_fn=decode_fn, mesh=mesh, loop=ns.loop)
    # what tells a run apart beyond the tiling's own inputs (hq_main.py:347)
    base_salt = (ns.class_label, float(conf.classifier_scale or 0), ns.sigma_y, ns.dtype)

    def run_one(gt, mask, image_index, tiles_dir, salt, write):
        """One Mask-Shift restoration; the tiling output dict. With
        --resume the state lives in `tiles_dir` (written where `write`)."""
        tiles_dir.mkdir(parents=True, exist_ok=True)

        def progress(t, x0_np):
            i, j = t.index
            if write:
                save_image(to01(x0_np[0]), tiles_dir / f"{i}_{j}.png")
            tiles_done.append(t.index)

        return mask_shift_sample(
            model_fn, gt, ns.deg, tables, ns.seed, image_index=image_index,
            scale=ns.scale, resize_y=ns.resize_y, mask=mask, parallel=ns.parallel_tiles,
            progress_fn=progress, tile_init=tile_init, tile=tile, stride=stride,
            guidance_fn=guidance_fn, device=dev, checkpoint_dir=tiles_dir if ns.resume else None,
            resume=ns.resume, resume_salt=salt, checkpoint_writer=write, **accel)

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
        first, last = 0, len(pairs)
        if grid is not None:
            # each data row restores its own slice; its spatial group shares it
            first, last = multihost.process_subset(len(pairs), grid.data_index, grid.dp)
            accel["mesh"] = grid.spatial_only()
        paths = dict(eval_ds.get("paths") or {})
        tree = {k: Path(paths.get(k) or out_dir / k)
                for k in ("srs", "lrs", "gts", "gt_keep_masks")}
        for p in tree.values():
            p.mkdir(parents=True, exist_ok=True)
        psnrs, ssims = [], []

        def write_outputs(idx, name, gt, mask, final, apy):
            final01, gt01 = to01(final), to01(gt)
            if writes:
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
        if sweep_batch > 1 and (ns.resize_y or pair_size != tile or ns.resume):
            logger.warning("--sweep_batch needs single-tile %dpx canvases and no --resume: "
                           "falling back to the per-image sweep", tile)
            sweep_batch = 1
        items = [pairs[i] for i in range(first, last)]
        t0 = time.perf_counter()
        for c0 in range(0, len(items), sweep_batch):
            chunk = items[c0:c0 + sweep_batch]
            c0 += first  # the images' global indices
            masks = [it["gt_keep_mask"][..., 0] for it in chunk]
            if sweep_batch > 1:
                out = batched_tile_sample(
                    model_fn, np.stack([it["GT"] for it in chunk]), ns.deg, tables,
                    ns.seed, range(c0, c0 + len(chunk)), scale=ns.scale, masks=masks,
                    tile=tile, guidance_fn=guidance_fn, device=dev, **accel)
            else:
                name = chunk[0]["GT_name"]
                out = run_one(chunk[0]["GT"][None], masks[0], c0,
                              out_dir / "tiles" / Path(name).stem, base_salt + (name,), writes)
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
    writes = writes and (grid is None or grid.data_index == 0)
    t0 = time.perf_counter()
    out = run_one(gt, mask, 0, out_dir / "tiles", base_salt, writes)
    sync()
    wall = time.perf_counter() - t0
    if writes:
        save_image(to01(out["final"][0]), out_dir / "final.png")
        save_image(to01(out["apy"][0]), out_dir / "Apy.png")
        save_image(to01(out["y"][0]), out_dir / "y.png")
    n_tiles = len(tiles_done)
    out["stats"] = {"wall_seconds": wall, "tiles": n_tiles, "model_calls": calls * n_tiles,
                    "seconds_per_tile": wall / max(n_tiles, 1),
                    "model_calls_per_second": calls * n_tiles / wall}
    logger.info("%s: %d tiles x %d model calls in %.2f s",
                f"wrote {out_dir / 'final.png'}" if writes else "restored (this rank writes "
                "nothing)", n_tiles, calls, wall)
    return out


if __name__ == "__main__":
    main()
