#!/usr/bin/env python
"""CLI of the PyTorch/CUDA port (ddnm_tpu_torch): DDNM / DDNM+ restoration.

Takes main.py's flags plus --device (default cuda; without a card it raises
unless --device cpu is given). With --simplified it runs the functional
A / A+ path, without it SVD mode (the matrix-free SVD operators of every
task), on the DDPM UNet ("simple" configs) or the ADM UNet ("openai"
configs). --add_noise corrupts each measurement with -n/--noise_type noise
of level 2 * sigma_y. Examples at full width on the card:

  python main_torch.py --config configs/celeba_hq.yml --path_y celeba_hq \
      --deg sr_averagepooling --deg_scale 4 --sigma_y 0 --simplified \
      --ckpt tests/fixtures/flag_ddpm256.pt --dtype bfloat16 -i demo --ni

  python main_torch.py --config configs/celeba_hq.yml --path_y celeba_hq \
      --deg cs_walshhadamard --deg_scale 0.25 --sigma_y 0 \
      --ckpt tests/fixtures/flag_ddpm256.pt --dtype bfloat16 -i demo_cs --ni

  python main_torch.py --config configs/imagenet_256.yml --path_y imagenet \
      --deg sr_averagepooling --deg_scale 4 --random_init --dtype bfloat16 \
      -i demo_inet --ni

Several cards: run one process a card, each restoring its own slice of
the images under their global names:

  torchrun --nproc_per_node 4 main_torch.py --config configs/celeba_hq.yml ...

(or a Slurm / OpenMPI launch with MASTER_ADDR and MASTER_PORT exported);
each rank takes cuda:<local rank> unless --device cuda:N is given (several
ranks may share one card). A run without a launcher uses one card (the
JAX CLI shards each batch over every device): one process a card scaled
3.7-4.0x on 4 H100s, an in-process mesh of 4 cards 2.49x under the scan
(PERF.md §6). `main(argv, mesh=)` shards each batch over a mesh of the
caller's (parallel/mesh.py).

--solver multistep (with --t_sampling 10, say) and --encoder_cache 3
[--encoder_cache_policy end_dense] are the JAX package's two opt-in
accelerators. --trace_dir DIR writes a torch.profiler Chrome trace of the
run. --loop picks the sampler's driver, as main.py's does: auto (the
default) and scan run each batch's whole trajectory as one CUDA graph,
captured at the first batch and replayed (eagerly on the CPU); host runs
the eager loop, one launch at a time from the host. On a data mesh
(main(mesh=)) each shard's trajectory is a graph of its own, as JAX's
scan runs on sharded arrays; --encoder_cache N > 1 runs host-driven.
"""

from __future__ import annotations

import argparse
import logging
import shutil
import sys
from pathlib import Path

REPO_ROOT = Path(__file__).resolve().parent
if str(REPO_ROOT) not in sys.path:
    sys.path.insert(0, str(REPO_ROOT))


from ddnm_tpu_torch.data.noise import NOISE_TYPES  # noqa: E402
from ddnm_tpu_torch.runtime import device_arg  # noqa: E402


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="DDNM image restoration (PyTorch/CUDA port)")
    p.add_argument("--config", type=str, required=True, help="YAML config under configs/")
    p.add_argument("--seed", type=int, default=1234)
    p.add_argument("--exp", type=str, default="exp", help="experiment root (datasets/)")
    p.add_argument("--deg", type=str, required=True, help="degradation task string")
    p.add_argument("--path_y", type=str, default="celeba_hq",
                   help="dataset folder name under <exp>/datasets, or absolute path")
    p.add_argument("--sigma_y", type=float, default=0.0, help="measurement noise (in [0,1] domain)")
    p.add_argument("--eta", type=float, default=0.85, help="DDIM eta")
    p.add_argument("--simplified", action="store_true",
                   help="functional A/A+ (default: SVD mode, the SVD operators)")
    p.add_argument("-i", "--image_folder", type=str, default="output")
    p.add_argument("--deg_scale", type=float, default=4.0)
    p.add_argument("--add_noise", action="store_true")
    p.add_argument("-n", "--noise_type", type=str, default="gaussian", choices=NOISE_TYPES)
    p.add_argument("--trace_dir", type=str, default=None,
                   help="write a torch.profiler Chrome trace of the run here")
    p.add_argument("--subset_start", type=int, default=-1)
    p.add_argument("--subset_end", type=int, default=-1)
    p.add_argument("--verbose", type=str, default="info")
    p.add_argument("--ni", action="store_true", help="non-interactive (overwrite outputs)")
    p.add_argument("--ckpt", type=str, default=None, help="torch checkpoint (.pt) to load")
    p.add_argument("--classifier_ckpt", type=str, default=None,
                   help="torch checkpoint (.pt) of the guidance classifier of a "
                        "class-conditional config with a classifier block (elsewhere "
                        "ignored)")
    p.add_argument("--random_init", action="store_true",
                   help="random weights from --seed (no checkpoint)")
    p.add_argument("--batch_size", type=int, default=None, help="override config batch size")
    p.add_argument("--t_sampling", type=int, default=None,
                   help="override time_travel.T_sampling")
    p.add_argument("--dtype", type=str, default="float32", choices=["float32", "bfloat16"])
    p.add_argument("--mask_path", type=str, default=None)
    p.add_argument("--manifest", type=str, default=None, help="imagenet manifest txt")
    p.add_argument("--max_images", type=int, default=None)
    p.add_argument("--loop", type=str, default="auto", choices=["auto", "scan", "host"],
                   help="the sampler's loop driver: auto and scan capture each batch's "
                        "trajectory as one CUDA graph and replay it; host runs the eager "
                        "loop (a graph a shard on a data mesh; auto is host with "
                        "--encoder_cache > 1)")
    p.add_argument("--solver", type=str, default="ddim", choices=["ddim", "multistep"],
                   help="ddim: the reference's first-order update (the quality choice "
                        "at 25+ steps); multistep: second-order and deterministic, "
                        "noise-free tasks only, for budgets of ~10 steps (set "
                        "--t_sampling)")
    p.add_argument("--encoder_cache", type=int, default=1,
                   help="encoder-propagation interval: > 1 reuses the UNet's encoder "
                        "features across that many model calls (approximate; "
                        "--simplified only, no effect in SVD mode)")
    p.add_argument("--encoder_cache_policy", type=str, default="uniform",
                   choices=["uniform", "end_dense"],
                   help="key-step placement of --encoder_cache: every N-th call, or an "
                        "exact tail and a spread head at the same budget")
    p.add_argument("--resume", action="store_true",
                   help="skip images whose outputs already exist")
    p.add_argument("--device", type=device_arg, default="cuda",
                   help="cuda (default: the current card, or the rank's under a "
                        "launcher; raises without one), cuda:N or cpu")
    return p.parse_args(argv)



def main(argv=None, mesh=None):
    """Run the CLI on `argv`; returns the runner's stats. `mesh` (a
    parallel.Mesh) shards each batch over those devices (one that repeats
    a card, say)."""
    ns = parse_args(argv)
    logging.basicConfig(
        level=getattr(logging, ns.verbose.upper(), logging.INFO),
        format="%(asctime)s - %(levelname)s - %(message)s",
    )
    from ddnm_tpu_torch.config import load_config
    from ddnm_tpu_torch.parallel import multihost
    from ddnm_tpu_torch.runner import RunArgs, Runner
    from ddnm_tpu_torch.runtime import resolve_device

    resolve_device(ns.device)  # fail before touching the output folder
    multihost.maybe_init_distributed()

    out = Path(ns.image_folder)
    if not out.is_absolute():
        out = Path(ns.exp) / "image_samples" / ns.image_folder
    rank0 = multihost.process_index() == 0
    if rank0 and out.exists() and not ns.resume:
        if ns.ni:
            shutil.rmtree(out)
        else:
            resp = input(f"Image folder {out} already exists. Overwrite? (Y/N) ")
            if resp.strip().upper() != "Y":
                print("Output image folder exists. Program halted.")
                return None
            shutil.rmtree(out)
    if multihost.process_count() > 1:
        import torch.distributed as dist

        dist.barrier()  # no rank writes before rank 0 has cleared the folder

    cfg_path = Path(ns.config)
    if not cfg_path.exists():
        cfg_path = REPO_ROOT / "configs" / ns.config
    config = load_config(cfg_path)
    if ns.t_sampling is not None:
        config.time_travel.T_sampling = ns.t_sampling

    args = RunArgs(
        config=str(cfg_path), deg=ns.deg, deg_scale=ns.deg_scale, sigma_y=ns.sigma_y,
        eta=ns.eta, seed=ns.seed, exp=ns.exp, path_y=ns.path_y,
        image_folder=str(out), simplified=ns.simplified, add_noise=ns.add_noise,
        noise_type=ns.noise_type, manifest=ns.manifest,
        subset_start=ns.subset_start, subset_end=ns.subset_end, ckpt=ns.ckpt,
        classifier_ckpt=ns.classifier_ckpt, random_init=ns.random_init,
        batch_size=ns.batch_size, dtype=ns.dtype, mask_path=ns.mask_path,
        max_images=ns.max_images, resume=ns.resume, solver=ns.solver,
        encoder_cache=ns.encoder_cache, encoder_cache_policy=ns.encoder_cache_policy,
        device=ns.device, trace_dir=ns.trace_dir, loop=ns.loop,
    )
    return Runner(args, config, mesh=mesh).run()


if __name__ == "__main__":
    main()
