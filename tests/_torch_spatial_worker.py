"""One rank of tests/test_torch_spatial.py's group of 4 gloo processes on
127.0.0.1: the port's spatially sharded runs on the CPU, written to
<dir>/rank<r>.npz for the parent to hold against JAX. Imports no JAX.

    python tests/_torch_spatial_worker.py RANK WORLD PORT DIR

DIR holds the parent's inputs: inputs.npz and the tiny DDPM's weights
(tiny_ddpm.pt)."""

from __future__ import annotations

import json
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402

from ddnm_tpu_torch.models import ADMUNet, DDPMUNet, shard_spatially  # noqa: E402
from ddnm_tpu_torch.operators import build_functional_operator  # noqa: E402
from ddnm_tpu_torch.parallel import COLLECTIVES, grid_sampler, make_mesh_2d  # noqa: E402
from ddnm_tpu_torch.runner import load_checkpoint  # noqa: E402
from ddnm_tpu_torch.sampling.accel import adm_split_fns  # noqa: E402
from ddnm_tpu_torch.sampling.posterior import build_posterior_tables, sample_posterior  # noqa: E402
from ddnm_tpu_torch.schedules import named_beta_schedule  # noqa: E402
from ddnm_tpu_torch import tiling  # noqa: E402

# tests/test_parallel_spatial.py's tiny DDPM UNet
TINY = dict(ch=32, ch_mult=(1, 2), num_res_blocks=1, attn_resolutions=(16,), resolution=32)
TOY_KW = json.loads((REPO / "tests/fixtures/toy_adm32.json").read_text())["adm_kw"]
JUMPS = dict(t_T=3, n_sample=1, jump_length=1, jump_n_sample=1)


def zero_noise(gens, shape):
    return torch.zeros(shape, dtype=torch.float32)


def toy(x, t):
    del t
    return torch.cat([0.1 * x, torch.zeros_like(x)], dim=-1)


def tables():
    return build_posterior_tables(betas=named_beta_schedule("linear", 100, use_scale=True),
                                  timestep_respacing="3", sigma_y=0.0,
                                  schedule_jump_params=dict(JUMPS))


@torch.no_grad()
def main(rank: int, world: int, port: int, out_dir: Path) -> None:
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", rank=rank,
                            world_size=world)
    inp = dict(np.load(out_dir / "inputs.npz"))
    t = lambda a: torch.from_numpy(a)
    out = {}
    grid14 = make_mesh_2d(1, 4, device="cpu")
    grid22 = make_mesh_2d(2, 2, device="cpu")

    # the tiny DDPM UNet's forward, rows over 4 shards
    ddpm = DDPMUNet(**TINY).eval()
    ddpm.load_state_dict(torch.load(out_dir / "tiny_ddpm.pt"))
    shard_spatially(ddpm, grid14.spatial)
    fwd, _, _ = grid14.wrap(lambda x, tt: ddpm(x, tt), model=ddpm)
    out["ddpm_sp4"] = fwd(t(inp["ddpm_x"]), t(inp["ddpm_t"])).numpy()

    # the toy32 ADM's forward over 4 and over 2 shards; its encoder cache's
    # halves (each rank caching its rows) over 2
    adm = ADMUNet(**TOY_KW).eval()
    load_checkpoint(adm, REPO / "tests/fixtures/toy_adm32.pt")
    x, tt = t(inp["adm_x"]), t(inp["adm_t"])
    for name, grid in (("adm_sp4", grid14), ("adm_sp2", grid22)):
        shard_spatially(adm, grid.spatial)
        fwd, enc, dec = grid.wrap(lambda a, b: adm(a, b), *adm_split_fns(adm), model=adm)
        out[name] = fwd(x, tt).numpy()
    out["adm_sp2_split"] = dec(enc(x, tt), x, tt).numpy()

    # the posterior trajectory on the (dp 2, sp 2) grid: the batch of 2
    # over the data indices, each image's rows over 2 shards
    shard_spatially(ddpm, grid22.spatial)
    model6, _, _ = grid22.wrap(
        lambda a, b: torch.cat([e := ddpm(a, b), torch.zeros_like(e)], dim=-1), model=ddpm)
    op = build_functional_operator("sr_averagepooling", image_size=32, deg_scale=4)
    gens = [torch.Generator().manual_seed(i) for i in range(2)]
    xs, x0 = grid_sampler(sample_posterior, grid22)(
        model6, t(inp["post_x_init"]), t(inp["post_apy"]), op, tables(), gens,
        noise_fn=zero_noise)
    out["post_x"], out["post_x0"] = xs.numpy(), x0.numpy()

    # the sequential carry chain at (1, 4) and the wavefront at (2, 2); the
    # fresh tiles' inits a constant, as the parent patches JAX's normal
    tiling.default_noise = lambda gens, shape: torch.full(shape, 0.25)
    for name, grid, gt, parallel in (("carry_1x4", grid14, inp["gt384"], False),
                                     ("wavefront_2x2", grid22, inp["gt512"], True)):
        res = tiling.mask_shift_sample(toy, gt, "sr_averagepooling", tables(), 0, scale=4,
                                       noise_fn=zero_noise, parallel=parallel,
                                       init_noise=inp["init256"], mesh=grid, device="cpu")
        out[name] = res["final"]
    out["collectives"] = np.array([COLLECTIVES[k] for k in sorted(COLLECTIVES)])
    np.savez(out_dir / f"rank{rank}.npz", **out)
    dist.barrier()
    dist.destroy_process_group()


if __name__ == "__main__":
    main(int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3]), Path(sys.argv[4]))
