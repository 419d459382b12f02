"""One rank of tests/test_torch_spatial_guidance.py's group of 2 gloo
processes on 127.0.0.1: classifier guidance through the port's spatially
sharded classifiers on the CPU, written to <dir>/rank<r>.npz for the parent
to hold against JAX. Imports no JAX.

    python tests/_torch_spatial_guidance_worker.py RANK WORLD PORT DIR

DIR holds the parent's inputs: inputs.npz and the state dicts of the four
tiny random classifiers (pool_<name>.pt)."""

from __future__ import annotations

import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402

import chip_smoke  # noqa: E402
from ddnm_tpu_torch.models import (  # noqa: E402
    ADMClassifier,
    classifier_guidance_fn,
    classifier_guidance_from_params,
    shard_spatially,
)
from ddnm_tpu_torch.parallel import (  # noqa: E402
    BACKWARD_COLLECTIVES,
    COLLECTIVES,
    make_mesh_2d,
)

# tests/test_torch_guidance.py's toy classifier architecture
TOY_ARCH = dict(image_size=32, in_channels=3, model_channels=32, num_res_blocks=1,
                attention_resolutions=(2,), channel_mult=(1, 2), num_heads=4,
                num_head_channels=32, use_scale_shift_norm=True, resblock_updown=True)
POOLS = ("attention", "adaptive", "spatial", "spatial_v2")
GUIDED_CLASS = 2  # tests/_golden_adm.py


def main(rank: int, world: int, port: int, out_dir: Path) -> None:
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", rank=rank,
                            world_size=world)
    inp = dict(np.load(out_dir / "inputs.npz"))
    x, t = torch.from_numpy(inp["x"]), torch.from_numpy(inp["t"])
    grid = make_mesh_2d(1, world, device="cpu")
    out = {}

    # the trained toy32 classifier: the guidance gradient through Grid.wrap
    # and through the hooks' own spatial= (per-example labels)
    clf = shard_spatially(chip_smoke.toy_classifier("cpu"), grid.spatial)
    _, _, _, guide = grid.wrap(guidance_fn=classifier_guidance_fn(clf, GUIDED_CLASS, 2.0),
                               classifier=clf)
    out["toy_clf"] = guide(x, t).numpy()
    out["toy_clf_params"] = classifier_guidance_from_params(
        lambda m, z, s: m(z, s), 1.5, spatial=grid.spatial)(
        {"classifier": clf, "classes": torch.from_numpy(inp["classes"])}, x, t).numpy()
    out["toy_collectives"] = np.array([COLLECTIVES[k] for k in sorted(COLLECTIVES)])
    out["toy_backward_collectives"] = np.array(
        [BACKWARD_COLLECTIVES[k] for k in sorted(BACKWARD_COLLECTIVES)])

    # a tiny random classifier of each pool
    for pool in POOLS:
        net = ADMClassifier(**TOY_ARCH, out_channels=5, pool=pool).eval()
        net.load_state_dict(torch.load(out_dir / f"pool_{pool}.pt"), strict=True)
        shard_spatially(net, grid.spatial)
        _, _, _, guide = grid.wrap(
            guidance_fn=classifier_guidance_fn(net, torch.tensor([1, 4]), 1.0), classifier=net)
        out[f"pool_{pool}"] = guide(x, t).numpy()

    # the guided toy32 golden's trajectory, the ADM and the classifier sharded
    model = shard_spatially(chip_smoke.toy_adm("cpu"), grid.spatial)
    psnr, final, per_image, _ = chip_smoke.guided_golden_run(model, clf, "cpu", grid=grid)
    out["golden_final"] = final.numpy()
    out["golden_psnr"] = np.array(psnr)
    np.savez(out_dir / f"rank{rank}.npz", **out)
    dist.barrier()
    dist.destroy_process_group()


if __name__ == "__main__":
    main(int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3]), Path(sys.argv[4]))
