"""Mask-Shift tiling for arbitrary-size restoration (port of
ddnm_tpu/tiling.py).

An H x W canvas is restored as overlapping square tiles (default 256 px)
slid in strides (default 128 px); inside every denoising step each tile's
overlap strips (the top strip if a row above exists, the left strip if a
tile to the left exists) are overwritten with the already-solved canvas,
so the seams stay consistent. The last tile of a row or column is shifted
back to end at the canvas edge, which enlarges its overlap.

The tile and stride are arguments (`tile`, `stride`); callers size them to
the model (hq_main_torch.py: the config's image_size and half of it).
Nothing here changes module state.

Sequential mode runs the tiles in the reference's row-major order, each
starting from the previous tile's final state ("carry", the reference's)
or from its own noise ("fresh"). Wavefront mode (`parallel=True`, fresh
only) batches the tiles of one skewed anti-diagonal s = 2i + j, which read
and write disjoint canvas regions, into one sampler call
(`_plan_groups`). Every tile draws its init and its sampler noise from its
own generators (sampling/rng.py `tile_generators`), so a tile's noise does
not depend on its group: with deterministic noise the wavefront order
equals the sequential fresh order, and with stochastic noise each tile
draws what it draws sequentially. The JAX package pads a wavefront group of
4-7 tiles to 8 so that one compiled executable serves every width; here
groups run at their own size, and the scan driver keeps one CUDA graph a
group size.

`loop` picks the sampler's driver (sampling/graphs.py): "auto" (the
default) and "scan" run each group's trajectory as one CUDA graph, one
graph a group size, replayed across the canvas's tiles and across images
(as the JAX package reuses one executable); "host" the eager loop. Over a
data `mesh` each shard's trajectory is a graph of its own, over a Grid
each rank's, its NCCL collectives inside (parallel/spatial.py); on a Grid
whose spatial group is gloo on a card "auto" is "host" and "scan" raises
ValueError naming gloo. The encoder cache always runs host-driven.

`solver="multistep"` runs each tile group through the second-order
solver (sampling/solvers.py; tiles start fresh unless `tile_init` says
otherwise), and `encoder_cache > 1` through the encoder propagation
(sampling/accel.py) with the caller's `encode_fn` / `decode_fn`. With a
`checkpoint_dir` the canvas, the finished tiles and the carried state are
written after every group (`mask_shift_state.npz`, atomically), so that a
run restarted with `resume=True` and the same inputs goes on at the next
group; a state file of another run is ignored with a warning, and the file
is deleted when the run completes.

`mesh` (parallel/mesh.py, a 1-D data mesh) shards each sampler call's
tiles over its entries, as the JAX package's tile batches shard over the
data axis: `model_fn`, `guidance_fn`, `encode_fn` and `decode_fn` are
replicated once a call (or passed as `Replicas`), and a group whose size
the mesh does not divide (a wavefront of 1-3 tiles, a sequential tile)
runs on the first entry, with a warning once: the port does not pad
groups to 8 as the JAX package does.

`mesh` may instead be this process's `Grid` of a (data, spatial) grid of
processes (parallel/spatial.py, make_mesh_2d with sp > 1): every rank
runs the tiling on the whole canvas; `model_fn`, `encode_fn` and
`decode_fn` (whose UNet `shard_spatially` has sharded) are wrapped so
that each rank's UNet runs on its block of the tile's rows and the output
is gathered back to the whole tile; a group's tiles split over the data
indices where dp divides them, else every data row runs the whole group.
`guidance_fn` (a hook of a classifier that `shard_spatially` has sharded
over the same group, classifier_guidance_fn) is wrapped likewise
(`Grid.wrap(guidance_fn=)`): its gradient is taken with respect to each
rank's rows through the sharded classifier and gathered back whole.
"""

from __future__ import annotations

import dataclasses
import hashlib
import logging
from itertools import groupby
from pathlib import Path
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from ddnm_tpu_torch.operators.functional import (
    FunctionalOperator,
    as_mask,
    avg_pool,
    build_functional_operator,
    color2gray,
    gray2color,
    mean_upsample,
)
from ddnm_tpu_torch.parallel.mesh import replicate, replicate_all, sharded_sampler
from ddnm_tpu_torch.parallel.spatial import Grid, grid_sampler
from ddnm_tpu_torch.runtime import resolve_device
from ddnm_tpu_torch.sampling.accel import key_steps_for_policy, sample_posterior_encoder_prop
from ddnm_tpu_torch.sampling.graphs import resolve_loop
from ddnm_tpu_torch.sampling.posterior import PosteriorTables, n_model_calls, sample_posterior
from ddnm_tpu_torch.sampling.rng import (
    STREAM_INIT,
    STREAM_SAMPLE,
    default_noise,
    tile_generators,
)

logger = logging.getLogger("ddnm_tpu_torch")

__all__ = [
    "Tile",
    "tile_grid",
    "build_hq_operators",
    "mask_shift_sample",
    "batched_tile_sample",
    "n_model_calls",
]

TILE = 256
STRIDE = 128
GROUP_SIZE = 8  # wavefront chunk size (_plan_groups)
MIN_PAD_BATCH = 4  # smallest remainder of a wavefront that runs as one group


@dataclasses.dataclass(frozen=True)
class Tile:
    """One size x size window on the canvas: top-left (h0, w0) and the
    heights of its top / left strips pasted from the solved canvas (0 in
    the first row / column)."""

    index: tuple[int, int]
    h0: int
    w0: int
    row_overlap: int
    col_overlap: int
    size: int = TILE

    def paste_mask(self) -> np.ndarray:
        m = np.zeros((self.size, self.size, 1), dtype=np.float32)
        if self.row_overlap:
            m[: self.row_overlap, :, :] = 1.0
        if self.col_overlap:
            m[:, : self.col_overlap, :] = 1.0
        return m


def tile_grid(h_target: int, w_target: int, tile: int = TILE,
              stride: int = STRIDE) -> list[Tile]:
    """Row-major tiles as the reference's shift loops place them:
    ceil(dim / stride) - 1 per axis, the last snapped to the canvas edge
    when dim % stride != 0."""
    if h_target < tile or w_target < tile:
        raise ValueError(f"canvas must be at least {tile}x{tile} (use a larger scale)")

    def starts(dim: int) -> list[tuple[int, int]]:
        n = int(np.ceil(dim / stride)) - 1
        out = []
        for s in range(n):
            x0 = stride * s
            overlap = 0 if s == 0 else stride
            if s == n - 1 and dim % stride != 0:
                x0 = dim - tile
                if s > 0:
                    overlap = tile - dim % stride
            out.append((x0, overlap))
        return out

    return [Tile((i, j), h0, w0, r_ov, c_ov, tile)
            for i, (h0, r_ov) in enumerate(starts(h_target))
            for j, (w0, c_ov) in enumerate(starts(w_target))]


def build_hq_operators(
    deg: str,
    *,
    scale: int = 4,
    gt_shape: tuple[int, int],
    mask: Optional[np.ndarray] = None,
    tile: int = TILE,
    device=None,
) -> tuple[FunctionalOperator, Callable]:
    """(tile-size operator, canvas-size A_temp) of an hq task. A_temp maps
    the whole ground truth to the measurement. The mask tasks take a
    canvas-sized mask and a context-parameterised operator
    (FunctionalOperator.A_ctx / Ap_ctx): each tile's mask slice rides into
    the sampler as its op_ctx."""
    if deg == "sr_averagepooling":
        op = build_functional_operator(deg, image_size=tile, deg_scale=scale)
        a_temp = lambda z: avg_pool(z, scale)
    elif deg == "colorization":
        op = build_functional_operator(deg, image_size=tile)
        a_temp = op.A
    elif deg == "sr_color":
        op = build_functional_operator(deg, image_size=tile, deg_scale=scale)
        a_temp = lambda z: color2gray(avg_pool(z, scale))
    elif deg in ("inpainting", "mask_color_sr"):
        if mask is None:
            raise ValueError(f"{deg} requires a mask")
        m = as_mask(mask, device)
        if tuple(m.shape[:2]) != tuple(gt_shape):
            raise ValueError(
                f"{deg} mask shape {tuple(m.shape[:2])} must match the "
                f"canvas {tuple(gt_shape)} (the reference's gt_keep_mask is gt-sized)")
        if deg == "inpainting":
            A_full = lambda z: z * m
            mask_ctx = lambda z, c: z * c
            op = FunctionalOperator(deg, A_full, A_full, mask_ctx, mask_ctx)
        else:
            A_full = lambda z: avg_pool(color2gray(z * m), scale)
            Ap_full = lambda z: gray2color(mean_upsample(z, scale)) * m
            A_ctx = lambda z, c: avg_pool(color2gray(z * c), scale)
            Ap_ctx = lambda z, c: gray2color(mean_upsample(z, scale)) * c
            op = FunctionalOperator(deg, A_full, Ap_full, A_ctx, Ap_ctx)
        a_temp = op.A
    else:
        raise NotImplementedError(f"hq degradation {deg} not supported")
    return op, a_temp


def _plan_groups(tiles: Sequence[Tile], group_size: int = GROUP_SIZE,
                 min_pad_batch: int = MIN_PAD_BATCH) -> list[list[Tile]]:
    """Chunk the tiles into wavefront groups: the tiles of one skewed
    anti-diagonal (2 * row + col) are independent, so they may share a
    sampler call. Each wavefront runs in chunks of `group_size`; a
    remainder of `min_pad_batch` tiles or more is one group, a smaller one
    runs tile by tile (the JAX package's chunking, measured there)."""
    skew = lambda t: 2 * t.index[0] + t.index[1]
    ordered = sorted(tiles, key=lambda t: (skew(t), t.index))
    groups = []
    for _, wave in groupby(ordered, key=skew):
        wave = list(wave)
        i = 0
        while len(wave) - i >= min_pad_batch:
            groups.append(wave[i: i + group_size])
            i += group_size
        groups.extend([t] for t in wave[i:])
    return groups


def _check_accel(encoder_cache: int, encode_fn, decode_fn, solver: str) -> None:
    """The JAX package's refusals of the encoder cache's misuse."""
    if encoder_cache > 1 and (encode_fn is None or decode_fn is None):
        raise ValueError("encoder_cache > 1 requires encode_fn and decode_fn")
    if solver != "ddim" and encoder_cache > 1:
        raise ValueError(
            "solver='multistep' does not compose with encoder_cache > 1 "
            "(the encoder-prop sampler is bound to the ddim posterior step)")


def _sample_group(model_fn, x_init, apy, op, tables, gens, *, encoder_cache: int,
                  encoder_cache_policy: str, encode_fn, decode_fn, solver: str, mesh=None,
                  loop: str = "auto", **kw):
    """One sampler call on a batch of tiles: the encoder propagation where
    encoder_cache > 1, else sample_posterior with `solver`; over `mesh`
    the tiles shard (the callables are `Replicas` then; over a Grid the
    tiles split over its data indices, the callables already wrapped)."""
    if isinstance(mesh, Grid):
        return grid_sampler(_sample_group, mesh)(
            model_fn, x_init, apy, op, tables, gens, encoder_cache=encoder_cache,
            encoder_cache_policy=encoder_cache_policy, encode_fn=encode_fn,
            decode_fn=decode_fn, solver=solver, loop=loop, **kw)
    if mesh is not None:
        return sharded_sampler(_sample_group, mesh)(
            model_fn, x_init, apy, replicate(mesh, op), tables, gens,
            encoder_cache=encoder_cache, encoder_cache_policy=encoder_cache_policy,
            encode_fn=encode_fn, decode_fn=decode_fn, solver=solver, loop=loop, **kw)
    if encoder_cache > 1:
        key_steps = key_steps_for_policy(n_model_calls(tables), encoder_cache,
                                         encoder_cache_policy)
        return sample_posterior_encoder_prop(encode_fn, decode_fn, x_init, apy, op, tables,
                                             gens, interval=encoder_cache,
                                             key_steps=key_steps, **kw)
    return sample_posterior(model_fn, x_init, apy, op, tables, gens, solver=solver, loop=loop,
                            **kw)


def _over_mesh(mesh, model_fn, guidance_fn, encode_fn, decode_fn):
    """The callables of a sampler call over `mesh`: replicated over a data
    mesh, wrapped over a Grid's spatial group (module docstring)."""
    if not isinstance(mesh, Grid):
        return replicate_all(mesh, model_fn, guidance_fn, encode_fn, decode_fn)
    if guidance_fn is None:
        model_fn, encode_fn, decode_fn = mesh.wrap(model_fn, encode_fn, decode_fn)
        return model_fn, guidance_fn, encode_fn, decode_fn
    model_fn, encode_fn, decode_fn, guidance_fn = mesh.wrap(
        model_fn, encode_fn, decode_fn, guidance_fn=guidance_fn,
        classifier=getattr(guidance_fn, "classifier", None))
    return model_fn, guidance_fn, encode_fn, decode_fn


def _device(x, device) -> torch.device:
    if device is not None:
        return resolve_device(device)
    return x.device if torch.is_tensor(x) else resolve_device()


def _images(x, dev) -> torch.Tensor:
    """x (numpy or tensor, (H, W, 3) or (B, H, W, 3)) as a float32 tensor on
    `dev`. A read-only numpy array is copied first, so that no tensor
    aliases memory torch may not write."""
    if not torch.is_tensor(x):
        x = np.asarray(x)
        if not x.flags.writeable:
            x = x.copy()
    x = torch.as_tensor(x, dtype=torch.float32).to(dev)
    return x[None] if x.ndim == 3 else x


def _tile_init(seed: int, image_index: int, tile: Tile, dev) -> torch.Tensor:
    """A tile's fresh x_T, from its own init generator."""
    gens = tile_generators(seed, image_index, [tile.index], STREAM_INIT, dev)
    return default_noise(gens, (1, tile.size, tile.size, 3)).to(dev)


def _numpy(t: torch.Tensor) -> np.ndarray:
    return t.detach().float().cpu().numpy()


def batched_tile_sample(
    model_fn,
    gts,
    deg: str,
    tables: PosteriorTables,
    seed: int,
    image_indices: Optional[Sequence[int]] = None,
    *,
    scale: int = 4,
    resize_y: bool = False,
    masks: Optional[list] = None,
    guidance_fn=None,
    noise_fn=default_noise,
    tile: int = TILE,
    device=None,
    mesh=None,
    encoder_cache: int = 1,
    encoder_cache_policy: str = "uniform",
    encode_fn=None,
    decode_fn=None,
    solver: str = "ddim",
    loop: str = "auto",
) -> dict:
    """B single-tile (tile x tile) restorations in one sampler call.

    Equal per image to B `mask_shift_sample` calls on tile-sized canvases
    with the same `seed` and `image_index`: each image draws its init and
    its sampler noise from the generators of its tile (0, 0), so grouping
    changes throughput only. `masks[i]`: image i's (H, W[, 1]) keep-mask for
    the mask tasks, its op_ctx. Raises ValueError for a canvas that is not
    one tile (callers then run mask_shift_sample per image). `solver`,
    `encoder_cache`, `encoder_cache_policy`, `encode_fn`, `decode_fn`,
    `loop`: as in mask_shift_sample; `mesh`: the images shard over it
    (module docstring)."""
    resolve_loop(loop, mesh=mesh)
    dev = _device(gts, device)
    gts = _images(gts, dev)
    n = int(gts.shape[0])
    idxs = list(range(n)) if image_indices is None else [int(i) for i in image_indices]
    if len(idxs) != n:
        raise ValueError(f"need one image index per image: {len(idxs)} for {n} images")
    if tile % scale != 0:
        raise ValueError(f"SR scale must divide the tile size {tile}")
    if resize_y:
        gts = mean_upsample(gts, scale)
    if tuple(gts.shape[1:3]) != (tile, tile):
        raise ValueError(
            f"batched_tile_sample needs single-tile {tile}x{tile} canvases, "
            f"got {tuple(gts.shape[1:3])}: use mask_shift_sample per image")
    _check_accel(encoder_cache, encode_fn, decode_fn, solver)

    if deg in ("inpainting", "mask_color_sr"):
        if masks is None or len(masks) != n:
            raise ValueError(f"{deg} needs one mask per image")
        ctx_b = torch.stack([as_mask(m, dev) for m in masks])  # (B, H, W, 1)
        op, _ = build_hq_operators(deg, scale=scale, gt_shape=(tile, tile), mask=masks[0],
                                   tile=tile, device=dev)
        y = op.A_ctx(gts, ctx_b)
        apy = op.Ap_ctx(y, ctx_b)
    else:
        ctx_b = None
        op, a_temp = build_hq_operators(deg, scale=scale, gt_shape=(tile, tile), tile=tile,
                                        device=dev)
        y = a_temp(gts)
        apy = op.Ap(y)

    origin = Tile((0, 0), 0, 0, 0, 0, tile)
    x_init = torch.cat([_tile_init(seed, i, origin, dev) for i in idxs])
    gens = [tile_generators(seed, i, [(0, 0)], STREAM_SAMPLE, dev)[0] for i in idxs]
    # single tiles paste nothing; passed explicitly, as mask_shift_sample's
    # step does
    paste_mask = torch.zeros((n, tile, tile, 1), device=dev)
    if mesh is not None:
        model_fn, guidance_fn, encode_fn, decode_fn = _over_mesh(
            mesh, model_fn, guidance_fn, encode_fn, decode_fn)
    _, x0_b = _sample_group(model_fn, x_init, apy, op, tables, gens,
                            encoder_cache=encoder_cache,
                            encoder_cache_policy=encoder_cache_policy, encode_fn=encode_fn,
                            decode_fn=decode_fn, solver=solver, mesh=mesh, loop=loop,
                            paste_mask=paste_mask, paste_content=torch.zeros_like(gts),
                            guidance_fn=guidance_fn, noise_fn=noise_fn, op_ctx=ctx_b)
    return {"final": _numpy(x0_b), "apy": _numpy(apy), "y": _numpy(y)}


def mask_shift_sample(
    model_fn,
    gt,
    deg: str,
    tables: PosteriorTables,
    seed: int,
    *,
    image_index: int = 0,
    scale: int = 4,
    resize_y: bool = False,
    mask: Optional[np.ndarray] = None,
    guidance_fn=None,
    parallel: bool = False,
    noise_fn=default_noise,
    progress_fn: Optional[Callable[[Tile, np.ndarray], None]] = None,
    tile_init: Optional[str] = None,
    init_noise=None,
    tile: int = TILE,
    stride: int = STRIDE,
    device=None,
    mesh=None,
    encoder_cache: int = 1,
    encoder_cache_policy: str = "uniform",
    encode_fn=None,
    decode_fn=None,
    checkpoint_dir=None,
    resume: bool = False,
    resume_salt=None,
    solver: str = "ddim",
    checkpoint_writer: bool = True,
    loop: str = "auto",
) -> dict:
    """Restore an arbitrary-size image with Mask-Shift DDNM.

    gt: (1, H, W, 3) float32 in [-1, 1] (NHWC, numpy or a tensor; a tensor
    keeps its device unless `device` is given). Returns the final canvas,
    the A+y canvas and y as NHWC numpy arrays in [-1, 1].

    `seed`, `image_index`: the tiles' generators (sampling/rng.py). With
    `parallel=True` each wavefront's independent tiles share a sampler call
    (module docstring). `tile_init`: "carry" (the sequential default, the
    reference's: every tile after the first starts from the previous tile's
    final state) or "fresh" (each tile from its own noise; the wavefront
    default, and its only choice). Left None it is "carry" for the
    sequential ddim sampler and "fresh" otherwise: the deterministic
    multistep solver needs each tile's init at the chain's top noise level,
    where the carried state is nearly clean (the JAX package measured ~9 dB
    lost at low NFE). `init_noise`: an optional (1, tile, tile, 3) init of
    the first tile. `progress_fn(tile, x0_hat)` is called after each tile.

    `solver`: "ddim" or "multistep" (sample_posterior). `encoder_cache >
    1` reuses the UNet's encoder features across that many model calls of
    each tile (sampling/accel.py; approximate), with `encode_fn(x, t)` /
    `decode_fn(cache, x, t)` (`adm_split_fns`) and `encoder_cache_policy`
    "uniform" or "end_dense" (`key_steps_for_policy`).

    `checkpoint_dir`: write the canvas, the finished tiles and, in carry
    order, the carried state after every group, so that an interrupted
    run restarts at tile granularity with `resume=True` (module
    docstring). The state carries a SHA-256 identity of the run: the
    geometry, the flags, `seed`, `image_index`, the image, the mask,
    `init_noise`, every table and `resume_salt` (what the caller knows of
    the run and this layer does not, e.g. a class label).
    `checkpoint_writer=False`: read the state at a resume but never write
    or delete it (the ranks of a grid that share one writer's folder).

    `mesh`: each group's tiles shard over it; `loop`: the sampler's driver
    (module docstring)."""
    _check_accel(encoder_cache, encode_fn, decode_fn, solver)
    resolve_loop(loop, mesh=mesh)
    if tile_init is None:
        tile_init = "fresh" if (parallel or solver != "ddim") else "carry"
    if tile_init not in ("carry", "fresh"):
        raise ValueError(f"tile_init must be 'carry' or 'fresh', got {tile_init!r}")
    if tile_init == "carry" and parallel:
        raise ValueError("tile_init='carry' serialises the tile chain; use "
                         "tile_init='fresh' with parallel=True (fresh is the parallel default)")
    dev = _device(gt, device)
    gt = _images(gt, dev)
    if tile % scale != 0:
        raise ValueError(f"SR scale must divide the tile size {tile}")
    if resize_y:
        # the input is the measurement: upsample it to the target canvas
        gt = mean_upsample(gt, scale)

    op, a_temp = build_hq_operators(deg, scale=scale, gt_shape=tuple(gt.shape[1:3]),
                                    mask=mask, tile=tile, device=dev)
    y_temp = a_temp(gt)
    apy = op.Ap(y_temp)
    h_target, w_target = int(apy.shape[1]), int(apy.shape[2])
    tiles = tile_grid(h_target, w_target, tile, stride)
    canvas = torch.zeros((1, h_target, w_target, 3), device=dev)
    ctx_canvas = as_mask(mask, dev)[None] if op.has_ctx else None
    samp_gens = dict(zip((t.index for t in tiles),
                         tile_generators(seed, image_index, [t.index for t in tiles],
                                         STREAM_SAMPLE, dev)))
    paste = {t.index: torch.from_numpy(t.paste_mask()).to(dev) for t in tiles}
    groups = _plan_groups(tiles) if parallel else [[t] for t in tiles]
    logger.info("mask-shift: canvas %dx%d, %d tiles in %d %s steps", h_target, w_target,
                len(tiles), len(groups), "wavefront" if parallel else "sequential")

    def window(img, t):
        return img[:, t.h0:t.h0 + tile, t.w0:t.w0 + tile, :]

    first_init = None
    if init_noise is not None:
        first_init = _images(init_noise, dev).reshape(1, tile, tile, 3)
    carry_x = first_init if tile_init == "carry" else None

    if mesh is not None:
        model_fn, guidance_fn, encode_fn, decode_fn = _over_mesh(
            mesh, model_fn, guidance_fn, encode_fn, decode_fn)
    done: set = set()
    ckpt = None
    if checkpoint_dir is not None:
        ckpt = Path(checkpoint_dir) / "mask_shift_state.npz"
        ckpt.parent.mkdir(parents=True, exist_ok=True)
        flags = (h_target, w_target, tile, stride, parallel, tile_init, deg, scale, resize_y,
                 encoder_cache, encoder_cache_policy, solver, seed, image_index, resume_salt)
        arrays = [_numpy(gt), None if mask is None else _numpy(as_mask(mask, "cpu")),
                  None if first_init is None else _numpy(first_init)]
        arrays += [getattr(tables, f.name) for f in dataclasses.fields(tables)]
        meta = _run_identity(flags, arrays)
        if resume and ckpt.exists():
            with np.load(ckpt) as f:
                state = dict(f)
            if np.array_equal(state["meta"], meta):
                canvas = torch.from_numpy(state["canvas"]).to(dev)
                done = set(map(tuple, state["done"].tolist()))
                if tile_init == "carry" and "carry_x" in state:
                    carry_x = torch.from_numpy(state["carry_x"]).to(dev)
                logger.info("resume: %d/%d tiles already done", len(done), len(tiles))
            else:
                logger.warning("resume: checkpoint %s is from another run (input, seed, "
                               "flags or schedule differ): starting afresh", ckpt)

    def save_state():
        arrays = dict(meta=meta, canvas=_numpy(canvas),
                      done=np.asarray(sorted(done), dtype=np.int64).reshape(-1, 2))
        if tile_init == "carry" and carry_x is not None:
            arrays["carry_x"] = _numpy(carry_x)
        tmp = ckpt.with_suffix(".tmp.npz")
        np.savez(tmp, **arrays)
        tmp.replace(ckpt)  # atomic: never a torn state file

    for group in groups:
        if done and all(t.index in done for t in group):
            continue
        apy_b = torch.cat([window(apy, t) for t in group])
        mask_b = torch.stack([paste[t.index] for t in group])
        content_b = torch.cat([window(canvas, t) for t in group])
        ctx_b = (torch.cat([window(ctx_canvas, t) for t in group])
                 if ctx_canvas is not None else None)
        if tile_init == "carry" and carry_x is not None:
            x_init_b = carry_x  # the previous tile's final state (or init_noise)
        else:
            x_init_b = torch.cat([
                first_init if (t.index == (0, 0) and first_init is not None)
                else _tile_init(seed, image_index, t, dev) for t in group])
        x_b, x0_b = _sample_group(
            model_fn, x_init_b, apy_b, op, tables, [samp_gens[t.index] for t in group],
            encoder_cache=encoder_cache, encoder_cache_policy=encoder_cache_policy,
            encode_fn=encode_fn, decode_fn=decode_fn, solver=solver, mesh=mesh, loop=loop,
            paste_mask=mask_b, paste_content=content_b, guidance_fn=guidance_fn,
            noise_fn=noise_fn, op_ctx=ctx_b)
        if tile_init == "carry":
            carry_x = x_b
        for i, t in enumerate(group):
            window(canvas, t).copy_(x0_b[i:i + 1])
            if progress_fn is not None:
                progress_fn(t, _numpy(x0_b[i:i + 1]))
        if ckpt is not None:
            done.update(t.index for t in group)
            if checkpoint_writer:
                save_state()
    if ckpt is not None and checkpoint_writer and ckpt.exists():
        ckpt.unlink()  # the run completed: never replay this state
    return {"final": _numpy(canvas), "apy": _numpy(apy), "y": _numpy(y_temp)}


def _run_identity(flags: tuple, arrays: list) -> np.ndarray:
    """SHA-256 of a Mask-Shift run: repr(flags) and the bytes of every array
    (None for one that is absent), as uint8."""
    h = hashlib.sha256(repr(flags).encode())
    for a in arrays:
        h.update(b"none" if a is None else np.ascontiguousarray(np.asarray(a)).tobytes())
    return np.frombuffer(h.digest(), dtype=np.uint8)
