"""Weights carried across from the JAX package's parameter tree.

`params_from_flax` inverts ddnm_tpu/models/convert.py
(`torch_state_dict_to_flax`) for the DDPM UNet: it turns the JAX package's
parameter tree (nested dicts of arrays) into this port's state dict:

  - conv kernel (kH, kW, I, O) -> weight (O, I, kH, kW)
  - dense kernel (I, O)        -> weight (O, I)
  - `<module>/gn/scale|bias`   -> `<module>.weight|bias`

The port keeps its own copy of the forward key rule (`ddpm_key_map`) and
checks every produced key against it.
"""

from __future__ import annotations

from typing import Mapping, Sequence

import numpy as np
import torch

__all__ = ["collapse_numeric", "ddpm_key_map", "params_from_flax"]


def collapse_numeric(segments: Sequence[str]) -> list[str]:
    """Merge numeric path segments into their predecessor:
    ["down", "0", "block", "1"] -> ["down_0", "block_1"]."""
    out: list[str] = []
    for seg in segments:
        if seg.isdigit() and out:
            out[-1] = f"{out[-1]}_{seg}"
        else:
            out.append(seg)
    return out


_INNER = {
    "norm1", "conv1", "temb_proj", "norm2", "conv2", "nin_shortcut",
    "conv_shortcut", "norm", "q", "k", "v", "proj_out", "conv",
}


def ddpm_key_map(segments: Sequence[str]) -> tuple[str, ...]:
    """Torch module path -> JAX parameter path (the JAX package's rule)."""
    segs = collapse_numeric(segments)
    if len(segs) >= 2 and segs[-1] in _INNER:
        return ("_".join(segs[:-1]), segs[-1])
    return ("_".join(segs),)


_UNSPLIT = {"conv_in", "conv_out", "norm_out"}


def _torch_path(flax_path: tuple[str, ...]) -> str:
    """JAX module path -> torch module path (the inverse of ddpm_key_map)."""
    top = flax_path[0]
    if top in _UNSPLIT:
        head = top
    elif top.startswith("mid_"):  # mid.block_1, mid.attn_1, mid.block_2
        head = "mid." + top[len("mid_"):]
    else:
        head = top.replace("_", ".")
    return ".".join((head,) + tuple(flax_path[1:]))


def _leaves(tree: Mapping, prefix=()):
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def params_from_flax(tree: Mapping) -> dict[str, torch.Tensor]:
    """JAX DDPM UNet parameter tree (optionally under "params") -> this
    port's state dict of fp32 CPU tensors."""
    if "params" in tree and isinstance(tree["params"], Mapping):
        tree = tree["params"]
    out: dict[str, torch.Tensor] = {}
    for path, value in _leaves(tree):
        arr = np.asarray(value, dtype=np.float32)
        *mods, leaf = path
        if mods and mods[-1] == "gn":
            mods = mods[:-1]
            name = {"scale": "weight", "bias": "bias"}[leaf]
        elif leaf == "kernel":
            name = "weight"
            if arr.ndim == 4:
                arr = np.transpose(arr, (3, 2, 0, 1))
            elif arr.ndim == 2:
                arr = arr.T
            else:
                raise ValueError(f"unhandled kernel ndim {arr.ndim} at {path}")
        elif leaf == "bias":
            name = "bias"
        else:
            raise ValueError(f"unhandled parameter {path}")
        mod_path = _torch_path(tuple(mods))
        if ddpm_key_map(mod_path.split(".")) != tuple(mods):
            raise ValueError(f"key rule does not invert at {path} -> {mod_path}")
        out[f"{mod_path}.{name}"] = torch.from_numpy(np.ascontiguousarray(arr))
    return out
