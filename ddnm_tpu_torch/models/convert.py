"""Weights carried across from the JAX package's parameter tree.

`params_from_flax` inverts ddnm_tpu/models/convert.py
(`torch_state_dict_to_flax`) for the DDPM and the ADM UNet: it turns the
JAX package's parameter tree (nested dicts of arrays) into this port's
state dict:

  - conv kernel (kH, kW, I, O) -> weight (O, I, kH, kW)
  - dense kernel (I, O)        -> weight (O, I); under an ADM attention's
    `qkv` / `proj_out` (the reference's 1-d convolutions) weight (O, I, 1)
  - `<module>/gn/scale|bias`   -> `<module>.weight|bias`
  - `label_emb/embedding`      -> `label_emb.weight` (num_classes, D)

The port keeps its own copy of the forward key rule (`ddpm_key_map`, which
is also the ADM family's `adm_key_map`) and checks every produced key
against it.
"""

from __future__ import annotations

from typing import Mapping, Sequence

import re

import numpy as np
import torch

__all__ = ["collapse_numeric", "ddpm_key_map", "adm_key_map", "params_from_flax"]


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
    # DDPM family
    "norm1", "conv1", "temb_proj", "norm2", "conv2", "nin_shortcut",
    "conv_shortcut", "norm", "q", "k", "v", "proj_out", "conv",
    # ADM family
    "in_layers_0", "in_layers_2", "emb_layers_1", "out_layers_0",
    "out_layers_3", "skip_connection", "qkv", "op", "qkv_proj", "c_proj",
}


def ddpm_key_map(segments: Sequence[str]) -> tuple[str, ...]:
    """Torch module path -> JAX parameter path (the JAX package's rule)."""
    segs = collapse_numeric(segments)
    if len(segs) >= 2 and segs[-1] in _INNER:
        return ("_".join(segs[:-1]), segs[-1])
    return ("_".join(segs),)


adm_key_map = ddpm_key_map  # one mechanical rule covers both families

_UNSPLIT = {"conv_in", "conv_out", "norm_out"}


# top-level module names of the ADM UNet (guided-diffusion's keys)
_ADM_TOPS = re.compile(r"^(time_embed|input_blocks|middle_block|output_blocks|out)(_\d+)+$"
                       r"|^label_emb$")


def _torch_path(flax_path: tuple[str, ...]) -> str:
    """JAX module path -> torch module path (the inverse of ddpm_key_map)."""
    top = flax_path[0]
    if _ADM_TOPS.match(top):
        # ADM: each "_<n>" is a Sequential / ModuleList index, at the top
        # and in the block-inner names (in_layers_0 -> in_layers.0)
        return ".".join(re.sub(r"_(\d+)", r".\1", seg) for seg in flax_path)
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
    """JAX DDPM or ADM UNet parameter tree (optionally under "params") ->
    this port's state dict of fp32 CPU tensors."""
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
                if mods and mods[-1] in ("qkv", "proj_out"):
                    arr = arr[:, :, None]  # the ADM attention's 1-d convolutions
            else:
                raise ValueError(f"unhandled kernel ndim {arr.ndim} at {path}")
        elif leaf == "bias":
            name = "bias"
        elif leaf == "embedding":  # nn.Embed -> nn.Embedding
            name = "weight"
        else:
            raise ValueError(f"unhandled parameter {path}")
        mod_path = _torch_path(tuple(mods))
        if ddpm_key_map(mod_path.split(".")) != tuple(mods):
            raise ValueError(f"key rule does not invert at {path} -> {mod_path}")
        out[f"{mod_path}.{name}"] = torch.from_numpy(np.ascontiguousarray(arr))
    return out
