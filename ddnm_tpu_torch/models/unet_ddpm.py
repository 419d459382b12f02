"""The "simple" DDPM UNet of the CelebA-HQ family (port of
ddnm_tpu/models/unet_ddpm.py).

128 base channels x (1,1,2,2,4,4), 2 res blocks per level, single-head
attention at `attn_resolutions`, GroupNorm(32, eps=1e-6) computed in fp32,
the swish after a norm (norm1, norm2, norm_out) inside the norm's own pass
(`GroupNormF32(swish=True)`), sin-first time embedding, a stride-2
downsample conv after an asymmetric (0,1,0,1) pad, nearest-x2 + conv
upsample.

Submodules are named after the reference checkpoint's keys
(`down.4.attn.0.q.weight`, `mid.block_1.norm1.bias`, ...), so those state
dicts load with `load_state_dict(..., strict=True)`.

`forward(x, t)` takes an NHWC image batch and float timesteps (B,) and
returns the NHWC fp32 epsilon prediction. Inside, activations are NCHW in
channels_last memory. The torso dtype is the dtype of the conv weights:
`cast_torso(model, torch.bfloat16)` gives a bf16 torso with fp32 GroupNorm.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn
from torch.nn import functional as F

from ddnm_tpu_torch.models.nn import (
    GroupNormF32,
    attention,
    nearest_upsample,
    swish,
    timestep_embedding_ddpm,
)

__all__ = ["DDPMUNet", "ResnetBlock", "AttnBlock", "Downsample", "Upsample",
           "set_op_force"]


def _norm(channels: int, swish: bool = False) -> GroupNormF32:
    return GroupNormF32(channels, num_groups=32, eps=1e-6, swish=swish)


class ResnetBlock(nn.Module):
    def __init__(self, in_channels: int, out_channels: int, temb_channels: int,
                 conv_shortcut: bool = False):
        super().__init__()
        self.norm1 = _norm(in_channels, swish=True)
        self.conv1 = nn.Conv2d(in_channels, out_channels, 3, padding=1)
        self.temb_proj = nn.Linear(temb_channels, out_channels)
        self.norm2 = _norm(out_channels, swish=True)
        self.conv2 = nn.Conv2d(out_channels, out_channels, 3, padding=1)
        if in_channels != out_channels:
            if conv_shortcut:
                self.conv_shortcut = nn.Conv2d(in_channels, out_channels, 3, padding=1)
            else:
                self.nin_shortcut = nn.Conv2d(in_channels, out_channels, 1)

    def forward(self, x, temb):
        h = self.conv1(self.norm1(x))  # norm1 and norm2 end in the swish
        h = h + self.temb_proj(swish(temb))[:, :, None, None]
        h = self.conv2(self.norm2(h))
        if hasattr(self, "conv_shortcut"):
            x = self.conv_shortcut(x)
        elif hasattr(self, "nin_shortcut"):
            x = self.nin_shortcut(x)
        return x + h


class AttnBlock(nn.Module):
    def __init__(self, channels: int):
        super().__init__()
        self.force: str | None = None  # handed to ops.fused_attention
        self.spatial = None  # models/nn.py shard_spatially
        self.norm = _norm(channels)
        self.q = nn.Conv2d(channels, channels, 1)
        self.k = nn.Conv2d(channels, channels, 1)
        self.v = nn.Conv2d(channels, channels, 1)
        self.proj_out = nn.Conv2d(channels, channels, 1)

    def forward(self, x):
        b, c, hgt, wid = x.shape
        h = self.norm(x)

        def tokens(t):  # NCHW channels_last -> (B, H*W, C), a view when possible
            return t.permute(0, 2, 3, 1).reshape(b, hgt * wid, c).contiguous()

        sharded = {} if self.spatial is None else {"spatial": self.spatial}
        out = attention(tokens(self.q(h)), tokens(self.k(h)), tokens(self.v(h)),
                        scale=int(c) ** (-0.5), force=self.force, **sharded)
        out = out.reshape(b, hgt, wid, c).permute(0, 3, 1, 2)
        return x + self.proj_out(out)


class Downsample(nn.Module):
    down = True  # halves the rows (parallel/spatial.py lowest_rows)

    def __init__(self, channels: int, with_conv: bool = True):
        super().__init__()
        self.with_conv = with_conv
        self.spatial = None  # models/nn.py shard_spatially
        if with_conv:
            self.conv = nn.Conv2d(channels, channels, 3, stride=2, padding=0)

    def forward(self, x):
        if self.with_conv:
            # one extra row/col at bottom/right, as the reference pads; a
            # spatial shard's extra row is its halo row below (zeros on the
            # last shard)
            return self.conv(F.pad(x, (0, 1) if self.spatial is not None else (0, 1, 0, 1)))
        return F.avg_pool2d(x, 2)


class Upsample(nn.Module):
    def __init__(self, channels: int, with_conv: bool = True):
        super().__init__()
        self.with_conv = with_conv
        if with_conv:
            self.conv = nn.Conv2d(channels, channels, 3, padding=1)

    def forward(self, x):
        x = nearest_upsample(x.permute(0, 2, 3, 1), 2).permute(0, 3, 1, 2)
        return self.conv(x) if self.with_conv else x


def set_op_force(model: nn.Module, force: str | None) -> None:
    """Route every GroupNorm and attention of `model` (a DDPM or an ADM
    UNet: each module that hands a `force` to its op) through `force`
    ("kernel", "torch", or None for the default of the tensor's device)."""
    for m in model.modules():
        if hasattr(m, "force"):
            m.force = force


class DDPMUNet(nn.Module):
    """NHWC DDPM UNet; forward(x, t) -> epsilon prediction.

    Also exposes `time_embed(t)`, `encode(x, temb)` and `decode(h, hs, temb)`
    with forward == decode(encode(...)), as the JAX model does."""

    # unet_adm.init_like_flax: flax's default initialisers everywhere (the
    # JAX DDPM UNet zero-initialises no layer)
    zero_init = ()

    def __init__(self, ch: int = 128, out_ch: int = 3,
                 ch_mult: Sequence[int] = (1, 1, 2, 2, 4, 4),
                 num_res_blocks: int = 2, attn_resolutions: Sequence[int] = (16,),
                 resolution: int = 256, resamp_with_conv: bool = True,
                 in_channels: int = 3):
        super().__init__()
        self.ch = ch
        self.ch_mult = tuple(ch_mult)
        self.num_res_blocks = num_res_blocks
        temb_ch = ch * 4

        self.temb = nn.Module()
        self.temb.dense = nn.ModuleList([nn.Linear(ch, temb_ch),
                                         nn.Linear(temb_ch, temb_ch)])
        self.conv_in = nn.Conv2d(in_channels, ch, 3, padding=1)

        curr_res = resolution
        in_mult = (1,) + self.ch_mult
        self.down = nn.ModuleList()
        block_in = ch
        for i_level, mult in enumerate(self.ch_mult):
            block = nn.ModuleList()
            attn = nn.ModuleList()
            block_in = ch * in_mult[i_level]
            block_out = ch * mult
            for _ in range(num_res_blocks):
                block.append(ResnetBlock(block_in, block_out, temb_ch))
                block_in = block_out
                if curr_res in attn_resolutions:
                    attn.append(AttnBlock(block_in))
            down = nn.Module()
            down.block = block
            down.attn = attn
            if i_level != len(self.ch_mult) - 1:
                down.downsample = Downsample(block_in, resamp_with_conv)
                curr_res //= 2
            self.down.append(down)

        self.mid = nn.Module()
        self.mid.block_1 = ResnetBlock(block_in, block_in, temb_ch)
        self.mid.attn_1 = AttnBlock(block_in)
        self.mid.block_2 = ResnetBlock(block_in, block_in, temb_ch)

        ups = []
        for i_level in reversed(range(len(self.ch_mult))):
            block = nn.ModuleList()
            attn = nn.ModuleList()
            block_out = ch * self.ch_mult[i_level]
            skip_in = ch * self.ch_mult[i_level]
            for i_block in range(num_res_blocks + 1):
                if i_block == num_res_blocks:
                    skip_in = ch * in_mult[i_level]
                block.append(ResnetBlock(block_in + skip_in, block_out, temb_ch))
                block_in = block_out
                if curr_res in attn_resolutions:
                    attn.append(AttnBlock(block_in))
            up = nn.Module()
            up.block = block
            up.attn = attn
            if i_level != 0:
                up.upsample = Upsample(block_in, resamp_with_conv)
                curr_res *= 2
            ups.insert(0, up)
        self.up = nn.ModuleList(ups)

        self.norm_out = _norm(block_in, swish=True)
        self.conv_out = nn.Conv2d(block_in, out_ch, 3, padding=1)
        self.to(memory_format=torch.channels_last)

    @property
    def dtype(self) -> torch.dtype:
        """The torso dtype (the dtype of the conv weights)."""
        return self.conv_in.weight.dtype

    def time_embed(self, t):
        temb = timestep_embedding_ddpm(t, self.ch).to(self.dtype)
        return self.temb.dense[1](swish(self.temb.dense[0](temb)))

    def encode(self, x, temb):
        """Down path + middle on an NHWC batch; returns (h, skip list)."""
        x = x.to(self.dtype).permute(0, 3, 1, 2)
        hs = [self.conv_in(x)]
        for down in self.down:
            for i_block, block in enumerate(down.block):
                h = block(hs[-1], temb)
                if len(down.attn):
                    h = down.attn[i_block](h)
                hs.append(h)
            if hasattr(down, "downsample"):
                hs.append(down.downsample(hs[-1]))
        h = self.mid.block_1(hs[-1], temb)
        h = self.mid.attn_1(h)
        h = self.mid.block_2(h, temb)
        return h, hs

    def decode(self, h, hs, temb, orig_dtype=torch.float32):
        """Up path + output head, consuming the encoder skips; NHWC fp32 out."""
        hs = list(hs)
        for i_level in reversed(range(len(self.ch_mult))):
            up = self.up[i_level]
            for i_block, block in enumerate(up.block):
                h = block(torch.cat([h, hs.pop()], dim=1), temb)
                if len(up.attn):
                    h = up.attn[i_block](h)
            if hasattr(up, "upsample"):
                h = up.upsample(h)
        h = self.norm_out(h.to(orig_dtype))  # ends in the swish
        out = self.conv_out(h.to(self.dtype)).float()
        return out.permute(0, 2, 3, 1).contiguous()

    def forward(self, x, t):
        temb = self.time_embed(t)
        h, hs = self.encode(x, temb)
        return self.decode(h, hs, temb, orig_dtype=x.dtype)

    @classmethod
    def from_config(cls, config) -> "DDPMUNet":
        m = config.model
        return cls(
            ch=m.ch,
            out_ch=m.out_ch,
            ch_mult=tuple(m.ch_mult),
            num_res_blocks=m.num_res_blocks,
            attn_resolutions=tuple(m.attn_resolutions),
            resolution=config.data.image_size,
            resamp_with_conv=m.resamp_with_conv,
            in_channels=m.in_channels,
        )
