"""The OpenAI guided-diffusion ("ADM") UNet of the hq pipeline (port of the
unguided part of ddnm_tpu/models/unet_adm.py).

FiLM scale-shift norm (the ResBlock's out norm takes the time embedding's
scale and shift inside the GroupNorm's own two launches, SiLU included),
resblock up/down sampling, multi-head attention at configured downsample
rates with the legacy head-major q/k/v channel split (or the new order),
zero-initialised output convolutions, the 6-channel learn_sigma head and a
class-label embedding. GroupNorm(32, eps=1e-5) runs in fp32 whatever the
torso dtype, and the output head (norm, SiLU, conv) in the input's dtype.

Submodules are named after the guided-diffusion state-dict keys
(`input_blocks.1.0.in_layers.0`, `middle_block.1.qkv`, `label_emb`,
`out.2`), so a reference checkpoint loads with
`load_state_dict(..., strict=True)`. The attention block's qkv and
proj_out keep the reference's 1-d convolution weights (O, I, 1).

`forward(x, t, y=None)` takes an NHWC batch, float timesteps (B,) and, for
a class-conditional model, int labels (B,), and returns the NHWC fp32
output (eps in channels 0-2, the learned variance's values in 3-5).
Inside, activations are NCHW in channels_last memory, as in the DDPM UNet.
The torso dtype is the dtype of the conv weights (`cast_torso`).

Not ported here: the classifier (`ADMClassifier`, `AttentionPool2d`,
`classifier_guidance_fn`), `ADMSuperResModel`, and the split forward of the
encoder cache (`mode="encode"` / `"decode"`), which raises.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
from torch import nn
from torch.nn import functional as F

from ddnm_tpu_torch.models.nn import (
    GroupNormF32,
    attention,
    avg_pool2,
    nearest_upsample,
    swish,
    timestep_embedding_adm,
)

__all__ = ["ADMUNet", "ResBlock", "AttentionBlock", "Downsample", "Upsample",
           "parse_channel_mult", "parse_attention_resolutions", "init_like_flax"]


def parse_channel_mult(channel_mult: str | Sequence[int], image_size: int) -> tuple:
    """Channel multipliers: the given list, or the default by image size."""
    if channel_mult:
        if isinstance(channel_mult, str):
            return tuple(int(c) for c in channel_mult.split(","))
        return tuple(channel_mult)
    if image_size == 512:
        return (0.5, 1, 1, 2, 2, 4, 4)
    if image_size == 256:
        return (1, 1, 2, 2, 4, 4)
    if image_size == 128:
        return (1, 1, 2, 3, 4)
    if image_size == 64:
        return (1, 2, 3, 4)
    raise ValueError(f"unsupported image size: {image_size}")


def parse_attention_resolutions(spec: str, image_size: int) -> tuple[int, ...]:
    """'32,16,8' (grid sizes) -> downsample rates."""
    return tuple(image_size // int(r) for r in str(spec).split(","))


def _norm(channels: int, swish: bool = False) -> GroupNormF32:
    return GroupNormF32(channels, num_groups=32, eps=1e-5, swish=swish)


def _up(x):
    """Nearest 2x upsample of an NCHW channels_last tensor."""
    return nearest_upsample(x.permute(0, 2, 3, 1), 2).permute(0, 3, 1, 2)


class Conv1x1(nn.Module):
    """The reference's 1-d 1x1 convolution (weight (O, I, 1)) applied to
    (B, T, I) tokens as a linear map."""

    def __init__(self, in_channels: int, out_channels: int):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(out_channels, in_channels, 1))
        self.bias = nn.Parameter(torch.empty(out_channels))
        bound = 1.0 / math.sqrt(in_channels)
        nn.init.uniform_(self.weight, -bound, bound)
        nn.init.uniform_(self.bias, -bound, bound)

    def forward(self, x):
        return F.linear(x, self.weight[:, :, 0], self.bias)


class ResBlock(nn.Module):
    """ADM ResBlock, with the up and down variants. The SiLU after each norm
    runs in the norm's pass (index 1 of in_layers and out_layers holds no
    weights, as in the reference's Sequential)."""

    def __init__(self, channels: int, emb_channels: int, out_channels: int,
                 use_scale_shift_norm: bool = True, up: bool = False, down: bool = False,
                 use_conv_skip: bool = False):
        super().__init__()
        self.up, self.down = up, down
        self.use_scale_shift_norm = use_scale_shift_norm
        self.in_layers = nn.ModuleList([
            _norm(channels, swish=True), nn.Identity(),
            nn.Conv2d(channels, out_channels, 3, padding=1)])
        self.emb_layers = nn.ModuleList([
            nn.Identity(),
            nn.Linear(emb_channels, 2 * out_channels if use_scale_shift_norm else out_channels)])
        self.out_layers = nn.ModuleList([
            _norm(out_channels, swish=True), nn.Identity(), nn.Identity(),
            nn.Conv2d(out_channels, out_channels, 3, padding=1)])
        if out_channels != channels:
            k = 3 if use_conv_skip else 1
            self.skip_connection = nn.Conv2d(channels, out_channels, k, padding=k // 2)
        else:
            self.skip_connection = nn.Identity()

    def forward(self, x, emb):
        h = self.in_layers[0](x)
        if self.up:
            h, x = _up(h), _up(x)
        elif self.down:
            h, x = avg_pool2(h), avg_pool2(x)
        h = self.in_layers[2](h)
        emb_out = self.emb_layers[1](swish(emb)).to(h.dtype)
        if self.use_scale_shift_norm:
            scale, shift = emb_out.chunk(2, dim=1)
            h = self.out_layers[0](h, scale, shift)
        else:
            h = self.out_layers[0](h + emb_out[:, :, None, None])
        h = self.out_layers[3](h)
        return self.skip_connection(x) + h


class AttentionBlock(nn.Module):
    """Multi-head self-attention over the spatial grid. `legacy_order`: the
    head-major split qkv.reshape(B, T, heads, 3, ch); otherwise
    (B, T, 3, heads, ch). q and k are each scaled by ch^-0.25 in the torso
    dtype (the scalar rounded to it first, as JAX rounds a weak-typed
    scalar), and the kernel runs with scale 1."""

    def __init__(self, channels: int, num_heads: int, legacy_order: bool = True):
        super().__init__()
        self.num_heads = num_heads
        self.legacy_order = legacy_order
        self.force: str | None = None  # handed to ops.fused_attention
        self.norm = _norm(channels)
        self.qkv = Conv1x1(channels, 3 * channels)
        self.proj_out = Conv1x1(channels, channels)
        self._scales: dict = {}

    def _qk_scale(self, ch: int, dtype: torch.dtype) -> float:
        if dtype not in self._scales:
            self._scales[dtype] = float(torch.tensor(ch ** -0.25).to(dtype))
        return self._scales[dtype]

    def forward(self, x):
        b, c, hgt, wid = x.shape
        t, heads = hgt * wid, self.num_heads
        ch = c // heads
        tokens = self.norm(x).permute(0, 2, 3, 1).reshape(b, t, c)
        qkv = self.qkv(tokens)  # (B, T, 3C)
        if self.legacy_order:
            q, k, v = qkv.reshape(b, t, heads, 3, ch).unbind(3)
        else:
            q, k, v = qkv.reshape(b, t, 3, heads, ch).unbind(2)

        def fold(z):  # (B, T, H, ch) -> contiguous (B*H, T, ch), the kernel's layout
            return z.transpose(1, 2).reshape(b * heads, t, ch).contiguous()

        s = self._qk_scale(ch, qkv.dtype)
        out = attention(fold(q) * s, fold(k) * s, fold(v), scale=1.0, force=self.force)
        out = out.reshape(b, heads, t, ch).transpose(1, 2).reshape(b, t, c)
        out = self.proj_out(out)
        return x + out.reshape(b, hgt, wid, c).permute(0, 3, 1, 2)


class Downsample(nn.Module):
    def __init__(self, channels: int, use_conv: bool = True,
                 out_channels: Optional[int] = None):
        super().__init__()
        self.use_conv = use_conv
        if use_conv:
            self.op = nn.Conv2d(channels, out_channels or channels, 3, stride=2, padding=1)

    def forward(self, x):
        return self.op(x) if self.use_conv else avg_pool2(x)


class Upsample(nn.Module):
    def __init__(self, channels: int, use_conv: bool = True,
                 out_channels: Optional[int] = None):
        super().__init__()
        self.use_conv = use_conv
        if use_conv:
            self.conv = nn.Conv2d(channels, out_channels or channels, 3, padding=1)

    def forward(self, x):
        x = _up(x)
        return self.conv(x) if self.use_conv else x


def _backbone_plan(model_channels, channel_mult, num_res_blocks, attention_resolutions):
    """The reference's input-block bookkeeping: (per-block specs
    (kind, ch_out, attn), skip channel list, final ch, final ds)."""
    ch = int(channel_mult[0] * model_channels)
    input_block_chans = [ch]
    ds = 1
    specs = []
    for level, mult in enumerate(channel_mult):
        for _ in range(num_res_blocks):
            ch = int(mult * model_channels)
            specs.append(("res", ch, ds in attention_resolutions))
            input_block_chans.append(ch)
        if level != len(channel_mult) - 1:
            specs.append(("down", ch, False))
            input_block_chans.append(ch)
            ds *= 2
    return specs, input_block_chans, ch, ds


class ADMUNet(nn.Module):
    """NHWC ADM UNet; forward(x, t, y=None) -> (B, H, W, out_channels) fp32."""

    def __init__(self, image_size: int = 256, in_channels: int = 3,
                 model_channels: int = 256, out_channels: int = 6,
                 num_res_blocks: int = 2,
                 attention_resolutions: Sequence[int] = (8, 16, 32),
                 channel_mult: Sequence[float] = (1, 1, 2, 2, 4, 4),
                 conv_resample: bool = True, num_heads: int = 4,
                 num_head_channels: int = 64, num_heads_upsample: int = -1,
                 use_scale_shift_norm: bool = True, resblock_updown: bool = True,
                 use_new_attention_order: bool = False,
                 num_classes: Optional[int] = None):
        super().__init__()
        self.image_size = image_size
        self.model_channels = model_channels
        self.num_classes = num_classes
        self.num_heads = num_heads
        self.num_head_channels = num_head_channels
        self.legacy_order = not use_new_attention_order
        attention_resolutions = tuple(attention_resolutions)
        ssn = use_scale_shift_norm
        ted = model_channels * 4

        # index 1 is the reference's SiLU (no weights), applied in forward
        self.time_embed = nn.ModuleList([nn.Linear(model_channels, ted), nn.Identity(),
                                         nn.Linear(ted, ted)])
        if num_classes is not None:
            self.label_emb = nn.Embedding(num_classes, ted)

        specs, chans, ch, ds = _backbone_plan(model_channels, channel_mult, num_res_blocks,
                                              attention_resolutions)
        ch_in = int(channel_mult[0] * model_channels)
        self.input_blocks = nn.ModuleList([nn.ModuleList([
            nn.Conv2d(in_channels, ch_in, 3, padding=1)])])
        for kind, ch_out, attn in specs:
            if kind == "res":
                layers = [ResBlock(ch_in, ted, ch_out, ssn)]
                if attn:
                    layers.append(self._attn(ch_out, self._heads(ch_out)))
            elif resblock_updown:
                layers = [ResBlock(ch_in, ted, ch_out, ssn, down=True)]
            else:
                layers = [Downsample(ch_in, conv_resample, ch_out)]
            self.input_blocks.append(nn.ModuleList(layers))
            ch_in = ch_out

        self.middle_block = nn.ModuleList([
            ResBlock(ch, ted, ch, ssn), self._attn(ch, self._heads(ch)),
            ResBlock(ch, ted, ch, ssn)])

        heads_up = num_heads if num_heads_upsample == -1 else num_heads_upsample
        chans = list(chans)
        self.output_blocks = nn.ModuleList()
        for level, mult in list(enumerate(channel_mult))[::-1]:
            for i in range(num_res_blocks + 1):
                out_ch = int(model_channels * mult)
                layers = [ResBlock(ch + chans.pop(), ted, out_ch, ssn)]
                ch = out_ch
                if ds in attention_resolutions:
                    heads = heads_up if num_head_channels == -1 else self._heads(ch)
                    layers.append(self._attn(ch, heads))
                if level and i == num_res_blocks:
                    layers.append(ResBlock(ch, ted, ch, ssn, up=True) if resblock_updown
                                  else Upsample(ch, conv_resample, ch))
                    ds //= 2
                self.output_blocks.append(nn.ModuleList(layers))

        # out.0 GroupNorm (+ the SiLU of out.1), out.2 the head conv
        self.out = nn.ModuleList([_norm(ch, swish=True), nn.Identity(),
                                  nn.Conv2d(ch, out_channels, 3, padding=1)])
        self.to(memory_format=torch.channels_last)

    def _heads(self, ch: int) -> int:
        if self.num_head_channels == -1:
            return self.num_heads
        if ch % self.num_head_channels:
            # the reference's constraint (unet.py:279-283), not a silent floor
            raise ValueError(
                f"q,k,v channels {ch} not divisible by num_head_channels "
                f"{self.num_head_channels} (guided_diffusion/unet.py:281)")
        return ch // self.num_head_channels

    def _attn(self, ch: int, heads: int) -> AttentionBlock:
        return AttentionBlock(ch, heads, legacy_order=self.legacy_order)

    @property
    def dtype(self) -> torch.dtype:
        """The torso dtype (the dtype of the conv weights)."""
        return self.input_blocks[0][0].weight.dtype

    def forward(self, x, timesteps, y=None, *, mode: str = "full", cache=None):
        if mode not in ("full", "encode", "decode"):
            raise ValueError(f"mode must be 'full', 'encode' or 'decode', got {mode!r}")
        if mode != "full":
            raise NotImplementedError(
                f"mode={mode!r} (the encoder cache) is not ported yet (ROADMAP.md "
                "Queue 1 D: solvers and acceleration)")
        emb = timestep_embedding_adm(timesteps, self.model_channels).to(self.dtype)
        emb = self.time_embed[2](swish(self.time_embed[0](emb)))
        if self.num_classes is not None:
            if y is None:
                raise ValueError("class-conditional model needs labels")
            emb = emb + self.label_emb(y)

        orig_dtype = x.dtype
        h = x.to(self.dtype).permute(0, 3, 1, 2)
        hs = []
        for block in self.input_blocks:
            for layer in block:
                h = layer(h, emb) if isinstance(layer, ResBlock) else layer(h)
            hs.append(h)
        h = self.middle_block[0](h, emb)
        h = self.middle_block[1](h)
        h = self.middle_block[2](h, emb)
        for block in self.output_blocks:
            h = torch.cat([h, hs.pop().to(h.dtype)], dim=1)
            for layer in block:
                h = layer(h, emb) if isinstance(layer, ResBlock) else layer(h)

        h = self.out[0](h.to(orig_dtype))  # norm + SiLU in the input's dtype
        head = self.out[2]  # the head conv runs in fp32 whatever the torso
        out = F.conv2d(h.float(), head.weight.float(), head.bias.float(), padding=1)
        return out.permute(0, 2, 3, 1).contiguous()

    @classmethod
    def from_config(cls, config) -> "ADMUNet":
        """From a main-layer Config whose model type is "openai"."""
        m = config.model
        size = config.data.image_size
        return cls(
            image_size=size,
            in_channels=3,
            model_channels=m.num_channels,
            out_channels=6 if m.learn_sigma else 3,
            num_res_blocks=m.num_res_blocks,
            attention_resolutions=parse_attention_resolutions(m.attention_resolutions, size),
            channel_mult=parse_channel_mult(m.channel_mult, size),
            num_heads=m.num_heads,
            num_head_channels=m.num_head_channels,
            num_heads_upsample=m.num_heads_upsample,
            use_scale_shift_norm=m.use_scale_shift_norm,
            resblock_updown=m.resblock_updown,
            use_new_attention_order=m.use_new_attention_order,
            num_classes=1000 if m.class_cond else None,
        )


_ZERO_INIT = ("out_layers.3", "proj_out", "out.2")


@torch.no_grad()
def init_like_flax(model: nn.Module, seed: int) -> nn.Module:
    """Random weights from `seed`, drawn as the JAX package's ADM init
    draws them (not its bits): kernels lecun-normal (a normal truncated at
    two standard deviations, variance 1 / fan_in), biases zero, the
    zero-initialised layers (each ResBlock's out conv, each attention's
    proj_out, the head conv) zero, GroupNorm scale 1 and shift 0, the label
    embedding normal with variance 1 / features. Draws on the parameters'
    device."""
    gens: dict = {}

    def gen(device):
        if device not in gens:
            gens[device] = torch.Generator(device=device).manual_seed(seed)
        return gens[device]

    for name, mod in model.named_modules():
        if isinstance(mod, GroupNormF32):
            mod.weight.fill_(1.0)
            mod.bias.fill_(0.0)
        elif isinstance(mod, nn.Embedding):
            w = mod.weight
            w.normal_(0.0, 1.0 / math.sqrt(w.shape[1]), generator=gen(w.device))
        elif isinstance(mod, (nn.Conv2d, nn.Linear, Conv1x1)):
            w = mod.weight
            if name.endswith(_ZERO_INIT):
                w.zero_()
            else:
                fan_in = w[0].numel()
                std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
                nn.init.trunc_normal_(w, 0.0, std, -2.0 * std, 2.0 * std,
                                      generator=gen(w.device))
            if mod.bias is not None:
                mod.bias.zero_()
    return model
