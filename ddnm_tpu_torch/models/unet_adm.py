"""The OpenAI guided-diffusion ("ADM") UNet, its super-resolution variant
and its classifier, with classifier guidance (port of
ddnm_tpu/models/unet_adm.py).

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

`ADMClassifier` is the reference's EncoderUNetModel: the UNet's input and
middle blocks (`_ADMTorso`, shared with `ADMUNet` as JAX shares
`_ADMBase._torso`) and a head, one of four pools (`attention`, the
CLIP-style `AttentionPool2d`; `adaptive`; `spatial`; `spatial_v2`).
`classifier_guidance_fn` and `classifier_guidance_from_params` build the
samplers' guidance hook grad_x log p(y | x) * scale: the classifier runs
under `torch.enable_grad()` on a detached copy of x that requires grad,
with its parameters frozen, so its GroupNorms and attentions take the
backward kernels on a card (models/nn.py). The layers that JAX computes
in fp32 under a bf16 classifier (the positional embedding, the spatial
pools' Linears and norm, the adaptive pool's 1x1 conv) keep fp32 weights
under `cast_torso` (`keep_fp32`).

Under spatial shards (`shard_spatially` on a classifier: classifier
guidance under --sp), the torso runs sharded as the UNet's does, and the
pool heads see the whole map: the attention and adaptive pools gather
the normed lowest map's rows (parallel.spatial.gather_rows, whose
gradient is this rank's block), and the spatial pools add the shards'
partial means (sum_replicated), so the logits, the loss and the
gradients entering the torso are the same on every rank. The guidance
hooks go through `Grid.wrap(guidance_fn=)` (classifier_guidance_from_params
takes `spatial=`): x's rows of this rank in, the gradient's rows of every
rank out.

`forward(..., mode="encode")` returns the encoder cache of the encoder
propagation (sampling/accel.py): (h, skips) after the middle block;
`mode="decode", cache=(h, skips)` runs the output blocks and the head on a
copy of the skips with a fresh time (and label) embedding, x giving only
its dtype. `mode="full"` runs both halves through the same code.
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
    halo_conv3x3,
    nearest_upsample,
    swish,
    timestep_embedding_adm,
)
from ddnm_tpu_torch.parallel.spatial import gather_rows, split_rows, sum_replicated

__all__ = ["ADMUNet", "ADMSuperResModel", "ADMClassifier", "AttentionPool2d", "ResBlock",
           "AttentionBlock", "Downsample", "Upsample", "parse_channel_mult",
           "parse_attention_resolutions", "init_like_flax", "classifier_guidance_fn",
           "classifier_guidance_from_params"]


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
        self.spatial = None  # models/nn.py shard_spatially
        self.norm = _norm(channels)
        self.qkv = Conv1x1(channels, 3 * channels)
        self.proj_out = Conv1x1(channels, channels)
        self._scales: dict = {}

    def _qk_scale(self, ch: int, dtype: torch.dtype) -> float:
        return _qk_scale(self._scales, ch, dtype)

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

        out = _heads_attention(q, k, v, self._qk_scale(ch, qkv.dtype), self.force,
                               self.spatial)
        out = self.proj_out(out)
        return x + out.reshape(b, hgt, wid, c).permute(0, 3, 1, 2)


def _qk_scale(cache: dict, ch: int, dtype: torch.dtype) -> float:
    """ch^-0.25 rounded to `dtype` (as JAX rounds a weak-typed scalar)."""
    if dtype not in cache:
        cache[dtype] = float(torch.tensor(ch ** -0.25).to(dtype))
    return cache[dtype]


def _heads_attention(q, k, v, s: float, force, spatial=None):
    """Attention of (B, T, H, ch) q, k, v, each scaled by `s`, head by
    head; returns (B, T, H ch). The head fold copies into the kernel's
    contiguous (B H, T, ch) layout (at batch 1 a reshape alone would leave
    a strided view). `spatial`: the tokens are this shard's, a contiguous
    block of the sequence; k and v are gathered from every shard."""
    b, t, heads, ch = q.shape

    def fold(z):
        return z.transpose(1, 2).reshape(b * heads, t, ch).contiguous()

    sharded = {} if spatial is None else {"spatial": spatial}
    out = attention(fold(q) * s, fold(k) * s, fold(v), scale=1.0, force=force, **sharded)
    return out.reshape(b, heads, t, ch).transpose(1, 2).reshape(b, t, heads * ch)


class Downsample(nn.Module):
    down = True  # halves the rows (parallel/spatial.py lowest_rows)

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


class _ADMTorso(nn.Module):
    """What the ADM UNet and its classifier share (JAX `_ADMBase`): the
    time embedding, the input blocks and the middle block, the head count
    rule and the torso dtype."""

    def _build_time_embed(self, model_channels: int) -> None:
        # index 1 is the reference's SiLU (no weights), applied in forward
        ted = model_channels * 4
        self.time_embed = nn.ModuleList([nn.Linear(model_channels, ted), nn.Identity(),
                                         nn.Linear(ted, ted)])

    def _build_torso(self, in_channels, model_channels, channel_mult, num_res_blocks,
                     attention_resolutions, conv_resample, use_scale_shift_norm,
                     resblock_updown):
        """The input blocks and the middle block; returns the backbone plan's
        (skip channels, final channels, final downsample rate)."""
        ted, ssn = model_channels * 4, use_scale_shift_norm
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
        return chans, ch, ds

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

    def _embed(self, timesteps):
        """The time embedding in the torso dtype."""
        emb = timestep_embedding_adm(timesteps, self.model_channels).to(self.dtype)
        return self.time_embed[2](swish(self.time_embed[0](emb)))

    def _torso(self, h, emb):
        """Input blocks + middle block on an NCHW torso-dtype tensor: (h,
        the input blocks' outputs)."""
        hs = []
        for block in self.input_blocks:
            for layer in block:
                h = layer(h, emb) if isinstance(layer, ResBlock) else layer(h)
            hs.append(h)
        h = self.middle_block[0](h, emb)
        h = self.middle_block[1](h)
        return self.middle_block[2](h, emb), hs


class ADMUNet(_ADMTorso):
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

        self._build_time_embed(model_channels)
        if num_classes is not None:
            self.label_emb = nn.Embedding(num_classes, ted)
        chans, ch, ds = self._build_torso(in_channels, model_channels, channel_mult,
                                          num_res_blocks, attention_resolutions, conv_resample,
                                          ssn, resblock_updown)

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
        self.spatial = None  # the head conv's halo (models/nn.py shard_spatially)
        self.to(memory_format=torch.channels_last)

    def forward(self, x, timesteps, y=None, *, mode: str = "full", cache=None):
        if mode not in ("full", "encode", "decode"):
            raise ValueError(f"mode must be 'full', 'encode' or 'decode', got {mode!r}")
        if mode == "decode" and cache is None:
            raise ValueError("mode='decode' requires cache=(h, skips)")
        emb = self._embed(timesteps)
        if self.num_classes is not None:
            if y is None:
                raise ValueError("class-conditional model needs labels")
            emb = emb + self.label_emb(y)

        if mode == "decode":
            # a copy: the output blocks pop it, and the cache serves many steps
            return self._decode(cache[0], list(cache[1]), emb, x.dtype)
        h, hs = self._torso(x.to(self.dtype).permute(0, 3, 1, 2), emb)
        if mode == "encode":
            return h, tuple(hs)
        return self._decode(h, hs, emb, x.dtype)

    def _decode(self, h, hs: list, emb, orig_dtype):
        """The output blocks, consuming the skip list `hs`, and the head:
        NHWC fp32 out."""
        for block in self.output_blocks:
            h = torch.cat([h, hs.pop().to(h.dtype)], dim=1)
            for layer in block:
                h = layer(h, emb) if isinstance(layer, ResBlock) else layer(h)

        h = self.out[0](h.to(orig_dtype))  # norm + SiLU in the input's dtype
        head = self.out[2]  # the head conv runs in fp32 whatever the torso
        out = halo_conv3x3(h.float(), head.weight.float(), head.bias.float(), self.spatial)
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
    proj_out, the head conv; the model's `zero_init` names where it has
    them) zero, GroupNorm scale 1 and shift 0, the label embedding normal
    with variance 1 / features, an attention pool's positional embedding
    normal with variance 1 / channels. Draws on the parameters' device."""
    zero_init = getattr(model, "zero_init", _ZERO_INIT)
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
        elif isinstance(mod, AttentionPool2d):
            w = mod.positional_embedding
            w.normal_(0.0, 1.0 / math.sqrt(w.shape[0]), generator=gen(w.device))
        elif isinstance(mod, (nn.Conv2d, nn.Linear, Conv1x1)):
            w = mod.weight
            if name.endswith(zero_init):
                w.zero_()
            else:
                fan_in = w[0].numel()
                std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
                nn.init.trunc_normal_(w, 0.0, std, -2.0 * std, 2.0 * std,
                                      generator=gen(w.device))
            if mod.bias is not None:
                mod.bias.zero_()
    return model



class ADMSuperResModel(ADMUNet):
    """ADM SuperResModel (reference unet.py:667-681; ddnm_tpu
    `ADMSuperResModel`): the UNet conditioned on a bilinear upsample of a
    low-resolution image concatenated to x on the channels (in_channels
    counts both). forward(x, t, low_res=None, y=None); the upsample follows
    `jax.image.resize(method="bilinear")`: half-pixel centres, and at the
    border the weights that fall outside renormalised, which for an
    upsample is F.interpolate's clamp (antialiasing where it shrinks). No
    CLI uses it."""

    def forward(self, x, timesteps, low_res=None, y=None, *, mode: str = "full", cache=None):
        if low_res is not None and mode != "decode":
            b, h, w, _ = x.shape
            up = F.interpolate(low_res.permute(0, 3, 1, 2).float(), size=(h, w),
                               mode="bilinear", align_corners=False, antialias=True)
            x = torch.cat([x, up.permute(0, 2, 3, 1).to(x.dtype)], dim=-1)
        return super().forward(x, timesteps, y, mode=mode, cache=cache)


class AttentionPool2d(nn.Module):
    """CLIP-style attention pooling (reference unet.py:22-51): the spatial
    tokens with their mean in front, plus a learned positional embedding
    (C, T + 1), through one multi-head attention (the new order: q, k, v
    split before the heads); returns the mean token's output (B,
    output_dim). The positional embedding stays fp32 (`keep_fp32`), as
    JAX keeps it; the projections compute in the torso dtype."""

    keep_fp32 = True

    def __init__(self, spacial_dim: int, embed_dim: int, num_head_channels: int,
                 output_dim: int):
        super().__init__()
        self.positional_embedding = nn.Parameter(
            torch.randn(embed_dim, spacial_dim ** 2 + 1) / embed_dim ** 0.5)
        self.qkv_proj = Conv1x1(embed_dim, 3 * embed_dim)
        self.c_proj = Conv1x1(embed_dim, output_dim)
        self.num_heads = embed_dim // num_head_channels
        self.force: str | None = None  # handed to ops.fused_attention
        self._scales: dict = {}

    def forward(self, x):
        b, c, hgt, wid = x.shape
        t, heads = hgt * wid + 1, self.num_heads
        tokens = x.permute(0, 2, 3, 1).reshape(b, t - 1, c)
        tokens = torch.cat([tokens.mean(dim=1, keepdim=True), tokens], dim=1)
        tokens = tokens + self.positional_embedding.t()[None].to(tokens.dtype)
        qkv = self.qkv_proj(tokens.to(self.qkv_proj.weight.dtype))  # (B, T + 1, 3C)
        q, k, v = qkv.reshape(b, t, 3, heads, c // heads).unbind(2)
        out = _heads_attention(q, k, v, _qk_scale(self._scales, c // heads, qkv.dtype),
                               self.force)
        return self.c_proj(out)[:, 0]


class _LinearF32(nn.Linear):
    """A Linear that JAX computes in fp32 under a bf16 classifier: its
    weights stay fp32 (`keep_fp32`) and its input is taken to fp32."""

    keep_fp32 = True

    def forward(self, x):
        return super().forward(x.float())


class _Conv1x1F32(nn.Conv2d):
    """The adaptive pool's 1x1 conv, fp32 as in JAX (`keep_fp32`)."""

    keep_fp32 = True

    def __init__(self, cin: int, cout: int):
        super().__init__(cin, cout, 1)

    def forward(self, x):
        return super().forward(x.float())


class ADMClassifier(_ADMTorso):
    """EncoderUNetModel (reference unet.py:684-895; ddnm_tpu
    `ADMClassifier`): forward(x, t) on an NHWC batch and float timesteps
    -> logits (B, out_channels), in the torso dtype for the attention pool
    and fp32 for the others. Heads of the four pools, named as the
    reference's `out` Sequential:

      attention:  out.0 GroupNorm (+ the SiLU of out.1), out.2 AttentionPool2d
      adaptive:   out.0 GroupNorm + SiLU, mean over the map, out.3 1x1 conv
                  (zero-initialised)
      spatial:    the mean of every input block's output and the middle
                  block's, concatenated; out.0 Linear, ReLU, out.2 Linear
      spatial_v2: the same features; out.0 Linear, out.1 GroupNorm + SiLU on
                  a 1 x 1 map, out.3 Linear

    `spatial` (models/nn.py shard_spatially): the pools' exchange over a
    spatial group (module docstring)."""

    def __init__(self, image_size: int = 256, in_channels: int = 3,
                 model_channels: int = 128, out_channels: int = 1000,
                 num_res_blocks: int = 2,
                 attention_resolutions: Sequence[int] = (8, 16, 32),
                 channel_mult: Sequence[float] = (1, 1, 2, 2, 4, 4),
                 conv_resample: bool = True, num_heads: int = 4,
                 num_head_channels: int = 64, use_scale_shift_norm: bool = True,
                 resblock_updown: bool = True, use_new_attention_order: bool = False,
                 pool: str = "attention"):
        super().__init__()
        if pool not in ("attention", "adaptive", "spatial", "spatial_v2"):
            raise NotImplementedError(f"pool {pool}")
        self.image_size = image_size
        self.model_channels = model_channels
        self.num_heads = num_heads
        self.num_head_channels = num_head_channels
        self.legacy_order = not use_new_attention_order
        self.pool = pool
        self._build_time_embed(model_channels)
        chans, ch, ds = self._build_torso(in_channels, model_channels, channel_mult,
                                          num_res_blocks, tuple(attention_resolutions),
                                          conv_resample, use_scale_shift_norm, resblock_updown)
        self.zero_init = ("out_layers.3", "proj_out") + (("out.3",) if pool == "adaptive"
                                                         else ())
        if pool == "attention":
            self.out = nn.ModuleList([
                _norm(ch, swish=True), nn.Identity(),
                AttentionPool2d(image_size // ds, ch, num_head_channels, out_channels)])
        elif pool == "adaptive":
            self.out = nn.ModuleList([_norm(ch, swish=True), nn.Identity(), nn.Identity(),
                                      _Conv1x1F32(ch, out_channels)])
        else:
            feats = sum(chans) + ch
            if pool == "spatial":
                self.out = nn.ModuleList([_LinearF32(feats, 2048), nn.Identity(),
                                          _LinearF32(2048, out_channels)])
            else:
                self.out = nn.ModuleList([_LinearF32(feats, 2048), _norm(2048, swish=True),
                                          nn.Identity(), _LinearF32(2048, out_channels)])
                self.out[1].replicated = True  # on the pooled features every rank holds
        self.spatial = None
        self.to(memory_format=torch.channels_last)

    def forward(self, x, timesteps):
        emb = self._embed(timesteps)
        orig_dtype = x.dtype
        h, hs = self._torso(x.to(self.dtype).permute(0, 3, 1, 2), emb)
        if self.pool.startswith("spatial"):
            feats = torch.cat([self._mean(z.to(orig_dtype)) for z in hs + [h]], dim=-1)
            if self.spatial is not None:
                feats = sum_replicated(feats, self.spatial)
            feats = self.out[0](feats)
            if self.pool == "spatial":
                return self.out[2](torch.relu(feats))
            feats = self.out[1](feats[:, :, None, None])[:, :, 0, 0]
            return self.out[3](feats)
        h = self.out[0](h.to(orig_dtype))  # norm + SiLU in the input's dtype
        if self.spatial is not None:  # the whole map's rows on every rank
            h = gather_rows(h, self.spatial, axis=2)
        if self.pool == "adaptive":
            h = self.out[3](h.mean(dim=(2, 3), keepdim=True))
            return h.reshape(h.shape[0], -1)
        return self.out[2](h)

    def _mean(self, z):
        """The mean over the map of an NCHW block; sharded, this shard's sum
        over the whole map's pixel count (the shards' add to the mean)."""
        if self.spatial is None:
            return z.mean(dim=(2, 3))
        return z.sum(dim=(2, 3)) / (z.shape[2] * self.spatial.size * z.shape[3])

    @classmethod
    def from_config(cls, classifier_config, image_size: int) -> "ADMClassifier":
        """From a main-layer ClassifierConfig (or a flat hq config with the
        same classifier_* keys): channel_mult by image size, heads of 64
        channels, 1000 classes (the reference's create_classifier)."""
        c = classifier_config
        return cls(
            image_size=image_size,
            in_channels=3,
            model_channels=c.classifier_width,
            num_res_blocks=c.classifier_depth,
            attention_resolutions=parse_attention_resolutions(
                c.classifier_attention_resolutions, image_size),
            channel_mult=parse_channel_mult("", image_size),
            num_heads=4,
            num_head_channels=64,
            use_scale_shift_norm=c.classifier_use_scale_shift_norm,
            resblock_updown=c.classifier_resblock_updown,
            pool=c.classifier_pool,
            out_channels=1000,
        )


def _frozen(classifier):
    """An nn.Module classifier set to eval with its parameters frozen (the
    Functions give the gradient of the input only)."""
    if isinstance(classifier, nn.Module):
        classifier.eval().requires_grad_(False)
    return classifier


def _log_prob_grad(classifier_apply, x, t, classes, spatial=None):
    """grad_x sum_i log softmax(classifier(x_i, t_i))[classes_i], fp32 like
    x. The logits and log_softmax stay in the classifier's dtype, as in
    JAX. `spatial`: the classifier is sharded over that group; the
    gradient is taken with respect to this rank's rows of x and its rows
    gathered back."""
    if spatial is not None:
        grad = _log_prob_grad(classifier_apply, split_rows(x, spatial), t, classes)
        return gather_rows(grad, spatial)
    with torch.enable_grad():
        x_in = x.detach().requires_grad_(True)
        logits = classifier_apply(x_in, t)
        logp = torch.log_softmax(logits, dim=-1)
        if isinstance(classes, int):
            # a fill on the card, not an upload: a CUDA graph captures it
            # (sampling/graphs.py)
            cls = torch.full((logp.shape[0],), classes, dtype=torch.long, device=logp.device)
        else:
            cls = torch.as_tensor(classes, dtype=torch.long, device=logp.device)
        cls = cls.expand(logp.shape[0]) if cls.ndim == 0 or cls.numel() == 1 else cls
        sel = logp.gather(1, cls.reshape(-1, 1)).sum()
        return torch.autograd.grad(sel, x_in)[0]


def classifier_guidance_fn(classifier, classes, scale: float):
    """grad_x log p(y | x) * scale (reference diffusion.py:183-191,
    hq_demo/main.py:87-96), the samplers' guidance hook: guidance(x, t,
    at=None) on NHWC x (fp32) and timesteps t (B,). `classifier(x, t)`
    gives the logits (an ADMClassifier, which is set to eval and frozen);
    `classes` is one label or one per image. A classifier sharded over a
    spatial group takes x's rows of its rank: wrap the hook with
    `Grid.wrap(guidance_fn=, classifier=)`, which gathers the gradient."""
    classifier = _frozen(classifier)

    def guidance(x, t, at=None):
        return _log_prob_grad(classifier, x, t, classes) * scale

    guidance.classifier = classifier  # its lowest grid, for Grid.wrap's check
    return guidance


def classifier_guidance_from_params(classifier_apply, scale: float, spatial=None):
    """The guidance hook with per-example labels read from run_params
    (ddnm_tpu `classifier_guidance_from_params`): guidance(run_params, x,
    t, at=None) with run_params["classifier"] (handed to
    classifier_apply(params, x, t)) and run_params["classes"] (B,), so one
    hook serves any class mix. `spatial`: the classifier is sharded over
    that group (shard_spatially); x is the whole tile, and the gradient
    comes back whole on every rank."""

    def guidance(run_params, x, t, at=None):
        params = _frozen(run_params["classifier"])
        return _log_prob_grad(lambda z, s: classifier_apply(params, z, s), x, t,
                              run_params["classes"], spatial) * scale

    return guidance
