"""The launch plans of the port's attention, GroupNorm (stats and apply),
fused GN+SiLU+conv and Walsh-Hadamard kernels and of the GroupNorm and
attention backward kernels, checked without a card: the plain Python
functions that choose tiles, grid, blocks, clusters, stages and
shared-memory bytes (`_attention_plan`, `_stats_plan`, `_apply_plan`,
`_conv_plan`, `_fwht_plan`, `_bwd_reduce_plan`, `_bwd_plan`) for every
shape the wrappers admit (the hq path's ADM forwards and every classifier
forward included, their shapes read off a forward on the meta device), and
their refusals."""

import functools
import math
from pathlib import Path

import pytest
import torch

from ddnm_tpu.config import load_config as j_load_config
from ddnm_tpu.config import load_hq_config
from ddnm_tpu.models.unet_adm import _backbone_plan, parse_channel_mult
from ddnm_tpu_torch.config import load_config
from ddnm_tpu_torch.models import DDPMUNet
from ddnm_tpu_torch.models.nn import GroupNormF32
from ddnm_tpu_torch.ops._build import SMEM_PER_BLOCK
from ddnm_tpu_torch.ops.attention import (
    WHOLE_ROW_MAX_T,
    _attention_plan,
    _bwd_plan,
    _kernel_attention,
)
from ddnm_tpu_torch.ops.fused_gn_conv import _conv_plan
from ddnm_tpu_torch.ops.fwht import _fwht_plan
from ddnm_tpu_torch.ops.groupnorm import (
    STATS_MAX_SPAN,
    _apply_plan,
    _bwd_reduce_plan,
    _stats_affine,
    _stats_plan,
)
from ddnm_tpu_torch.ops.groupnorm import _torch_bwd_reduce

CONFIGS = Path(__file__).resolve().parents[1] / "configs"
H100_SMS = 132


def _blocks(plan):
    n = 1
    for d in plan["grid"]:
        n *= d
    return n


@pytest.mark.parametrize("C", range(32, 513, 32))
def test_attention_plan_fits_shared_memory_for_every_admitted_shape(C):
    """bf16: every T from 1 past the whole-row limit, and long grids, fit in
    one block's shared memory; the whole-row softmax up to the limit, the
    online one above it. fp32 keeps the FMA kernel (static shared memory)."""
    last = 0
    for T in [*range(1, WHOLE_ROW_MAX_T + 40), 4096, 65536]:
        plan = _attention_plan(8, T, C, torch.bfloat16)
        assert plan["kernel"] == "mma" and plan["threads"] == 128
        assert plan["whole"] == (T <= WHOLE_ROW_MAX_T)
        assert plan["smem"] <= SMEM_PER_BLOCK
        assert plan["grid"] == (-(-T // 16), 8)
        assert plan["key_tile"] % 32 == 0  # 8 keys a warp and n8 tile
        assert 16 * 1024 <= plan["key_tile"] * (C + 8) * 2 <= 70 * 1024  # one ring stage
        assert plan["tma"] == (C % 64 == 0)  # 64-column boxes
        if plan["whole"]:
            assert plan["smem"] >= last  # the score rows grow with T
            last = plan["smem"]
        fp32 = _attention_plan(8, T, C, torch.float32)
        assert fp32["kernel"] == "fma" and fp32["smem"] == 0


def test_attention_plan_fills_the_card_at_the_main_path_shape():
    plan = _attention_plan(8, 256, 512, torch.bfloat16)
    assert _blocks(plan) >= 128 and plan["whole"]


@pytest.mark.parametrize("B,T,C,dtype,err", [
    (1, 8, 48, torch.bfloat16, "C % 32"),
    (1, 8, 544, torch.float32, "C % 32"),
    (1, 8, 1024, torch.bfloat16, "C % 32"),
    (65536, 8, 64, torch.bfloat16, "B\\* <= 65535"),
    (1, 0, 64, torch.bfloat16, "T >= 1"),
    (1, 8, 64, torch.float16, "float32/bfloat16"),
])
def test_attention_plan_refuses_what_the_kernels_do_not_take(B, T, C, dtype, err):
    with pytest.raises((ValueError, TypeError), match=err):
        _attention_plan(B, T, C, dtype)


def test_attention_wrapper_checks_before_it_builds():
    """The wrapper refuses a CPU tensor and a non-(B, T, C) input before it
    builds or launches anything."""
    q = torch.zeros(2, 8, 64, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="CUDA"):
        _kernel_attention(q, q, q, 1.0)
    with pytest.raises(ValueError, match="CUDA"):
        _stats_affine(torch.zeros(1, 2, 2, 32), torch.ones(32), torch.zeros(32), 32, 1e-6,
                      None, None)


def _ddpm_groupnorms():
    """(C, G) of every GroupNorm of the DDPM UNet configs, read off the
    port's model built on the meta device."""
    found = set()
    for path in sorted(CONFIGS.glob("*.yml")):
        cfg = load_config(path)
        if cfg.model.type != "simple":
            continue
        with torch.device("meta"):
            model = DDPMUNet.from_config(cfg)
        found |= {(m.weight.shape[0], m.num_groups) for m in model.modules()
                  if isinstance(m, GroupNormF32)}
    return found


def _adm_channels(model_channels, channel_mult, num_res_blocks):
    """Input channels of every GroupNorm of an ADM UNet (and its encoder):
    the ResBlocks' in and out norms, down and up, with the skip
    concatenations of the up path, the attention norms and the out norm."""
    specs, skips, ch, _ = _backbone_plan(model_channels, channel_mult, num_res_blocks, ())
    chans = {int(channel_mult[0] * model_channels)}
    prev = int(channel_mult[0] * model_channels)
    for _, ch_out, _ in specs:
        chans |= {prev, ch_out}
        prev = ch_out
    skips = list(skips)
    for mult in channel_mult[::-1]:
        for _ in range(num_res_blocks + 1):
            chans.add(ch + skips.pop())
            ch = int(model_channels * mult)
            chans.add(ch)
    return chans


def _adm_groupnorms():
    found = set()
    for path in sorted(CONFIGS.glob("*.yml")):
        cfg = j_load_config(path)
        if cfg.model.type != "openai":
            continue
        mult = parse_channel_mult(cfg.model.channel_mult, cfg.data.image_size)
        found |= {(c, 32) for c in _adm_channels(cfg.model.num_channels, mult,
                                                  cfg.model.num_res_blocks)}
        clf = getattr(cfg, "classifier", None)
        if clf is not None:
            found |= {(c, 32) for c in _adm_channels(clf.classifier_width, mult,
                                                      clf.classifier_depth)}
    for path in sorted((CONFIGS / "hq").glob("*.yml")):
        cfg = load_hq_config(path)
        mult = parse_channel_mult(cfg.channel_mult, cfg.image_size)
        found |= {(c, 32) for c in _adm_channels(cfg.num_channels, mult, cfg.num_res_blocks)}
    return found


def test_config_groupnorms_are_found():
    ddpm, adm = _ddpm_groupnorms(), _adm_groupnorms()
    assert {(128, 32), (768, 32), (1024, 32)} <= ddpm  # 256 px: C / G 4 ... 32
    assert (96 * 3 + 96 * 4, 32) in adm  # adm128: 96-channel ladder, C / G 21
    assert len(adm) > 10


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_groupnorm_stats_plan_holds_whole_groups_for_every_config(dtype):
    """For every (C, G) of the DDPM and ADM configs, at the maps they run
    at and a ragged one, and with x on or off 16 bytes: a span is whole
    groups, divides C and is a multiple of the load width; the blocks and
    their scratch are consistent and the shared memory fits."""
    elem = torch.empty((), dtype=dtype).element_size()
    for C, G in sorted(_ddpm_groupnorms() | _adm_groupnorms()):
        for B, HW in ((8, 256 * 256), (8, 64 * 64), (8, 8 * 8), (3, 35), (1, 1)):
            for aligned in (True, False):
                p = _stats_plan(B, HW, C, G, elem, aligned)
                span, vec = p["span"], p["vec"]
                assert span % (C // G) == 0 and C % span == 0 and span % vec == 0
                assert vec in ((16 // elem, 1) if aligned else (1,))
                assert span <= STATS_MAX_SPAN
                assert p["threads"] <= 1024 and p["threads"] % p["lanes_c"] == 0
                assert p["grid"] == (p["n_blk"], C // span, B) and 1 <= p["n_blk"] <= HW
                assert p["scratch"] == (2 * B * C * p["n_blk"] if p["n_blk"] > 1 else 0)
                assert p["counters"] == B * (C // span)
                assert p["smem"] == 4 * (2 * span + 2 * p["threads"] * vec
                                         + 2 * span // (C // G)) + 16
                assert p["smem"] <= SMEM_PER_BLOCK


def test_groupnorm_stats_plan_fills_the_card_on_the_big_maps():
    """The main path's big maps are read in whole pixel rows, 16 bytes a
    thread, by about two blocks per SM; the small maps by one block per
    (image, 64-byte channel span), with no partial sums and no counter."""
    for HW, C in ((256 * 256, 128), (256 * 256, 256), (128 * 128, 256)):
        big = _stats_plan(8, HW, C, 32, 2)
        assert big["vec"] == 8 and big["span"] == C and big["threads"] == 512
        assert _blocks(big) >= 2 * H100_SMS - 8
    for HW, C in ((32 * 32, 256), (16 * 16, 512), (8 * 8, 1024)):
        small = _stats_plan(8, HW, C, 32, 2)
        assert small["n_blk"] == 1 and small["scratch"] == 0 and small["span"] == 32
        assert _blocks(small) >= 64


@pytest.mark.parametrize("B,HW,C,G,err", [
    (1, 4, 30, 32, "divisible"),
    (1, 4, 2 * (STATS_MAX_SPAN + 2), 2, "C / G"),
])
def test_groupnorm_stats_plan_refuses_what_the_kernel_does_not_take(B, HW, C, G, err):
    with pytest.raises(ValueError, match=err):
        _stats_plan(B, HW, C, G, 2)


# the fused kernel's shapes in chip_smoke.py (FUSED_SHAPES) and the DDPM
# UNet's six Cin = Cout 3x3 shapes at batch 8
# (tools/experiments/fused_gn_conv_torch.py UNET_SHAPES)
FUSED_SHAPES = ((8, 256, 256, 128), (2, 32, 32, 64), (3, 20, 36, 96))
UNET_CONV_SHAPES = ((8, 256, 256, 128), (8, 128, 128, 128), (8, 64, 64, 256),
                    (8, 32, 32, 256), (8, 16, 16, 512), (8, 8, 8, 512))


def _conv_layout_total(kc, bn, ws):
    """csrc/fused_gn_conv.cu conv_layout(kc, bn, ws).total, restated: two
    halo stages, ws weights stages, two staging buffers per consumer
    warpgroup, the mbarriers of 2 + 8 stages, 1024 bytes of slack."""
    halo_stage = -(-18 * 18 * kc * 2 // 1024) * 1024
    return 1024 + 2 * halo_stage + ws * kc * bn * 2 + 2 * 2 * 8192 + 8 * (3 * 2 + 2 * 8)


@pytest.mark.parametrize("shape", sorted(set(FUSED_SHAPES + UNET_CONV_SHAPES)
                                         | {(1, 5, 3, 32), (2, 16, 16, 128), (1, 8, 8, 512),
                                            (1, 1, 1, 160), (4, 17, 33, 224)}))
def test_conv_plan_fits_and_covers_every_shape(shape):
    """Chunks and N tiles cover C, 16 x 16 tiles cover the map, the weights
    ring has 3-8 stages beside two halo stages, the shared memory is the
    kernel's layout and fits one H100 block, the persistent grid is at most
    one block per SM and at most the tiles."""
    B, H, W, C = shape
    p = _conv_plan(B, H, W, C)
    assert p["kc"] == (64 if C % 64 == 0 else 32) and C % p["kc"] == 0
    assert p["bn"] in (64, 128) and (p["bn"] == 64 or C > 64)
    assert p["tile"] == (16, 16) and p["threads"] == 384
    assert p["tiles"] == B * -(-H // 16) * -(-W // 16) * -(-C // p["bn"])
    assert 3 <= p["w_stages"] <= 8
    assert p["smem"] == _conv_layout_total(p["kc"], p["bn"], p["w_stages"])
    assert p["smem"] <= SMEM_PER_BLOCK
    assert _conv_layout_total(p["kc"], p["bn"], p["w_stages"] + 1) > SMEM_PER_BLOCK or \
        p["w_stages"] == 8  # as many weights stages as fit
    assert p["grid"] == min(p["tiles"], H100_SMS)


def test_conv_plan_at_the_experiment_shape():
    """(8, 256, 256, 128): 256 x 128 tiles, 64-channel chunks with the
    128-byte swizzle, six weights stages, a full persistent wave; 64-wide N
    tiles only where 128 would leave SMs idle (C = 512 at 16 and 8 px)."""
    p = _conv_plan(8, 256, 256, 128)
    assert (p["kc"], p["bn"], p["w_stages"], p["grid"], p["tiles"]) == (64, 128, 6, 132, 2048)
    assert p["smem"] == 216240
    assert _conv_plan(8, 64, 64, 256)["bn"] == 128
    for shape in ((8, 16, 16, 512), (8, 8, 8, 512), (8, 32, 32, 256)):
        assert _conv_plan(*shape)["bn"] == 64


@pytest.mark.parametrize("shape,err", [
    ((1, 4, 4, 48), "C % 32"),
    ((1, 4, 4, 0), "C % 32"),
    ((0, 4, 4, 64), "non-empty"),
    ((65535, 4096, 4096, 32), "2\\^31 tiles"),
])
def test_conv_plan_refuses_what_the_kernel_does_not_take(shape, err):
    with pytest.raises(ValueError, match=err):
        _conv_plan(*shape)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_apply_plan_keeps_each_threads_channels_fixed(dtype):
    """16-byte loads where x is aligned and C allows them, one channel
    otherwise; a row of blocks per image whose thread count is a multiple of
    C / vec (a thread's channels never change along its stride), at most
    2048 threads an SM over the batch, and no more blocks than one vector a
    thread needs."""
    wide = 4 if dtype == torch.float32 else 8
    for C in sorted({c for c, _ in _ddpm_groupnorms()} | {36, 34, 96, 4096, 8194}):
        for B, HW in ((8, 256 * 256), (8, 8 * 8), (3, 35), (1, 1)):
            for aligned in (True, False):
                p = _apply_plan(B, HW, C, dtype, aligned, H100_SMS)
                assert p["vec"] == (wide if aligned and C % wide == 0 else 1)
                assert p["cv"] == C // p["vec"] and p["img_vec"] == HW * p["cv"]
                assert p["grid"] == (p["blocks"], B)
                assert (p["blocks"] * p["threads"]) % p["cv"] == 0
                assert 0 < p["threads"] <= 256
                unit = p["cv"] // math.gcd(p["cv"], p["threads"])
                assert p["blocks"] <= min(-(-p["img_vec"] // p["threads"]),
                                          -(-2048 // p["threads"] * H100_SMS // B)) + unit - 1


def test_apply_plan_fills_the_card_on_the_big_maps():
    """The main path's big maps: 8 blocks of 256 threads on each of the 132
    SMs over the batch of 8, 16 bytes a thread."""
    for C in (128, 256):
        p = _apply_plan(8, 256 * 256, C, torch.bfloat16, True, H100_SMS)
        assert p["vec"] == 8 and p["threads"] == 256 and p["grid"] == (H100_SMS, 8)
    assert _apply_plan(8, 256 * 256, 128, torch.float32, True, H100_SMS)["vec"] == 4


def test_apply_plan_refuses_other_dtypes():
    with pytest.raises(TypeError, match="float32/bfloat16"):
        _apply_plan(1, 4, 32, torch.float16)


@pytest.mark.parametrize("p", [1 << m for m in range(17)])
def test_fwht_plan_covers_every_slab_once(p):
    """Every P = 2^0..2^16 at slab counts from one to the (64, 3) of phase
    3: the CTAs' tiles cover the n P floats exactly once (a cluster of K
    CTAs per slab, or whole slabs per CTA), a tile fits a block's shared
    memory as 64 floats a thread, and K is a power of two <= 8 (the portable
    cluster size) that csrc/fwht.cu instantiates."""
    for n in (1, 3, 6, 24, 25, 192):
        plan = _fwht_plan(n, p, H100_SMS)
        tile, k = 1 << plan["log_tile"], plan["cluster"]
        assert 11 <= plan["log_tile"] <= 13 and k in (1, 2, 4, 8)
        assert plan["smem"] == 4 * tile <= SMEM_PER_BLOCK
        assert plan["threads"] * plan["floats_per_thread"] == tile
        assert plan["threads"] % 32 == 0 and plan["floats_per_thread"] == 64
        covered = [0] * n
        for cta in range(plan["grid"][0]):
            lo, hi = cta * tile, min((cta + 1) * tile, n * p)
            assert lo < hi  # no CTA without work
            for slab in range(lo // p, -(-hi // p)):
                covered[slab] += min(hi, (slab + 1) * p) - max(lo, slab * p)
        assert covered == [p] * n
        if k > 1:
            assert p == k * tile and plan["grid"][0] == n * k
        else:
            assert plan["slabs_per_cta"] == tile // p >= 1


def test_fwht_plan_fills_the_card_at_the_svd_shapes():
    """(24, 65536), the SVD main path: 8-CTA clusters of 32 KB, 192 CTAs in
    flight, more than one per SM; narrower slabs take smaller tiles and
    larger clusters rather than leave SMs idle; big batches take the
    largest tiles that still give every SM two CTAs."""
    plan = _fwht_plan(24, 65536, H100_SMS)
    assert (plan["log_tile"], plan["cluster"], plan["grid"]) == (13, 8, (192,))
    assert _blocks(plan) >= H100_SMS
    assert _fwht_plan(6, 65536, H100_SMS)["grid"] == (48,)
    assert _fwht_plan(24, 16384, H100_SMS)["cluster"] == 8  # 128 px: 192 CTAs of 8 KB
    assert _fwht_plan(192, 65536, H100_SMS)["grid"] == (1536,)
    big = _fwht_plan(192, 16384, H100_SMS)
    assert (big["log_tile"], big["cluster"]) == (13, 2) and _blocks(big) >= 2 * H100_SMS


@pytest.mark.parametrize("n,p,err", [(3, 96, "power-of-two"), (3, 131072, "P <= 65536"),
                                     (0, 1024, "n >= 1|1 <= n"), (2**31, 1, "n < 2")])
def test_fwht_plan_refuses_what_the_kernel_does_not_take(n, p, err):
    with pytest.raises(ValueError, match=err):
        _fwht_plan(n, p, H100_SMS)


def test_ctypes_signatures_match_the_c_entry_points():
    """Each C entry point of csrc/*.cu and its ctypes argument list agree in
    number and kind (a pointer passed as a 32-bit int would be cut)."""
    import ctypes
    import re

    from ddnm_tpu_torch.ops._build import _SIGNATURES, CSRC

    kinds = {"void*": ctypes.c_void_p, "int": ctypes.c_int, "float": ctypes.c_float}
    found = {}
    for src in sorted(CSRC.glob("*.cu")):
        text = src.read_text()
        for name, params in re.findall(r"^int (ddnm_\w+)\(([^)]*)\)", text, re.M):
            args = []
            for param in params.split(","):
                words = param.replace("const ", "").replace("*", "* ").split()
                args.append(kinds["".join(words[:-1])])
            found[name] = args
    assert found == _SIGNATURES


def _hq_forward_shapes(tier: str, batch: int) -> dict:
    """{(op, shape, dtype): calls} of one ADM UNet forward (chip_smoke.py
    op_shapes) on the meta device: the inet256 ADM of configs/hq/inet256.yml
    at `batch` 256 px tiles, or the toy32 ADM of the hq golden tier."""
    import json

    import chip_smoke
    import hq_main_torch
    from ddnm_tpu_torch.config import load_hq_config
    from ddnm_tpu_torch.models import ADMUNet

    with torch.device("meta"):
        if tier == "inet256":
            model = hq_main_torch.build_adm_from_hq(
                load_hq_config(CONFIGS / "hq" / "inet256.yml"), "meta")
        else:
            fixtures = CONFIGS.parent / "tests" / "fixtures"
            model = ADMUNet(**json.loads((fixtures / "toy_adm32.json").read_text())["adm_kw"])
    size = model.image_size
    args = ((torch.zeros(batch, dtype=torch.long, device="meta"),)
            if model.num_classes else ())
    return chip_smoke.op_shapes(model, torch.zeros(batch, size, size, 3, device="meta"), *args)


@pytest.mark.parametrize("tier,batch", [("inet256", 1), ("inet256", 2), ("inet256", 8),
                                        ("toy32", 1), ("toy32", 2), ("toy32", 8)])
def test_plans_admit_every_shape_of_the_hq_forward(tier, batch):
    """Every GroupNorm (B, H*W, C, 32 groups) and attention (B * heads, T,
    C / heads) of an ADM forward on the hq path, in fp32 and bf16, x on or
    off 16 bytes: the stats plan spans whole groups and fits, the apply
    plan keeps each thread's channels fixed, the attention plan admits it
    and fits. The inet256 ADM: C up to 2048 in the decoder's
    concatenations, 1024 on 8 px maps, heads of 64 channels at T = 1024,
    256 and 64."""
    shapes = _hq_forward_shapes(tier, batch)
    gn = {s for (op, s, _), _ in shapes.items() if op == "groupnorm"}
    attn = {s for (op, s, _), _ in shapes.items() if op == "attention"}
    if tier == "inet256":
        assert {c for *_, c in gn} >= {256, 512, 768, 1024, 1536, 2048}
        assert (batch, 8, 8, 1024) in gn
        assert attn == {(8 * batch, 1024, 64), (16 * batch, 256, 64), (16 * batch, 64, 64)}
        assert sum(n for (op, *_), n in shapes.items() if op == "groupnorm") == 101
        assert sum(n for (op, *_), n in shapes.items() if op == "attention") == 16
    else:
        assert attn == {(2 * batch, 256, 32)}
    for dtype in (torch.float32, torch.bfloat16):
        elem = torch.empty((), dtype=dtype).element_size()
        for B, H, W, C in gn:
            for aligned in (True, False):
                p = _stats_plan(B, H * W, C, 32, elem, aligned)
                assert p["span"] % (C // 32) == 0 and C % p["span"] == 0
                assert p["span"] % p["vec"] == 0 and p["span"] <= STATS_MAX_SPAN
                assert p["grid"] == (p["n_blk"], C // p["span"], B)
                assert 1 <= p["n_blk"] <= H * W and p["threads"] <= 1024
                assert p["smem"] <= SMEM_PER_BLOCK
                a = _apply_plan(B, H * W, C, dtype, aligned, H100_SMS)
                assert (a["blocks"] * a["threads"]) % a["cv"] == 0 and 0 < a["threads"] <= 256
                assert a["grid"] == (a["blocks"], B)
        for BH, T, C in attn:
            plan = _attention_plan(BH, T, C, dtype)
            assert plan["smem"] <= SMEM_PER_BLOCK
            assert plan["grid"] == (-(-T // 16), BH)
            if dtype == torch.bfloat16:
                assert plan["kernel"] == "mma" and plan["whole"] and plan["tma"] == (C % 64 == 0)
            else:
                assert plan["kernel"] == "fma"


def _classifier_grad_shapes() -> dict:
    """{name: chip_smoke.grad_shapes(...)} of every ADM classifier the repo
    runs, on the meta device: the 256 px classifier of
    configs/imagenet_256_cc.yml and configs/hq/inet256.yml (the same
    network) at batch 1 and 8, and the trained toy32, mid64 and big128
    fixtures' classifiers at batch 2."""
    import json

    import chip_smoke
    from ddnm_tpu_torch.models import ADMClassifier

    fixtures = CONFIGS.parent / "tests" / "fixtures"
    with torch.device("meta"):
        nets = {"cc256": ADMClassifier.from_config(
            load_config(CONFIGS / "imagenet_256_cc.yml").classifier, 256)}
        for name, key in (("toy_clf32", "clf_kw"), ("mid_clf64", "arch"),
                          ("big_clf128", "arch")):
            nets[name] = ADMClassifier(**json.loads((fixtures / f"{name}.json").read_text())[key])
    out = {}
    for name, net in nets.items():
        res = net.image_size
        for b in ((1, 8) if name == "cc256" else (2,)):
            out[f"{name}_b{b}"] = chip_smoke.grad_shapes(
                net, torch.zeros(b, res, res, 3, device="meta"))
    return out


def test_classifier_shapes_are_found():
    shapes = _classifier_grad_shapes()
    cc8 = shapes["cc256_b8"]
    assert sum(n for k, n in cc8.items() if k[0] == "gn") == 46
    assert sum(n for k, n in cc8.items() if k[0] == "attn") == 8
    assert {k[1] for k in cc8 if k[0] == "attn"} == {(32, 1024, 64), (64, 256, 64),
                                                    (64, 64, 64), (64, 65, 64)}
    assert {k[1] for k in shapes["toy_clf32_b2"] if k[0] == "attn"} == {(4, 256, 32),
                                                                       (4, 257, 32)}
    assert ("gn", (8, 256, 256, 128), True, False) in cc8  # the biggest map, norm -> SiLU
    assert any(k[0] == "gn" and k[3] for k in cc8)  # FiLM in the out norms


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_backward_plans_admit_every_classifier_shape(dtype):
    """For every GroupNorm and attention of every classifier forward, x on
    or off 16 bytes: the backward reduce plan has its own grid (whole
    groups a span, the whole pixel row at these widths, 256 threads, its
    shared memory as the C entry computes it, clusters of at most 8 CTAs,
    scratch and counters for its clusters), the dx pass takes the apply
    plan; the attention backward plan admits
    the head and fits both kernels' shared memory: fp32 the FMA kernels,
    one block of 256 threads per 32 query rows (dq) and per 32 keys
    (dkdv); bf16 the tensor-core kernels, one block of 4 warps per 64 rows
    in both."""
    elem = torch.empty((), dtype=dtype).element_size()
    for table in _classifier_grad_shapes().values():
        for key in table:
            if key[0] == "gn":
                B, H, W, C = key[1]
                for aligned in (True, False):
                    p = _bwd_reduce_plan(B, H * W, C, 32, elem, aligned, H100_SMS)
                    span, vec, lanes_c = p["span"], p["vec"], p["lanes_c"]
                    assert span % (C // 32) == 0 and C % span == 0 and span % vec == 0
                    assert span * elem >= 32  # a pixel's span: a 32-byte sector or more
                    assert vec == (16 // elem if aligned else 1)
                    assert p["threads"] == 256 and lanes_c & (lanes_c - 1) == 0
                    # at or above span / vec, else slots of 256 lanes
                    assert lanes_c == 256 or span // vec <= lanes_c < 2 * span // vec
                    assert p["smem"] == _bwd_smem_bytes(span, vec, C // 32, elem)
                    assert p["smem"] <= SMEM_PER_BLOCK // 2  # two blocks an SM
                    runs, k = p["runs"], p["cluster"]
                    assert k in (1, 2, 4, 8) and runs % k == 0 and k <= runs <= H * W
                    assert p["grid"] == (runs, C // span, B) and p["clusters"] == runs // k
                    assert p["clusters"] * k == runs and _blocks(p) <= 2 * H100_SMS  # one wave
                    many = p["clusters"] > 1
                    assert p["scratch"] == (4 * B * C * p["clusters"] if many else 0)
                    assert p["counters"] == (B * (C // span) * k if many else 0)
                    a = _apply_plan(B, H * W, C, dtype, aligned, H100_SMS)
                    assert (a["blocks"] * a["threads"]) % a["cv"] == 0
            else:
                B, T, C = key[1]
                p = _bwd_plan(B, T, C, dtype)
                fp32 = dtype == torch.float32
                assert p["kernel"] == ("fma" if fp32 else "mma")
                assert p["threads"] == (256 if fp32 else 128)
                rows = 32 if fp32 else 64
                assert p["dq"]["grid"] == (-(-T // rows), B)
                assert p["dkdv"]["grid"] == (-(-T // rows), B)
                for k in ("dq", "dkdv"):
                    assert 0 < p[k]["smem"] <= SMEM_PER_BLOCK


def _bwd_smem_bytes(span: int, vec: int, cpg: int, elem: int) -> int:
    """csrc/groupnorm.cu bwd_smem_bytes, written out: the block's sums
    [4][span], gamma and film_scale [2][span], then the larger of the
    16-byte path's ring (3 stages x 4 pixels x (x, dy) x 16 bytes x 256
    threads = 96 KiB) and what overlays it: a work area of the larger of
    every thread's sums [4][256 vec] and the finalised sums [4][span];
    rstd, Bx, Cx per group [3][span / cpg]; a 16-byte flag."""
    work = max(4 * 256 * vec, 4 * span)
    tail = 4 * (work + 3 * (span // cpg)) + 16
    return 24 * span + max(3 * 4 * 2 * 16 * 256 if vec * elem == 16 else 0, tail)


@functools.lru_cache(maxsize=None)
def _gn_grad_shapes(name: str) -> tuple:
    """The (B, H, W, C) of every GroupNorm backward of one classifier table."""
    return tuple(sorted({k[1] for k in _classifier_grad_shapes()[name] if k[0] == "gn"}))


@pytest.mark.parametrize("batch", [1, 8])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_backward_reduce_plan_fills_the_card(batch, dtype):
    """At every GroupNorm of the 256 px classifier's backward at batch 1
    and 8: the plan wants a block per 8 KiB of x, one wave of two blocks
    an SM at most (256 on 132 SMs). Where x makes that whole wave (the
    plan's "enough work"), the grid holds at least one block per SM and at
    most the wave, in clusters of 2; elsewhere at most twice the blocks it
    wants, and one cluster an (image, span) at most, so no combine through
    scratch. In bf16 the 256, 128, 64 and 32 px maps have the work at
    batch 8, the 256 and 128 px maps at batch 1."""
    elem = torch.empty((), dtype=dtype).element_size()
    filled = set()
    for B, H, W, C in _gn_grad_shapes(f"cc256_b{batch}"):
        p = _bwd_reduce_plan(B, H * W, C, 32, elem, True, H100_SMS)
        blocks = _blocks(p)
        nbytes, wave = B * H * W * C * elem, 2 * H100_SMS // 32 * 32
        want = min(wave, max(1, nbytes // (8 << 10)))
        assert p["enough_work"] == (nbytes // (8 << 10) >= 2 * H100_SMS)
        if p["enough_work"]:
            assert H100_SMS <= blocks <= wave and p["cluster"] == 2
            filled.add((H, W))
        else:  # channels, then one cluster of up to 8 runs: no scratch
            assert blocks <= 2 * want and p["clusters"] == 1 and p["scratch"] == 0
    bf16 = ({(256, 256), (128, 128), (64, 64), (32, 32)} if batch == 8
            else {(256, 256), (128, 128)})
    assert filled == bf16 if dtype == torch.bfloat16 else filled >= bf16  # fp32: twice the bytes


def _reduce_coverage(B, HW, C, G, elem, aligned):
    """A model of the reduce kernel's block -> (image, span, run, rank)
    mapping and of each thread's loops (csrc/groupnorm.cu
    gn_bwd_reduce_kernel, bwd_thread_sums: the ring's whole stages, then
    guarded passes): how often each (image, pixel)
    and each channel of a span is read, the groups each cluster rank
    finalises, and the scratch and counter slots it touches."""
    import numpy as np

    p = _bwd_reduce_plan(B, HW, C, G, elem, aligned, H100_SMS)
    span, vec, lanes_c, k = p["span"], p["vec"], p["lanes_c"], p["cluster"]
    runs, n_span = p["runs"], C // span
    lanes_p, U = 256 // lanes_c, 4
    cpg, ng = C // G, span // (C // G)
    # channels: slots of lanes_c vectors; thread lane tc reads VEC channels
    width = lanes_c * vec
    ch = np.zeros(span, dtype=np.int64)
    for slot in range(-(-span // width)):
        for tc in range(lanes_c):
            cv = slot * lanes_c + tc
            if cv * vec < span:
                ch[cv * vec:(cv + 1) * vec] += 1
    # pixels: runs of one (image, span), each thread's passes and tail
    px = np.zeros((B, n_span, HW), dtype=np.int64)
    finalised = np.zeros((B, n_span, ng), dtype=np.int64)
    slots = set()
    for b in range(B):
        for s in range(n_span):
            for run in range(runs):
                lo, hi = run * HW // runs, (run + 1) * HW // runs
                assert lo < hi  # no block without pixels
                for tp in range(lanes_p):
                    q = lo + tp
                    if vec * elem == 16:  # the ring: whole stages of U pixels
                        n_stage = (hi - q + lanes_p - 1) // lanes_p // U if q < hi else 0
                        px[b, s, q:q + n_stage * U * lanes_p:lanes_p] += 1
                        q += n_stage * U * lanes_p
                    while q < hi:  # guarded passes of U pixels
                        px[b, s, q:min(hi, q + U * lanes_p):lanes_p] += 1
                        q += U * lanes_p
                rank, cl = run % k, run // k
                g_lo, g_hi = rank * ng // k, (rank + 1) * ng // k
                if p["clusters"] > 1:
                    bs = b * n_span + s
                    slots.add(("counter", bs * k + rank))
                    assert (bs * p["clusters"] + cl + 1) * 4 * span <= p["scratch"]
                    if cl == p["clusters"] - 1:  # one of the ranks' last CTAs
                        finalised[b, s, g_lo:g_hi] += 1
                elif cl == 0:
                    finalised[b, s, g_lo:g_hi] += 1
    return p, ch, px, finalised, slots


@pytest.mark.parametrize("shape", [(1, 33, 35, 96), (3, 5, 7, 96), (8, 1, 1, 2048),
                                   (2, 64, 64, 256), (1, 1, 1, 32), (5, 17, 3, 64)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_backward_reduce_plan_covers_every_pixel_once(shape, dtype):
    """Ragged maps, 1 x 1 maps and one pixel, on and off 16 bytes: every
    (image, pixel) is read by exactly one thread of one block and every
    channel of a span by one channel lane of one slot; each group is
    finalised by exactly one CTA; every counter and scratch slot lies in
    what the wrapper allocates."""
    B, H, W, C = shape
    elem = torch.empty((), dtype=dtype).element_size()
    for aligned in (True, False):
        p, ch, px, fin, slots = _reduce_coverage(B, H * W, C, 32, elem, aligned)
        assert (ch == 1).all() and (px == 1).all() and (fin == 1).all()
        assert all(i < p["counters"] for _, i in slots)
        assert len(slots) == (p["counters"] if p["clusters"] > 1 else 0)


def test_backward_reduce_plan_covers_every_classifier_pixel_once():
    """The same model at every GroupNorm of the 256 px classifier's
    backward, batch 1 and 8, bf16 and fp32 (x on 16 bytes, as the
    Function gives it)."""
    for name in ("cc256_b1", "cc256_b8"):
        for B, H, W, C in _gn_grad_shapes(name):
            for elem in (2, 4):
                p, ch, px, fin, slots = _reduce_coverage(B, H * W, C, 32, elem, True)
                assert (ch == 1).all() and (px == 1).all() and (fin == 1).all()
                assert all(i < p["counters"] for _, i in slots)


@pytest.mark.parametrize("B,HW,C,G,err", [(2, 16, 100, 32, "divisible"),
                                          (2, 16, 8192 * 2, 2, "C / G <="),
                                          (0, 16, 64, 32, "B <="),
                                          (65536, 16, 64, 32, "B <="),
                                          (2, 0, 64, 32, "H\\*W >= 1")])
def test_backward_reduce_plan_refuses_what_the_kernel_does_not_take(B, HW, C, G, err):
    with pytest.raises(ValueError, match=err):
        _bwd_reduce_plan(B, HW, C, G, 2)


def test_backward_reduce_plan_model_sums_match_plain():
    """The kernel's order of sums, modelled in float64 at a ragged shape
    with several clusters (per-run sums, cluster ranks, the clusters'
    scratch), folds to the plain version's coefficients; the layout of
    such a launch sizes its scratch for the clusters."""
    import numpy as np

    from ddnm_tpu_torch.ops.groupnorm import _bwd_reduce_layout

    B, H, W, C, G = 1, 33, 35, 96, 32
    p = _bwd_reduce_layout(B, H * W, C, C // G, 4, 1, C, 12, 4)  # 3 clusters of 4
    assert p["clusters"] == 3 and p["scratch"] == 4 * B * C * 3
    rng = np.random.default_rng(0)
    x = rng.normal(size=(B, H * W, C))
    dy = rng.normal(size=(B, H * W, C))
    g = rng.normal(size=C)
    runs, k = p["runs"], p["cluster"]
    per_run = [np.stack([x[0, lo:hi].sum(0), (x[0, lo:hi] ** 2).sum(0),
                         dy[0, lo:hi].sum(0), (dy[0, lo:hi] * x[0, lo:hi]).sum(0)])
               for lo, hi in ((r * H * W // runs, (r + 1) * H * W // runs)
                              for r in range(runs))]
    clusters = [sum(per_run[c * k:(c + 1) * k]) for c in range(runs // k)]
    tot = sum(clusters)
    cpg, n = C // G, H * W * (C // G)
    grp = lambda v: v.reshape(G, cpg).sum(-1)
    mean = grp(tot[0]) / n
    rstd = 1 / np.sqrt(np.maximum(grp(tot[1]) / n - mean ** 2, 0) + 1e-5)
    c1 = grp(g * tot[2]) / n
    c2 = rstd * (grp(g * tot[3]) / n - mean * c1)
    rep = lambda v: np.repeat(v, cpg)
    model = np.stack([rep(rstd) * g, rep(-rstd * rstd * c2), rep(rstd * (mean * rstd * c2 - c1))])
    t = lambda a: torch.from_numpy(a)
    plain = _torch_bwd_reduce(t(x.reshape(B, H, W, C)), t(dy.reshape(B, H, W, C)), t(g), G,
                              1e-5, False)
    assert np.abs(plain[:, 0].numpy() - model).max() <= 1e-9 * max(1.0, np.abs(model).max())


def test_backward_plans_at_the_classifier_heads():
    """The dynamic shared memory of the two fp32 attention backward
    kernels, as csrc/attention.cu bwd_dq_smem_floats / bwd_dkdv_smem_floats
    compute it (rows padded to C + 1 floats), at the head dimensions they
    are built for; the biggest, C = 128, still fits a block."""
    want = {32: (33792, 42496), 64: (58368, 67072), 128: (107520, 116224)}
    for C, (dq, dkdv) in want.items():
        p = _bwd_plan(8, 1024, C, torch.float32)
        assert (p["dq"]["smem"], p["dkdv"]["smem"]) == (dq, dkdv)
    assert max(want[128]) <= SMEM_PER_BLOCK


def _bwd_layout_bytes(C: int, dkdv: bool) -> int:
    """csrc/attention.cu bwd_layout(C, dkdv).total, written out: a two-stage
    ring of (X, Y) tiles of R streamed rows (R = 32 for dkdv at C = 128,
    else 64; TMA's swizzled C-wide rows plus 1024 bytes of alignment slack
    where C % 64 == 0, rows padded by 8 bf16 otherwise), two 8-byte
    mbarriers, 2 x 64 resident rows padded by 8 bf16, then fp32 statistics:
    D of the 64 resident rows (dq) or LSE and D of the R streamed rows of
    each stage (dkdv)."""
    R = 32 if dkdv and C == 128 else 64
    tma = C % 64 == 0
    ring = 2 * 2 * R * (C if tma else C + 8) * 2 + (1024 if tma else 0)
    stats = 2 * 2 * R if dkdv else 64
    return ring + 2 * 8 + 2 * 64 * (C + 8) * 2 + 4 * stats


@pytest.mark.parametrize("C", [32, 64, 128])
def test_bf16_backward_plan_matches_the_kernel_layout(C):
    """The bf16 backward plan at every classifier (B, T) with head
    dimensions 32, 64 and 128: 64 rows a block in both kernels, the
    shared-memory bytes of the C layout (a 1024-byte multiple for every
    swizzled TMA tile), TMA where C % 64 == 0; the fp32 plan at the same
    shape is the FMA kernels', unchanged."""
    seen = {key[1][:2] for table in _classifier_grad_shapes().values()
            for key in table if key[0] == "attn"}
    assert (32, 1024) in seen and (4, 257) in seen
    for B, T in sorted(seen):
        p = _bwd_plan(B, T, C, torch.bfloat16)
        assert p["kernel"] == "mma" and p["threads"] == 128 and p["tma"] == (C % 64 == 0)
        for name, dkdv in (("dq", False), ("dkdv", True)):
            assert p[name]["grid"] == (-(-T // 64), B)
            assert p[name]["stream_rows"] == (32 if dkdv and C == 128 else 64)
            assert p[name]["smem"] == _bwd_layout_bytes(C, dkdv) <= SMEM_PER_BLOCK
            if p["tma"]:
                assert p[name]["stream_rows"] * C * 2 % 1024 == 0
        f = _bwd_plan(B, T, C, torch.float32)
        assert f["kernel"] == "fma" and f["threads"] == 256
        assert f["dq"]["grid"] == f["dkdv"]["grid"] == (-(-T // 32), B)


def test_bf16_backward_plan_at_the_classifier_heads():
    """The bf16 kernels' shared memory at (8, 1024, C), by hand: at C = 64
    (the classifier's heads) 52,496 and 53,264 bytes, four blocks an SM."""
    want = {32: (30992, 31760), 64: (52496, 53264), 128: (101648, 69136)}
    for C, (dq, dkdv) in want.items():
        p = _bwd_plan(8, 1024, C, torch.bfloat16)
        assert (p["dq"]["smem"], p["dkdv"]["smem"]) == (dq, dkdv)
    assert 4 * max(want[64]) <= 228 * 1024  # the SM's shared memory


@pytest.mark.parametrize("B,T,C,dtype,err", [
    (2, 16, 96, torch.float32, "C in"),
    (2, 16, 512, torch.bfloat16, "C in"),
    (0, 16, 64, torch.float32, "B\\*"),
    (65536, 16, 64, torch.float32, "B\\*"),
    (2, 0, 64, torch.float32, "T >= 1"),
    (2, 16, 64, torch.float16, "float32/bfloat16"),
])
def test_backward_plan_refuses_what_the_kernels_do_not_take(B, T, C, dtype, err):
    with pytest.raises((ValueError, TypeError), match=err):
        _bwd_plan(B, T, C, dtype)


def test_backward_wrappers_check_before_they_build():
    """On a CPU tensor the backward wrappers raise before touching the
    library (no nvcc here): the kernels take CUDA tensors only."""
    from ddnm_tpu_torch.ops.attention import _attn_bwd_dq
    from ddnm_tpu_torch.ops.groupnorm import _bwd_reduce

    q = torch.zeros(2, 8, 64)
    with pytest.raises(ValueError, match="CUDA"):
        _attn_bwd_dq(q, q, q, q, q, 1.0)
    x = torch.zeros(1, 4, 4, 64)
    with pytest.raises(ValueError, match="CUDA"):
        _bwd_reduce(x, x, torch.ones(64), 32, 1e-5, False)


def test_backward_entry_points_have_ctypes_signatures():
    """The four backward kernels' C entry points are bound with a pointer
    for every pointer and the stream (the whole table is checked against
    the sources by test_ctypes_signatures_match_the_c_entry_points)."""
    import ctypes

    from ddnm_tpu_torch.ops._build import _SIGNATURES

    P = ctypes.c_void_p
    assert _SIGNATURES["ddnm_gn_bwd_reduce"][:9] == [P] * 9
    assert _SIGNATURES["ddnm_gn_bwd_dx"][:6] == [P] * 6
    for name in ("ddnm_attention_bwd_dq", "ddnm_attention_bwd_dkdv"):
        assert _SIGNATURES[name][:8] == [P] * 8 and _SIGNATURES[name][-1] is P
        assert _SIGNATURES[name][11] is ctypes.c_float  # the scale


@pytest.mark.parametrize("sp", [2, 4])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_backward_reduce_partial_plan_at_the_sharded_classifier_shapes(sp, dtype):
    """The backward reduce kernel's partial mode (a spatial shard's sums) at
    every GroupNorm of the 256 px classifier's backward at batch 1 with its
    rows cut over sp shards: the whole kernel's launch at the shard's
    pixels, with 4 rows of per-(B, C) output (the sums of x, x^2, dy' and
    dy' x) in place of 3; every pixel of the shard read once and each group
    finalised once."""
    elem = torch.empty((), dtype=dtype).element_size()
    for B, H, W, C in _gn_grad_shapes("cc256_b1"):
        assert H % sp == 0
        hw = H // sp * W
        whole = _bwd_reduce_plan(B, hw, C, 32, elem, True, H100_SMS)
        part = _bwd_reduce_plan(B, hw, C, 32, elem, True, H100_SMS, True)
        assert whole["out_rows"] == 3 and part == {**whole, "out_rows": 4}
        p, ch, px, fin, slots = _reduce_coverage(B, hw, C, 32, elem, True)
        assert (ch == 1).all() and (px == 1).all() and (fin == 1).all()
        assert all(i < part["counters"] for _, i in slots)


@pytest.mark.parametrize("sp", [2, 4])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_backward_plan_with_fewer_queries_than_keys(sp, dtype):
    """The attention backward with a spatial shard's Tq = T / sp queries
    against every one of the T keys, at each sharded head of the 256 px
    classifier (its attention pool runs whole): the dq pass's grid by the
    queries, the dkdv pass's by the keys, the shared memory of the Tq == Tk
    launch (it follows C alone); Tk = T by default."""
    rows = 32 if dtype == torch.float32 else 64
    heads = {k[1] for k in _classifier_grad_shapes()["cc256_b1"] if k[0] == "attn"}
    sharded = sorted((B, T, C) for B, T, C in heads if T % 2 == 0)
    assert sharded == [(4, 1024, 64), (8, 64, 64), (8, 256, 64)]
    for B, T, C in sharded:
        tq = T // sp
        p = _bwd_plan(B, tq, C, dtype, T)
        same = _bwd_plan(B, T, C, dtype)
        assert same == _bwd_plan(B, T, C, dtype, T)
        assert p["dq"]["grid"] == (-(-tq // rows), B)
        kv_rows = 32 if dtype == torch.float32 else 64
        assert p["dkdv"]["grid"] == (-(-T // kv_rows), B) == same["dkdv"]["grid"]
        for name in ("dq", "dkdv"):
            assert p[name]["smem"] == same[name]["smem"]
    with pytest.raises(ValueError, match="T >= 1"):
        _bwd_plan(4, 16, 64, dtype, 0)


def test_sharded_backward_wrappers_check_before_they_build():
    """On a CPU tensor the spatial modes' wrappers raise before touching the
    library (no nvcc here): the kernels take CUDA tensors only; the
    attention backward checks that k and v share one shape against q's."""
    from ddnm_tpu_torch.ops.attention import _attn_bwd_dkdv, _attn_bwd_dq
    from ddnm_tpu_torch.ops.groupnorm import _bwd_finalize, _bwd_partial

    x = torch.zeros(1, 4, 4, 64)
    with pytest.raises(ValueError, match="CUDA"):
        _bwd_partial(x, x, 32, False)
    with pytest.raises(ValueError, match="CUDA"):
        _bwd_finalize(torch.zeros(4, 1, 64), 32, torch.ones(64), 32, 1e-5)
    q, k = torch.zeros(2, 8, 64), torch.zeros(2, 16, 64)
    with pytest.raises(ValueError, match="CUDA"):
        _attn_bwd_dq(q, k, k, q, q, 1.0)
    with pytest.raises(ValueError, match="CUDA"):
        _attn_bwd_dkdv(q, k, k, q, torch.zeros(2, 8), torch.zeros(2, 8), 1.0)
