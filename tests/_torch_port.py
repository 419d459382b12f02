"""Shared set-up of the port's parity tests (tests/test_torch_*.py): the
JAX model and the port's model at one golden tier, built from the same
committed fixture."""

from __future__ import annotations

from pathlib import Path

import numpy as np
import pytest
import torch

from tests._golden import MID64, TOY32, _trainer, load_our_model

TIERS = {"toy32": TOY32, "mid64": MID64}


def port_arch(tier) -> dict:
    """DDPMUNet kwargs of a golden tier, read from its trainer module."""
    mod = _trainer(tier)
    if hasattr(mod, "DDPM_KW"):
        return dict(mod.DDPM_KW)
    return dict(ch=mod.CH, ch_mult=mod.CH_MULT, num_res_blocks=mod.NUM_RES_BLOCKS,
                attn_resolutions=mod.ATTN, resolution=mod.RES)


def port_model(tier, state_dict=None):
    """The port's DDPMUNet with the tier's fixture (or `state_dict`) loaded."""
    from ddnm_tpu_torch.models import DDPMUNet
    from ddnm_tpu_torch.runner import load_checkpoint

    model = DDPMUNet(**port_arch(tier)).eval()
    if state_dict is None:
        load_checkpoint(model, tier.fixture)
    else:
        model.load_state_dict(state_dict, strict=True)
    return model


def jax_model(tier):
    """(model_fn(params, x, t), params) of the JAX package, fp32."""
    return load_our_model(tier)


def zero_noise_torch(gens, shape):
    return torch.zeros(shape, dtype=torch.float32)


def x_T(n: int, res: int) -> np.ndarray:
    """The golden protocol's shared initial noise, NHWC."""
    x = np.random.RandomState(42).randn(n, 3, res, res).astype(np.float32)
    return np.ascontiguousarray(np.transpose(x, (0, 2, 3, 1)))


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Run a test module's torch ops on one intra-op thread: toy sizes gain
    nothing from more, and the suite's workers share the machine's cores
    (idle OpenMP threads of one worker spin while the others wait)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# A cut of configs/imagenet_256_cc.yml (the class-conditional ADM guided by
# its classifier, in the same sections) at 64 px, the smallest size whose
# classifier channel_mult the reference's create_classifier defines: the
# UNet 32 channels wide, the classifier 64, one res block each, attention
# at 16 px, 3 steps, batch 1, the ImageNet folder exp/datasets/imagenet.
TOY_CC_CONFIG = """\
data: { dataset: ImageNet, image_size: 64, channels: 3, rescaled: true }
model:
  type: openai
  num_channels: 32
  num_res_blocks: 1
  num_heads: 4
  num_head_channels: 32
  attention_resolutions: "16"
  channel_mult: "1,2,2"
  use_scale_shift_norm: true
  resblock_updown: true
  learn_sigma: true
  class_cond: true
classifier:
  classifier_width: 64
  classifier_depth: 1
  classifier_attention_resolutions: "16"
  classifier_pool: attention
  classifier_resblock_updown: true
  classifier_use_scale_shift_norm: true
  classifier_scale: 1.0
diffusion: { beta_schedule: linear, beta_start: 1.0e-4, beta_end: 0.02, num_diffusion_timesteps: 1000 }
time_travel: { T_sampling: 3, travel_length: 1, travel_repeat: 1 }
sampling: { batch_size: 1 }
"""


def write_toy_cc_config(path):
    """TOY_CC_CONFIG written to `path`; returns the path."""
    path.write_text(TOY_CC_CONFIG)
    return path


def linear_gaussian(res: int = 8, v: float = 0.25, n: int = 2):
    """The analytic probability-flow case of tests/test_solvers.py on both
    sides: Gaussian data N(0, v), whose exact eps predictor is
    sqrt(1 - abar) x / (abar v + 1 - abar), through a zero-mask inpainting
    operator (A = A+ = 0: the projection vanishes). Returns (betas, JAX
    model_fn, port model_fn, JAX operator, port operator, x_init NHWC numpy)."""
    import jax.numpy as jnp

    from ddnm_tpu import schedules as jsch
    from ddnm_tpu.operators import build_functional_operator as j_build_op
    from ddnm_tpu_torch.operators import build_functional_operator

    betas = jsch.get_beta_schedule("linear", beta_start=1e-4, beta_end=2e-2,
                                   num_diffusion_timesteps=1000)
    table = np.asarray(jsch.alpha_bar_table(betas), np.float32)
    jtable = jnp.asarray(table)
    ttable = torch.from_numpy(table)

    def j_model(x, t):
        ab = jtable[t.astype(jnp.int32) + 1].reshape(-1, 1, 1, 1)
        return jnp.sqrt(1.0 - ab) * x / (ab * v + 1.0 - ab)

    def t_model(x, t):
        ab = ttable[t.long() + 1].reshape(-1, 1, 1, 1)
        return torch.sqrt(1.0 - ab) * x / (ab * v + 1.0 - ab)

    zero = np.zeros((res, res), np.int64)
    x_init = np.random.RandomState(3).randn(n, res, res, 3).astype(np.float32)
    return (betas, j_model, t_model, j_build_op("inpainting", image_size=res, mask=zero),
            build_functional_operator("inpainting", image_size=res, mask=zero), x_init)


def shared_noise(monkeypatch, res: int = 32, seed: int = 3) -> np.ndarray:
    """Make every standard-normal draw of both frameworks return one fixed
    (res, res, 3) pattern per image (jax.random.normal and torch.randn
    patched): the CLIs' x_T, tile inits and sampler noise then agree
    between the JAX package and the port, whose generators cannot
    reproduce each other's bits. Returns the pattern."""
    import jax
    import jax.numpy as jnp

    pattern = np.random.RandomState(seed).randn(res, res, 3).astype(np.float32)
    monkeypatch.setattr(jax.random, "normal", lambda key, shape, dtype=jnp.float32:
                        jnp.broadcast_to(jnp.asarray(pattern, dtype), shape))

    def randn(*size, generator=None, device=None, dtype=None, **_):
        if len(size) == 1 and isinstance(size[0], (tuple, list, torch.Size)):
            size = size[0]
        return torch.from_numpy(pattern).expand(tuple(size)).to(
            device=device or "cpu", dtype=dtype or torch.float32).clone()

    monkeypatch.setattr(torch, "randn", randn)
    return pattern


def main_pair(tmp_path, monkeypatch, flags: list) -> tuple[dict, dict]:
    """main_torch (--device cpu) and the JAX package's main.py in process on
    configs/toy32.yml with toy_ddpm32.pt: simplified 4x average-pooling SR
    of 2 images of exp/datasets/toy32, `flags` appended, under
    `shared_noise`. Returns (port stats, JAX stats)."""
    import main as j_main
    import main_torch

    repo = Path(__file__).resolve().parents[1]
    shared_noise(monkeypatch)
    common = ["--config", "configs/toy32.yml", "--exp", str(repo / "exp"), "--path_y", "toy32",
              "--deg", "sr_averagepooling", "--simplified",
              "--ckpt", str(repo / "tests" / "fixtures" / "toy_ddpm32.pt"),
              "--max_images", "2", "--batch_size", "2", "--ni", "--verbose", "warning", *flags]
    ours = main_torch.main(common + ["-i", str(tmp_path / "port"), "--device", "cpu"])
    ref = j_main.main(common + ["-i", str(tmp_path / "jax")])
    return ours, ref


class StandInGraph:
    """A graph for the CPU in place of torch.cuda.CUDAGraph
    (ddnm_tpu_torch/sampling/graphs.py `_BACKENDS`): its capture runs the
    body once, and each replay runs it again on the entry's static buffers
    and noise slots (what a CUDA replay recomputes). `fail_capture` raises
    before the body runs; `fail_after` raises the given error once, after
    the body ran (a CUDA capture that recorded every collective and then
    failed)."""

    fail_capture = False
    fail_after = None

    def __init__(self, device):
        self.replays = 0

    def owns_stream(self) -> bool:
        return True

    def register_generator(self, gen) -> None:
        pass

    def warm(self, fn) -> None:
        fn()

    def capture(self, fn):
        if self.fail_capture:
            raise RuntimeError("stand-in capture failed")
        out = fn()
        err = type(self).fail_after
        if err is not None:
            type(self).fail_after = None
            raise err
        return out

    def instantiate(self) -> None:
        pass

    def begin(self) -> None:
        pass

    def replay(self, rerun):
        self.replays += 1
        return rerun()

    def end(self) -> None:
        pass

    def release(self) -> None:
        pass
