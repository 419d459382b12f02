"""The port of the fused GN+SiLU+conv experiment against the JAX experiment.

The JAX side is the experiment's own code (tools/experiments/fused_gn_conv.py
and fused_gn_conv_ablations.py): its module globals B, H, W, C are set to a
small shape in both modules, and its Pallas kernels run in TPU interpret
mode on the CPU (`pl.pallas_call` with `interpret=pltpu.InterpretParams()`
and no compiler params); nothing in the experiment's files changes. The
port's side is `ddnm_tpu_torch.ops.fused_gn_conv` on CPU tensors, its plain
version.

Gate: max abs <= 1e-2 * max(1, max |JAX|). Both sides round the output to
bf16 once, after fp32 sums of the same bf16 products in another order, so
they may land one bf16 ulp apart (<= 2^-7 relative). The affine differs by
fp32 rounding only: the port takes one-pass GroupNorm statistics (sum and
sum of squares, clamped), the experiment a two-pass variance.
"""

import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from ddnm_tpu_torch import ops
from ddnm_tpu_torch.ops.fused_gn_conv import fused_gn_conv

REPO = Path(__file__).resolve().parents[1]
EXPERIMENTS = REPO / "tools" / "experiments"
SHAPE = (2, 32, 32, 64)


@pytest.fixture(scope="module")
def exp():
    """The two JAX experiment modules at SHAPE, Pallas in interpret mode."""
    with pytest.MonkeyPatch.context() as mp:
        mp.syspath_prepend(str(EXPERIMENTS))
        import fused_gn_conv as E
        import fused_gn_conv_ablations as A

        for mod in (E, A):
            for name, value in zip("BHWC", SHAPE):
                mp.setattr(mod, name, value)
        pallas_call = pl.pallas_call

        def interpreted(*args, **kwargs):
            kwargs.pop("compiler_params", None)
            return pallas_call(*args, interpret=pltpu.InterpretParams(), **kwargs)

        mp.setattr(pl, "pallas_call", interpreted)
        yield E, A
    for name in ("fused_gn_conv", "fused_gn_conv_ablations"):
        sys.modules.pop(name, None)


def _inputs(seed, beta_mean=0.0):
    """x with a non-zero mean, w ~ 0.05 N(0, 1), random gamma and beta."""
    rng = np.random.default_rng(seed)
    B, H, W, C = SHAPE
    x = (2 * rng.standard_normal(SHAPE) + 0.5).astype(np.float32)
    w = (0.05 * rng.standard_normal((3, 3, C, C))).astype(np.float32)
    g = (1 + 0.1 * rng.standard_normal(C)).astype(np.float32)
    b = (beta_mean + 0.1 * rng.standard_normal(C)).astype(np.float32)
    xj, wj = jnp.asarray(x, jnp.bfloat16), jnp.asarray(w, jnp.bfloat16)
    xt = torch.from_numpy(np.array(xj.astype(jnp.float32))).bfloat16()
    wt = torch.from_numpy(np.array(wj.astype(jnp.float32))).bfloat16()
    return (xj, wj, jnp.asarray(g), jnp.asarray(b)), (xt, wt, torch.from_numpy(g),
                                                      torch.from_numpy(b))


def _gate(ours, ref):
    ref = np.asarray(jnp.asarray(ref, jnp.float32))
    assert ours.dtype == torch.bfloat16 and ours.shape == ref.shape
    err = float(np.abs(ours.float().numpy() - ref).max())
    tol = 1e-2 * max(1.0, float(np.abs(ref).max()))
    assert err <= tol, (err, tol)
    return err, tol


def _lax_conv(z, w, g, b):
    return jax.lax.conv_general_dilated(z, w, (1, 1), "SAME",
                                        dimension_numbers=("NHWC", "HWIO", "NHWC"),
                                        preferred_element_type=jnp.bfloat16)


# (our mode, the JAX function it is held to)
CASES = {
    "full-vs-pallas": ("full", lambda E, A: E._pallas_raw),
    "full-vs-xla-chain": ("full", lambda E, A: E._chain_raw),
    "conv-vs-pallas-noact": ("conv", lambda E, A: lambda *a: A._call(A._kernel_noact, *a)),
    "conv-vs-lax-conv": ("conv", lambda E, A: _lax_conv),
    "act-vs-pallas-nodot": ("act", lambda E, A: lambda *a: A._call(A._kernel_nodot, *a)),
}


@pytest.mark.parametrize("case", list(CASES))
def test_port_matches_jax_experiment(exp, case):
    mode, jax_fn = CASES[case]
    jin, tin = _inputs(0)
    ref = jax_fn(*exp)(*jin)
    ops.reset_launch_counts()
    _gate(fused_gn_conv(*tin, mode=mode), ref)
    assert not any(ops.launch_counts().values())  # CPU: the plain version


def test_border_is_masked_after_the_activation(exp):
    """With beta ~ 0.5, silu(b_eff) ~ 0.3 outside the image: a version that
    pads x and then activates (mask before the SiLU) misses the JAX kernel by
    far more than the gate; the port meets it."""
    E, _ = exp
    jin, (x, w, g, b) = _inputs(1, beta_mean=0.5)
    ref = E._pallas_raw(*jin)
    _, tol = _gate(fused_gn_conv(x, w, g, b, mode="full"), ref)

    from ddnm_tpu_torch.ops.fused_gn_conv import _torch_act
    from ddnm_tpu_torch.ops.groupnorm import _torch_stats_affine

    a, bb = _torch_stats_affine(x, g, b, 32, 1e-5)
    h = _torch_act(torch.nn.functional.pad(x, (0, 0, 1, 1, 1, 1)), a, bb)
    wrong = torch.nn.functional.conv2d(h.float().permute(0, 3, 1, 2),
                                       w.float().permute(3, 2, 0, 1)).permute(0, 2, 3, 1)
    ref32 = np.asarray(jnp.asarray(ref, jnp.float32))
    assert float(np.abs(wrong.numpy() - ref32).max()) > 10 * tol
    # the interior agrees: only the border tells the two apart
    inner = (slice(None), slice(1, -1), slice(1, -1))
    assert float(np.abs(wrong.numpy()[inner] - ref32[inner]).max()) <= tol


def test_kernel_force_on_cpu_raises_and_counts_nothing():
    ops.reset_launch_counts()
    x = torch.zeros(1, 4, 4, 32, dtype=torch.bfloat16)
    w = torch.zeros(3, 3, 32, 32, dtype=torch.bfloat16)
    for mode in ("full", "conv", "act"):
        with pytest.raises(ValueError, match="CUDA"):
            fused_gn_conv(x, w, torch.ones(32), torch.zeros(32), mode=mode, force="kernel")
    with pytest.raises(ValueError, match="mode"):
        fused_gn_conv(x, w, torch.ones(32), torch.zeros(32), mode="fused")
    with pytest.raises(ValueError, match="force"):
        fused_gn_conv(x, w, torch.ones(32), torch.zeros(32), force="pallas")
    assert not any(ops.launch_counts().values())


def test_experiment_tool_runs_on_the_cpu():
    """The ported experiment's three parts at a tiny CPU size: plain routes,
    launch counts all 0, finite outputs, the trace refused without a card."""
    sys.path.insert(0, str(EXPERIMENTS))
    try:
        import fused_gn_conv_torch as T
    finally:
        sys.path.remove(str(EXPERIMENTS))
    res = T.main(["--device", "cpu", "--shape", "1,8,8,32", "--n_iter", "2", "--ablations"])
    assert res["device"] == "cpu" and res["max_abs_diff"] == 0.0
    assert set(res["variants"]) == set(T.VARIANTS)
    for r in res["variants"].values():
        assert r["finite"] and not any(r["launches"].values())
    with pytest.raises(SystemExit, match="card"):
        T.main(["--device", "cpu", "--shape", "1,8,8,32", "--trace", "kernel_full"])
