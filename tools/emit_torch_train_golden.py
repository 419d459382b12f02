"""Emit tests/fixtures/toy_train_golden.json: the JAX trainers' first
Adam steps from the committed toy weights, which chip_smoke.py phase 24
holds the port's training path to on the card.

For each toy model (the DDPM toy_ddpm32.pt, the ADM toy_adm32.pt, the
classifier toy_clf32.pt) the step of its JAX trainer (tools/
train_toy_golden.py, train_toy_adm_golden.py,
train_toy_classifier_golden.py: jax.value_and_grad of the epsilon MSE or
the cross entropy, optax.adam at the trainer's learning rate), keys from
PRNGKey(1) split before every step as the trainers split them, at batch
BATCH, for STEPS steps from the committed weights, fp32 on the CPU:
  - every step's loss;
  - at step 1, the L2 norm of each leaf's gradient;
  - after the last step, the sum of each leaf's parameters;
  - a checksum of the first step's x0, t and noise (sums and sums of
    absolute values), so that the card holds the data draw too.
Leaves are named by the port's state-dict keys (models/convert.py
`params_from_flax`: the transposes keep norms and sums).

`jax_steps` is the step the CPU tests (tests/test_torch_training.py) run
against the port's from the same parameters and key.

  JAX_PLATFORMS=cpu python tools/emit_torch_train_golden.py   (~1 min)
"""

from __future__ import annotations

import json
import sys
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))
sys.path.insert(0, str(REPO / "tools"))
sys.path.insert(0, str(REPO / "tools/experiments"))

OUT = REPO / "tests/fixtures/toy_train_golden.json"
BATCH = 16
STEPS = 3
T = 1000
# name -> (fixture, JAX trainer module, kind, learning rate, cumulative
# product dtype of the schedule, schedule)
MODELS = {
    "ddpm": ("toy_ddpm32.pt", "train_toy_golden", "eps", 2e-4, "float32", "ddpm"),
    "adm": ("toy_adm32.pt", "train_toy_adm_golden", "eps", 2e-4, "float64", "adm"),
    "clf": ("toy_clf32.pt", "train_toy_classifier_golden", "classifier", 3e-4, "float64",
            "adm"),
}


def abar(schedule: str, cumprod_dtype: str) -> np.ndarray:
    """The JAX trainer's float32 table."""
    from ddnm_tpu import schedules

    if schedule == "ddpm":
        betas = schedules.get_beta_schedule("linear", beta_start=1e-4, beta_end=0.02,
                                            num_diffusion_timesteps=T)
    else:
        betas = schedules.named_beta_schedule("linear", T, use_scale=True)
    return np.cumprod(1.0 - np.asarray(betas).astype(cumprod_dtype)).astype(np.float32)


def jax_model(name: str):
    import importlib

    return importlib.import_module(MODELS[name][1]).build_model()


def jax_params(name: str, model=None):
    """The committed weights as the JAX model's tree."""
    import jax
    import jax.numpy as jnp

    from ddnm_tpu.data.checkpoints import load_params

    model = model or jax_model(name)
    expected = jax.eval_shape(model.init, jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3)),
                              jnp.zeros((1,)))
    params = load_params(REPO / "tests/fixtures" / MODELS[name][0], cache=False,
                         expected=expected)
    return params if "params" in params else {"params": params}


def jax_steps(name: str, params, n_steps: int, batch: int, seed: int = 1):
    """`n_steps` of the JAX trainer's step from `params`: (losses, the
    first step's gradient tree, the final params, the first batch (x0, t,
    noise))."""
    import jax
    import jax.numpy as jnp
    import optax

    from toy_quality_encoder_cache import make_blobs
    from train_toy_classifier_golden import make_class_blobs

    _, _, kind, lr, cum, schedule = MODELS[name]
    model = jax_model(name)
    table = jnp.asarray(abar(schedule, cum))
    opt = optax.adam(lr)
    opt_state = opt.init(params)

    def draw(key):
        k_img, k_t, k_noise = jax.random.split(key, 3)
        if kind == "classifier":
            x0, cls = make_class_blobs(k_img, batch, 32)
        else:
            x0, cls = make_blobs(k_img, batch, 32), None
        t = jax.random.randint(k_t, (batch,), 0, T)
        noise = jax.random.normal(k_noise, x0.shape)
        return x0, cls, t, noise

    @jax.jit
    def step(params, opt_state, key):
        x0, cls, t, noise = draw(key)
        at = table[t][:, None, None, None]
        xt = jnp.sqrt(at) * x0 + jnp.sqrt(1 - at) * noise

        def loss_fn(p):
            out = model.apply(p, xt, t.astype(jnp.float32))
            if kind == "classifier":
                return optax.softmax_cross_entropy_with_integer_labels(out, cls).mean()
            return jnp.mean((out[..., :3] - noise) ** 2)

        loss, grads = jax.value_and_grad(loss_fn)(params)
        updates, opt_state = opt.update(grads, opt_state)
        return (optax.apply_updates(params, updates), opt_state, loss, grads,
                (x0, t, noise))

    key = jax.random.PRNGKey(seed)
    losses, first_grads, first_batch = [], None, None
    for i in range(n_steps):
        key, k = jax.random.split(key)
        params, opt_state, loss, grads, batch_drawn = step(params, opt_state, k)
        losses.append(float(loss))
        if i == 0:
            first_grads = grads
            first_batch = tuple(np.asarray(a) for a in batch_drawn)
    return losses, first_grads, params, first_batch


def leaf_table(tree, fn) -> dict:
    """{port state-dict key: fn(array)} of a flax tree."""
    from ddnm_tpu_torch.models.convert import params_from_flax

    return {k: fn(v.numpy().astype(np.float64)) for k, v in params_from_flax(tree).items()}


def batch_checksum(x0, t, noise) -> dict:
    return {"x0_sum": float(np.sum(x0, dtype=np.float64)),
            "x0_abs": float(np.abs(x0).sum(dtype=np.float64)),
            "t_sum": int(np.sum(t, dtype=np.int64)),
            "noise_sum": float(np.sum(noise, dtype=np.float64)),
            "noise_abs": float(np.abs(noise).sum(dtype=np.float64))}


def main():
    import jax

    from ddnm_tpu.utils import apply_platform_env

    apply_platform_env()
    out = {"protocol": {"batch": BATCH, "steps": STEPS, "seed": 1, "res": 32,
                        "lr": {k: v[3] for k, v in MODELS.items()},
                        "fixtures": {k: v[0] for k, v in MODELS.items()},
                        "jax": jax.__version__, "dtype": "float32",
                        "emitted_by": "tools/emit_torch_train_golden.py"}}
    for name in MODELS:
        losses, grads, params, batch = jax_steps(name, jax_params(name), STEPS, BATCH)
        out[name] = {
            "losses": losses,
            "grad_norms_step1": leaf_table(grads, lambda a: float(np.sqrt(np.sum(a * a)))),
            "param_sums_final": leaf_table(params, lambda a: float(np.sum(a))),
            "first_batch": batch_checksum(*batch)}
        print(f"# {name}: losses {losses}", flush=True)
    OUT.write_text(json.dumps(out, indent=1, sort_keys=True) + "\n")
    print(f"wrote {OUT} ({OUT.stat().st_size} bytes)")


if __name__ == "__main__":
    main()
