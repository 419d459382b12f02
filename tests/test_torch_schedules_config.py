"""Port parity: ddnm_tpu_torch.schedules and .config against ddnm_tpu.

Both are host NumPy / dataclass code, so the gate is exact equality."""

import dataclasses
from pathlib import Path

import numpy as np
import pytest

from ddnm_tpu import config as jcfg
from ddnm_tpu import schedules as jsch
from ddnm_tpu_torch import config as tcfg
from ddnm_tpu_torch import schedules as tsch
from ddnm_tpu_torch.sampling import build_schedule as t_build_schedule
from ddnm_tpu.sampling import build_schedule as j_build_schedule

REPO = Path(__file__).resolve().parents[1]


@pytest.mark.parametrize("name", ["quad", "linear", "const", "jsd", "sigmoid"])
def test_beta_schedule_equal(name):
    kw = dict(beta_start=1e-4, beta_end=0.02, num_diffusion_timesteps=1000)
    ours = tsch.get_beta_schedule(name, **kw)
    ref = jsch.get_beta_schedule(name, **kw)
    assert ours.dtype == ref.dtype and np.array_equal(ours, ref)
    assert np.array_equal(tsch.alpha_bar_table(ours), jsch.alpha_bar_table(ref))


@pytest.mark.parametrize("t,length,repeat",
                         [(100, 1, 1), (100, 2, 2), (100, 10, 3), (25, 5, 4), (25, 1, 1)])
def test_jump_schedule_and_time_pairs_equal(t, length, repeat):
    ours = tsch.get_schedule_jump(t, length, repeat)
    assert ours == jsch.get_schedule_jump(t, length, repeat)
    for skip in (1, 10, 40):
        a, b = tsch.build_time_pairs(ours, skip), jsch.build_time_pairs(ours, skip)
        for f in ("t_cur", "t_next", "is_travel"):
            assert np.array_equal(getattr(a, f), getattr(b, f)), f
            assert getattr(a, f).dtype == getattr(b, f).dtype, f
    betas = jsch.get_beta_schedule("linear", beta_start=1e-4, beta_end=0.02,
                                   num_diffusion_timesteps=1000).astype(np.float32)
    a = t_build_schedule(betas=betas, t_sampling=t, travel_length=length,
                         travel_repeat=repeat)
    b = j_build_schedule(betas=betas, t_sampling=t, travel_length=length,
                         travel_repeat=repeat)
    for f in ("alpha_bar", "t_cur", "t_next", "is_travel"):
        assert np.array_equal(np.asarray(getattr(a, f)), np.asarray(getattr(b, f))), f


def test_check_times_rejects_bad_schedules():
    for bad in ([1, 2, -1], [3, 2, 1], [3, 1, -1], [2, 1, 0, -1, -2]):
        with pytest.raises(ValueError):
            tsch.check_times(bad, -1, 3)


@pytest.mark.parametrize("path", sorted((REPO / "configs").glob("*.yml")),
                         ids=lambda p: p.name)
def test_load_config_equals_jax(path):
    ours = dataclasses.asdict(tcfg.load_config(path))
    ref = dataclasses.asdict(jcfg.load_config(path))
    assert ours == ref
