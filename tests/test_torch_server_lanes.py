"""The served convolutions' lane pinning (ddnm_tpu_torch/server.py
`_LanePinnedConv`): on a card, a Conv2d whose engine computes some lane of
a batched call in another order than lane 0 runs one image at a time, so a
request's reply does not depend on its lane. The CPU's convolutions agree
across lanes, so the per-image route is forced here; tolerance: exact."""

import torch

from ddnm_tpu_torch import server
from ddnm_tpu_torch.server import _LanePinnedConv, _pin_conv_lanes


def _conv():
    torch.manual_seed(0)
    conv = torch.nn.Conv2d(6, 5, 3, padding=1)
    x = torch.randn(4, 6, 9, 7).contiguous(memory_format=torch.channels_last)
    return conv, x


def test_agreeing_lanes_keep_the_batched_call():
    conv, x = _conv()
    pinned = _LanePinnedConv(conv)
    assert torch.equal(pinned(x), conv._conv_forward(x, conv.weight, conv.bias))
    assert pinned.per_lane == {(tuple(x.shape), x.stride(), x.dtype): False}


def test_disagreeing_lanes_run_one_image_at_a_time(monkeypatch):
    conv, x = _conv()
    pinned = _LanePinnedConv(conv)
    probes = []
    monkeypatch.setattr(_LanePinnedConv, "_lanes_agree",
                        lambda self, t: probes.append(t.shape) or False)
    per_image = torch.cat([conv._conv_forward(x[i:i + 1], conv.weight, conv.bias)
                           for i in range(4)])
    for _ in range(2):  # the layout is probed once
        assert torch.equal(pinned(x), per_image)
    assert probes == [x.shape]
    assert torch.equal(pinned(x[:1]), per_image[:1])  # one image: no probe
    assert probes == [x.shape]


def test_pin_conv_lanes_wraps_every_conv_once():
    model = torch.nn.Sequential(torch.nn.Conv2d(3, 4, 3), torch.nn.ReLU(),
                                torch.nn.Sequential(torch.nn.Conv2d(4, 2, 1)))
    _pin_conv_lanes({"model": model, "other": 3})
    first = [m.forward for m in model.modules() if isinstance(m, torch.nn.Conv2d)]
    assert len(first) == 2 and all(isinstance(f, _LanePinnedConv) for f in first)
    _pin_conv_lanes(model)
    assert [m.forward for m in model.modules() if isinstance(m, torch.nn.Conv2d)] == first
    x = torch.randn(2, 3, 8, 8)
    assert model(x).shape == (2, 2, 6, 6)


def test_a_cpu_service_leaves_its_convolutions_alone(monkeypatch):
    calls = []
    monkeypatch.setattr(server, "_pin_conv_lanes", lambda params: calls.append(params))
    conv = torch.nn.Conv2d(3, 3, 1)
    server.RestorationService(lambda p, x, t: x, conv, None, {}, image_size=8, max_batch=2)
    assert calls == [] and not isinstance(conv.forward, _LanePinnedConv)
