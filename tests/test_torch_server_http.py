"""The port's RestorationServer (ddnm_tpu_torch/server.py): HTTP round
trips, /healthz against the JAX server's, RGBA keep-masks, backpressure
(503 "queue full"), cancellation (504), the drain on stop, failures that
stay in their group, the pipelined worker against direct restores, the
batcher's grouping fuzz and swap_params landing only between groups.

The pure batcher tests drive a device-free fake service (tests/test_server.py
`_FakeService`, the JAX suite's own); the others a random 32 px DDPM UNet
at 3 steps (tests/test_server.py's set-up). Replies are compared as uint8
images, exactly."""

from __future__ import annotations

import json
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from ddnm_tpu_torch import schedules
from ddnm_tpu_torch.data.io import decode_png, encode_png
from ddnm_tpu_torch.models import DDPMUNet
from ddnm_tpu_torch.operators import build_functional_operator
from ddnm_tpu_torch.sampling import build_schedule
from ddnm_tpu_torch.server import RestorationServer, RestorationService, _Request
from tests._torch_port import one_torch_thread  # noqa: F401
from tests.test_server import _FakeService

RES = 32


def _net(seed=0):
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        return DDPMUNet(ch=32, ch_mult=(1, 2), num_res_blocks=1, attn_resolutions=(16,),
                        resolution=RES).eval()


def _service(ops, net=None, max_batch=4):
    betas = schedules.get_beta_schedule("linear", beta_start=1e-4, beta_end=0.02,
                                        num_diffusion_timesteps=100).astype(np.float32)
    return RestorationService(lambda p, x, t: p["model"](x, t), {"model": net or _net()},
                              build_schedule(betas=betas, t_sampling=3), ops,
                              image_size=RES, max_batch=max_batch)


@pytest.fixture(scope="module")
def service():
    return _service({
        "sr_averagepooling": build_functional_operator("sr_averagepooling", image_size=RES,
                                                       deg_scale=4),
        "colorization": build_functional_operator("colorization", image_size=RES)})


@pytest.fixture(scope="module")
def mask_service():
    ones = np.ones((RES, RES, 1), np.float32)
    return _service({
        "inpainting": build_functional_operator("inpainting", image_size=RES, mask=ones),
        "mask_color_sr": build_functional_operator("mask_color_sr", image_size=RES,
                                                   deg_scale=4, mask=ones)})


def _gt_images(n, seed=7):
    return np.random.default_rng(seed).uniform(0.2, 0.8, (n, RES, RES, 3)).astype(np.float32)


def _masks(n, seed=17):
    return (np.random.default_rng(seed).random((n, RES, RES, 1)) > 0.4).astype(np.float32)


def _u8(img01):
    return np.clip(img01 * 255.0 + 0.5, 0, 255).astype(np.uint8)


def _png(img01):
    return encode_png(_u8(img01))


def _rgba(img01, mask01):
    return encode_png(np.concatenate([_u8(img01), (mask01 * 255).astype(np.uint8)], -1))


def _post(url, body):
    req = urllib.request.Request(url, data=body, headers={"Content-Type": "image/png"})
    try:
        with urllib.request.urlopen(req, timeout=300) as resp:
            return resp.status, resp.read(), dict(resp.headers)
    except urllib.error.HTTPError as e:
        return e.code, e.read(), dict(e.headers)


class _GatedService(_FakeService):
    """The JAX suite's fake service whose dispatch says it has started
    (`entered`) and then waits for `gate`."""

    def __init__(self):
        super().__init__()
        self.entered, self.gate = threading.Event(), threading.Event()

    def restore_async(self, images, deg, seqs, **kw):
        self.entered.set()
        if not self.gate.wait(timeout=60):
            raise RuntimeError("gate never opened")
        return super().restore_async(images, deg, seqs, **kw)


class _UploadRecorder(_FakeService):
    """A fake service with a mask task ("m") and a task whose measurement
    is gray ("g"), for servers whose submit() is recorded."""

    def __init__(self):
        super().__init__(image_size=RES)
        self.tasks, self.ctx_tasks = ("m", "g"), ("m",)

    def y_shape(self, deg):
        return (RES, RES, 1) if deg == "g" else (RES, RES, 3)

    def restore_async(self, images, deg, seqs, *, input_kind="degraded", ctxs=None,
                      classes=None):
        return np.zeros((len(seqs), RES, RES, 3), np.float32)


def _recorded_uploads(server_cls, uploads) -> list:
    """(status, submitted image, submitted mask) of each (url tail, body)
    upload through a server of `server_cls` over _UploadRecorder."""
    server = server_cls(_UploadRecorder(), max_wait_ms=1.0)
    seen = []
    submit = server.submit

    def recording_submit(arr, deg, input_kind, ctx=None, cls=None):
        seen.append((np.asarray(arr), None if ctx is None else np.asarray(ctx)))
        return submit(arr, deg, input_kind, ctx=ctx, cls=cls)

    server.submit = recording_submit
    server.start()
    try:
        base = "http://%s:%d" % server.address
        out = []
        for tail, body in uploads:
            n = len(seen)
            status, reply, _ = _post(f"{base}/restore?{tail}", body)
            assert status == 200, reply
            out.append((status,) + seen[n])
        return out
    finally:
        server.stop()


def test_uploads_of_other_formats_parse_as_the_jax_server():
    """An RGBA WebP is a per-request mask; a palette PNG with tRNS has no
    alpha band (mode "P"), so no mask; a 16-bit gray PNG ("I;16") is a gray
    measurement, clipped at 255: what the port's handler submits equals
    what ddnm_tpu/server.py's (PIL) submits, byte for byte."""
    import io
    import struct
    import zlib

    from PIL import Image

    from ddnm_tpu.server import RestorationServer as JRestorationServer

    rng = np.random.default_rng(31)
    rgba = np.concatenate([_u8(_gt_images(1, seed=31)[0]),
                           (_masks(1, seed=31)[0] * 255).astype(np.uint8)], -1)
    buf = io.BytesIO()
    Image.fromarray(rgba).save(buf, "WEBP", quality=80)
    webp = buf.getvalue()
    pal = Image.fromarray(_u8(_gt_images(1, seed=32)[0])).quantize(16)
    buf = io.BytesIO()
    pal.save(buf, "PNG", transparency=bytes([0, 128] + [255] * 14))
    palette = buf.getvalue()
    gray16 = rng.integers(0, 600, (RES, RES)).astype(">u2")

    def chunk(tag, b):
        return struct.pack(">I", len(b)) + tag + b + struct.pack(">I", zlib.crc32(tag + b))

    raw = b"".join(b"\0" + row.tobytes() for row in gray16)
    ihdr = struct.pack(">IIBBBBB", RES, RES, 16, 0, 0, 0, 0)
    png16 = (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", ihdr) + chunk(b"IDAT", zlib.compress(raw))
             + chunk(b"IEND", b""))
    assert Image.open(io.BytesIO(png16)).mode == "I;16"
    uploads = [("deg=m&input=gt", webp), ("deg=m&input=gt", palette),
               ("deg=g&input=degraded", png16)]
    ours = _recorded_uploads(RestorationServer, uploads)
    ref = _recorded_uploads(JRestorationServer, uploads)
    for (s0, a0, c0), (s1, a1, c1) in zip(ours, ref):
        assert s0 == s1 == 200
        np.testing.assert_array_equal(a0, a1)
        assert (c0 is None) == (c1 is None)
        if c0 is not None:
            np.testing.assert_array_equal(c0, c1)
    assert ours[0][2] is not None and ours[1][2] is None
    assert ours[2][1].shape == (RES, RES, 1) and ours[2][1].max() == 1.0


def _get(url):
    with urllib.request.urlopen(url, timeout=30) as resp:
        return json.loads(resp.read())


def _parallel(fn, n):
    threads = [threading.Thread(target=fn, args=(i,)) for i in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()


def test_http_roundtrip_and_health_keys_equal_the_jax_server(service):
    from ddnm_tpu.server import RestorationServer as JRestorationServer

    server = RestorationServer(service, max_wait_ms=200.0)
    server.start()
    base = "http://%s:%d" % server.address
    try:
        gts = _gt_images(2, seed=3)
        results = {}
        _parallel(lambda i: results.__setitem__(
            i, _post(f"{base}/restore?deg=sr_averagepooling&input=gt", _png(gts[i]))), 2)
        for i in range(2):
            status, body, headers = results[i]
            assert status == 200, body
            assert decode_png(body).shape == (RES, RES, 3)
            assert headers["Content-Type"] == "image/png" and "X-Batch-Size" in headers
        h = _get(f"{base}/healthz")
        assert h["status"] == "ok" and h["requests"] == 2 and h["batches"] >= 1
        assert set(h["tasks"]) == {"sr_averagepooling", "colorization"}
        assert h["degraded_upload"] == {"colorization": [RES, RES, 3],
                                        "sr_averagepooling": [RES // 4, RES // 4, 3]}
        status, body, _ = _post(f"{base}/restore?deg=nope", _png(gts[0]))
        assert status == 400 and b"unknown deg" in body
        status, body, _ = _post(f"{base}/restore?deg=sr_averagepooling", _png(gts[0]))
        assert status == 400 and b"degraded input" in body
        status, body, _ = _post(f"{base}/restore?deg=sr_averagepooling&input=gt",
                                b"not a png")
        assert status == 400 and b"bad image" in body
        status, body, _ = _post(f"{base}/nope", b"x")
        assert status == 404
    finally:
        server.stop()
    # the JAX server's /healthz over the JAX suite's fake service, after one
    # request, has the same keys (and latency keys)
    ports = {}
    for name, cls in (("jax", JRestorationServer), ("port", RestorationServer)):
        srv = cls(_FakeService(image_size=RES), max_wait_ms=1.0)
        srv.start()
        try:
            b = "http://%s:%d" % srv.address
            status, _, _ = _post(f"{b}/restore?deg=a", _png(_gt_images(1)[0]))
            assert status == 200
            ports[name] = _get(f"{b}/healthz")
        finally:
            srv.stop()
    assert sorted(ports["port"]) == sorted(ports["jax"])
    assert sorted(ports["port"]["latency_s"]) == sorted(ports["jax"]["latency_s"])
    assert sorted(h) == sorted(ports["jax"])


def test_http_rgba_masks_coalesce_and_match_direct(mask_service):
    """RGBA uploads carry per-request keep-masks: two requests with
    different masks coalesce into one group and each reply is the direct
    restore of its seq and mask; a degraded masked upload against
    mask_color_sr is a 400, and an RGB upload against a mask-required task
    too."""
    server = RestorationServer(mask_service, max_wait_ms=200.0)
    server.start()
    base = "http://%s:%d" % server.address
    try:
        gts, m = _gt_images(2, seed=23), _masks(2, seed=29)
        results = {}
        _parallel(lambda i: results.__setitem__(
            i, _post(f"{base}/restore?deg=inpainting&input=gt", _rgba(gts[i], m[i]))), 2)
        assert all(results[i][0] == 200 for i in (0, 1)), results
        assert server.stats.batched_requests == 2
        for i in (0, 1):
            _, body, headers = results[i]
            sent = _u8(gts[i]).astype(np.float32) / 255.0
            direct = mask_service.restore(sent[None], "inpainting", [int(headers["X-Seq"])],
                                          input_kind="gt", ctxs=m[i:i + 1])[0]
            np.testing.assert_array_equal(decode_png(body), _u8(direct))
        assert _get(f"{base}/healthz")["ctx_tasks"] == ["inpainting", "mask_color_sr"]
        status, body, _ = _post(f"{base}/restore?deg=mask_color_sr", _rgba(gts[0], m[0]))
        assert status == 400 and b"degraded masked" in body
    finally:
        server.stop()
    req_svc = RestorationService(
        mask_service._model_fn, mask_service._params, mask_service._sched,
        mask_service._operators, image_size=RES, max_batch=4, require_ctx=("inpainting",))
    server = RestorationServer(req_svc)
    server.start()
    try:
        status, body, _ = _post("http://%s:%d/restore?deg=inpainting&input=gt"
                                % server.address, _png(_gt_images(1)[0]))
        assert status == 400 and b"without a static mask" in body
    finally:
        server.stop()


def test_rgba_and_gray_uploads_decode_as_pil_does(service):
    """An RGBA upload against a maskless task is a 400; a gray+alpha one too;
    an RGB upload for a grayscale measurement converts with PIL's luma."""
    from PIL import Image

    from ddnm_tpu_torch.data.io import convert

    server = RestorationServer(service)
    server.start()
    base = "http://%s:%d" % server.address
    try:
        status, body, _ = _post(f"{base}/restore?deg=sr_averagepooling&input=gt",
                                _rgba(_gt_images(1)[0], _masks(1)[0]))
        assert status == 400 and b"per-request mask" in body
        la = np.stack([_u8(_gt_images(1)[0][..., 0]), np.full((RES, RES), 255, np.uint8)], -1)
        status, body, _ = _post(f"{base}/restore?deg=sr_averagepooling&input=gt",
                                encode_png(la))
        assert status == 400 and b"per-request mask" in body
    finally:
        server.stop()
    rgb = np.random.default_rng(0).integers(0, 256, (16, 16, 3), dtype=np.uint8)
    np.testing.assert_array_equal(convert(rgb, "RGB", "L"),
                                  np.asarray(Image.fromarray(rgb).convert("L")))


def test_overload_sheds_with_503_queue_full():
    fake = _FakeService(dispatch_delay_s=0.2)
    server = RestorationServer(fake, max_wait_ms=5.0, queue_size=2)
    server.start()
    url = "http://%s:%d/restore?deg=a&input=gt" % server.address
    body = _png(np.zeros((8, 8, 3), np.float32))
    results = {}
    try:
        _parallel(lambda i: results.__setitem__(i, _post(url, body)), 16)
        codes = [results[i][0] for i in range(16)]
        ok, shed = codes.count(200), codes.count(503)
        assert ok + shed == 16 and ok >= 2 and shed >= 1, codes
        assert all(b"queue full" in results[i][1] for i in range(16) if codes[i] == 503)
        assert server.stats.requests == ok and server.stats.errors == 0
    finally:
        server.stop()


def test_cancelled_requests_skip_device_work_and_time_out_with_504(service):
    server = RestorationServer(service)
    gone = _Request(image=_gt_images(1)[0], deg="sr_averagepooling", input_kind="gt", seq=101)
    gone.cancelled.set()
    live = _Request(image=_gt_images(1)[0], deg="sr_averagepooling", input_kind="gt", seq=102)
    server._serve_group([gone, live])
    assert gone.event.is_set() and gone.result is None
    assert gone.error_code == 504 and "cancelled" in gone.error
    assert live.error is None and live.result is not None and live.batch_size == 1
    assert server.stats.cancelled == 1 and server.stats.requests == 1
    server._httpd.server_close()
    # through HTTP: the handler gives up after request_timeout_s (504); the
    # two requests queued behind a slow group are then skipped by the worker.
    # The group is slow because its dispatch waits on a gate that opens only
    # once all three handlers have answered, so no wall-clock sleep orders
    # the events: request 0 is dispatched alone before 1 and 2 are sent.
    fake = _GatedService()
    server = RestorationServer(fake, max_wait_ms=1.0, request_timeout_s=0.5)
    server.start()
    try:
        url = "http://%s:%d/restore?deg=a&input=gt" % server.address
        body = _png(np.zeros((8, 8, 3), np.float32))
        results = {}
        first = threading.Thread(target=lambda: results.__setitem__(0, _post(url, body)))
        first.start()
        assert fake.entered.wait(timeout=60)
        _parallel(lambda i: results.__setitem__(i + 1, _post(url, body)), 2)
        first.join()
        fake.gate.set()
        assert [results[i][0] for i in range(3)] == [504] * 3
        assert all(b"timed out" in results[i][1] for i in range(3))
        deadline = time.monotonic() + 5
        while server.stats.cancelled < 2 and time.monotonic() < deadline:
            time.sleep(0.05)
        assert server.stats.cancelled == 2 and server.stats.requests == 1
    finally:
        fake.gate.set()
        server.stop()


def test_stop_drains_and_rejects(service):
    server = RestorationServer(service)
    req = server.submit(_gt_images(1)[0], "sr_averagepooling", "gt")
    server.stop()
    assert req.event.is_set()
    assert req.error == "server shutting down" and req.error_code == 503
    with pytest.raises(RuntimeError):
        server.submit(_gt_images(1)[0], "sr_averagepooling", "gt")
    fake = _FakeService(dispatch_delay_s=0.05)
    server = RestorationServer(fake, max_wait_ms=1.0, queue_size=256)
    server.start()
    reqs = [server.submit(np.zeros((8, 8, 3), np.float32), "a", "degraded") for _ in range(40)]
    server.stop()
    for r in reqs:
        assert r.event.wait(timeout=10)
        assert (r.error is None and r.result[0, 0, 0] == r.seq + 1.0) or r.error_code == 503


def test_failures_do_not_poison_other_groups(service):
    fake = _FakeService(fail_seqs={1})
    server = RestorationServer(fake, max_wait_ms=1.0)
    server.start()
    try:
        reqs = []
        for _ in range(6):
            reqs.append(server.submit(np.zeros((8, 8, 3), np.float32), "a", "degraded"))
            time.sleep(0.02)
        for r in reqs:
            assert r.event.wait(timeout=10)
        failed = [r for r in reqs if r.error is not None]
        assert any(r.seq == 1 for r in failed)
        assert all("injected dispatch failure" in r.error for r in failed)
        assert sum(r.error is None for r in reqs) >= 4
        assert server.stats.errors == len(failed)
    finally:
        server.stop()
    # a malformed request is a 400 at the handler; its neighbour is served
    server = RestorationServer(service, max_wait_ms=150.0)
    server.start()
    base = "http://%s:%d" % server.address
    try:
        good = _gt_images(1, seed=5)[0, :RES // 4, :RES // 4]
        bad = _gt_images(1, seed=6)[0, :RES // 2, :RES // 2]
        results = {}
        _parallel(lambda i: results.__setitem__(
            i, _post(f"{base}/restore?deg=sr_averagepooling", _png((good, bad)[i]))), 2)
        assert results[1][0] == 400 and b"degraded input" in results[1][1]
        assert results[0][0] == 200, results[0][1]
        assert server.stats.errors == 0
        status, body, _ = _post(f"{base}/restore?deg=sr_averagepooling&input=nope",
                                _png(good))
        assert status == 400 and b"input must be" in body
    finally:
        server.stop()


def test_pipelined_worker_matches_direct_restore(service):
    """12 requests at max_batch 4 (three or more groups through the one-deep
    pipeline): every reply is the uint8 image of the direct restore of its
    seq and its upload's own quantisation."""
    server = RestorationServer(service, max_wait_ms=30.0, queue_size=32)
    server.start()
    url = "http://%s:%d/restore?deg=sr_averagepooling&input=gt" % server.address
    try:
        gts = _gt_images(12, seed=31)
        results = {}
        _parallel(lambda i: results.__setitem__(i, _post(url, _png(gts[i]))), 12)
        assert all(results[i][0] == 200 for i in range(12))
        assert server.stats.requests == 12 and server.stats.errors == 0
        assert server.stats.batches >= 3 and server.stats.batched_requests > 0
        for i in range(12):
            _, body, headers = results[i]
            sent = _u8(gts[i]).astype(np.float32) / 255.0
            direct = service.restore(sent[None], "sr_averagepooling", [int(headers["X-Seq"])],
                                     input_kind="gt")[0]
            np.testing.assert_array_equal(decode_png(body), _u8(direct))
    finally:
        server.stop()


def test_batcher_grouping_invariants_fuzz():
    """tests/test_server.py:1119-1171 on the port's batcher: groups are
    homogeneous in (task, input_kind, maskedness), at most max_batch, their
    concatenation keeps submission order, and the stats add up."""
    from hypothesis import given, settings
    from hypothesis import strategies as st

    img = np.zeros((8, 8, 3), np.float32)
    mask = np.ones((8, 8, 1), np.float32)

    @settings(max_examples=40, deadline=None)
    @given(st.lists(st.tuples(st.sampled_from(["a", "b"]), st.sampled_from(["gt", "degraded"]),
                              st.booleans(), st.booleans()), min_size=1, max_size=24))
    def run(seq):
        server = RestorationServer(_FakeService(max_batch=3), max_wait_ms=0.001)
        try:
            reqs = []
            for deg, kind, has_ctx, cancel in seq:
                r = server.submit(img, deg, kind, ctx=mask if has_ctx else None)
                if cancel:
                    r.cancelled.set()
                reqs.append(r)
            groups = []
            while server._held is not None or not server._queue.empty():
                if server._held is not None:
                    first, server._held = server._held, None
                else:
                    first = server._queue.get_nowait()
                groups.append(server._collect(first))
            assert [r.seq for g in groups for r in g] == [r.seq for r in reqs]
            for g in groups:
                assert len(g) <= server.service.max_batch
                assert len({(r.deg, r.input_kind, r.ctx is None) for r in g}) == 1
            for g in groups:
                server._serve_group(g)
            assert all(r.event.is_set() for r in reqs)
            n_cancelled = sum(1 for *_, c in seq if c)
            assert server.stats.cancelled == n_cancelled
            assert server.stats.requests == len(seq) - n_cancelled
            assert server.stats.errors == 0
        finally:
            server._httpd.server_close()

    run()


def test_swap_params_lands_between_groups(service):
    """A swap requested while a group is launching (from inside its model
    calls, as a SIGHUP thread would land) leaves that group on the old
    weights; the next group runs the new ones; swapping back gives the old
    bits; a foreign structure is refused."""
    net1, net2 = _net(0), _net(9)
    state1 = {k: v.clone() for k, v in net1.state_dict().items()}
    calls = {"n": 0, "swap_at": None}
    svc_ref = {}

    def model_fn(p, x, t):
        calls["n"] += 1
        if calls["n"] == calls["swap_at"]:
            svc_ref["svc"].swap_params({"model": net2})
        return p["model"](x, t)

    betas = schedules.get_beta_schedule("linear", beta_start=1e-4, beta_end=0.02,
                                        num_diffusion_timesteps=100).astype(np.float32)
    svc = RestorationService(model_fn, {"model": net1}, build_schedule(betas=betas, t_sampling=3),
                             service._operators, image_size=RES, max_batch=2)
    svc_ref["svc"] = svc
    gts = _gt_images(1, seed=73)
    out1 = svc.restore(gts, "sr_averagepooling", [0], input_kind="gt")
    calls.update(n=0, swap_at=2)  # mid-trajectory
    during = svc.restore(gts, "sr_averagepooling", [0], input_kind="gt")
    np.testing.assert_array_equal(during, out1)
    assert all(torch.equal(v, state1[k]) for k, v in net1.state_dict().items())
    calls["swap_at"] = None
    out2 = svc.restore(gts, "sr_averagepooling", [0], input_kind="gt")
    assert not np.array_equal(out1, out2)
    svc.swap_params({"model": _net(0)})
    np.testing.assert_array_equal(svc.restore(gts, "sr_averagepooling", [0], input_kind="gt"),
                                  out1)
    with pytest.raises(ValueError, match="structure"):
        svc.swap_params({"bogus": np.zeros(3)})
    with pytest.raises(ValueError, match="shapes"):
        svc.swap_params({"model": DDPMUNet(ch=32, ch_mult=(1, 2), num_res_blocks=1,
                                           attn_resolutions=(16,), resolution=RES,
                                           out_ch=6)})
