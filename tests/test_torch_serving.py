"""The port's serving runtime on the CPU: ``ServingLoop`` and the HTTP
frontend, serving the forward that ``cli.build_psrp_forward`` builds (the
function the CLI and chip_smoke.py call), against that forward called
directly."""

import io
import json
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from retinal_oct_image_segmentation_via_deep_learning_tpu_torch.cli import (
    build_model,
    build_psrp_forward,
    main,
)
from retinal_oct_image_segmentation_via_deep_learning_tpu_torch.inference.http_server import (
    start_in_background,
)
from retinal_oct_image_segmentation_via_deep_learning_tpu_torch.inference.server import (
    ServingLoop,
)

HW = 32


@pytest.fixture(scope="module")
def served():
    model = build_model(num_classes=5, init_features=8, seed=0, device="cpu")
    forward, _ = build_psrp_forward(model, image_size=HW, device="cpu")
    imgs = np.random.default_rng(0).uniform(0, 255, (7, HW, HW, 1)).astype(
        np.float32
    )
    with torch.inference_mode():
        direct = forward(torch.from_numpy(imgs)).numpy()
    return forward, imgs, direct


def _post(url, arr):
    buf = io.BytesIO()
    np.save(buf, arr)
    req = urllib.request.Request(url, data=buf.getvalue(), method="POST")
    with urllib.request.urlopen(req, timeout=60) as r:
        return np.load(io.BytesIO(r.read()), allow_pickle=False)


def test_serving_loop_matches_direct_forward(served):
    forward, imgs, direct = served
    assert direct.dtype == np.int8 and direct.shape == (7, HW, HW)
    loop = ServingLoop(forward, (HW, HW, 1), device="cpu", batch_size=4,
                       max_wait_ms=20.0)
    loop.warmup()
    with loop:
        futs = [loop.submit(im) for im in imgs]
        outs = [f.result(timeout=60) for f in futs]
        with pytest.raises(ValueError):
            loop.submit(np.zeros((HW, HW + 1, 1), np.float32))
    for got, want in zip(outs, direct):
        np.testing.assert_array_equal(got, want)
    # 7 requests in batches of 4: at least 2 batches, padding rows dropped
    assert loop.requests_served == 7 and loop.batches_run >= 2
    with pytest.raises(RuntimeError):
        loop.submit(imgs[0])


def test_close_drains_queued_requests(served):
    forward, imgs, direct = served
    loop = ServingLoop(forward, (HW, HW, 1), device="cpu", batch_size=2)
    futs = [loop.submit(im) for im in imgs[:5]]  # queued before start
    loop.start()
    loop.close()
    for f, want in zip(futs, direct[:5]):
        np.testing.assert_array_equal(f.result(timeout=60), want)
    assert loop.requests_served == 5


def test_http_predict_and_healthz(served):
    forward, imgs, direct = served
    loop = ServingLoop(forward, (HW, HW, 1), device="cpu", batch_size=4,
                       max_wait_ms=5.0)
    httpd, _ = start_in_background(loop, port=0)
    url = f"http://127.0.0.1:{httpd.server_address[1]}"
    try:
        np.testing.assert_array_equal(_post(f"{url}/predict", imgs[0]),
                                      direct[0])
        np.testing.assert_array_equal(_post(f"{url}/predict", imgs[1:4]),
                                      direct[1:4])
        with urllib.request.urlopen(f"{url}/healthz", timeout=30) as r:
            h = json.loads(r.read())
        assert h["ok"] and h["requests_served"] == 4
        assert h["image_shape"] == [HW, HW, 1] and h["batch_size"] == 4
        with pytest.raises(urllib.error.HTTPError) as e:
            _post(f"{url}/predict", np.zeros((HW, 3, 1), np.float32))
        assert e.value.code == 400
    finally:
        httpd.shutdown()
        loop.close()


def test_cli_serve_refuses_missing_cuda(monkeypatch):
    """No fallback: asking for the card where there is none exits."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="no CUDA device"):
        main(["serve", "--device", "cuda", "--image-size", "32"])


def test_cuda_tensor_never_takes_the_plain_version():
    """A wrapper given a non-CPU tensor launches its kernel or raises; it
    never falls back to the plain version."""
    from retinal_oct_image_segmentation_via_deep_learning_tpu_torch.ops import (
        conv_int8,
        head_argmax,
    )

    x = torch.zeros((1, 4, 4, 4), dtype=torch.int8, device="meta")
    s = torch.zeros(4, device="meta")
    for call in (
        lambda: conv_int8.conv3x3_int8(x, x, s, s),
        lambda: conv_int8.ct2x2_int8(x, x, s, s),
        lambda: head_argmax.head_argmax(x, x, s, s),
    ):
        with pytest.raises(ValueError, match="unsupported device"):
            call()
