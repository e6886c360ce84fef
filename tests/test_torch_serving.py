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


def _serve_args(*extra):
    from retinal_oct_image_segmentation_via_deep_learning_tpu_torch.cli import (
        parser,
    )

    return parser().parse_args([
        "serve", "--device", "cpu", "--image-size", str(HW),
        "--num-classes", "5", "--init-features", "8", "--batch-size", "4",
        "--max-wait-ms", "5", *extra])


def _direct(mode, imgs):
    """Labels of the forward of ``mode`` built from the seeded model, called
    directly."""
    from retinal_oct_image_segmentation_via_deep_learning_tpu_torch.cli import (
        build_float_forward,
        build_quantized_forward,
    )

    model = build_model(num_classes=5, init_features=8, seed=0, device="cpu")
    if mode == "off":
        forward = build_float_forward(model, "float32")
    else:
        forward, _ = build_quantized_forward(model, "unet", mode,
                                             image_size=HW, device="cpu")
    with torch.inference_mode():
        return forward(torch.from_numpy(imgs)).numpy()


def _artifact(tmp_path, mode):
    """``infer --save-quantized`` of the seeded model in ``mode``."""
    path = str(tmp_path / f"{mode}.npz")
    main(["infer", "--device", "cpu", "--image-size", str(HW),
          "--num-classes", "5", "--batch-size", "2", "--model-kwargs",
          '{"init_features": 8}', "--quantize", mode, "--out-dir",
          str(tmp_path / "out"), "--save-quantized", path])
    return path


@pytest.mark.parametrize("mode,load", [("off", False), ("int8", False),
                                       ("int8", True), ("psrp", True)],
                         ids=["off", "int8", "int8-artifact",
                              "psrp-artifact"])
def test_cli_serve_modes_answer_with_the_direct_forward(tmp_path, mode,
                                                        load):
    """``serve --quantize off|int8|psrp [--load-quantized]``, built as
    ``cli serve`` builds it, answers HTTP with the labels of the same graph
    called directly (from an artifact: the graph it was saved from)."""
    from retinal_oct_image_segmentation_via_deep_learning_tpu_torch.cli import (
        build_serving,
    )

    extra = ["--quantize", mode]
    if mode == "off":
        extra += ["--dtype", "float32"]
    if load:
        extra += ["--load-quantized", _artifact(tmp_path, mode)]
    loop = build_serving(_serve_args(*extra))
    imgs = np.random.default_rng(1).uniform(0, 255, (5, HW, HW, 1)).astype(
        np.float32)
    direct = _direct(mode, imgs)
    httpd, _ = start_in_background(loop.warmup(), port=0)
    url = f"http://127.0.0.1:{httpd.server_address[1]}"
    try:
        got = [_post(f"{url}/predict", imgs[i]) for i in range(3)]
        got.append(_post(f"{url}/predict", imgs[3:5]))
    finally:
        httpd.shutdown()
        httpd.server_close()
        loop.close()
    for g, w in zip(got, [direct[0], direct[1], direct[2], direct[3:5]]):
        np.testing.assert_array_equal(g, w)
    assert loop.requests_served == 5


def test_cli_serve_refuses_wrong_artifacts(tmp_path):
    art = _artifact(tmp_path, "int8")
    from retinal_oct_image_segmentation_via_deep_learning_tpu_torch.cli import (
        build_serving,
    )

    with pytest.raises(ValueError, match="a int8 artifact"):
        build_serving(_serve_args("--quantize", "psrp", "--load-quantized",
                                  art))
    with pytest.raises(SystemExit, match="needs --quantize"):
        build_serving(_serve_args("--quantize", "off", "--load-quantized",
                                  art))
    with pytest.raises(SystemExit, match="U-Net only"):
        build_serving(_serve_args("--model", "relaynet", "--quantize",
                                  "int8", "--load-quantized", art))
