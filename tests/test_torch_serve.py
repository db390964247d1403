"""The port's inference server and client on a tiny CPU model over a
temporary Unix socket: three requests round-trip (one of them a wrong
channel count answered with MPER), and each served volume equals the
direct call."""

import os
import tempfile
import threading

import numpy as np
import pytest
import torch

from mpgan_torch import serve
from mpgan_torch.models import generator as TG


@pytest.fixture
def sock_path():
    with tempfile.TemporaryDirectory() as d:  # AF_UNIX paths are short
        yield os.path.join(d, "m.sock")


def _tiny_chain(seed=0):
    torch.manual_seed(seed)
    g1 = TG.make_pass1(2, 8, 1).eval()
    g2 = TG.make_pass2(2, 8, 1).eval()
    return g1, g2, None


def test_server_round_trips_three_requests(sock_path):
    upscale = serve.make_upscaler(_tiny_chain(), "cpu", up_res=4)
    server = serve.InferenceServer(upscale, sock_path, expect_channels=4)
    server.warm((2, 4, 4, 4))
    th = threading.Thread(target=server.serve_forever, daemon=True)
    th.start()
    rng = np.random.default_rng(0)
    vols = [rng.random((3, 4, 4, 4), dtype=np.float32),
            rng.random((4, 6, 5, 4), dtype=np.float32)]
    try:
        with serve.Client(sock_path, timeout=60) as c:
            for lr in vols:
                hr = c.upscale(lr)
                direct = serve._to_host(upscale(lr))
                assert hr.shape == (4 * lr.shape[0], 4 * lr.shape[1],
                                    4 * lr.shape[2], 1)
                np.testing.assert_array_equal(hr, direct)
            with pytest.raises(RuntimeError, match="expected 4 channels"):
                c.upscale(np.zeros((2, 4, 4, 3), np.float32))
            # the connection survives an MPER and keeps serving
            np.testing.assert_array_equal(
                c.upscale(vols[0]), serve._to_host(upscale(vols[0])))
            c.shutdown_server()
    finally:
        th.join(timeout=30)
    assert not th.is_alive()
    assert not os.path.exists(sock_path)


def test_make_upscaler_returns_device_tensor_without_grad():
    upscale = serve.make_upscaler(_tiny_chain(), "cpu", up_res=4)
    out = upscale(np.zeros((2, 4, 4, 4), np.float32))
    assert isinstance(out, torch.Tensor) and not out.requires_grad
    assert out.shape == (8, 16, 16, 1) and out.dtype == torch.float32


def test_main_serves_bundled_pair_on_cpu(sock_path):
    """``python -m mpgan_torch.serve`` end to end: load the bundled .npz
    pair, warm, answer a request, shut down on MPQT."""
    from mpgan_torch import config
    from mpgan_torch.infer import load

    argv = ["weights1", load.bundled_weights("g1_l1_4x"),
            "weights2", load.bundled_weights("g2_l1_4x"), "upRes", "4",
            "dtype", "float32", "device", "cpu", "sock", sock_path,
            "warmShape", "2,3,3"]
    th = threading.Thread(target=serve.main, args=(argv,), daemon=True)
    th.start()
    lr = np.random.default_rng(2).random((2, 3, 3, 4), dtype=np.float32)
    cfg = config.Config()
    cfg.model.dtype = "float32"
    chain = (load.load_generator_npz(load.bundled_weights("g1_l1_4x"), 1,
                                     cfg, "cpu"),
             load.load_generator_npz(load.bundled_weights("g2_l1_4x"), 2,
                                     cfg, "cpu"), None)
    direct = serve._to_host(serve.make_upscaler(chain, "cpu")(lr))
    try:
        for _ in range(600):  # the socket appears once warm-up is done
            if os.path.exists(sock_path) and th.is_alive():
                try:
                    c = serve.Client(sock_path, timeout=60)
                    break
                except (ConnectionRefusedError, FileNotFoundError):
                    pass
            th.join(timeout=0.05)
        else:
            pytest.fail("server did not come up")
        with c:
            np.testing.assert_array_equal(c.upscale(lr), direct)
            c.shutdown_server()
    finally:
        th.join(timeout=30)
    assert not th.is_alive()


def test_main_rejects_typo_and_missing_weights(sock_path):
    with pytest.raises(SystemExit):
        serve.main(["sock", sock_path, "upRez", "4"])
    with pytest.raises(SystemExit, match="weights1"):
        serve.main(["sock", sock_path])
