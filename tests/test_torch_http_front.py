"""qtpu_torch's HTTP front (``serve/http_front.py``) on the CPU, no JAX
(mirrors tests/test_http_front.py): the 413 body cap without buffering and
the drained 413, a bad or negative Content-Length's 400, the unhealthy
engine's 503 on ``/predict`` and ``/healthz`` (also when it dies
mid-request), a client error's 400 with the engine serving on, and
``/metrics`` in Prometheus' text format; the port's ``stats()`` carries
``rounds_per_bucket``, a dict, which ``/stats`` returns as JSON and
``/metrics`` as one labelled line per bucket.  A real engine behind the front: LeNet-5 from
``build_engine`` on the CPU, whose HTTP logits equal ``engine.predict``'s
exactly (the same rows through the same forward)."""
import dataclasses
import http.client
import io
import json
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from qtpu_torch.serve.engine import ServingEngine
from qtpu_torch.serve.http_front import serve_http


class FakeEngine:
    def __init__(self, healthy=True):
        self.healthy = healthy

    def predict(self, arr):
        if not self.healthy:
            raise RuntimeError("engine stopped")
        return np.zeros((arr.shape[0], 10), np.float32)

    def stats(self):
        return {"images": 0, "rounds_per_bucket": {}}


def _serve(engine, **kw):
    server, _ = serve_http(engine, host="127.0.0.1", port=0, block=False,
                           **kw)
    return server, f"http://127.0.0.1:{server.server_address[1]}"


def _post(url, body, timeout=30):
    return urllib.request.urlopen(url + "/predict", body, timeout=timeout)


def _npy(arr):
    buf = io.BytesIO()
    np.save(buf, arr)
    return buf.getvalue()


def test_predict_ok_and_stats():
    server, url = _serve(FakeEngine())
    try:
        r = _post(url, _npy(np.zeros((2, 4, 4, 1), np.float32)))
        assert r.status == 200
        assert np.load(io.BytesIO(r.read())).shape == (2, 10)
        one = _post(url, _npy(np.zeros((4, 4, 1), np.float32)))  # one image
        assert np.load(io.BytesIO(one.read())).shape == (1, 10)
        s = json.loads(urllib.request.urlopen(url + "/stats",
                                              timeout=30).read())
        assert s == {"images": 0.0, "rounds_per_bucket": {}}
    finally:
        server.shutdown()


def test_oversized_body_413_without_buffering():
    server, url = _serve(FakeEngine(), max_body_bytes=1024)
    try:
        req = urllib.request.Request(
            url + "/predict", data=b"x" * 16,
            headers={"Content-Length": str(1 << 30)})
        with pytest.raises(urllib.error.HTTPError) as ei:
            urllib.request.urlopen(req, timeout=30)
        assert ei.value.code == 413
        assert "exceeds" in json.loads(ei.value.read())["error"]
    finally:
        server.shutdown()


def test_oversized_body_drained_clean_413():
    server, url = _serve(FakeEngine(), max_body_bytes=4096)
    try:
        with pytest.raises(urllib.error.HTTPError) as ei:
            _post(url, b"y" * 8192)
        assert ei.value.code == 413
    finally:
        server.shutdown()


def test_body_under_limit_accepted():
    server, url = _serve(FakeEngine(), max_body_bytes=1 << 20)
    try:
        assert _post(url, _npy(np.zeros((1, 8, 8, 1), np.float32))
                     ).status == 200
    finally:
        server.shutdown()


def test_unhealthy_engine_503_on_predict_and_healthz():
    server, url = _serve(FakeEngine(healthy=False))
    try:
        with pytest.raises(urllib.error.HTTPError) as ei:
            _post(url, _npy(np.zeros((1, 4, 4, 1), np.float32)))
        assert ei.value.code == 503
        with pytest.raises(urllib.error.HTTPError) as eh:
            urllib.request.urlopen(url + "/healthz", timeout=30)
        assert eh.value.code == 503
    finally:
        server.shutdown()


def test_engine_dies_mid_request_503():
    class DiesOnPredict(FakeEngine):
        def predict(self, arr):
            self.healthy = False
            raise RuntimeError("scheduler crashed")

    server, url = _serve(DiesOnPredict())
    try:
        with pytest.raises(urllib.error.HTTPError) as ei:
            _post(url, _npy(np.zeros((1, 4, 4, 1), np.float32)))
        assert ei.value.code == 503
    finally:
        server.shutdown()


def test_client_error_still_400():
    server, url = _serve(FakeEngine())
    try:
        with pytest.raises(urllib.error.HTTPError) as ei:
            _post(url, b"not an npy payload")
        assert ei.value.code == 400
    finally:
        server.shutdown()


def test_bad_content_length_header_400():
    server, url = _serve(FakeEngine())
    try:
        conn = http.client.HTTPConnection(url.split("//")[1], timeout=30)
        conn.putrequest("POST", "/predict", skip_accept_encoding=True)
        conn.putheader("Content-Length", "abc")
        conn.endheaders()
        resp = conn.getresponse()
        assert resp.status == 400
        assert "Content-Length" in json.loads(resp.read())["error"]
        conn.close()
    finally:
        server.shutdown()


def test_negative_content_length_400():
    """A negative length is refused at once on a keep-alive connection
    (read as it stands it would wait for the client's EOF)."""
    server, url = _serve(FakeEngine())
    try:
        conn = http.client.HTTPConnection(url.split("//")[1], timeout=30)
        conn.putrequest("POST", "/predict", skip_accept_encoding=True)
        conn.putheader("Content-Length", "-1")
        conn.putheader("Connection", "keep-alive")
        conn.endheaders()
        resp = conn.getresponse()
        assert resp.status == 400
        assert "Content-Length" in json.loads(resp.read())["error"]
        assert resp.getheader("Connection") == "close"
        conn.close()
    finally:
        server.shutdown()


def test_malformed_request_400_engine_survives():
    """A real ``ServingEngine``: a wrong-shape request gets a 400 from its
    submit-time check and the engine serves on; f64 → f32 is accepted."""
    eng = ServingEngine(None, {}, batch_buckets=(4,), max_wait_ms=1.0,
                        forward_fn=lambda _v, x: x.sum(dim=(1, 2)),
                        device="cpu")
    server, url = _serve(eng)
    try:
        good = _npy(np.zeros((2, 4, 4, 1), np.float32))
        assert _post(url, good).status == 200
        with pytest.raises(urllib.error.HTTPError) as ei:
            _post(url, _npy(np.zeros((2, 4, 5, 1), np.float32)))
        assert ei.value.code == 400
        assert "shape" in json.loads(ei.value.read())["error"]
        r = _post(url, _npy(np.zeros((2, 4, 4, 1), np.float64) + 0.5))
        assert r.status == 200
        assert eng.healthy
        assert _post(url, good).status == 200
        s = json.loads(urllib.request.urlopen(url + "/stats",
                                              timeout=30).read())
        assert s["images"] == 6.0 and sum(s["rounds_per_bucket"].values()) \
            == s["batches"] and set(s["rounds_per_bucket"]) == {"4"}
    finally:
        server.shutdown()
        eng.stop()


def test_metrics_prometheus_format():
    eng = FakeEngine()
    eng.stats = lambda: {"images": 42, "p50_ms": 1.5,
                         "rounds_per_bucket": {8: 3, 32: 1}}
    server, base = _serve(eng)
    try:
        r = urllib.request.urlopen(base + "/metrics", timeout=30)
        assert r.headers["Content-Type"].startswith("text/plain")
        body = r.read().decode()
        assert "# TYPE qtpu_serving_images counter" in body
        assert "qtpu_serving_images 42\n" in body
        assert "# TYPE qtpu_serving_p50_ms gauge" in body
        assert "qtpu_serving_p50_ms 1.5\n" in body
        assert "# TYPE qtpu_serving_rounds_per_bucket counter" in body
        assert 'qtpu_serving_rounds_per_bucket{bucket="8"} 3\n' in body
        assert 'qtpu_serving_rounds_per_bucket{bucket="32"} 1\n' in body
        assert "qtpu_serving_healthy 1" in body
        eng.healthy = False
        body = urllib.request.urlopen(base + "/metrics",
                                      timeout=30).read().decode()
        assert "qtpu_serving_healthy 0" in body
    finally:
        server.shutdown()


def test_lenet_engine_behind_the_front():
    from qtpu_torch.examples.configs import CONFIGS
    from qtpu_torch.serve.cli import build_engine

    cfg = dataclasses.replace(CONFIGS["lenet_mnist_int8"], n_train=32,
                              calib_batches=1, batch_size=16)
    eng, info = build_engine(cfg, buckets=(2, 4), max_wait_ms=5.0,
                             device="cpu")
    server, url = _serve(eng)
    try:
        x = np.random.default_rng(3).normal(size=(3, 28, 28, 1)).astype(
            np.float32)
        got = np.load(io.BytesIO(_post(url, _npy(x)).read()))
        np.testing.assert_array_equal(got, eng.predict(x))
        assert got.shape == (3, 10) and info["serve_path"] == "module"
        with torch.inference_mode():
            direct = eng.model(torch.from_numpy(x)).numpy()
        np.testing.assert_array_equal(got, direct)
    finally:
        server.shutdown()
        eng.stop()
