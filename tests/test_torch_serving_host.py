"""The port's online serving host (``peekvit_torch/serving_host.py``) on the
CPU: JAX's cases (tests/test_serving_host.py) on the port's bundles.
Concurrent requests coalesce into engine-sized batches, different budgets
never share a batch, results route back to the right caller bitwise, the
HTTP front end round-trips npy bodies. Then one JAX MicroBatcher and one
port MicroBatcher, on the same weights and the same four submits, report
the same batching counters and replies within 2e-4.
"""

import io
import json
import threading
import time
import urllib.error
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from peekvit_torch import InferenceEngine, build_model
from peekvit_torch.models.adapters import params_from_jax
from peekvit_torch.serving import load_serving_bundle, save_bucketed_bundle, save_serving_bundle
from peekvit_torch.serving_host import MicroBatcher, _main, build_server

VIT = dict(image_size=32, patch_size=8, num_layers=2, num_heads=4, hidden_dim=64, mlp_dim=128,
           num_classes=7)
PAD_ATOL = 5e-6  # padded geometry: inert up to the GEMM's batch-shape blocking
FP32 = torch.float32


@pytest.fixture(autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _engine(kind="vit", seed=3, extra=None, **kw):
    model = build_model(kind, dict(VIT, **(extra or {})), seed=seed, device="cpu")
    gen = torch.Generator().manual_seed(seed + 100)
    with torch.no_grad():
        for p in model.parameters():
            p.add_(0.05 * torch.randn(p.shape, generator=gen))
    return InferenceEngine(model, compute_dtype=FP32, device="cpu", **kw)


def _x(b=1, seed=0):
    return np.asarray(np.random.default_rng(seed).normal(size=(b, 32, 32, 3)), np.float32)


def _want(engine, x, budget=None):
    return (engine(x) if budget is None else engine(x, budget=budget)).numpy()


def _load(path):
    return load_serving_bundle(path, device="cpu")


@pytest.fixture(scope="module")
def plain_bundle(tmp_path_factory):
    eng = _engine()
    path = str(tmp_path_factory.mktemp("host") / "plain")
    save_bucketed_bundle(eng, path, _x(4), batch_sizes=(1, 2, 4))
    return path, eng


def test_microbatcher_coalesces_and_routes(plain_bundle):
    """4 concurrent single-image submits -> ONE engine batch; each caller
    gets exactly its own rows, bitwise-equal to a direct engine call."""
    path, eng = plain_bundle
    mb = MicroBatcher(_load(path), max_delay_ms=200.0)
    try:
        xs = [_x(seed=i) for i in range(4)]
        futs = [mb.submit(x[0]) for x in xs]  # item-shaped also accepted
        outs = [f.result(timeout=60) for f in futs]
        want = _want(eng, np.concatenate(xs))
        for i, out in enumerate(outs):
            assert isinstance(out, np.ndarray) and out.shape == (1, 7)
            np.testing.assert_array_equal(out, want[i:i + 1])
        assert mb.stats["batches"] == 1  # coalesced, not 4 dispatches
        assert mb.stats["requests"] == 4
    finally:
        mb.close()


def test_microbatcher_pads_partial_batches(plain_bundle):
    """3 items at buckets (1, 2, 4): one padded batch of 4, one pad row."""
    path, eng = plain_bundle
    mb = MicroBatcher(_load(path), max_delay_ms=150.0)
    try:
        x = _x(b=3, seed=9)
        out = mb.predict(x, timeout=60)
        np.testing.assert_allclose(out, _want(eng, x), rtol=0, atol=PAD_ATOL)
        assert mb.stats["padded_rows"] == 1
    finally:
        mb.close()


def test_microbatcher_plain_single_geometry_bundle(tmp_path):
    """A plain (non-bucketed) bundle batches too: the batcher pads to its
    one saved geometry."""
    eng = _engine(seed=5)
    path = save_serving_bundle(eng, str(tmp_path / "one"), _x(4))
    mb = MicroBatcher(_load(path), max_delay_ms=50.0)
    try:
        x = _x(seed=2)
        np.testing.assert_allclose(mb.predict(x, timeout=60), _want(eng, x), rtol=0,
                                   atol=PAD_ATOL)
        assert mb.stats["padded_rows"] == 3
    finally:
        mb.close()


def test_microbatcher_budget_grouping(tmp_path):
    """Requests with different budgets never share a batch (the budget is a
    whole-batch operand); each group matches the engine at its budget."""
    eng = _engine("rankvit", 7, dict(rankvit_layers=[1]), max_budget=0.75)
    path = save_bucketed_bundle(eng, str(tmp_path / "rk"), _x(2), batch_sizes=(2, 4))
    mb = MicroBatcher(_load(path), max_delay_ms=150.0)
    try:
        xa, xb = _x(b=2, seed=1), _x(b=2, seed=2)
        fa = mb.submit(xa, budget=0.5)
        fb = mb.submit(xb, budget=0.25)
        np.testing.assert_array_equal(fa.result(60), _want(eng, xa, 0.5))
        np.testing.assert_array_equal(fb.result(60), _want(eng, xb, 0.25))
        assert mb.stats["batches"] == 2
    finally:
        mb.close()


def test_microbatcher_coupled_bundle_no_padding(tmp_path):
    """batch_coupled bundles dispatch requests exactly as submitted: exact
    bucket sizes pass, everything else is rejected at submit."""
    eng = _engine("residualvit", 11, dict(residual_layers=["attention+mlp"] * 2,
                                          gate_type="sigmoid", add_budget_token=True))
    path = save_bucketed_bundle(eng, str(tmp_path / "cp"), _x(2), batch_sizes=(2,))
    mb = MicroBatcher(_load(path), max_delay_ms=10.0)
    try:
        x = _x(b=2, seed=3)
        np.testing.assert_array_equal(mb.predict(x, budget=0.5, timeout=60),
                                      _want(eng, x, 0.5))
        with pytest.raises(ValueError, match="batch-coupled"):
            mb.submit(_x(seed=4), budget=0.5)
    finally:
        mb.close()


def test_microbatcher_rejects_bad_requests(plain_bundle):
    path, _ = plain_bundle
    mb = MicroBatcher(_load(path), max_delay_ms=1.0)
    try:
        with pytest.raises(ValueError, match="expected items"):
            mb.submit(np.zeros((16, 16, 3), np.float32))
        with pytest.raises(ValueError, match="split larger"):
            mb.submit(_x(b=5))
        with pytest.raises(ValueError, match="1\\.\\."):
            mb.submit(_x(b=4)[:0])
    finally:
        mb.close()
    with pytest.raises(RuntimeError, match="closed"):
        mb.submit(_x())


def test_microbatcher_overload_cap_and_shedding(plain_bundle):
    """Backpressure: submits beyond max_queue_items raise (HTTP 503), and a
    cancelled Future (the caller timed out) is shed before dispatch."""
    path, _ = plain_bundle
    mb = MicroBatcher(_load(path), max_delay_ms=300.0, max_queue_items=2)
    try:
        f1 = mb.submit(_x(seed=0))
        f2 = mb.submit(_x(seed=1))
        with pytest.raises(RuntimeError, match="overloaded"):
            mb.submit(_x(seed=2))
        assert mb.stats["rejected"] == 1
        assert f2.cancel()  # pending entry: the caller gives up
        assert f1.result(timeout=60).shape == (1, 7)
        deadline = time.monotonic() + 30
        while mb.stats["shed"] < 1 and time.monotonic() < deadline:
            time.sleep(0.01)
        assert mb.stats["shed"] == 1 and f2.cancelled()
    finally:
        mb.close()


def _http(url, data=None, headers=None, method=None):
    req = urllib.request.Request(url, data=data, headers=headers or {}, method=method)
    try:
        with urllib.request.urlopen(req, timeout=120) as resp:
            return resp.status, resp.headers.get("Content-Type"), resp.read()
    except urllib.error.HTTPError as e:
        return e.code, e.headers.get("Content-Type"), e.read()


def _npy(x):
    buf = io.BytesIO()
    np.save(buf, x)
    return buf.getvalue()


def test_http_server_end_to_end(plain_bundle):
    """POST /predict round-trips npy bodies through the batcher; /healthz
    and /stats report; bad input answers 400 without killing the host."""
    path, eng = plain_bundle
    mb = MicroBatcher(_load(path), max_delay_ms=2.0)
    httpd = build_server(mb, port=0)
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    base = f"http://127.0.0.1:{httpd.server_port}"
    try:
        status, _, body = _http(f"{base}/healthz")
        assert status == 200 and json.loads(body)["ok"] is True
        x = _x(b=2, seed=8)
        status, ctype, body = _http(f"{base}/predict", data=_npy(x), method="POST")
        assert status == 200 and ctype == "application/x-npy"
        np.testing.assert_array_equal(np.load(io.BytesIO(body)), _want(eng, x))
        status, _, body = _http(f"{base}/predict", data=_npy(np.zeros((2, 3), np.float32)),
                                method="POST")
        assert status == 400 and "expected items" in json.loads(body)["error"]
        status, _, body = _http(f"{base}/stats")
        stats = json.loads(body)
        assert status == 200 and stats["requests"] >= 1 and stats["buckets"] == [1, 2, 4]
        assert _http(f"{base}/nope")[0] == 404
    finally:
        httpd.shutdown()
        httpd.server_close()
        mb.close()


def test_http_budget_header_and_tuple_replies(tmp_path):
    """X-Budget reaches the bundle (over the cap: a clean 400); a tuple
    bundle answers .npz with out_0.. keys."""
    eng = _engine("rankvit", 7, dict(rankvit_layers=[1]), max_budget=0.75)
    ee = _engine("eeresidualvit", 19, dict(residual_layers=["attention+mlp"] * 2,
                                           gate_type="sigmoid", add_budget_token="learnable"),
                 ee_outputs=True)
    x = _x(b=2, seed=5)
    servers = []
    try:
        for name, e in (("rk", eng), ("ee", ee)):
            mb = MicroBatcher(_load(save_serving_bundle(e, str(tmp_path / name), _x(2))),
                              max_delay_ms=2.0)
            httpd = build_server(mb, port=0)
            threading.Thread(target=httpd.serve_forever, daemon=True).start()
            servers.append((httpd, mb))
        base = f"http://127.0.0.1:{servers[0][0].server_port}"
        status, _, body = _http(f"{base}/predict", data=_npy(x), headers={"X-Budget": "0.5"},
                                method="POST")
        assert status == 200
        np.testing.assert_array_equal(np.load(io.BytesIO(body)), _want(eng, x, 0.5))
        status, _, body = _http(f"{base}/predict", data=_npy(x), headers={"X-Budget": "0.9"},
                                method="POST")
        assert status == 400 and "max_budget" in json.loads(body)["error"]
        status, ctype, body = _http(f"http://127.0.0.1:{servers[1][0].server_port}/predict",
                                    data=_npy(x), headers={"X-Budget": "0.5"}, method="POST")
        assert status == 200 and ctype == "application/x-npz"
        got = np.load(io.BytesIO(body))
        want = ee(x, budget=0.5)
        assert sorted(got.files) == [f"out_{i}" for i in range(len(want))]
        for i, w in enumerate(want):
            np.testing.assert_array_equal(got[f"out_{i}"], w.numpy())
    finally:
        for httpd, mb in servers:
            httpd.shutdown()
            httpd.server_close()
            mb.close()


def test_microbatcher_fetch_pipeline_and_breakdown(plain_bundle):
    """Pipelined result fetches (the completer pool) deliver the same
    results as the serial dispatcher, and the per-dispatch cost breakdown
    counters accumulate."""
    path, _ = plain_bundle
    xs = [_x(seed=50 + i) for i in range(6)]
    results = {}
    for fetches in (0, 3):
        mb = MicroBatcher(_load(path), max_delay_ms=20.0, pipeline_fetches=fetches)
        try:
            futs = [mb.submit(x) for x in xs]
            results[fetches] = [f.result(timeout=60) for f in futs]
            stats = dict(mb.stats)
        finally:
            mb.close()
        assert stats["batches"] >= 1 and stats["t_dispatch_ms"] > 0.0
        assert stats["t_fetch_ms"] >= 0.0 and stats["t_deliver_ms"] >= 0.0
    for a, b in zip(results[0], results[3]):
        np.testing.assert_array_equal(a, b)


def test_microbatcher_pipelined_close_flushes(plain_bundle):
    """close() joins the completer pool: every submitted Future resolves
    even when close races the in-flight fetches."""
    path, _ = plain_bundle
    mb = MicroBatcher(_load(path), max_delay_ms=1.0, pipeline_fetches=2)
    futs = [mb.submit(_x(seed=70 + i)) for i in range(8)]
    mb.close()
    for f in futs:
        assert f.result(timeout=5) is not None


def test_host_cli_defaults_to_the_card(plain_bundle, monkeypatch):
    """python -m peekvit_torch.serving_host BUNDLE: --device defaults to the
    card, which it needs unless the CPU is asked for."""
    path, _ = plain_bundle
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        _main([path, "--port", "0"])


def test_microbatcher_counters_held_against_jax(tmp_path):
    """One JAX MicroBatcher and one port MicroBatcher over bundles of the
    same weights (fp32; JAX's at interpret=True), each given the same four
    submits at max_delay_ms=200: the same requests / items / batches /
    padded_rows, and replies within 2e-4."""
    from peekvit_tpu.inference import InferenceEngine as JaxEngine
    from peekvit_tpu.models.registry import build_model as jax_build_model
    from peekvit_tpu import serving as jserving
    from peekvit_tpu import serving_host as jhost

    jm = jax_build_model("vit", VIT, seed=3)
    tree = jax.tree.map(lambda a: np.array(a, np.float32), jm.params)
    tree["head"]["kernel"][:] = np.random.default_rng(9).normal(
        0, 0.05, tree["head"]["kernel"].shape)
    jm.params = jax.tree.map(jnp.asarray, tree)
    tm = params_from_jax(build_model("vit", VIT, device="cpu"), tree)
    sample = _x(8, seed=1)
    jpath = jserving.save_serving_bundle(
        JaxEngine(jm, compute_dtype=jnp.float32, interpret=True), str(tmp_path / "jax"), sample)
    tpath = save_serving_bundle(InferenceEngine(tm, compute_dtype=FP32, device="cpu"),
                                str(tmp_path / "port"), sample)
    requests = [_x(seed=80), _x(b=2, seed=81), _x(seed=82)[0], _x(seed=83)]
    counters = ("requests", "items", "batches", "padded_rows")
    got = {}
    for name, batcher in (("jax", jhost.MicroBatcher(jserving.load_serving_bundle(jpath),
                                                     max_delay_ms=200.0)),
                          ("port", MicroBatcher(_load(tpath), max_delay_ms=200.0))):
        try:
            futs = [batcher.submit(r) for r in requests]
            got[name] = ([np.asarray(f.result(timeout=120)) for f in futs],
                         {k: batcher.stats[k] for k in counters})
        finally:
            batcher.close()
    assert got["port"][1] == got["jax"][1] == {"requests": 4, "items": 5, "batches": 1,
                                               "padded_rows": 3}
    for t, j in zip(got["port"][0], got["jax"][0]):
        assert t.shape == j.shape
        np.testing.assert_allclose(t, j, rtol=2e-4, atol=2e-4)
