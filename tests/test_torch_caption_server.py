"""The port's caption server
(``python -m simpleimagecaptionzoo_tpu_torch.tools.caption_server``) on
the CPU, driven as tests/test_caption_server.py drives the JAX package's:
real HTTP requests against the server object built through the real
argument path (``build_argparser().parse_args``, ``build_server``), from a
checkpoint written by the JAX package (tests/torch_serving.py: NIC, the
ResNet at (1, 1, 1, 1), float32 trunks), ``--gpu_id cpu``.

Also: every caption equals the port's bundle's caption of the same image
decoded in a full batch; the Batcher's cancelled-future skip, 503 under a
tiny request timeout (the future cancelled and its row skipped), 413 for
an oversized body, and the shutdown that fails what is still queued.
"""
import json
import threading
import urllib.error
import urllib.request
from concurrent.futures import ThreadPoolExecutor
from http.server import ThreadingHTTPServer

import numpy as np
import pytest
import torch

import torch_serving as TSV
from simpleimagecaptionzoo_tpu_torch import inference as TINF
from simpleimagecaptionzoo_tpu_torch.tools import caption_server as CS

MAX_BATCH, SIDE = 4, 224


@pytest.fixture(scope="module", autouse=True)
def shallow():
    with TSV.shallow_f32_trunks():
        yield


@pytest.fixture(scope="module")
def served(tmp_path_factory, shallow):
    """The real server on an ephemeral port from a daemon thread, and the
    layout it serves."""
    torch.set_num_threads(1)
    tmp = tmp_path_factory.mktemp("serve")
    layout = TSV.write_layout(tmp, "NIC")
    args = CS.build_argparser().parse_args(TSV.flags(layout) + [
        "--beam", "-1", "--max_batch", str(MAX_BATCH), "--img_size",
        str(SIDE), "--dtype", "float32", "--port", "0", "--max_wait_ms",
        "30", "--gpu_id", "cpu"])
    with pytest.MonkeyPatch.context() as mp:
        mp.chdir(tmp)
        httpd, batcher = CS.build_server(args)
    assert batcher.warm_s is not None       # warmed on the batcher's thread
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    url = "http://127.0.0.1:%d" % httpd.server_address[1]
    yield url, layout, tmp
    httpd.shutdown()
    batcher.stop()
    thread.join(timeout=10)


def _images(n, seed=40):
    return [TSV.photos(1, side, seed + i)[0]
            for i, side in zip(range(n), (160, 224, 300, 200, 256, 240))]


def _post(url: str, data: bytes) -> dict:
    req = urllib.request.Request(url + "/caption", data=data, method="POST")
    with urllib.request.urlopen(req, timeout=120) as r:
        return json.load(r)


def _stats(url):
    with urllib.request.urlopen(url + "/stats", timeout=30) as r:
        return json.load(r)


def test_healthz(served):
    with urllib.request.urlopen(served[0] + "/healthz", timeout=30) as r:
        health = json.load(r)
    assert health["ok"] is True
    assert health["model_type"] == "NIC"
    assert health["max_batch"] == MAX_BATCH


def test_concurrent_uploads_are_coalesced_and_equal_the_bundle(served):
    """6 concurrent requests against max_batch 4: at least two decode
    batches, every batch padded to 4 rows, and every caption the bundle's
    caption of the same uploaded pixels decoded in a full batch of 4."""
    url, layout, tmp = served
    before = _stats(url)
    jpegs = [TSV.jpeg_bytes(im) for im in _images(6)]
    with ThreadPoolExecutor(max_workers=6) as pool:
        results = list(pool.map(lambda b: _post(url, b), jpegs))
    for out in results:
        assert isinstance(out["caption"], str)
    stats = _stats(url)
    assert stats["requests"] - before["requests"] == 6
    assert stats["batches"] - before["batches"] >= 2
    assert stats["rows_decoded"] == stats["batches"] * MAX_BATCH
    assert "latency_ms_p50" in stats and "latency_ms_p99" in stats

    with pytest.MonkeyPatch.context() as mp:
        mp.chdir(tmp)
        b = TINF.load_inference_bundle(use_scst_model=False, beam=-1,
                                       dtype="float32", device="cpu",
                                       **layout)
    pix = [CS.decode_upload(j, SIDE) for j in jpegs]
    want = []
    for i in range(0, len(pix), MAX_BATCH):
        chunk = pix[i:i + MAX_BATCH]
        chunk = chunk + [chunk[-1]] * (MAX_BATCH - len(chunk))
        ids = b.decode(b.tree["params"], b.tree["model_state"],
                       {"img_tensors": torch.from_numpy(np.stack(chunk))})
        want += [" ".join(b.vocab.decode_ids(r)) for r in ids.numpy()]
    assert [r["caption"] for r in results] == want[:6]
    assert len(set(want)) >= 2, want


def test_load_generator_in_its_own_process(served):
    """scripts/serve_load.py (chip_smoke.py phase 19's clients, outside
    the server's process): 3 threads POST 6 JPEG files and a corrupt one;
    the replies in the input's order, 200 with a caption each and 400 for
    the corrupt file, and the requests counted by /stats."""
    import os
    import subprocess
    import sys
    url, _, tmp = served
    paths = []
    for i, im in enumerate(_images(6, seed=70)):
        paths.append(str(tmp / ("load_%d.jpg" % i)))
        with open(paths[-1], "wb") as f:
            f.write(TSV.jpeg_bytes(im))
    paths.append(str(tmp / "load_corrupt.jpg"))
    with open(paths[-1], "wb") as f:
        f.write(b"not an image at all")
    before = _stats(url)
    script = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "scripts", "serve_load.py")
    res = subprocess.run([sys.executable, script, url + "/caption", "3"],
                         input="\n".join(paths), capture_output=True,
                         text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    out = json.loads(res.stdout)
    codes = [r[0] for r in out["replies"]]
    assert codes == [200] * 6 + [400]
    assert all(isinstance(r[1]["caption"], str) for r in out["replies"][:6])
    assert out["seconds"] > 0
    assert _stats(url)["requests"] - before["requests"] == 6


def test_bad_upload_rejected_not_fatal(served):
    url = served[0]
    req = urllib.request.Request(url + "/caption",
                                 data=b"not an image at all", method="POST")
    with pytest.raises(urllib.error.HTTPError) as e:
        urllib.request.urlopen(req, timeout=30)
    assert e.value.code == 400
    assert "undecodable" in json.load(e.value)["error"]
    # the server still answers real work afterwards
    jpeg = TSV.jpeg_bytes(_images(1, seed=99)[0])
    assert isinstance(_post(url, jpeg)["caption"], str)


def test_unknown_path_404(served):
    with pytest.raises(urllib.error.HTTPError) as e:
        urllib.request.urlopen(served[0] + "/nope", timeout=30)
    assert e.value.code == 404
    req = urllib.request.Request(served[0] + "/nope", data=b"x",
                                 method="POST")
    with pytest.raises(urllib.error.HTTPError) as e:
        urllib.request.urlopen(req, timeout=30)
    assert e.value.code == 404


class _StubVocab:
    def decode_ids(self, row):
        return ["a", "caption"]


def _make_batcher(decode_fn, batch=4, wait_ms=5.0):
    return CS.Batcher(decode_fn, {"params": 0, "model_state": 0},
                      _StubVocab(), batch, 8, wait_ms, device="cpu")


def _img():
    return np.zeros((8, 8, 3), np.uint8)


def _stub_server(batcher, max_body=1 << 20, timeout=60.0):
    httpd = ThreadingHTTPServer(("127.0.0.1", 0), CS.make_handler(
        batcher, 8, {"model_type": "stub"}, max_body, timeout))
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    return httpd, thread, "http://127.0.0.1:%d" % httpd.server_address[1]


def test_batcher_skips_cancelled_requests():
    """A client that timed out cancels its future; the batcher must not
    count it or try to resolve it."""
    def decode(params, state, visual):
        return torch.zeros((4, 5), dtype=torch.long)

    b = _make_batcher(decode)
    live = b.submit(_img())             # enqueue BEFORE the worker starts,
    dead = b.submit(_img())             # so the cancel can't race the drain
    assert dead.cancel()
    b.start()
    assert live.result(timeout=30) == "a caption"
    assert dead.cancelled()
    b.stop()
    assert b.stats["requests"] == 1


def test_request_timeout_answers_503_and_skips_the_row():
    """A request that waits longer than --request_timeout for a decode slot
    gets 503; its future is cancelled, and the batcher leaves its row out
    (requests counts only the answered one)."""
    in_decode, release = threading.Event(), threading.Event()

    def decode(params, state, visual):
        in_decode.set()
        release.wait(timeout=60)
        return torch.zeros((1, 5), dtype=torch.long)

    b = _make_batcher(decode, batch=1).start()
    httpd, thread, url = _stub_server(b, timeout=0.3)
    try:
        first = b.submit(_img())
        assert in_decode.wait(timeout=30)   # the worker holds the only slot
        jpeg = TSV.jpeg_bytes(_images(1)[0])
        req = urllib.request.Request(url + "/caption", data=jpeg,
                                     method="POST")
        with pytest.raises(urllib.error.HTTPError) as e:
            urllib.request.urlopen(req, timeout=30)
        assert e.value.code == 503
        assert "overloaded" in json.load(e.value)["error"]
        release.set()
        assert first.result(timeout=30) == "a caption"
    finally:
        release.set()
        httpd.shutdown()
        thread.join(timeout=10)
        b.stop()
    assert b.stats["requests"] == 1 and b.stats["batches"] == 1


def test_oversized_body_answers_413():
    b = _make_batcher(lambda p, s, v: torch.zeros((4, 5), dtype=torch.long))
    b.start()
    httpd, thread, url = _stub_server(b, max_body=1000)
    try:
        req = urllib.request.Request(url + "/caption", data=b"\0" * 2000,
                                     method="POST")
        with pytest.raises(urllib.error.HTTPError) as e:
            urllib.request.urlopen(req, timeout=30)
        assert e.value.code == 413
        assert "1..1000 bytes" in json.load(e.value)["error"]
    finally:
        httpd.shutdown()
        thread.join(timeout=10)
        b.stop()
    assert b.stats["requests"] == 0


def test_batcher_stop_fails_queued_work_fast_and_rejects_new():
    """stop() resolves (with an error) anything still queued behind the
    wake sentinel instead of leaving clients blocked, and submits after it
    fail at once."""
    in_decode = threading.Event()
    release = threading.Event()

    def decode(params, state, visual):
        in_decode.set()
        release.wait(timeout=60)
        return torch.zeros((1, 5), dtype=torch.long)

    b = _make_batcher(decode, batch=1)
    b.start()
    first = b.submit(_img())
    assert in_decode.wait(timeout=30)   # worker is inside decode
    stuck = b.submit(_img())            # queued; worker will exit before it
    stopper = threading.Thread(target=b.stop)
    stopper.start()                     # sets _stop, then joins the worker
    release.set()
    stopper.join(timeout=30)
    assert not stopper.is_alive()
    assert first.result(timeout=5) == "a caption"
    with pytest.raises(RuntimeError, match="shutting down"):
        stuck.result(timeout=5)
    with pytest.raises(RuntimeError, match="shutting down"):
        b.submit(_img()).result(timeout=5)


def test_warm_decode_runs_on_the_batcher_thread_before_traffic():
    """start() returns after the warm batch decoded on the batcher's own
    thread (where the kernels' per-thread TMA map caches live), and that
    batch is not counted; a warm decode that raises makes start() raise."""
    seen = []

    def decode(params, state, visual):
        seen.append((threading.current_thread().name,
                     tuple(visual["img_tensors"].shape)))
        return torch.zeros((4, 5), dtype=torch.long)

    b = CS.Batcher(decode, {"params": 0, "model_state": 0}, _StubVocab(), 4,
                   8, 5.0, device="cpu", warm=np.zeros((4, 8, 8, 3),
                                                       np.uint8)).start()
    assert seen == [("caption-batcher", (4, 8, 8, 3))]
    assert b.warm_s is not None and b.stats["batches"] == 0
    b.stop()

    def broken(params, state, visual):
        raise RuntimeError("kernel build failed")

    with pytest.raises(RuntimeError, match="kernel build failed"):
        CS.Batcher(broken, {"params": 0, "model_state": 0}, _StubVocab(), 4,
                   8, 5.0, device="cpu",
                   warm=np.zeros((4, 8, 8, 3), np.uint8)).start()


def test_a_decode_that_raises_answers_500():
    """No fallback: a decode that raises answers its requests 500."""
    def decode(params, state, visual):
        raise RuntimeError("launch failed")

    b = _make_batcher(decode).start()
    httpd, thread, url = _stub_server(b)
    try:
        req = urllib.request.Request(
            url + "/caption", data=TSV.jpeg_bytes(_images(1)[0]),
            method="POST")
        with pytest.raises(urllib.error.HTTPError) as e:
            urllib.request.urlopen(req, timeout=30)
        assert e.value.code == 500
        assert "launch failed" in json.load(e.value)["error"]
    finally:
        httpd.shutdown()
        thread.join(timeout=10)
        b.stop()


def test_server_defaults_to_the_gpu(served):
    """Without ``--gpu_id`` the server decodes on cuda:0, and its build
    raises without a card."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    _, layout, tmp = served
    args = CS.build_argparser().parse_args(TSV.flags(layout) + ["--port",
                                                               "0"])
    assert args.gpu_id == "0"
    with pytest.MonkeyPatch.context() as mp:
        mp.chdir(tmp)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            CS.build_server(args)
