"""The port's HTTP server (``vae_tagger_tpu_torch/serve``) on the CPU: the
same JPEG bytes to the port's server and the JAX package's give the same
tags (tiny engines of both packages at 64px, loaded from the same files),
and the worker and handler semantics of tests/test_serve.py: coalescing,
backpressure, cross-shape FIFO, timeout withdrawal, stop, one batch in
flight, 413, 400, several resolutions, yuv420, odd yuv resolutions, and
``python -m vae_tagger_tpu_torch.serve --device cpu``.
"""

import concurrent.futures
import functools
import io
import json
import os
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from vae_tagger_tpu.core.config import default_flux_vae_config
from vae_tagger_tpu.infer import TaggerEngine as JaxEngine
from vae_tagger_tpu.io import save_decoder_bin, save_vae_pretrained
from vae_tagger_tpu.models.autoencoder_kl import AutoencoderKL as JaxVAE
from vae_tagger_tpu.models.taggers import AttentionClassificationDecoder
from vae_tagger_tpu.serve import TaggerServer as JaxServer
from vae_tagger_tpu_torch.data.bucketing import decode_bytes_square
from vae_tagger_tpu_torch.infer import TaggerEngine
from vae_tagger_tpu_torch.serve import (
    BatchingWorker,
    QueueFullError,
    TaggerServer,
)
from vae_tagger_tpu_torch.serve.__main__ import build_parser, build_server

RES, TAGS = 64, 12
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _noisy(tree, seed):
    rng = np.random.default_rng(seed)
    leaves, treedef = jax.tree_util.tree_flatten(jax.device_get(tree))
    return jax.tree_util.tree_unflatten(treedef, [
        np.asarray(a, np.float32)
        + (rng.normal(size=np.shape(a)) * 0.05).astype(np.float32)
        for a in leaves])


@functools.lru_cache(maxsize=None)
def _artifacts(root):
    """A tiny VAE and an attention head written by the JAX package."""
    cfg = default_flux_vae_config(block_out_channels=(8, 16, 16, 16),
                                  norm_num_groups=4, latent_channels=16,
                                  sample_size=RES)
    vae = JaxVAE(cfg)
    params = jax.jit(vae.init)({"params": jax.random.key(0)},
                               jnp.zeros((1, RES, RES, 3)),
                               jax.random.key(1))["params"]
    save_vae_pretrained(_noisy(params, 1), cfg, f"{root}/vae")
    head = AttentionClassificationDecoder(latent_channels=16,
                                          num_classes=TAGS)
    variables = jax.jit(head.init, static_argnames=("deterministic",))(
        {"params": jax.random.key(2)}, jnp.zeros((1, 8, 8, 16)),
        deterministic=True)
    rng = np.random.default_rng(3)
    stats = {"feature_compress_1": {
        "mean": (rng.normal(size=(8,)) * 0.1).astype(np.float32),
        "var": rng.uniform(0.5, 1.5, size=(8,)).astype(np.float32)}}
    save_decoder_bin(_noisy(variables["params"], 4), stats,
                     f"{root}/decoder.bin")
    with open(f"{root}/tags.csv", "w") as f:
        f.write("name,count\n")
        f.writelines(f"tag_{i},{i}\n" for i in range(TAGS))
    return dict(vae_checkpoint=f"{root}/vae/"
                "diffusion_pytorch_model.safetensors",
                vae_config_path=f"{root}/vae/config.json",
                decoder_checkpoint=f"{root}/decoder.bin",
                tags_csv_path=f"{root}/tags.csv")


@pytest.fixture(scope="module")
def art(tmp_path_factory):
    return _artifacts(str(tmp_path_factory.mktemp("torch_serve")))


@pytest.fixture(scope="module")
def engine(art):
    return TaggerEngine.load(device="cpu", **art)


def _jpeg_bytes(seed=0, hw=(96, 80)):
    """A smooth photo-like JPEG (q90)."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:hw[0], 0:hw[1]].astype(np.float32)
    ph = rng.uniform(0, 6.28, size=3)
    img = np.stack([128 + 90 * np.sin(xx / 11.0 + ph[c]) * np.cos(yy / 7.0)
                    for c in range(3)], -1) + rng.normal(0, 4, (*hw, 3))
    buf = io.BytesIO()
    Image.fromarray(np.clip(img, 0, 255).astype(np.uint8)).save(
        buf, "JPEG", quality=90)
    return buf.getvalue()


def _post(base, data, query="", headers=None, timeout=120):
    req = urllib.request.Request(f"{base}/classify{query}", data=data,
                                 method="POST", headers=headers or {})
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return json.load(r)


def _get(base, path):
    with urllib.request.urlopen(f"{base}{path}", timeout=30) as r:
        return json.load(r)


def test_http_responses_match_the_jax_server(art, engine):
    """The same JPEG bytes to both servers: the same tags in the same
    order, confidences one 4-decimal rounding apart at most; the raw
    probabilities through both workers within 1e-5."""
    jax_engine = JaxEngine.load(**art)
    blobs = [_jpeg_bytes(i) for i in range(3)]
    with TaggerServer(engine, resolution=RES, threshold=0.0, port=0,
                      max_batch=4, batch_timeout_ms=5) as ours, \
            JaxServer(jax_engine, resolution=RES, threshold=0.0, port=0,
                      max_batch=4, batch_timeout_ms=5,
                      warmup=False) as theirs:
        for data in blobs:
            got = _post(f"http://127.0.0.1:{ours.port}", data)
            want = _post(f"http://127.0.0.1:{theirs.port}", data)
            assert set(got) == set(want)
            assert got["total_tags_above_threshold"] == TAGS
            a = {t["tag"]: t["confidence"] for t in got["predicted_tags"]}
            b = {t["tag"]: t["confidence"] for t in want["predicted_tags"]}
            assert a.keys() == b.keys()
            assert max(abs(a[k] - b[k]) for k in a) <= 1e-4 + 1e-9
        px = [decode_bytes_square(d, RES) for d in blobs]
        got = [ours.worker.submit(p) for p in px]
        want = [theirs.worker.submit(p) for p in px]
    np.testing.assert_allclose(np.stack(got), np.stack(want), rtol=0,
                               atol=1e-5)


def test_http_classify_schema_and_health(engine):
    with TaggerServer(engine, resolution=RES, threshold=0.0, port=0,
                      max_batch=4, batch_timeout_ms=5) as server:
        base = f"http://127.0.0.1:{server.port}"
        health = _get(base, "/healthz")
        assert health == {"status": "ok", "num_tags": TAGS,
                          "resolution": RES, "resolutions": [RES]}
        assert _get(base, "/tags")["tags"] == engine.tag_names
        out = _post(base, _jpeg_bytes())
        assert set(out) == {"predicted_tags", "total_tags_above_threshold",
                            "max_confidence", "avg_confidence_top5"}
        confs = [t["confidence"] for t in out["predicted_tags"]]
        assert confs == sorted(confs, reverse=True)
        timed = _post(base, _jpeg_bytes(), headers={"X-Timing": "1"})
        assert set(timed["timing_ms"]) == {"queue_wait_ms",
                                           "device_pipeline_ms"}
        assert timed["timing_ms"]["device_pipeline_ms"] > 0
        with pytest.raises(urllib.error.HTTPError) as ei:
            urllib.request.urlopen(f"{base}/nope", timeout=30)
        assert ei.value.code == 404


def test_worker_coalesces_and_matches_direct(engine):
    """Concurrent requests coalesce into fewer batches than requests, and
    each response equals the engine's classify of its pixels."""
    worker = BatchingWorker(engine, max_batch=4, batch_timeout_ms=200)
    try:
        px = [np.random.default_rng(i).integers(
            0, 255, (RES, RES, 3), dtype=np.uint8) for i in range(4)]
        with concurrent.futures.ThreadPoolExecutor(4) as ex:
            probs = list(ex.map(worker.submit, px))
        direct = engine.classify(np.stack(px))
        np.testing.assert_allclose(np.stack(probs), direct, rtol=0,
                                   atol=1e-5)
        sizes = worker.batch_sizes
        assert sum(k * n for k, n in sizes.items()) == 4
        assert sum(sizes.values()) < 4
    finally:
        worker.stop()


class _StallingEngine:
    """classify_async blocks until released; records the batch shapes."""

    def __init__(self, num_tags=4):
        self.tag_names = [f"t{i}" for i in range(num_tags)]
        self.release = threading.Event()
        self.entered = threading.Event()
        self.shapes = []

    def classify_async(self, pixels):
        self.shapes.append(pixels.shape[1:3])
        self.entered.set()
        self.release.wait(timeout=60)
        return torch.zeros(pixels.shape[0], len(self.tag_names)), \
            pixels.shape[0]


def test_worker_backpressure_queue_full():
    eng = _StallingEngine()
    worker = BatchingWorker(eng, max_batch=1, batch_timeout_ms=1,
                            max_queue=2)
    try:
        px = np.zeros((8, 8, 3), np.uint8)
        with concurrent.futures.ThreadPoolExecutor(4) as ex:
            futs = [ex.submit(worker.submit, px)]
            assert eng.entered.wait(timeout=30)
            futs += [ex.submit(worker.submit, px) for _ in range(2)]
            time.sleep(0.3)
            with pytest.raises(QueueFullError):
                worker.submit(px)
            eng.release.set()
            for f in futs:
                assert f.result(timeout=60).shape == (4,)
    finally:
        worker.stop()


def test_worker_cross_shape_fifo_no_starvation():
    eng = _StallingEngine()
    worker = BatchingWorker(eng, max_batch=2, batch_timeout_ms=1,
                            max_queue=16)
    try:
        a = np.zeros((8, 8, 3), np.uint8)
        b = np.zeros((16, 16, 3), np.uint8)
        with concurrent.futures.ThreadPoolExecutor(8) as ex:
            f0 = ex.submit(worker.submit, a)
            assert eng.entered.wait(timeout=30)
            fb = ex.submit(worker.submit, b)
            time.sleep(0.1)
            fas = [ex.submit(worker.submit, a) for _ in range(4)]
            time.sleep(0.3)
            eng.release.set()
            for f in [f0, fb] + fas:
                assert f.result(timeout=60).shape == (4,)
        assert eng.shapes[1] == (16, 16)
    finally:
        worker.stop()


def test_worker_timeout_withdraws_and_stop_fails_pending_fast():
    eng = _StallingEngine()
    worker = BatchingWorker(eng, max_batch=1, batch_timeout_ms=1,
                            max_queue=2, request_timeout_s=600)
    worker._join_timeout = 0.5
    px = np.zeros((8, 8, 3), np.uint8)
    with concurrent.futures.ThreadPoolExecutor(4) as ex:
        f0 = ex.submit(worker.submit, px)
        assert eng.entered.wait(timeout=30)
        f1 = ex.submit(worker.submit, px)
        time.sleep(0.2)
        with pytest.raises(TimeoutError):
            worker.submit(px, timeout=0.3)
        with worker._cond:
            assert worker._size == 1  # the abandoned request left
        f2 = ex.submit(worker.submit, px)  # no QueueFullError
        time.sleep(0.2)
        t0 = time.monotonic()
        worker.stop()
        for f in (f1, f2):
            with pytest.raises(RuntimeError):
                f.result(timeout=10)
        assert time.monotonic() - t0 < 10
        eng.release.set()
        assert f0.result(timeout=60).shape == (4,)


class _LazyProbs:
    """A dispatched batch whose fetch blocks until released."""

    def __init__(self, n, release):
        self.n, self.release = n, release

    def __array__(self, dtype=None, copy=None):
        self.release.wait(timeout=60)
        return np.zeros((self.n, 2), np.float32)


class _PipelineProbeEngine:
    tag_names = ["a", "b"]

    def __init__(self):
        self.dispatches = 0
        self.second_queued = threading.Event()
        self.fetch_release = threading.Event()

    def classify_async(self, pixels):
        self.dispatches += 1
        if self.dispatches == 1:
            self.second_queued.wait(timeout=60)
        return _LazyProbs(pixels.shape[0], self.fetch_release), \
            pixels.shape[0]


def test_worker_keeps_one_batch_in_flight():
    """Batch 2 is dispatched while batch 1's fetch still blocks."""
    eng = _PipelineProbeEngine()
    worker = BatchingWorker(eng, max_batch=1, batch_timeout_ms=0,
                            request_timeout_s=30)
    px = np.zeros((8, 8, 3), np.uint8)
    try:
        with concurrent.futures.ThreadPoolExecutor(2) as ex:
            f1 = ex.submit(worker.submit, px)
            deadline = time.monotonic() + 5
            while eng.dispatches < 1 and time.monotonic() < deadline:
                time.sleep(0.01)
            f2 = ex.submit(worker.submit, px)
            time.sleep(0.1)
            eng.second_queued.set()
            deadline = time.monotonic() + 5
            while eng.dispatches < 2 and time.monotonic() < deadline:
                time.sleep(0.01)
            assert eng.dispatches == 2
            assert not f1.done() and not f2.done()
            eng.fetch_release.set()
            assert f1.result(timeout=10).shape == (2,)
            assert f2.result(timeout=10).shape == (2,)
    finally:
        eng.fetch_release.set()
        worker.stop()


@pytest.mark.parametrize("case", ["413", "bad_image", "bad_resolution",
                                  "unserved_resolution"])
def test_http_rejections(engine, case):
    """413 before the body is read (8 MB drained, the JSON still arrives),
    400 for undecodable bytes and for a bad or unserved resolution with a
    large body."""
    data = {"413": b"x" * (8 << 20), "bad_image": b"not an image"}.get(
        case, b"x" * (8 << 20))
    query = {"bad_resolution": "?resolution=abc",
             "unserved_resolution": "?resolution=999"}.get(case, "")
    with TaggerServer(engine, resolution=RES, port=0, warmup=False,
                      max_body_bytes=1024 if case == "413"
                      else 32 << 20) as server:
        with pytest.raises(urllib.error.HTTPError) as ei:
            _post(f"http://127.0.0.1:{server.port}", data, query,
                  timeout=30)
    body = json.load(ei.value)
    assert ei.value.code == (413 if case == "413" else 400)
    assert {"413": "exceeds", "bad_image": "bad image",
            "bad_resolution": "bad resolution",
            "unserved_resolution": "not served"}[case] in body["error"]


def test_http_multi_resolution(engine):
    with TaggerServer(engine, resolution=(RES, 32), threshold=0.0, port=0,
                      max_batch=2, batch_timeout_ms=5) as server:
        base = f"http://127.0.0.1:{server.port}"
        health = _get(base, "/healthz")
        assert health["resolution"] == RES
        assert health["resolutions"] == [32, RES]
        got32 = _post(base, _jpeg_bytes(), "?resolution=32")
        want32 = engine.classify(decode_bytes_square(_jpeg_bytes(), 32)[None])
        assert got32["max_confidence"] == pytest.approx(
            float(want32.max()), abs=1e-4)
        assert "predicted_tags" in _post(base, _jpeg_bytes())


def test_http_yuv420_transfer_tags_like_rgb(engine):
    data = _jpeg_bytes(seed=7)

    def serve_once(fmt):
        with TaggerServer(engine, resolution=RES, threshold=0.0, port=0,
                          max_batch=2, batch_timeout_ms=5,
                          transfer_format=fmt) as server:
            return _post(f"http://127.0.0.1:{server.port}", data)

    rgb, yuv = serve_once("rgb"), serve_once("yuv420")
    a = {t["tag"]: t["confidence"] for t in rgb["predicted_tags"]}
    b = {t["tag"]: t["confidence"] for t in yuv["predicted_tags"]}
    assert a.keys() == b.keys()
    assert max(abs(a[k] - b[k]) for k in a) < 0.05


def test_server_refuses_odd_yuv_resolutions_and_unported_flags(engine, art):
    """Odd resolutions in yuv420 are refused; --no_data_parallel and
    --spatial_parallel, no longer refused, change nothing on one device:
    the same server settings and the same probabilities."""
    with pytest.raises(ValueError):
        TaggerServer(engine, resolution=63, transfer_format="yuv420",
                     warmup=False, port=0)
    pixels = np.random.default_rng(3).integers(0, 256, (3, RES, RES, 3),
                                               dtype=np.uint8)
    served = {}
    for flag in ((), ("--no_data_parallel",), ("--spatial_parallel",)):
        args = build_parser().parse_args([
            *[x for k, v in art.items() for x in (f"--{k}", v)],
            "--device", "cpu", "--no_warmup", "--port", "0", *flag])
        server = build_server(args)
        try:
            worker = server.worker
            assert worker.engine.replicas is None
            served[flag] = (worker.max_batch,
                            worker.engine.classify(pixels))
        finally:
            server.httpd.server_close()
            server.worker.stop()
    (mb, probs), *others = served.values()
    assert mb == 8
    for other_mb, other in others:
        assert other_mb == mb
        np.testing.assert_array_equal(other, probs)


def test_serve_cli_on_the_cpu(art):
    """``python -m vae_tagger_tpu_torch.serve --device cpu`` serves
    /healthz, /tags and /classify, and stops on SIGTERM."""
    argv = [sys.executable, "-m", "vae_tagger_tpu_torch.serve",
            *[x for k, v in art.items() for x in (f"--{k}", v)],
            "--device", "cpu", "--resolution", str(RES), "--port", "0",
            "--max_batch", "2", "--confidence_threshold", "0"]
    env = dict(os.environ, PYTHONPATH=ROOT)
    proc = subprocess.Popen(argv, cwd=ROOT, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    try:
        port = None
        deadline = time.monotonic() + 120
        while port is None and time.monotonic() < deadline:
            line = proc.stdout.readline()
            if not line:
                break
            if "listening on :" in line:
                port = int(line.split("listening on :")[1].split()[0])
        assert port is not None, "the server did not start"
        base = f"http://127.0.0.1:{port}"
        assert _get(base, "/healthz")["status"] == "ok"
        assert len(_get(base, "/tags")["tags"]) == TAGS
        out = _post(base, _jpeg_bytes())
        assert out["total_tags_above_threshold"] == TAGS
    finally:
        proc.terminate()
        proc.wait(timeout=60)
