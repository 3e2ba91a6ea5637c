"""Port serving: the port's CaptionServer on the CPU (the kernel wrappers'
plain twins) — batch and region padding exactness, close() draining, the
HTTP front — and its captions against the JAX package's CaptionServer on
the same weights."""

import json
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from boficap_tpu_torch.decode import bound_fill as tbf
from boficap_tpu_torch.serve import CaptionServer, _buckets, _Future, _Request
from boficap_tpu_torch.text import decode_sequence
from tests._torch_port_util import L, R, VOCAB, make_feats, make_pair

IX_TO_WORD = {str(i): f"w{i}" for i in range(4, VOCAB + 4)}


@pytest.fixture(scope="module")
def pair():
    return make_pair("UIC", "add", seed=4)


def _direct(tm, att, am):
    """Each request decoded alone (batch 1) on the same route."""
    seqs = []
    for i in range(att.shape[0]):
        a = torch.from_numpy(att[i:i + 1])
        m = torch.from_numpy(am[i:i + 1])
        with torch.no_grad():
            mem = tbf.fused_encode(tm, a, m)
        seqs.append(tbf.na_decode(tm, mem, m.bool(), fused_fill=True)
                    ["seq"][0].numpy())
    return np.stack(seqs)


def test_serve_matches_direct_decode_and_jax(pair):
    """Concurrent requests each get their own image's caption; bucket
    padding changes nothing (every request equals its batch-1 decode); and
    the captions equal the JAX package's server on the same weights."""
    import jax
    from boficap_tpu.serve import CaptionServer as JaxCaptionServer
    jm, params, tm = pair
    att, am = make_feats(B=3, seed=11)
    want_seq = _direct(tm, att, am)
    srv = CaptionServer(tm, IX_TO_WORD, max_batch=4, max_wait_ms=30.0,
                        max_regions=R, device="cpu")
    try:
        futs = [srv.submit(att[i], am[i]) for i in range(3)]
        outs = [f.wait(timeout=120) for f in futs]
        st = srv.stats()
    finally:
        srv.close()
    np.testing.assert_array_equal(np.stack([o["seq"] for o in outs]),
                                  want_seq)
    assert [o["caption"] for o in outs] == decode_sequence(IX_TO_WORD,
                                                           want_seq)
    assert any(o["caption"] for o in outs)
    assert st["n"] == 3 and st["p50_ms"] > 0

    jsrv = JaxCaptionServer(jm, params, IX_TO_WORD, mode="NAIC",
                            max_batch=4, max_wait_ms=30.0, max_regions=R,
                            route="unfused")
    try:
        jfuts = [jsrv.submit(att[i], am[i]) for i in range(3)]
        jouts = [f.wait(timeout=300) for f in jfuts]
    finally:
        jsrv.close()
    assert [o["caption"] for o in outs] == [o["caption"] for o in jouts]


def test_serve_region_padding_and_buckets(pair):
    """Fewer regions than R are padded and masked exactly; three requests
    round up to the bucket of 4."""
    _, _, tm = pair
    assert _buckets(64) == [1, 2, 4, 8, 16, 32, 64]
    assert _buckets(6) == [1, 2, 4, 6]
    att, am = make_feats(B=3, seed=12)
    n_short = 3
    att_pad = att.copy()
    att_pad[1, n_short:] = 0.0
    am_pad = am.copy()
    am_pad[1] = (np.arange(R) < n_short).astype(np.float32)
    want = _direct(tm, att_pad, am_pad)
    srv = CaptionServer(tm, IX_TO_WORD, max_batch=4, max_wait_ms=30.0,
                        max_regions=R, device="cpu")
    try:
        futs = [srv.submit(att[0], am[0]), srv.submit(att[1][:n_short]),
                srv.submit(att[2], am[2])]
        outs = [f.wait(timeout=120) for f in futs]
        # a short mask matching the short region list pads with zeros too
        short = srv.submit(att[1][:n_short],
                           np.ones(n_short, np.float32)).wait(timeout=120)
    finally:
        srv.close()
    assert {o["bucket"] for o in outs} == {4}
    np.testing.assert_array_equal(np.stack([o["seq"] for o in outs]), want)
    np.testing.assert_array_equal(short["seq"], want[1])


def test_serve_bf16_feature_transport(pair):
    """feature_dtype='bfloat16' rounds the features on the host; the result
    equals a direct decode of the rounded features."""
    _, _, tm = pair
    att, am = make_feats(B=2, seed=13)
    rounded = torch.from_numpy(att).to(torch.bfloat16).float().numpy()
    want = _direct(tm, rounded, am)
    srv = CaptionServer(tm, IX_TO_WORD, max_batch=2, max_wait_ms=30.0,
                        max_regions=R, feature_dtype="bfloat16",
                        device="cpu")
    try:
        outs = [f.wait(timeout=120) for f in
                [srv.submit(att[i], am[i]) for i in range(2)]]
    finally:
        srv.close()
    np.testing.assert_array_equal(np.stack([o["seq"] for o in outs]), want)


def test_serve_close_drains_and_validates(pair):
    """close() fails still-queued requests; a closed server refuses new
    ones; bad shapes raise at submit(); the mode and device are checked."""
    _, _, tm = pair
    att, am = make_feats(B=1, seed=14)
    srv = CaptionServer(tm, IX_TO_WORD, max_batch=4, max_regions=R,
                        device="cpu")
    srv._stop.set()
    srv._worker.join(timeout=10)
    req = _Request(att=torch.from_numpy(att[0]), att_mask=None)
    srv._q.put(req)                       # stuck: the worker is gone
    fut = _Future(req, srv)
    srv.close()
    with pytest.raises(RuntimeError, match="closed"):
        fut.wait(timeout=10)
    with pytest.raises(RuntimeError, match="closed"):
        srv.submit(att[0])

    srv2 = CaptionServer(tm, IX_TO_WORD, max_batch=2, max_regions=R,
                         device="cpu", pipeline=False)
    try:
        with pytest.raises(ValueError, match="features"):
            srv2.submit(np.zeros((3,), np.float32))
        with pytest.raises(ValueError, match="features"):
            srv2.submit(np.zeros((R + 1, 2048), np.float32))
        with pytest.raises(ValueError, match="att_mask"):
            srv2.submit(att[0], np.ones(R + 3, np.float32))
        out = srv2.submit(att[0], am[0]).wait(timeout=120)   # inline finish
        assert isinstance(out["caption"], str)
    finally:
        srv2.close()

    CaptionServer(tm, IX_TO_WORD, mode="SAIC", device="cpu").close()
    # an AR model serves mode AIC (its captions against the JAX server's:
    # tests/test_torch_port_ar.py); a model without an A role does not
    from boficap_tpu_torch.config import make_config
    from boficap_tpu_torch.convert import init_params
    aic = init_params(make_config(train_mode="AIC", N_enc=1, N_dec=1,
                                  d_model=32, d_ff=64, num_att_heads=4,
                                  max_length=6, max_boxes=R, dtype="float32"),
                      VOCAB, seed=1, device="cpu")
    srv3 = CaptionServer(aic, IX_TO_WORD, mode="AIC", max_regions=R,
                         device="cpu")
    try:
        out = srv3.submit(att[0], am[0]).wait(timeout=120)
    finally:
        srv3.close()
    assert isinstance(out["caption"], str) and out["seq"].shape == (6,)
    with pytest.raises(ValueError):
        CaptionServer(tm, IX_TO_WORD, mode="AIC", device="cpu")


def test_serve_close_fails_straggler_inflight(pair):
    """A worker that outlives close()'s join deadline must not leave its
    batch's futures blocked: close() fails them through the in-flight set."""
    _, _, tm = pair
    att, _ = make_feats(B=1, seed=15)
    srv = CaptionServer(tm, IX_TO_WORD, max_batch=2, max_wait_ms=1.0,
                        max_regions=R, device="cpu")
    release = threading.Event()
    try:
        def slow_decode(a, m):
            release.wait(timeout=30)
            raise RuntimeError("released")

        srv._decode = slow_decode
        fut = srv.submit(att[0])
        for _ in range(200):
            if srv._inflight:
                break
            time.sleep(0.01)
        assert srv._inflight, "worker never picked up the request"
        srv.close(join_timeout=0.2)
        with pytest.raises(RuntimeError, match="closed"):
            fut.wait(timeout=5)
    finally:
        release.set()
        srv.close(join_timeout=1)


def test_default_device_is_cuda():
    """Entry points run on the card unless asked for the CPU: without a
    card they raise instead of quietly running on the CPU."""
    from boficap_tpu_torch.device import resolve_device
    if torch.cuda.is_available():
        assert resolve_device().type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            resolve_device()
    assert resolve_device("cpu").type == "cpu"


def test_serve_http_endpoints(pair):
    """POST /caption (JSON) and /caption_bin (raw bfloat16 body) batch
    through one server; GET /stats reports latencies; a malformed request
    gets a 400 and the server stays up."""
    from concurrent.futures import ThreadPoolExecutor

    from boficap_tpu_torch.serve_http import make_http_server
    _, _, tm = pair
    att, _ = make_feats(B=3, seed=16)
    srv = CaptionServer(tm, IX_TO_WORD, max_batch=4, max_wait_ms=30.0,
                        max_regions=R, device="cpu")
    httpd = make_http_server(srv, "127.0.0.1", 0)
    port = httpd.server_address[1]
    t = threading.Thread(target=httpd.serve_forever, daemon=True)
    t.start()
    try:
        def post(path, data, headers):
            req = urllib.request.Request(f"http://127.0.0.1:{port}{path}",
                                         data=data, headers=headers)
            with urllib.request.urlopen(req, timeout=120) as r:
                return json.loads(r.read())

        def post_json(i):
            return post("/caption",
                        json.dumps({"features": att[i].tolist()}).encode(),
                        {"Content-Type": "application/json"})

        with ThreadPoolExecutor(3) as ex:
            outs = list(ex.map(post_json, range(3)))
        assert all(isinstance(o["caption"], str) for o in outs)
        body = torch.from_numpy(att[0]).to(torch.bfloat16).view(
            torch.int16).numpy().tobytes()
        out = post("/caption_bin", body, {"X-Regions": str(R),
                                          "X-Dtype": "bfloat16"})
        assert isinstance(out["seq"], list) and len(out["seq"]) == 8
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/stats",
                                    timeout=30) as r:
            assert json.loads(r.read())["n"] == 4
        with pytest.raises(urllib.error.HTTPError) as ei:
            post("/caption", json.dumps({"features": [1, 2, 3]}).encode(),
                 {"Content-Type": "application/json"})
        assert ei.value.code == 400
    finally:
        httpd.shutdown()
        srv.close()


# ---------------------------------------------------------------------------
# route: the kernel program or the plain one, a bucket at a time (the JAX
# server's route='auto' | 'fused' | 'unfused')
# ---------------------------------------------------------------------------

def _bucket_decode(tm, att, am, bucket, mode, fused):
    """What the server runs on a batch: padded to ``bucket`` rows as the
    server pads it, then the kernel program (fused_encode and the fused
    fill: on the CPU their plain twins) or the plain one."""
    n = att.shape[0]
    a = torch.zeros((bucket,) + att.shape[1:])
    m = torch.zeros((bucket, att.shape[1]))
    a[:n], m[:n] = torch.from_numpy(att), torch.from_numpy(am)
    m[n:, 0] = 1.0
    decode = tbf.sa_decode if mode == "SAIC" else tbf.na_decode
    with torch.no_grad():
        mem = tbf.fused_encode(tm, a, m) if fused else tm.encode(a, m)
        return decode(tm, mem, m.bool(), fused_fill=fused)["seq"][:n].numpy()


@pytest.mark.parametrize("mode", ["NAIC", "SAIC"])
@pytest.mark.parametrize("route", ["fused", "unfused", "auto"])
def test_serve_route_answers_with_its_program(pair, route, mode):
    """Each route answers with the direct decode of the program it kept
    for the bucket (the forced one, untimed, or under 'auto' the kernel
    program unless the plain one wins by more than the repeats' spread on
    this host), and reports its choice with the times it took."""
    _, _, tm = pair
    att, am = make_feats(B=3, seed=16)
    srv = CaptionServer(tm, IX_TO_WORD, mode=mode, max_batch=4,
                        max_wait_ms=30.0, max_regions=R, route=route,
                        device="cpu")
    try:
        outs = [f.wait(timeout=120) for f in
                [srv.submit(att[i], am[i]) for i in range(3)]]
    finally:
        srv.close()
    bucket = outs[0]["bucket"]
    assert {o["bucket"] for o in outs} == {bucket} == set(srv.routes)
    chosen = srv.routes[bucket]
    if route != "auto":
        assert chosen == {"route": route, "fused_ms": None,
                          "unfused_ms": None, "spread_ms": None}
    else:
        assert chosen["fused_ms"] > 0 and chosen["unfused_ms"] > 0
        plain_wins = (chosen["unfused_ms"]
                      < chosen["fused_ms"] - chosen["spread_ms"])
        assert chosen["route"] == ("unfused" if plain_wins else "fused")
    want = _bucket_decode(tm, att, am, bucket, mode,
                          chosen["route"] == "fused")
    np.testing.assert_array_equal(np.stack([o["seq"] for o in outs]), want)


def test_serve_auto_keeps_the_faster_program(pair, monkeypatch):
    """With the server's timer patched so that one program is slower,
    'auto' keeps the other in every bucket, warmed at construction, but
    keeps the kernel program where the plain one wins by less than the
    repeats' spread; AIC has one program (ar_sample takes no fused_fill),
    the kernel one, kept untimed whatever the route; a route outside
    ROUTES raises."""
    jm, params, tm = pair
    timed = []

    def timer(fused_s, plain_s):
        def time_program(self, fused, prog, att, am):
            timed.append((att.shape[0], fused))
            return list(fused_s if fused else plain_s)
        return time_program

    for fused_s, plain_s, kept in (
            ((2.0, 2.0, 2.0), (1.0, 1.0, 1.0), "unfused"),
            ((1.0, 1.0, 1.0), (2.0, 2.0, 2.0), "fused"),
            # plain 0.1 s ahead, inside the kernel repeats' 0.4 s spread
            ((1.1, 1.5, 1.3), (1.0, 1.0, 1.0), "fused")):
        monkeypatch.setattr(CaptionServer, "_time_program",
                            timer(fused_s, plain_s))
        timed.clear()
        srv = CaptionServer(tm, IX_TO_WORD, max_batch=2, max_regions=R,
                            warm=True, device="cpu")
        srv.close()
        assert sorted(timed) == [(1, False), (1, True), (2, False),
                                 (2, True)]
        assert {b: r["route"] for b, r in srv.routes.items()} == {
            1: kept, 2: kept}
        assert srv.routes[1]["fused_ms"] == min(fused_s) * 1e3
        assert srv.routes[1]["unfused_ms"] == min(plain_s) * 1e3
        assert srv.routes[1]["spread_ms"] == pytest.approx(
            max(max(fused_s) - min(fused_s), max(plain_s) - min(plain_s))
            * 1e3)
    aic = make_pair("AIC", seed=2)[2]
    timed.clear()
    srv = CaptionServer(aic, IX_TO_WORD, mode="AIC", max_batch=1,
                        max_regions=R, warm=True, route="unfused",
                        device="cpu")
    srv.close()
    assert timed == []
    assert srv.routes[1] == {"route": "fused", "fused_ms": None,
                             "unfused_ms": None, "spread_ms": None}
    with pytest.raises(ValueError, match="route"):
        CaptionServer(tm, IX_TO_WORD, route="tpu", device="cpu")


@pytest.mark.parametrize("route", ["fused", "auto"])
def test_serve_refused_shapes_raise_on_the_card(pair, monkeypatch, route):
    """On a CUDA device, where the wrappers refuse the model's shapes,
    'fused' and 'auto' raise the wrappers' ValueError at construction,
    before the weights move, and never serve the plain program in the
    kernels' place."""
    import boficap_tpu_torch.serve as serve_mod
    _, _, tm = pair
    monkeypatch.setattr(serve_mod, "resolve_device",
                        lambda device: torch.device("cuda"))
    monkeypatch.setattr(CaptionServer, "_kernel_refusal",
                        lambda self, m: ValueError("head width 7"))
    with pytest.raises(ValueError, match="head width 7") as err:
        CaptionServer(tm, IX_TO_WORD, route=route, max_regions=R)
    assert "route='unfused'" in str(err.value)
    assert next(tm.parameters()).device.type == "cpu"
