"""The port's HTTP server end to end on the CPU, on the tiny model with the
row-prefix layout (bucket_size=1): the five cases of tests/test_server.py,
each server on a free port (port=0), plus the single-flight answers to
sampling and logprobs, and speculative decode (single flight and
batched).
"""

import asyncio
import json
import urllib.error
import urllib.request

import pytest
import torch

from effort_tpu_torch.config import BucketConfig, tiny_test_model
from effort_tpu_torch.models.generate import Engine
from effort_tpu_torch.models.transformer import init_random_weights
from effort_tpu_torch.serving.server import EffortServer, make_batch_server

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def weights():
    cfg = tiny_test_model(max_seq_len=64)
    return cfg, init_random_weights(
        cfg, BucketConfig(bucket_size=1, chunk_rows=128, dtype="int8"),
        calibrate=True, fuse=True, device="cpu")


def _fetch(port, path, payload=None):
    """(status, content type, body text); an HTTP error's status too."""
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}",
        data=None if payload is None else json.dumps(payload).encode(),
        headers={"content-type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=120) as r:
            return r.status, r.headers.get("content-type"), r.read().decode()
    except urllib.error.HTTPError as e:
        return e.code, None, e.read().decode()


def _get(port, path):
    st, _, body = _fetch(port, path)
    return st, json.loads(body)


def _run(srv, client):
    """Start srv, run client(port) in a worker thread, stop srv."""
    async def run():
        await srv.start()
        try:
            return await asyncio.get_running_loop().run_in_executor(
                None, client, srv.port)
        finally:
            await srv.stop()
    return asyncio.run(run())


def _batch_server(weights):
    cfg, w = weights
    return make_batch_server(w, cfg, batch_size=2, pad_to=8, port=0,
                             device="cpu")


def test_server_endpoints(weights):
    cfg, w = weights
    srv = EffortServer(Engine(w, cfg, pad_to=8, device="cpu"), port=0)

    def client(port):
        st, body = _get(port, "/health")
        assert st == 200 and body["status"] == "ok"
        st, body = _get(port, "/q?query=hello&effort=60&numtokens=4")
        assert st == 200
        assert "reply" in body and body["effort"] == 0.6
        st, body = _get(port, "/q?tokids=1,5,9&effort=100")
        assert st == 200 and len(body["predictions"]) == 3
        st, body = _get(port, "/stats")
        assert body["requests"] >= 3
        # sampling and logprobs reach the engine; /q carries the logprobs
        st, body = _get(port, "/q?query=hi&numtokens=2&temperature=0.9")
        assert st == 200 and "logprobs" not in body
        st, body = _get(port, "/q?query=hi&numtokens=2&logprobs=3")
        assert st == 200 and len(body["logprobs"]) <= 2
        assert all(len(d) == 3 for d in body["logprobs"])
    _run(srv, client)

    # speculative decode: a full-effort greedy /q goes to
    # generate_speculative, which gives the greedy tokens at 1.0; a
    # lower-effort one takes generate
    eng = Engine(w, cfg, pad_to=8, device="cpu")
    spec = EffortServer(eng, port=0, spec_k=2, spec_draft_effort=0.5)
    ids = spec._encode_query("hi")
    calls = []
    real = eng.generate_speculative

    def counted(*a, **kw):
        calls.append(kw)
        return real(*a, **kw)
    eng.generate_speculative = counted

    def client_spec(port):
        st, body = _get(port, "/q?query=hi&numtokens=4&effort=100")
        assert st == 200
        assert body["reply"] == str(eng.generate(ids, n_new=4,
                                                 effort=1.0).token_ids)
        st, body = _get(port, "/q?query=hi&numtokens=4&effort=50")
        assert st == 200 and "reply" in body
    _run(spec, client_spec)
    assert calls == [dict(n_new=4, draft_effort=0.5, k=2)]


def test_batch_server_concurrent_requests(weights):
    from concurrent.futures import ThreadPoolExecutor

    def client(port):
        # three concurrent generations through 2 slots
        with ThreadPoolExecutor(3) as pool:
            results = list(pool.map(
                lambda i: _get(port, f"/q?query=h{i}&effort=100"
                                     f"&numtokens=4"), range(3)))
        for st, body in results:
            assert st == 200
            assert 1 <= len(body["token_ids"]) <= 4
        # the eval path still works in batch mode
        st, body = _get(port, "/q?tokids=1,5,9&effort=100")
        assert st == 200 and len(body["predictions"]) == 3
    _run(_batch_server(weights), client)


def test_batch_server_streaming(weights):
    """stream=1 in batching mode: one SSE data event per token, then an
    event: done carrying the full result."""
    def client(port):
        st, ctype, body = _fetch(
            port, "/q?query=hi&effort=100&numtokens=5&stream=1")
        assert st == 200 and ctype == "text/event-stream"
        events = [e for e in body.split("\n\n") if e.strip()]
        data = [json.loads(e.split("data: ", 1)[1])
                for e in events if e.startswith("data: ")]
        done = [e for e in events if e.startswith("event: done")]
        assert len(done) == 1
        final = json.loads(done[0].split("data: ", 1)[1])
        assert [d["token"] for d in data] == final["token_ids"]
        assert len(data) >= 2          # actually streamed per token
    _run(_batch_server(weights), client)


def test_batch_server_rejects_sampling_params(weights):
    def client(port):
        st, _, _ = _fetch(port, "/q?query=hi&numtokens=2&temperature=0.9")
        assert st == 400
    _run(_batch_server(weights), client)


def test_openai_completions_endpoint(weights):
    def client(port):
        st, _, body = _fetch(port, "/v1/completions",
                             {"prompt": "hello", "max_tokens": 4,
                              "effort": 0.5})
        assert st == 200
        obj = json.loads(body)
        assert obj["object"] == "text_completion"
        assert obj["choices"][0]["finish_reason"] == "length"
        st, _, body = _fetch(port, "/v1/completions",
                             {"prompt": "hello", "max_tokens": 4,
                              "stream": True})
        assert st == 200
        assert body.strip().endswith("data: [DONE]")
        assert body.count('"text_completion"') >= 4
    _run(_batch_server(weights), client)


def test_batch_server_speculative(weights):
    """make_batch_server(spec_k=...) serves concurrent requests through
    speculative steps, with the plain batch server's tokens."""
    cfg, w = weights

    def client(port):
        return [_get(port, f"/q?query=h{i}&effort={e}&numtokens=5")
                for i, e in enumerate((100, 50))]
    plain = _run(_batch_server(weights), client)
    spec = _run(make_batch_server(w, cfg, batch_size=2, pad_to=8, port=0,
                                  spec_k=3, spec_draft_effort=0.25,
                                  impl="reference", device="cpu"), client)
    ref = _run(make_batch_server(w, cfg, batch_size=2, pad_to=8, port=0,
                                 impl="reference", device="cpu"), client)
    assert all(st == 200 for st, _ in plain + spec)
    assert [b["token_ids"] for _, b in spec] == \
        [b["token_ids"] for _, b in ref]


def test_batch_server_stats_carry_the_batchers_counts(weights):
    """/stats of a batch server: its own three counters and the batcher's
    counts, which agree with the requests it served."""
    srv = _batch_server(weights)

    def client(port):
        for i in range(2):
            st, body = _get(port, f"/q?query=s{i}&effort=50&numtokens=3")
            assert st == 200
        st, body = _get(port, "/stats")
        assert st == 200
        assert {"requests", "tokens", "busy_rejects"} <= set(body)
        c = body["batcher"]
        assert c["submitted"] == c["admitted"] == 2
        assert c["tokens"] == body["tokens"]
        assert c["steps"] >= 2 and c["queue_wait_s"] >= 0
        assert c == srv.batcher.counts
    _run(srv, client)
