"""HTTP inference server.

  GET /q?query=...&effort=0-100&numtokens=N   -> JSON {reply, tokens_per_s}
  GET /q?...&stream=1                         -> SSE token stream
     (continuous-batching mode only: `data: {token, text}` per token as
      it lands in the decode slot, `event: done` with the full result;
      single-flight mode answers with one response)
  GET /q?tokids=1,2,3&effort=...              -> JSON {predictions: [...]}
     (per-position argmax ids, for benchmarks driven from outside)
  GET /health                                 -> {"status": "ok"}
  GET /stats                                  -> queue/throughput counters
     (requests, tokens, busy_rejects; in continuous-batching mode also
      "batcher": ContinuousBatcher.counts, the scheduler's counters)
  POST /v1/completions                        -> OpenAI-compatible
     completions: {prompt, max_tokens, temperature, top_p, seed, stream}
     plus the extension field "effort" (0-1)

Requests are serialized through a single worker task, or, when constructed
with a ContinuousBatcher (make_batch_server), admitted into batched decode
slots so concurrent requests share each decode step (serving/batcher.py).

In single-flight mode the sampling, penalty and logprobs parameters reach
Engine.generate, and a /q reply carries "logprobs" when asked for, as the
JAX package's does. Batch mode refuses them with a 400: the batched step is
argmax-only, as in the JAX package. With spec_k, a single-flight server
answers full-effort greedy requests without logprobs through
Engine.generate_speculative (drafts at spec_draft_effort), and a batch
server (make_batch_server(spec_k=...)) takes speculative steps.
"""

from __future__ import annotations

import asyncio
import json
import urllib.parse
from typing import Optional

from effort_tpu_torch.runtime.tokenizer import (Tokenizer,
                                                mistral_instruct_prompt)

# /q parameters the single-flight path hands to Engine.generate when a
# request sets them: (query name, generate keyword, type)
_GENERATE_OPTIONS = (("temperature", "temperature", float),
                     ("topk", "top_k", int), ("topp", "top_p", float),
                     ("seed", "seed", int),
                     ("presence", "presence_penalty", float),
                     ("frequency", "frequency_penalty", float),
                     ("logprobs", "logprobs", int))


class EffortServer:
    def __init__(self, engine, tokenizer=None, host="127.0.0.1", port=8089,
                 max_queue: int = 32, batcher=None, spec_k: int = 0,
                 spec_draft_effort: float = 0.25):
        """spec_k (single-flight mode): full-effort greedy requests with no
        logprobs go to Engine.generate_speculative, k = spec_k drafts a
        round at spec_draft_effort."""
        self.engine = engine
        self.tokenizer = tokenizer
        self.batcher = batcher          # ContinuousBatcher or None
        self.spec_k = spec_k
        self.spec_draft_effort = spec_draft_effort
        self.host, self.port = host, port
        self.queue: asyncio.Queue = asyncio.Queue(maxsize=max_queue)
        self.stats = {"requests": 0, "tokens": 0, "busy_rejects": 0}
        self._server: Optional[asyncio.AbstractServer] = None

    # ---------------- request handling ----------------

    async def _worker(self):
        if self.batcher is not None:
            await self._batch_worker()
            return
        while True:
            fut, fn = await self.queue.get()
            try:
                result = await asyncio.get_running_loop().run_in_executor(
                    None, fn)
                fut.set_result(result)
            except Exception as e:  # surface errors as 500s
                fut.set_exception(e)

    async def _batch_worker(self):
        """Continuous batching loop: admit whatever is queued, then run one
        batched decode step; repeat while any slot is active."""
        loop = asyncio.get_running_loop()

        def submit(item):
            if len(item) == 2:           # eval-path request (tokids): run
                fut, fn = item           # directly, not via decode slots
                try:
                    fut.set_result(fn())
                except Exception as e:
                    fut.set_exception(e)
                return
            fut, ids, n_new, effort, on_token = item
            self.batcher.submit(
                ids, n_new, effort,
                lambda out: loop.call_soon_threadsafe(fut.set_result, out),
                on_token=on_token)

        while True:
            if not self.batcher.has_work():
                submit(await self.queue.get())
            while not self.queue.empty():
                submit(self.queue.get_nowait())
            try:
                await loop.run_in_executor(None, self.batcher.tick)
            except Exception:
                # a failed tick must not kill the serving loop
                import traceback
                traceback.print_exc()

    def _encode_query(self, query: str):
        if self.tokenizer is not None:
            # plain-LM tokenizers (instruct=False) take the raw text; chat
            # checkpoints get the [INST] template
            if not getattr(self.tokenizer, "instruct", True):
                return self.tokenizer.encode(query)
            return self.tokenizer.encode(mistral_instruct_prompt(query))
        vocab = (self.batcher.eng.cfg.vocab_size if self.batcher is not None
                 else self.engine.cfg.vocab_size)
        return [1] + [ord(c) % vocab for c in query]

    def _handle_q(self, params) -> dict:
        effort = float(params.get("effort", ["100"])[0]) / 100.0
        effort = min(max(effort, 0.01), 1.0)
        n_tokens = int(params.get("numtokens", ["50"])[0])

        if "tokids" in params:
            ids = [int(x) for x in params["tokids"][0].split(",") if x]
            _, preds = self.engine.prompt_logits(ids, effort=effort)
            return {"predictions": preds}

        ids = self._encode_query(params.get("query", [""])[0])
        opts = {name: conv(params[key][0])
                for key, name, conv in _GENERATE_OPTIONS if key in params}
        if (self.spec_k and effort >= 1.0
                and opts.get("temperature", 0.0) <= 0
                and not opts.get("logprobs", 0)):
            # the verify pass is greedy at effort 1.0 by contract; sampled
            # and lower-effort requests take the plain path
            reply = self.engine.generate_speculative(
                ids, n_new=n_tokens, draft_effort=self.spec_draft_effort,
                k=self.spec_k)
        else:
            reply = self.engine.generate(ids, n_new=n_tokens,
                                         effort=effort, **opts)
        self.stats["tokens"] += len(reply.token_ids)
        text = reply.text
        finish = None
        for stop in json.loads(params.get("stop", ["[]"])[0]):
            cut = text.find(stop)
            if cut >= 0:
                text = text[:cut]
                finish = "stop"
        out = {"reply": text or str(reply.token_ids),
               "effort": effort,
               "tokens_per_s": round(reply.tokens_per_s, 2)}
        if finish:
            out["finish_reason"] = finish
        if reply.logprobs is not None:
            out["logprobs"] = [{str(t): v for t, v in d.items()}
                               for d in reply.logprobs]
        return out

    async def _handle(self, reader: asyncio.StreamReader,
                      writer: asyncio.StreamWriter):
        try:
            line = await reader.readline()
            if not line:
                writer.close()
                return
            parts = line.decode().split()
            headers = {}
            while True:
                h = await reader.readline()
                if h in (b"\r\n", b"\n", b""):
                    break
                k, _, v = h.decode().partition(":")
                headers[k.strip().lower()] = v.strip()
            if len(parts) < 2:
                await self._respond(writer, 400, {"error": "bad request"})
                return
            path = urllib.parse.urlparse(parts[1])
            params = urllib.parse.parse_qs(path.query)
            clen = int(headers.get("content-length", "0") or 0)
            body = {}
            if clen:
                try:
                    body = json.loads(await reader.readexactly(clen))
                except (ValueError, asyncio.IncompleteReadError):
                    await self._respond(writer, 400,
                                        {"error": "bad JSON body"})
                    return
            self.stats["requests"] += 1

            openai = path.path == "/v1/completions"
            if openai:
                # OpenAI completions schema -> the /q parameter space;
                # "effort" (0-1) rides along as an extension field
                params = {
                    "query": [str(body.get("prompt", ""))],
                    "numtokens": [str(body.get("max_tokens", 16))],
                    "temperature": [str(body.get("temperature", 0) or 0)],
                    "topp": [str(body.get("top_p", 1.0) or 1.0)],
                    "seed": [str(body.get("seed", 0) or 0)],
                    "effort": [str(float(body.get("effort", 1.0)) * 100)],
                    "stream": ["1" if body.get("stream") else "0"],
                    "presence": [str(body.get("presence_penalty", 0) or 0)],
                    "frequency": [str(body.get("frequency_penalty", 0)
                                      or 0)],
                    "logprobs": [str(body.get("logprobs", 0) or 0)],
                }
                stops = body.get("stop") or []
                if isinstance(stops, str):
                    stops = [stops]
                if stops:
                    params["stop"] = [json.dumps(stops)]

            if path.path == "/health":
                await self._respond(writer, 200, {"status": "ok"})
            elif path.path == "/stats":
                stats = dict(self.stats)
                if self.batcher is not None:
                    stats["batcher"] = dict(self.batcher.counts)
                await self._respond(writer, 200, stats)
            elif path.path == "/q" or openai:
                await self._handle_generation(writer, params, openai)
            else:
                await self._respond(writer, 404, {"error": "not found"})
        except ConnectionError:
            pass
        finally:
            try:
                writer.close()
            except Exception:
                pass

    async def _handle_generation(self, writer, params, openai: bool):
        loop = asyncio.get_running_loop()
        fut = loop.create_future()
        stream = params.get("stream", ["0"])[0] not in ("0", "", "false")
        tok_q: Optional[asyncio.Queue] = None
        batched = self.batcher is not None and "tokids" not in params
        if batched:
            if (float(params.get("temperature", ["0"])[0]) > 0
                    or float(params.get("presence", ["0"])[0])
                    or float(params.get("frequency", ["0"])[0])
                    or int(params.get("logprobs", ["0"])[0])):
                # the batched decode step is argmax-only; refuse rather
                # than silently return greedy output
                await self._respond(writer, 400, {
                    "error": "sampling/penalty params are not supported "
                             "in continuous-batching mode"})
                return
            effort = float(params.get("effort", ["100"])[0]) / 100.0
            effort = min(max(effort, 0.01), 1.0)
            n_new = int(params.get("numtokens", ["50"])[0])
            ids = self._encode_query(params.get("query", [""])[0])
            on_token = None
            if stream:
                tok_q = asyncio.Queue()
                q = tok_q

                def on_token(t, q=q):
                    loop.call_soon_threadsafe(q.put_nowait, int(t))
                fut.add_done_callback(lambda _: q.put_nowait(None))
            item = (fut, ids, n_new, effort, on_token)
        else:
            item = (fut, lambda: self._handle_q(params))
        try:
            self.queue.put_nowait(item)
        except asyncio.QueueFull:
            self.stats["busy_rejects"] += 1
            await self._respond(writer, 503, {"error": "busy"})
            return
        try:
            if tok_q is not None:
                await self._respond_sse(writer, tok_q, fut, openai=openai)
                return
            result = await fut
            if batched:
                tokens = result
                self.stats["tokens"] += len(tokens)
                text = (self.tokenizer.decode(tokens)
                        if self.tokenizer is not None else "")
                finish = None
                for stop in json.loads(params.get("stop", ["[]"])[0]):
                    cut = text.find(stop)
                    if cut >= 0:
                        text, finish = text[:cut], "stop"
                result = {"reply": text or str(tokens), "token_ids": tokens}
                if finish:
                    result["finish_reason"] = finish
            if openai:
                n_req = int(params["numtokens"][0])
                n_got = len(result.get("token_ids", []) or [])
                result = self._openai_completion(
                    result.get("reply", ""),
                    result.get("finish_reason") or (
                        "length" if (not n_got or n_got >= n_req)
                        else "stop"))
            await self._respond(writer, 200, result)
        except Exception as e:
            await self._respond(writer, 500, {"error": str(e)})

    @staticmethod
    def _openai_completion(text: str, finish_reason: str = "length",
                           stream_delta: bool = False) -> dict:
        return {"object": "text_completion", "model": "effort-tpu",
                "choices": [{"text": text, "index": 0, "logprobs": None,
                             "finish_reason": (None if stream_delta
                                               else finish_reason)}]}

    async def _respond_sse(self, writer, tok_q: asyncio.Queue, fut,
                           openai: bool = False):
        """Server-sent events: one `data:` event per token as it lands in
        the decode slot, then `event: done` with the full result (native
        format) or a `data: [DONE]` terminator (OpenAI format)."""
        writer.write(b"HTTP/1.1 200 OK\r\n"
                     b"content-type: text/event-stream\r\n"
                     b"cache-control: no-cache\r\n"
                     b"connection: close\r\n\r\n")
        await writer.drain()
        toks, prev_text = [], ""
        while True:
            tok = await tok_q.get()
            if tok is None:
                break
            toks.append(tok)
            piece = ""
            if self.tokenizer is not None:
                # decode the whole prefix and emit the delta: per-token
                # decode would strip sentencepiece space markers and
                # mangle byte-fallback tokens
                full = self.tokenizer.decode(toks)
                piece, prev_text = full[len(prev_text):], full
            payload = (self._openai_completion(piece, stream_delta=True)
                       if openai else {"token": tok, "text": piece})
            writer.write(b"data: " + json.dumps(payload).encode()
                         + b"\n\n")
            await writer.drain()
        tokens = await fut
        self.stats["tokens"] += len(tokens)
        text = (self.tokenizer.decode(tokens)
                if self.tokenizer is not None else "")
        if openai:
            writer.write(b"data: [DONE]\n\n")
        else:
            writer.write(b"event: done\ndata: " + json.dumps(
                {"reply": text or str(tokens),
                 "token_ids": tokens}).encode() + b"\n\n")
        await writer.drain()

    @staticmethod
    async def _respond(writer, code: int, obj: dict):
        body = json.dumps(obj).encode()
        writer.write(
            f"HTTP/1.1 {code} OK\r\ncontent-type: application/json\r\n"
            f"content-length: {len(body)}\r\nconnection: close\r\n\r\n"
            .encode() + body)
        await writer.drain()

    # ---------------- lifecycle ----------------

    async def start(self):
        """Start serving. port=0 binds a free port; self.port then holds
        the one bound."""
        self._worker_task = asyncio.create_task(self._worker())
        self._server = await asyncio.start_server(self._handle, self.host,
                                                  self.port)
        self.port = self._server.sockets[0].getsockname()[1]
        return self

    async def stop(self):
        self._worker_task.cancel()
        self._server.close()
        await self._server.wait_closed()

    async def serve_forever(self):
        await self.start()
        async with self._server:
            await self._server.serve_forever()


def make_server(engine, tokenizer=None, **kw) -> EffortServer:
    return EffortServer(engine, tokenizer=tokenizer, **kw)


def make_batch_server(weights, cfg, tokenizer=None, batch_size: int = 4,
                      pad_to: int = 32, impl: str = "auto",
                      kv_dtype: str = "bf16", spec_k: int = 0,
                      spec_draft_effort: float = 0.25, device=None,
                      **kw) -> EffortServer:
    """Server in continuous-batching mode: concurrent /q requests share
    batched decode steps. impl "auto" runs K2 on the card (the JAX
    package's default is its "jnp" route, the port's "reference").
    kv_dtype "int8" quantizes the batch KV cache; spec_k > 0 makes the
    steps speculative (drafts at spec_draft_effort). device: the card
    unless named."""
    from effort_tpu_torch.models.generate import Engine
    from effort_tpu_torch.serving.batcher import (BatchEngine,
                                                  ContinuousBatcher)
    be = BatchEngine(weights, cfg, batch_size=batch_size, pad_to=pad_to,
                     impl=impl, kv_dtype=kv_dtype, spec_k=spec_k,
                     spec_draft_effort=spec_draft_effort, device=device)
    eng = Engine(be.w, cfg, tokenizer=tokenizer, impl=impl, pad_to=pad_to,
                 device=be.device)  # eval (tokids) path
    return EffortServer(eng, tokenizer=tokenizer,
                        batcher=ContinuousBatcher(be), **kw)


def parse_args(argv=None):
    import argparse
    p = argparse.ArgumentParser(description="effort-tpu HTTP server on the "
                                            "PyTorch port")
    p.add_argument("--port", type=int, default=8089)
    p.add_argument("--ckpt")
    p.add_argument("--tokenizer")
    p.add_argument("--synthetic", action="store_true",
                   help="a random tiny model (the default without --ckpt)")
    p.add_argument("--batch", type=int, default=0,
                   help="continuous-batching slots (0 = single-flight)")
    p.add_argument("--kv-dtype", default="bf16", choices=["bf16", "int8"],
                   help="KV cache dtype (int8 = about half the memory): the "
                        "batch cache, or the single-flight engine's")
    p.add_argument("--spec-k", type=int, default=0,
                   help="speculative decode: drafted tokens a round (single "
                        "flight) or per slot a step (batching); 0 = off")
    p.add_argument("--draft-effort", type=float, default=0.25,
                   help="the speculative drafts' effort")
    p.add_argument("--device", default=None,
                   help="torch device (default: the card)")
    return p.parse_args(argv)


def build_server(args) -> EffortServer:
    """The server main() runs, from its parsed arguments: --ckpt DIR loads
    a converted checkpoint (models/weights.load_bucketized) onto --device,
    or without it the synthetic tiny model with BucketConfig(bucket_size=4,
    chunk_rows=8), as the JAX package's; --tokenizer FILE (a HuggingFace
    tokenizer.json) gives replies as text, in both modes. Single-flight,
    or with --batch slots; --kv-dtype int8 gives the batch engine, or the
    single-flight Engine (quant_kv), the int8 KV cache; --spec-k and
    --draft-effort speculative decode (the bf16 cache only). On the CPU a
    checkpoint's stored dense copies are loaded whenever present (there is
    no card memory to budget them against)."""
    if args.spec_k and args.kv_dtype == "int8":
        raise ValueError("--spec-k needs the bf16 KV cache")
    spec = dict(spec_k=args.spec_k, spec_draft_effort=args.draft_effort)
    from effort_tpu_torch.models.generate import Engine
    from effort_tpu_torch.models.transformer import resolve_device
    device = resolve_device(args.device)
    tok = Tokenizer(args.tokenizer) if args.tokenizer else None
    if args.ckpt:
        from effort_tpu_torch.models.weights import load_bucketized
        w, cfg, _ = load_bucketized(
            args.ckpt, device=device,
            load_dense="auto" if device.type == "cuda" else True)
    else:
        from effort_tpu_torch.config import BucketConfig, tiny_test_model
        from effort_tpu_torch.models.transformer import init_random_weights
        cfg = tiny_test_model()
        w = init_random_weights(cfg, BucketConfig(bucket_size=4,
                                                  chunk_rows=8),
                                device=device)
    if args.batch > 0:
        return make_batch_server(w, cfg, tokenizer=tok,
                                 batch_size=args.batch, port=args.port,
                                 kv_dtype=args.kv_dtype, device=device,
                                 **spec)
    return EffortServer(Engine(w, cfg, tokenizer=tok,
                               quant_kv=args.kv_dtype == "int8",
                               device=device),
                        tokenizer=tok, port=args.port, **spec)


def main(argv=None):
    srv = build_server(parse_args(argv))
    print(f"effort-tpu server on :{srv.port}"
          + (f" (continuous batching x{srv.batcher.eng.B})"
             if srv.batcher is not None else ""))
    asyncio.run(srv.serve_forever())


if __name__ == "__main__":
    main()
