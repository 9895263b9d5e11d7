"""Command-line interface of the PyTorch port (the JAX package's cli.py).

    python -m effort_tpu_torch MODE [options]

Run modes mirror the reference binary:
  convert     HF safetensors -> bucketized checkpoint
  generate    one-shot generation at a given effort
  repl        interactive: type text to generate; type a number 0-100 to
              set effort and re-run the previous query; 'r' re-runs
  bucket      single-matrix quality sweep (goBucketPerformance)
  quiz        QA accuracy across the effort scale (goQuiz)
  agreement   token-prediction agreement sweep (goBenchmarkSimilarity)
  kl          per-position KL(full||effort) sweep over a text
  autotune    measure the checkpoint's operating points and choose one

Reference-name aliases: playground -> bucket, benchmark -> agreement,
quickstart -> generate.

Checkpoints: --ckpt DIR (bucketized) or --synthetic for random weights.
Everything runs on the card unless --device names another device (e.g.
--device cpu). --impl takes the JAX package's names: auto, jnp (the
port's "reference" route, which reads every weight), pallas (the port's
"kernel" route: the hand-written CUDA kernels) and dense.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

# the JAX package's --impl names -> the port's routes
IMPLS = {"auto": "auto", "jnp": "reference", "pallas": "kernel",
         "dense": "dense"}
_DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "eval",
                     "data")


def _device(args):
    from effort_tpu_torch.models.transformer import resolve_device
    return resolve_device(args.device)


def _build_engine(args):
    from effort_tpu_torch.models.generate import Engine
    from effort_tpu_torch.runtime.tokenizer import Tokenizer
    device = _device(args)
    tok = Tokenizer(args.tokenizer) if args.tokenizer else None
    if args.ckpt:
        from effort_tpu_torch.models.weights import load_bucketized
        # on the CPU there is no card memory to budget the stored dense
        # copies against: they are loaded whenever present
        w, cfg, _ = load_bucketized(
            args.ckpt, percent_load=args.percent_load, device=device,
            load_dense="auto" if device.type == "cuda" else True)
    else:
        from effort_tpu_torch.config import (BucketConfig, mistral_7b,
                                             tiny_test_model)
        from effort_tpu_torch.models.transformer import init_random_weights
        cfg = tiny_test_model() if args.synthetic == "tiny" else mistral_7b()
        bcfg = BucketConfig(bucket_size=args.bucket_size,
                            chunk_rows=args.chunk_rows, dtype=args.dtype)
        w = init_random_weights(cfg, bcfg, keep_dense=args.keep_dense,
                                fuse=args.fuse, device=device)
    if args.qhead:
        from effort_tpu_torch.models.transformer import quantize_head
        w = quantize_head(w)
    if args.effort_floors:
        import dataclasses
        floors = {}
        for part in args.effort_floors.split(","):
            name, val = part.split("=")
            floors[name.strip()] = float(val)
        cfg = dataclasses.replace(cfg, effort_floors=floors)
    # row-prefix layout: the effort rides in a device buffer at every
    # value, so the REPL's effort knob moves without a new graph
    dyn = w.layers.any_w1.bucket_size == 1
    return Engine(w, cfg, tokenizer=tok, impl=IMPLS[args.impl],
                  dynamic_effort=dyn, device=device), cfg


def _render_reply(r, cfg):
    """Reply -> printable text: tokenizer text when present, raw utf-8
    for byte-vocab models, ids otherwise."""
    if r.text:
        return r.text
    if cfg.vocab_size == 256:
        return bytes(t % 256 for t in r.token_ids).decode(
            "utf-8", errors="replace")
    return r.token_ids


def parse_args(argv=None):
    p = argparse.ArgumentParser(prog="effort-tpu-torch", description=__doc__,
                                formatter_class=argparse.
                                RawDescriptionHelpFormatter)
    p.add_argument("mode", choices=["convert", "generate", "repl", "bucket",
                                    "quiz", "agreement", "kl", "autotune",
                                    # reference run-mode aliases
                                    "playground", "benchmark", "quickstart"])
    p.add_argument("--ckpt", help="bucketized checkpoint dir")
    p.add_argument("--src", help="HF checkpoint dir (convert)")
    p.add_argument("--dst", help="output dir (convert)")
    p.add_argument("--model", default="mistral-7b",
                   choices=["auto", "mistral-7b", "mixtral-8x7b",
                            "llama2-7b", "llama3-8b", "tiny"],
                   help="'auto' (convert only) reads the architecture "
                        "from the HF checkpoint's config.json")
    p.add_argument("--synthetic", nargs="?", const="tiny",
                   choices=["tiny", "mistral-7b"],
                   help="use random weights (tiny|mistral-7b)")
    p.add_argument("--tokenizer", help="tokenizer.json path")
    p.add_argument("--effort", type=float, default=1.0)
    p.add_argument("--effort-floors", default=None,
                   help="per-projection minimum efforts, e.g. "
                        "'wk=0.4,wv=0.4' (quality mitigation at low "
                        "effort)")
    p.add_argument("--percent-load", type=float, default=None)
    p.add_argument("--dtype", default="bf16",
                   choices=["bf16", "int8", "int4"])
    p.add_argument("--bucket-size", type=int, default=4)
    p.add_argument("--chunk-rows", type=int, default=16)
    p.add_argument("--impl", default="auto", choices=list(IMPLS),
                   help="auto, jnp (the reference route), pallas (the "
                        "CUDA kernels) or dense")
    p.add_argument("--keep-dense", action="store_true")
    p.add_argument("--fuse", action="store_true",
                   help="fused q|k|v and w1|w3 projections (one kernel "
                        "launch + one shared selection each)")
    p.add_argument("--qhead", action="store_true",
                   help="int8 LM head for decode (exact top-16 rescore)")
    p.add_argument("--calib", default=None,
                   help="convert: .npz with rms_m/rms_f activation "
                        "calibration -> baked whole-model relayout "
                        "(see convert/calibrate.py)")
    p.add_argument("--prompt", default="How are")
    p.add_argument("--n-tokens", type=int, default=30)
    p.add_argument("--spec-k", type=int, default=0,
                   help="generate: self-speculative decode, k drafted "
                        "tokens per verify round (0 = off); output is "
                        "exactly the effort=1.0 greedy continuation")
    p.add_argument("--draft-effort", type=float, default=0.25,
                   help="draft effort for --spec-k")
    p.add_argument("--temperature", type=float, default=0.0,
                   help="generate: 0 = greedy (reference behavior), "
                        ">0 samples")
    p.add_argument("--top-k", type=int, default=0)
    p.add_argument("--top-p", type=float, default=1.0)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--stream", action="store_true",
                   help="repl: print tokens progressively (chunked "
                        "session decode)")
    p.add_argument("--quiz-file", default=None)
    p.add_argument("--target-agreement", type=float, default=0.8,
                   help="autotune: agreement floor vs the full bf16 "
                        "checkpoint")
    p.add_argument("--hbm-budget-gb", type=float, default=None,
                   help="autotune: restrict candidates to configs "
                        "fitting this weight budget")
    p.add_argument("--device", default=None,
                   help="torch device (default: the card)")
    args = p.parse_args(argv)
    args.mode = {"playground": "bucket", "benchmark": "agreement",
                 "quickstart": "generate"}.get(args.mode, args.mode)
    return args


def _convert(args) -> None:
    from effort_tpu_torch.config import (BucketConfig, llama2_7b, llama3_8b,
                                         mistral_7b, mixtral_8x7b,
                                         tiny_test_model)
    from effort_tpu_torch.convert.convert import (config_from_hf,
                                                  convert_checkpoint)
    if args.model == "auto":
        cfg = config_from_hf(args.src)
    else:
        cfg = {"mistral-7b": mistral_7b(),
               "mixtral-8x7b": mixtral_8x7b(),
               "llama2-7b": llama2_7b(),
               "llama3-8b": llama3_8b(),
               "tiny": tiny_test_model()}[args.model]
    bcfg = BucketConfig(bucket_size=args.bucket_size,
                        chunk_rows=args.chunk_rows, dtype=args.dtype)
    convert_checkpoint(args.src, args.dst, cfg, bcfg, calib=args.calib,
                       fuse=args.fuse, device=_device(args))


def _autotune(args) -> None:
    # one call: checkpoint + target -> measured, chosen operating point
    # (every knob, measured curves, quality scored vs the full bf16
    # control)
    from effort_tpu_torch.models.autotune import auto_tune
    if not args.ckpt:
        raise SystemExit("autotune needs --ckpt (bucketized bf16 dir)")
    budget = (int(args.hbm_budget_gb * 2**30)
              if args.hbm_budget_gb else None)
    res = auto_tune(args.ckpt, target_agreement=args.target_agreement,
                    hbm_budget_bytes=budget, device=_device(args))
    print(json.dumps(res, indent=1, default=float))
    c = res["chosen"]
    if c is None:
        print("# no measured point meets the target; "
              "use full bf16 at effort=1.0", file=sys.stderr)
    else:
        print(f"# chosen: {c['config']} effort={c['effort']} -> "
              f"{c['speedup']}x dense, agreement {c['agreement']}",
              file=sys.stderr)


def main(argv=None):
    args = parse_args(argv)
    if args.mode == "convert":
        _convert(args)
        return
    if args.mode == "bucket":
        _run_bucket_sweep(args)
        return
    if args.mode == "autotune":
        _autotune(args)
        return

    engine, cfg = _build_engine(args)
    tok = engine.tokenizer

    def encode(text):
        if tok is not None:
            from effort_tpu_torch.runtime.tokenizer import (
                mistral_instruct_prompt)
            return tok.encode(mistral_instruct_prompt(text))
        return [1] + [ord(c) % cfg.vocab_size for c in text]

    if args.mode == "generate":
        if args.spec_k > 0:
            r = engine.generate_speculative(
                encode(args.prompt), n_new=args.n_tokens,
                draft_effort=args.draft_effort, k=args.spec_k)
            print(_render_reply(r, cfg))
            print(f"[speculative, draft {args.draft_effort*100:.0f}%: "
                  f"{r.eval_ms_per_token:.2f} ms/token, "
                  f"{r.tokens_per_s:.1f} tok/s, "
                  f"{r.spec_tokens_per_iter:.2f} tok/round]")
            return
        r = engine.generate(encode(args.prompt), n_new=args.n_tokens,
                            effort=args.effort,
                            temperature=args.temperature,
                            top_k=args.top_k, top_p=args.top_p,
                            seed=args.seed)
        print(_render_reply(r, cfg))
        print(f"[effort {args.effort*100:.0f}%: "
              f"{r.eval_ms_per_token:.2f} ms/token, "
              f"{r.tokens_per_s:.1f} tok/s]")
    elif args.mode == "repl":
        _repl(engine, encode, args)
    elif args.mode == "quiz":
        from effort_tpu_torch.eval.harness import load_quiz, run_quiz
        qf = args.quiz_file or os.path.join(_DATA, "quiz.json")
        if tok is None:
            raise SystemExit("quiz needs --tokenizer")
        scores = run_quiz(engine, load_quiz(qf), tok,
                          progress=lambda i, n: print(f"\r{i}/{n}", end=""))
        print()
        for e, s in scores.items():
            print(f"effort {e*100:5.1f}%: accuracy {s*100:5.1f}%")
    elif args.mode == "agreement":
        from effort_tpu_torch.eval.harness import agreement_sweep
        prompt = args.prompt
        if prompt == "How are":   # default: the fixed real-text article
            with open(os.path.join(_DATA, "article.json")) as f:
                prompt = json.load(f)["body"][:600]
        out = agreement_sweep(engine, encode(prompt),
                              n_tokens=args.n_tokens)
        for e, s in out.items():
            print(f"effort {e*100:5.1f}%: agreement {s*100:5.1f}%")
    elif args.mode == "kl":
        from effort_tpu_torch.eval.harness import kl_divergence_sweep
        # generate a full-effort continuation, then measure KL over it
        gen = engine.generate(encode(args.prompt), n_new=args.n_tokens,
                              effort=1.0)
        text_ids = encode(args.prompt) + gen.token_ids
        out = kl_divergence_sweep(engine, text_ids)
        for e, s in out.items():
            print(f"effort {e*100:5.1f}%: KL {s:8.4f} nats")


def _repl(engine, encode, args):
    """Interactive loop, the reference REPL's semantics.

    --stream prints tokens progressively via chunked ChatSession turns
    (each chunk's steps replays of one captured step on the card); the
    default runs the whole generation and prints once."""
    from effort_tpu_torch.models.session import ChatSession
    effort = args.effort
    prev = "Tell me a story."
    session = None
    if args.stream:
        session = ChatSession(engine.w, engine.cfg, impl=engine.impl,
                              tokenizer=engine.tokenizer,
                              device=engine.device)
    print("query, or 0-100 to set effort and re-run, or 'r' to repeat:")
    for line in sys.stdin:
        line = line.strip()
        if not line:
            continue
        if line.isdigit() and 0 <= int(line) <= 100:
            effort = int(line) / 100
            query = prev
        elif line == "r":
            query = prev
        else:
            query = line
        prev = query
        if session is not None:
            session.reset()   # each REPL query is a fresh conversation
            tok = engine.tokenizer
            shown = ""
            all_toks = []
            for chunk in session.turn_stream(encode(query),
                                             n_new=args.n_tokens,
                                             effort=max(effort, 0.01)):
                all_toks.extend(chunk)
                if tok is not None:
                    full = tok.decode(all_toks)
                    print(full[len(shown):], end="", flush=True)
                    shown = full
                else:
                    print(" ".join(str(t) for t in chunk), end=" ",
                          flush=True)
            print(f"\n[effort {effort*100:.0f}%]")
        else:
            r = engine.generate(encode(query), n_new=args.n_tokens,
                                effort=max(effort, 0.01))
            print(_render_reply(r, engine.cfg))
            print(f"[effort {effort*100:.0f}%: "
                  f"{r.tokens_per_s:.1f} tok/s]")
        print("> ", end="", flush=True)


def bucket_inputs(device, in_dim: int = 4096, out_dim: int = 14336):
    """The bucket mode's matrix and vector: wt [in, out] ~ N(0, 0.02^2)
    and v [in] ~ N(0, 1), from seeded torch generators on `device` (seeds
    0 and 1; the same numbers on one device in every process)."""
    import torch
    g = torch.Generator(device=device)
    g.manual_seed(0)
    wt = torch.randn((in_dim, out_dim), generator=g, device=device) * 0.02
    g.manual_seed(1)
    v = torch.randn((in_dim,), generator=g, device=device)
    return wt, v


def _run_bucket_sweep(args):
    from effort_tpu_torch.config import BucketConfig
    from effort_tpu_torch.eval.harness import matrix_quality_sweep
    from effort_tpu_torch.ops.bucketize import bucketize
    device = _device(args)
    wt, v = bucket_inputs(device)
    bcfg = BucketConfig(bucket_size=args.bucket_size,
                        chunk_rows=args.chunk_rows, dtype=args.dtype)
    bm = bucketize(wt, bcfg, keep_dense=True)
    impl = IMPLS[args.impl]
    if impl == "auto":
        impl = "kernel" if device.type == "cuda" else "reference"
    out = matrix_quality_sweep(bm, v, impl=impl, wt_dense=wt)
    for e, s in out.items():
        print(f"effort {e*100:5.1f}%: cos-sim {s:.4f}")


if __name__ == "__main__":
    main()
