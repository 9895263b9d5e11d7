"""Drive the PyTorch port's main path on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Phases, one JSON line each (a failure raises and exits non-zero):
  device    the card's name, count and power limit (nvidia-smi)
  build     nvcc builds every csrc/*.cu of effort_tpu_torch, in parallel
  kernels   K1 (mxu_matvec, csrc/mxu_matvec.cu) against its plain PyTorch
            version at the four fused Mistral-7B projection shapes x
            {bf16, int8, int4} x efforts {0.1, 0.25, 0.5, 1.0} x tau
            {0.97, 1.0}: equal streamed length C, cos >= 0.9999 and
            max|dy| <= 1e-2 max|y_ref|; device times beside the memory
            bound and a dense bf16 torch.mm GEMV of the same shape; at
            int8, tau 0.97 the device time of one call by kernel
            (selection, stream, split sum; the last two, programmatic
            dependents, with their wait behind the launch before)
  kernels_batch
            K2 (mxu_matvec_batch, csrc/mxu_matvec_batch.cu) likewise at
            the four shapes x {bf16, int8, int4} x T in {4, 64} slots x
            tau {0.97, 1.0}, and int8 at tau 0.97 with T in {16, 256}
            (where the bound turns from bytes to operations), per-slot
            efforts 0.1/0.25/0.5/1.0 repeated with the last slot at 0:
            equal C, cos >= 0.9999 per slot, max|dy| <= 1e-2 max|y_ref|;
            times beside the bound (bytes, or bf16 operations where they
            weigh more) and a dense bf16 torch.mm [T, in] @ [in, out];
            at int8, tau 0.97 the device time of one call by kernel
            (selection, stream, split sum)
  attention K3 (flash_attention, csrc/flash_attention.cu) against its plain
            version at Mistral-7B's heads (32 query, 8 KV, 128 wide) over
            a 512-slot cache: left-padded prompts of 32 and 64 queries, 64
            queries at slot 448, a 128-slot window, and a 512-query
            prefill from slot 0; and 64 queries of 256-wide heads (16
            query, 8 KV); then the long prefills: 1984 queries over 2048
            slots, and 4032 over 4096 with Llama-2-7B's heads (32 KV, one
            query head each) and Mistral's; cos >= 0.9999 per row,
            max|dy| <= 1e-4
            max|y_ref| (pv_f32, as forward_seq calls it), queries with no
            live key exactly 0; times beside the bound and torch's SDPA
            with the same boolean mask (timed only, never called by the
            port)
  k3_device_slots
            K3 with start_slot and mask_from as 0-d int32 CUDA tensors,
            read on the card, against the int call: T in {4, 8, 64} x
            start slots {0, 37, 448} and a 128-slot window, Mistral-7B
            heads, y bit for bit; ms of both forms
  decode_attention
            K8 (decode_attention, csrc/decode_attention.cu) against its
            plain version (attn_core on the widened caches) at the main
            paths' shapes: Mistral-7B chat (1 slot, 2048 slots of cache,
            position 1024), 16 serving slots (2048, ragged positions and
            left pads, about 17% of the cache live, as the serve mix) and
            Llama-2-7B's MHA (1 slot, 4096, position 2048): max|dy| <=
            K8_TOL max|y_ref|; times beside the bound (the live rows'
            bytes), the plain version and torch's SDPA with the same
            boolean mask (timed only, never called by the port)
  kernels_llama
            K1 and K2 alone at Llama-2-7B's four fused projections (wqkv
            4096->12288, wo 4096->4096, w13 4096->22016, w2 11008->4096:
            43 chunks of 256 rows, 3669 probes), int8, efforts 0.25 and
            1.0, K2 at T = 4 and 64: against their plain versions (equal
            C, cos >= 0.9999 a slot, max|dy| <= 1e-2 max|y_ref|), ms
            beside the bound, the plain version and torch.mm
  generate  Mistral-7B width, 32 layers, int8 row-prefix buckets, fused
            projections, int8 LM head: Engine.generate answers four
            requests at efforts 0.25 and 0.5 (K1) and 1.0 (dense copies),
            through the captured steps (each decode step one replayed CUDA
            graph, Engine's default on the card) and the eager ones
            (capture=False): the same tokens; K1's launch count must be
            4 * 32 per decode step, K8's 32, K2's and K3's 0, on both
  profile   device time by kernel over one request, and the card's busy
            share of that request's wall time, graph and eager
  teacher   logits of the kernel route against the route through K1's
            plain version over one reply's tokens at tau = 1, both reading
            the same history: cos >= 0.999 at every step at depth 4;
            depth 32 (over the first 13 steps), and the reference route,
            are printed only
  prefill   the same model, Engine(prefill=True): the four prompts at
            efforts 0.25, 0.5 and 1.0; time to first token and decode ms
            per token; per call K3 must run 32 times, K2 4 * 32 times
            below effort 1 (0 at 1: dense copies) and K1 4 * 32 times a
            decode step below effort 1; beside it the token-loop engine's
            time to first token on the same prompts; then device time by
            kernel over one prefill call (64 tokens, effort 0.25)
  prefill_teacher
            forward_seq at tau = 1 over a left-padded prompt: the kernel
            route (K2, K3) against the plain route, and dense forward_seq
            against dense forward_token steps, cos >= 0.999 at every
            position at depth 4; depth 32 printed only, beside two
            witnesses: at each of the 32 layers K2 and K3 against their
            plain versions on the inputs the kernel route gave them (cos
            >= 0.9999, equal C), and the plain route against itself with
            the attention-norm weights moved by a relative 2^-20 (printed)
  serve     BatchEngine(batch_size=4) + ContinuousBatcher: 8 requests
            (prompts of 5 to 64 tokens, efforts 0.25/0.5/1.0, 32 new
            tokens each) through 4 slots; aggregate tokens/s; K2 must run
            4 * 32 times a decode step and an admission, K3 32 times an
            admission, K1 never. Then device time by kernel over four
            8-token requests, one batched step against the
            single-stream K1 route at depth 4, tau = 1 (cos >= 0.999 per
            slot), and make_batch_server on 127.0.0.1 answering four
            concurrent /q, one stream=1 and one /v1/completions
  graph     the captured step against the eager one at full width and
            depth, efforts 0.25 and 1.0: teacher-forced logits of 64
            positions bit for bit (or within the eager route's own spread,
            measured first), one whole generation's launches under
            set_sync_debug_mode("error") (no host read before its end),
            equal tokens and launch counts; also on the rank-prefix
            (rank_graph) and MoE (moe_graph) models
  batch_graph
            BatchEngine's captured step against its eager step in lockstep
            over 8 steps of 4 slots: logits bit for bit, equal launches,
            one replay under set_sync_debug_mode("error"); also on the MoE
            model (moe_batch_graph: per-slot K1)
  sampling  same seed, same tokens; temperature 0, top_k 1 and top_p 1e-9
            are greedy; new sampling and penalty values capture no graph;
            10 000 draws of _pick_token within 0.02 total variation of the
            truncated softmax
  session   ChatSession on the same model: three turns (17, 5 and 32
            prompt tokens, 16 new each) at efforts 0.25 and 1.0, each
            turn's steps replays of one captured step; turns 2 and 3 give
            Engine.generate's tokens on the concatenated history; a
            capture=False session the same tokens; turn 2 launched under
            set_sync_debug_mode("error") (its one host read after); saved
            after turn 2 and loaded, turn 3 again; turn_stream's chunks
            joined equal turn 1; K1 4 * 32 times a step below effort 1;
            ms a step of turn 3 beside Engine.generate's on the same tokens
  eval      the eval harness on the same model over a 48-token history:
            agreement_sweep and kl_divergence_sweep over effort_scale()
            (100% agreement and KL <= 1e-6 at 1.0), decode_speed_sweep at
            1.0, 0.5 and 0.25 with dense beside `generate`'s ms a token,
            streamed_fraction at 0.5 and 0.25 with each probed chunk prefix
            beside the C K1 streams on the same input (within one chunk),
            golden states at 1.0 (passed, no drift) and at 0.25 on the
            kernel route (drift printed), one sweep (nll_sweep over 4
            tokens at 0.25) under profiling.trace() (its Chrome trace in
            the output directory's eval_trace/)
  spec      Engine.generate_speculative on the KV-cache phases' model
            (Mistral-7B, 32 layers, uncalibrated, dense copies): prompt of
            32, 64 new tokens, k in {4, 8} x draft efforts {0.25, 0.5,
            1.0}; tokens a round, ms a token, host reads a round, beside
            the captured greedy decode at 1.0. Gates: its tokens (a first
            divergence only at a near tie: the spec token the reference's
            runner-up, their gap within the largest difference of the
            decode step's logits (K8) from forward_seq's (K3) teacher-
            forced over the same tokens; the same difference over every
            position with the plain attention forced printed beside it,
            spec_route_witness); at draft 1.0 at least k - 1 tokens a
            round; one status read a round; exact launches; a
            generation's rounds replayed bit for bit against eager ones;
            one round under set_sync_debug_mode("error")
  batch_spec
            BatchEngine(batch_size=4, spec_k=4) on the same model, the 8
            serving requests at mixed efforts: ms and tokens a step; at
            tau = 1 the requests at effort 1.0 give plain batched decode's
            tokens (near-tie rule as spec's); every first divergence
            printed, at tau = 1 and at the default tau (where K2's prefix,
            the longest of its rows', depends on which rows share the
            launch)
  int8_kv   the int8 KV cache: under 0.6x the bf16 cache's bytes; its
            attention read against the bf16 cache's on the same inputs
            at every layer and position (128 teacher-forced, depth 32,
            effort 1.0), cos >= 0.999; end-to-end logits at 1.0 and 0.25
            printed beside their noise floors (int8_kv's docstring);
            BatchEngine(kv_dtype="int8") serves the 8 requests in 4 slots
            with exact launch counts
  ring_kv   the ring KV cache (4096 slots, RING_LAYERS = 4 layers): 4160
            teacher-forced positions against a full cache of max_seq_len
            4224, cos >= 0.999 at every position >= 4096 at effort 1.0
            (0.25 printed)
  long_ctx  after `eval`, the same weights at Mistral-7B's default
            max_seq_len of 2048 (nothing rebuilt: the caches follow the
            config): Engine(prefill=True) on a seeded 1984-token prompt, 64
            new tokens (to the last slot) at efforts 0.25 and 1.0 (dense):
            time to first token and decode ms a token at positions
            1984-2047, beside the 512-slot cells' (exact launches as in
            `prefill`); device time by kernel over one 8-token request of
            the token loop at 2048 slots (the copies: _attention widens
            the whole cache to f32 every step, beside its bytes at the
            card's rate); at depth 32 every K1 call of two decode steps
            and every K2 (T = 1984) and K3 (1984 queries, four query heads
            a KV head) call of the prompt's prefill against their plain
            versions on the same inputs (cos >= 0.9999, equal C); at
            depth 4 and tau = 1 the kernel route's prefill logits against
            the plain route's (seq_teacher): the prompt's last 32
            positions on one history the kernel route wrote, cos >= 0.999
            at each at effort 1.0 through K2 (not the dense copies); the
            whole prompt in one pass, and 0.25, printed beside the plain
            route against itself nudged by 2^-20; BatchEngine(batch_size=4)
            serving four requests with prompts of 500 to 1900 tokens at
            mixed efforts, 16 new tokens each, its step one graph, exact
            launches; peak GiB
  llama2, llama3
            after `parallel`, llama2_7b(n_layers=32) (MHA: 32 KV heads, FFN
            11008, theta 1e4) and then llama3_8b(n_layers=32) (vocabulary
            128256, theta 5e5), each at its max_seq_len of 4096, with the
            main model's recipe (int8 row-prefix, chunk_rows 128, fused
            wqkv and w13, int8 head, dense copies, random calibrated
            weights from seed 0); each freed after its phase. Decode: the
            captured steps at 0.25, 0.5 and 1.0 from prompts of 5 and 17
            tokens, 32 new (CUDA events; K1 4 a layer a step below 1.0, 0
            at 1.0), one 8-token eager request at 0.25 whose tokens are the
            graph's; device time by kernel over one request at 4096 slots
            (the copies beside the widening's bytes); prefill: a 4032-token
            prompt with 32 new tokens at 0.25 and 1.0 (time to first
            token, exact launches); at depth 32 every K1 call of two decode
            steps and every K2 (T = 4032) and K3 (4032 queries over 4096
            slots: one query head a KV head for llama2, four for llama3)
            call of that prefill against their plain versions on the same
            inputs; the depth-4 teacher as in `long_ctx`; serving as in
            `serve` (8 requests in 4 slots, the step a captured graph,
            exact launches; make_batch_server over HTTP); peak GiB
  llama3_ckpt
            a random HF-format Llama-3-8B checkpoint (Meta-Llama-3-8B's
            published config.json, LLAMA3_CKPT_LAYERS = 2 of 32 layers,
            bf16, seeded), converted on the card by `python3 -m
            effort_tpu_torch convert --model auto` (int8 row-prefix, fused;
            one subprocess, started once llama3's timed parts are done and
            run beside its gates); config_from_hf gives llama3_8b's fields at
            that depth, its name aside; load_bucketized loads it;
            build_server (single flight, no tokenizer) answers four /q,
            each reply's tokens those of an Engine in this process on the
            same loaded weights
  ckpt      the row-prefix model freed: a random HF-format Mistral-7B
            checkpoint (HF_MISTRAL: full width, CKPT_LAYERS deep, bf16,
            seeded) written to a temporary directory; config_from_hf;
            convert_checkpoint on the card (int8 row-prefix, fused,
            calibrated with seeded rms, dense copies stored), its seconds
            and GB/s; load_bucketized onto the card, its seconds. Gate 1:
            layer 0's four projections converted again on the CPU, vals,
            pos, probes and dense copies byte for byte, stats and scales
            within 1e-6 relative. Gate 2: the loaded model against
            assemble_weights on the same raw arrays and calibration (the
            fields that differ printed): the same greedy tokens for 3
            prompts x 16 tokens at efforts 0.25/0.5/1.0 and teacher-forced
            logits cos >= 0.9999; decode ms a token of both. Gate 3: K1,
            K2 and K3 against their plain versions on the loaded model's
            own inputs. build_server(--ckpt, --tokenizer, --batch 4 and
            0) answering four /q with decoded text (a BPE tokenizer.json
            the phase writes); which IO paths ran (native or Python)
  cli       inside `ckpt`, on its converted checkpoint and tokenizer, each
            mode a `python3 -m effort_tpu_torch` subprocess exiting 0 (the
            first nine at once): generate at 0.25, generate --spec-k 4,
            repl --stream fed "Hello", "25", "r", quiz on a 3-item file,
            agreement and kl (--n-tokens 16), bucket at B = 1 int8 (K1)
            and at its defaults (K4), convert to bf16; then autotune on
            that with the int8 conversion as its ckpt_int8 sibling and a
            seeded corpus.npy. Gates: the line formats, 100% agreement and
            0 KL at 100% effort, bucket's cos within 1e-3 of the same
            sweep in process on the kernels' plain versions (the reference
            route printed beside), autotune's 12 points, its bf16
            control agreeing with itself at 1.0 and one candidate's
            agreements within one hold-out token of the same sweep in
            process; the subprocesses' launches are not counted
  train     the row-prefix model freed: the trainer
            (effort_tpu_torch/train) on wordlm-500m, the repository's
            trained configuration (Mistral-7B's matrices, 2 layers, a
            word vocabulary of 8192 built from about 8 MB of the
            repository's and the standard library's text); its f32 loss
            and gradient norm on one 64-token row against float64 on the
            card (LOSS_RTOL); one whole chunk (25 steps) under
            set_sync_debug_mode("error"); ms a step, tokens/s and the FLOP
            share in f32 and with TF32 products; then train() (batch 8 x
            512, lr 3e-4, warmup 30, chunks of 25) for about
            TRAIN_SECONDS: at least 100 steps, the holdout loss falling to
            below ln 8192 - 2, every parameter and moment finite. Its
            export (export_hf) calibrated (collect_act_rms), converted on
            the card (row-prefix, B = 1, chunk_rows 128, bf16) and loaded:
            the trainer's logits against the captured decode step's (K1,
            tau = 1) at effort 1.0 over 8 holdout tokens, cos > 0.999 and
            the same argmax beyond a 0.05 margin; one prefill request (K2,
            K3); agreement, NLL (500 holdout tokens), streamed fraction and
            decode ms a token at 1.0 / 0.5 / 0.25, printed. Then
            Mixtral-8x7B at 1 layer (all experts dense): the f64 gate, 4
            steps at batch 2 x 512, ms a step, the aux term (finite, >= 0)
            and the peak memory
  parallel  the card empty (after `train`): K1 alone at the shard shapes of
            Mistral-7B at tp = 4 (wq 4096->1024, wk/wv ->256, wo
            1024->4096, w1/w3 ->3584, w2 3584->4096, head ->8000; int8,
            efforts 0.25 and 1.0) against its plain version, timed beside
            its bound and torch.mm; then PAR_WORLD = 4 ranks, one process
            each (effort_tpu_torch.parallel.multihost.spawn; NCCL where
            each rank has a card, else gloo, which moves CUDA tensors
            through host memory), each building its own shard from the
            seed-0 draws (int8 row-prefix, chunk_rows 128, unfused,
            uncalibrated; 4 of 32 layers, full width) and decoding in six
            modes: tp 4 and pp 4 (4 microbatches, prompts 5/17/32/64, 8
            new) on Mistral-7B, sp 4 and tp 2 x sp 2 on Mistral-7B at
            max_seq_len 8192 (4600 seeded cache slots, 16 steps, window
            4096), ep 4 and tp 2 x ep 2 on Mixtral-8x7B (plus ep_ffn_tokens
            over 64 tokens a rank at capacity 1.25, and with every token
            routed to rank 0's experts); prompt 17 and 16 new at efforts
            1.0 and 0.25. Gates: (a) every K1 call of one step against its
            plain version on each rank's own inputs; (b) the effort-1.0
            logits against the single-device model (same draws, same
            bucketize) teacher-forced over the same tokens, cos >= 0.999
            (tp, tp x ep, tp x sp) or 0.9999 (sp, ep, pp), the ranks'
            experts the model's own at every route call (the int8 tp x ep
            run: at most PAR_ROUTES_APART of them apart), and the ep
            tokens' outputs (0.9999) and drops (exact); (c) the 0.25
            tokens printed; (d) each rank's exact K1 launches. Host ms a
            step (labelled with the backend and ranks a card), peak GiB a
            rank
  kernels_rank
            K4 (fused_matvec, csrc/fused_matvec.cu) and K5 (stream_matvec,
            csrc/stream_matvec.cu) against their plain versions at the four
            shapes x {bf16, int8, int4} x efforts {0.1, 0.25, 0.5} x tau
            {0.97, 1.0}, rank-prefix buckets B = 4, G = 16: equal C_k per
            rank, cos >= 0.9999, max|dy| <= 1e-2 max|y_ref|, and y equal
            bit for bit (the plain versions add in the kernels' order); K5
            on K4's own selection equals K4 to 1e-5; at int8, effort 0.25,
            tau 0.97 the device time of one K4 call by kernel (selection,
            stream, split sum); K6 (gather_matvec_dma, csrc/gather_dma.cu)
            and K7 (gather_bucket_matvec, csrc/gather_mul.cu) likewise at
            {bf16, int8} x the efforts at the gather route's capacity, y
            bit for bit and K7 equal to K6; times beside the bound and the
            dense bf16 torch.mm GEMV (K6's and K7's `kernels` entries also
            give each projection's ms)
  rank_decode
            the row-prefix model freed, Mistral-7B width and depth with int8
            rank-prefix buckets (B = 4, G = 16), fused projections, int8 LM
            head, no dense copies: Engine.generate on the four prompts at
            efforts 0.25, 0.5 and 1.0 through "auto" (K4 only, 4 * 32
            launches a step), a few tokens through "stream" (K5 only) and
            "gather" (K6 only) at 8-slot padding, and the "gather" route's
            device time by kernel over two tokens; device time by kernel
            over one request ("auto", graph and eager; decode eager at
            0.25 only, with the graph's tokens);
            every layer's K4 call against its plain version on the same
            inputs at depth 32 (cos >= 0.9999, equal C_k); the kernel route
            against the plain route at tau = 1, depth 4, over a prompt and
            8 reply tokens (cos >= 0.999); and
            make_server (single flight) answering /q on this model
  instances K1 at the Mixtral-8x7B expert shapes (w13, w2) x {bf16, int8,
            int4} and K4 at the four shapes (int8), on containers of 3
            instances: each instance as an int and as a 0-d int32 CUDA
            tensor (read by the kernel), y, C (C_k) and u bit for bit
  moe_model the rank-prefix model freed, Mixtral-8x7B width and depth (32
            layers, 8 experts, top 2), int8 row-prefix buckets, fused
            projections, int8 LM head, no dense copies
  moe_decode
            Engine.generate on the four prompts at efforts 0.25, 0.5 and
            1.0, graph (and eager at 0.25, the same tokens): K1 6 * 32
            times a step
            (wqkv, wo, w13 and w2 of the two routed experts, whose
            instance the kernel reads on the card) and no other kernel;
            one step under torch.cuda.set_sync_debug_mode("error")
  moe_profile
            device time by kernel over one request (39 steps, efforts 0.25
            and 0.5, graph and eager), the busy share, K1's parts, the
            gate's and the top-k's
  moe_teacher
            the kernel route against the plain route at tau = 1, depth 4:
            cos >= 0.999 and the same top-2 experts at every layer and
            step; at depth 32 every K1 call against its plain version on
            the same inputs and instance (cos >= 0.9999, equal C)
  moe_prefill
            Engine(prefill=True): time to first token; per pass K3 32
            times, K2 2 + 2 g_l times a layer (g_l experts with tokens),
            one host read of the routing a layer; prefill logits against
            the token loop's at depth 4, printed (with the token loop's
            experts and f32 attention, through K3, with its own routing,
            beside the token loop against itself nudged by 2^-20); at
            depth 32, required, every K2 and K3 call against its plain
            version and every layer's grouped MoE FFN against the
            per-token one (K1) on the same inputs (cos >= 0.9999)
  moe_serve BatchEngine(batch_size=4) + ContinuousBatcher, 8 requests:
            tokens/s, exact launch counts, the batched MoE FFN slot by slot
            (K1) and grouped by expert (K2) timed in turns, a batched step
            against the single stream at depth 4 (cos >= 0.999),
            make_batch_server and make_server answering HTTP
  moe_spec  speculative decode on the MoE model, one request, k = 4, drafts
            at 0.25: tokens a round, ms, one status read a round and no
            routing read, exact launches (the verify's experts through
            K1), graph against eager; its tokens against the MoE greedy
            at 1.0 gated at depth 4, tau = 1 (printed at depth 32)
  moe_rank  the row-prefix MoE model freed, Mixtral-8x7B width and depth
            with int8 rank-prefix buckets: "auto" decode (K4, 6 * 32
            launches a step, the instance read on the card), one step
            under set_sync_debug_mode("error"), every K4 call against its
            plain version on the same inputs at depth 32, and the kernel
            route against the plain route at depth 4 (as moe_teacher)
The phases' seconds are printed (`phase_seconds`, with the four of
long_ctx, llama2, llama3 and llama3_ckpt summed as `new_phases`).
Then the `kernels` summary line, the card's nvidia-smi line, and last
{"ok": true, "device": {...}}. The full per-point table is written to
chiprun_out/chip_smoke.json. float32 matmuls run in full f32 (TF32 off).
"""

from __future__ import annotations

import dataclasses
import gc
import json
import math
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

from effort_tpu_torch import cli
from effort_tpu_torch.config import (BucketConfig, ModelConfig, llama2_7b,
                                     llama3_8b, mistral_7b, mixtral_8x7b)
from effort_tpu_torch.convert.calibrate import collect_act_rms
from effort_tpu_torch.convert.convert import (HF_NAME_MAPS,
                                              _bucketize_and_store,
                                              config_from_hf,
                                              convert_checkpoint)
from effort_tpu_torch.kernels import LAUNCHES, _build, reset_launches
from effort_tpu_torch.kernels import (fused_stream, gather_dma, gather_mul,
                                      prefix_stream)
from effort_tpu_torch.kernels.decode_attention import (attn_core,
                                                      decode_attention,
                                                      decode_plan)
from effort_tpu_torch.kernels.flash_attention import flash_attention_seq
from effort_tpu_torch.eval import harness
from effort_tpu_torch.models import tester, transformer
from effort_tpu_torch.models.generate import Engine, _pick_token
from effort_tpu_torch.models.session import ChatSession
from effort_tpu_torch.ops import bucketmul
from effort_tpu_torch.models.transformer import (HOST_READS, _attention,
                                                 assemble_weights, embed,
                                                 forward_layers,
                                                 forward_seq, forward_token,
                                                 forward_token_batch,
                                                 head_logits,
                                                 init_random_weights,
                                                 make_kv_cache,
                                                 make_quant_kv_cache,
                                                 quant_kv_hooks,
                                                 quantize_head, rms_norm,
                                                 write_row)
from effort_tpu_torch.ops.bucketize import (bucketize, calib_row_order,
                                            pick_chunk_rows)
from effort_tpu_torch.ops.bucketmul import dense_matvec
from effort_tpu_torch.ops.effort import effort_q16, select_blocks
from effort_tpu_torch.parallel import _ranks, multihost, tp
from effort_tpu_torch.parallel.ep import expert_capacity
from effort_tpu_torch.models.weights import attach_dense, load_bucketized
from effort_tpu_torch.runtime._native_build import native_lib_path
from effort_tpu_torch.runtime.safetensors_io import (MultiShardReader,
                                                     SafeTensorWriter)
from effort_tpu_torch.serving.batcher import BatchEngine, ContinuousBatcher
from effort_tpu_torch.serving.server import (build_server, make_batch_server,
                                             make_server, parse_args)
from effort_tpu_torch.runtime.word_tokenizer import (N_BYTE, PIECE_RE,
                                                     WordTokenizer)
from effort_tpu_torch.train import (TrainConfig, export_hf, init_params,
                                    next_token_loss, train)
from effort_tpu_torch.train.optim import adamw_init, global_norm
from effort_tpu_torch.train.trainer import forward as train_forward
from effort_tpu_torch.train.trainer import leaves as train_leaves
from effort_tpu_torch.train.trainer import params_to_raw, run_chunk
from effort_tpu_torch.utils import profiling
from effort_tpu_torch.utils.timing import gpu_ms

HBM_BYTES_PER_S = 3.35e12          # H100 SXM data sheet
BF16_FLOPS = 989e12                # dense bf16 tensor-core peak, same sheet
SHAPES = {"wqkv": (4096, 6144), "wo": (4096, 4096),
          "w13": (4096, 28672), "w2": (14336, 4096)}
DTYPES = ("bf16", "int8", "int4")
EFFORTS = (0.1, 0.25, 0.5, 1.0)
TAUS = (0.97, 1.0)
RUNS = 20
PLAIN_RUNS = 3                     # K4-K7's plain versions, timed only
# the teacher phase's printed depth-32 witness runs over the first steps
# only (a 5-token prompt and 8 reply tokens), to keep the run's time
DEEP_TEACHER_STEPS = 13
# K2's points: (T, value kinds, taus); T = 4 batched decode slots, 64
# prefill tokens, 16 and 256 either side of where the bound turns from
# bytes to operations
BATCH_CASES = ((4, DTYPES, TAUS), (64, DTYPES, TAUS), (16, ("int8",), (0.97,)),
               (256, ("int8",), (0.97,)))
# K3's cases: Mistral-7B's heads (H 32, KV 8, D 128) over ATTN_SLOTS cache
# slots unless a case names others
ATTN_SLOTS = 512
# K3's gate under pv_f32: max|dy| <= PV_F32_TOL max|y_ref| against its plain
# version (besides min row cos >= 0.9999 and dead rows exactly 0)
PV_F32_TOL = 1e-4
ATTN_CASES = (
    dict(name="prefill32", T=32, start_slot=0, mask_from=27, window=0),
    dict(name="prefill64", T=64, start_slot=0, mask_from=47, window=0),
    dict(name="chunk64_at448", T=64, start_slot=448, mask_from=0, window=0),
    dict(name="window128", T=64, start_slot=448, mask_from=0, window=128),
    dict(name="prefill512", T=512, start_slot=0, mask_from=0, window=0),
    dict(name="d256", T=64, start_slot=0, mask_from=0, window=0, H=16, KV=8,
         D=256),
    # the long_ctx, llama2 and llama3 prefills: Mistral-7B's 1984-token
    # prompt in its default 2048 slots; Llama-2-7B's (MHA: 32 KV heads, a
    # query head each) and Llama-3-8B's 4032-token prompts in 4096 slots
    dict(name="prefill1984_s2048", T=1984, start_slot=0, mask_from=0,
         window=0, S=2048),
    dict(name="prefill4032_s4096_mha", T=4032, start_slot=0, mask_from=0,
         window=0, S=4096, KV=32),
    dict(name="prefill4032_s4096", T=4032, start_slot=0, mask_from=0,
         window=0, S=4096),
)
# K8's cases: one query token a slot against B slots of an S-slot bf16
# cache; "pos" the slots' positions ("serve": 16 ragged positions from 40
# to 660 with left pads of up to 30, about 17% of the cache live)
DECODE_CASES = (
    dict(name="chat", B=1, S=2048, KV=8, rep=4, D=128, pos=[1024]),
    dict(name="serve", B=16, S=2048, KV=8, rep=4, D=128, pos="serve"),
    dict(name="llama2", B=1, S=4096, KV=32, rep=1, D=128, pos=[2048]),
)
# K8 against its plain version: max|dy| <= K8_TOL max|y_ref| (f32 sums in
# other orders; as K3's PV_F32_TOL)
K8_TOL = 1e-4
SUMMARY_DECODE = "chat"
# the summary line's times: one layer's four launches of the generate
# phase's layout (int8) at effort 0.25 and the default tau
SUMMARY = ("int8", 0.25, 0.97)
# K2's: one prefill layer's four launches (int8, T = 64, default tau), and
# beside it one batched decode step's (T = 4, the "_t4" keys); K3's: one
# prefill call at T = 64
SUMMARY_BATCH = ("int8", 64, 0.97)
SUMMARY_BATCH_T4 = ("int8", 4, 0.97)
PROFILE_CALLS = 5
SUMMARY_ATTN = "prefill64"
# rank-prefix buckets of the K4-K7 points and the rank_decode model
RANK_BUCKETS = dict(bucket_size=4, chunk_rows=16)
RANK_EFFORTS = (0.1, 0.25, 0.5)
# K4's and K5's summary: one decode layer's four launches (int8, effort
# 0.25, default tau); K6's and K7's: the same at effort 0.25
SUMMARY_RANK = ("int8", 0.25, 0.97)
PROMPT_LENS = (5, 17, 32, 64)
N_NEW = 32
# the MoE cells: decode efforts, and K1 / K4 launches a layer a step (wqkv,
# wo, and w13 and w2 of the two routed experts)
MOE_EFFORTS = (0.25, 0.5, 1.0)
MOE_PER_LAYER = 6
OUT_DIR = Path(__file__).resolve().parent / "chiprun_out"


def emit(obj: dict) -> None:
    print(json.dumps(obj), flush=True)


def cos(a: torch.Tensor, b: torch.Tensor) -> float:
    return float(torch.nn.functional.cosine_similarity(
        a.double(), b.double(), dim=0))


def median(xs):
    xs = sorted(xs)
    return xs[len(xs) // 2]


def padded(n: int, pad_to: int = 32) -> int:
    return max(pad_to, -(-n // pad_to) * pad_to)


def phase_device() -> tuple:
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
        timeout=60).stdout.strip().splitlines()[0]
    emit({"phase": "device", "name": name,
          "count": torch.cuda.device_count(), "nvidia_smi": smi,
          "torch": torch.__version__, "cuda": torch.version.cuda})
    print(smi, flush=True)
    return name, smi


def phase_build() -> None:
    t0 = time.perf_counter()
    built = _build.build_all()
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "built": sorted(built), "libraries": {
              k: str(p.relative_to(p.parents[2]))
              for k, p in _build.library_paths().items()}})


def k1_bytes(bm, C: int) -> int:
    """Bytes K1 must move: the streamed prefix of the values, v, probes,
    stats and scales once each, y written once."""
    row_bytes = bm.vals.shape[2] * bm.vals.element_size()
    streamed = C * bm.chunk_rows * row_bytes
    per_row = 4 * (2 + (bm.scales is not None))       # v, stats, scales
    return (streamed + bm.in_dim * per_row + bm.probes.shape[1] * 4
            + bm.n_buckets * 4)


def phase_kernels(flush: torch.Tensor) -> list:
    g = torch.Generator(device="cuda")
    g.manual_seed(1234)
    points = []
    inst0 = torch.zeros((), dtype=torch.int32, device="cuda")
    for name, (i, o) in SHAPES.items():
        rms = torch.exp(torch.randn(i, generator=g, device="cuda") * 1.2)
        pi = calib_row_order(rms)
        wt = torch.randn((i, o), generator=g, device="cuda") * 0.02
        dense = wt[pi.long()].to(torch.bfloat16)
        vs = [rms[pi.long()] * torch.randn(i, generator=g, device="cuda")
              for _ in range(RUNS)]
        vb = [v.to(torch.bfloat16)[None] for v in vs]
        lib_ms = median([gpu_ms(lambda a: torch.mm(a, dense), (a,), flush)
                         for a in vb])
        del dense
        for dtype in DTYPES:
            bc = BucketConfig(bucket_size=1, chunk_rows=128, dtype=dtype)
            bc = dataclasses.replace(bc, chunk_rows=pick_chunk_rows(bc, i, o))
            bm = bucketize(wt, bc, in_perm=pi)
            for effort in EFFORTS:
                eq = effort_q16(effort, "cuda")
                for tau in TAUS:
                    y, C = fused_stream.mxu_matvec(bm, vs[0], eq, 0, tau=tau,
                                                   return_len=True)
                    yr, Cr = fused_stream.mxu_matvec_ref(
                        bm, vs[0], eq, 0, tau=tau, return_len=True)
                    torch.cuda.synchronize()
                    C, Cr = int(C), int(Cr)
                    err = float((y - yr).abs().max())
                    scale = float(yr.abs().max())
                    c = cos(y, yr)
                    p = dict(shape=name, in_dim=i, out_dim=o, dtype=dtype,
                             chunk_rows=bm.chunk_rows, n_chunks=bm.n_chunks,
                             effort=effort, tau=tau, C=C, C_plain=Cr,
                             cos=c, max_abs_err=err, max_abs_ref=scale)
                    if C != Cr or not c >= 0.9999 or not err <= 1e-2 * scale:
                        raise AssertionError(f"K1 disagrees with its plain "
                                             f"version: {p}")
                    p["ms"] = median([gpu_ms(
                        lambda v: fused_stream.mxu_matvec(bm, v, eq, 0,
                                                          tau=tau),
                        (v,), flush) for v in vs])
                    p["plain_ms"] = median([gpu_ms(
                        lambda v: fused_stream.mxu_matvec_ref(bm, v, eq, 0,
                                                              tau=tau),
                        (v,), flush) for v in vs])
                    p["bytes"] = k1_bytes(bm, C)
                    p["bound_ms"] = p["bytes"] / HBM_BYTES_PER_S * 1e3
                    p["library_ms"] = lib_ms
                    if (dtype, effort, tau) == SUMMARY:
                        # the instance as a 0-d int32 on the card, which
                        # the kernel reads there (the routed MoE form)
                        p["ms_device_instance"] = median([gpu_ms(
                            lambda v: fused_stream.mxu_matvec(
                                bm, v, eq, inst0, tau=tau),
                            (v,), flush) for v in vs])
                        # where a call's device time goes, as for K2
                        prof = device_profile(lambda: [
                            fused_stream.mxu_matvec(bm, v, eq, 0, tau=tau)
                            for v in vs[:PROFILE_CALLS]],
                            need=K1_PARTS)["kernel_ms"]
                        p["parts_ms"] = per_call(prof, PROFILE_CALLS)
                    points.append(p)
                    emit({"phase": "kernels", **p})
            del bm
        del wt, vs, vb
        torch.cuda.empty_cache()
    return points


def k2_bytes(bm, C: int, T: int) -> int:
    """Bytes K2 must move: the streamed prefix once (shared by the T
    slots), V, probes, stats and scales once each, Y written once."""
    row_bytes = bm.vals.shape[2] * bm.vals.element_size()
    per_row = 4 * (1 + (bm.scales is not None)) + 4 * T   # stats, scales, V
    return (C * bm.chunk_rows * row_bytes + bm.in_dim * per_row
            + bm.probes.shape[1] * 4 + T * bm.n_buckets * 4)


def batch_efforts(T: int) -> torch.Tensor:
    """0.1 / 0.25 / 0.5 / 1.0 repeated over the slots, the last slot at 0."""
    e = [EFFORTS[t % len(EFFORTS)] for t in range(T)]
    e[-1] = 0.0
    return torch.tensor(e, dtype=torch.float32, device="cuda")


def rows_agree(y: torch.Tensor, yr: torch.Tensor) -> float:
    """The least cosine over rows; a row that is 0 in the plain version
    must be exactly 0 in the kernel's output (counted as cosine 1)."""
    worst = 1.0
    for a, b in zip(y, yr):
        if not bool(b.any()):
            if bool(a.any()):
                return 0.0
            continue
        worst = min(worst, cos(a, b))
    return worst


def phase_kernels_batch(flush: torch.Tensor) -> list:
    """K2 against its plain version at BATCH_CASES over the four fused
    projections, with mixed per-slot efforts."""
    g = torch.Generator(device="cuda")
    g.manual_seed(4321)
    points = []
    for name, (i, o) in SHAPES.items():
        rms = torch.exp(torch.randn(i, generator=g, device="cuda") * 1.2)
        pi = calib_row_order(rms)
        wt = torch.randn((i, o), generator=g, device="cuda") * 0.02
        dense = wt[pi.long()].to(torch.bfloat16)
        Ts = [case[0] for case in BATCH_CASES]
        Vs = {T: [rms[pi.long()] * torch.randn((T, i), generator=g,
                                               device="cuda")
                  for _ in range(RUNS)] for T in Ts}
        lib_ms = {T: median([gpu_ms(lambda a: torch.mm(a, dense),
                                    (V.to(torch.bfloat16),), flush)
                             for V in Vs[T]]) for T in Ts}
        del dense
        for dtype in DTYPES:
            bc = BucketConfig(bucket_size=1, chunk_rows=128, dtype=dtype)
            bc = dataclasses.replace(bc, chunk_rows=pick_chunk_rows(bc, i, o))
            bm = bucketize(wt, bc, in_perm=pi)
            for T, dtypes, taus in BATCH_CASES:
                if dtype not in dtypes:
                    continue
                eff = batch_efforts(T)
                for tau in taus:
                    V = Vs[T][0]
                    y, C = fused_stream.mxu_matvec_batch(
                        bm, V, eff, 0, tau=tau, return_len=True)
                    yr, Cr = fused_stream.mxu_matvec_batch_ref(
                        bm, V, eff, 0, tau=tau, return_len=True)
                    torch.cuda.synchronize()
                    C, Cr = int(C), int(Cr)
                    err = float((y - yr).abs().max())
                    scale = float(yr.abs().max())
                    c = rows_agree(y, yr)
                    p = dict(shape=name, in_dim=i, out_dim=o, dtype=dtype,
                             T=T, chunk_rows=bm.chunk_rows,
                             n_chunks=bm.n_chunks, tau=tau, C=C, C_plain=Cr,
                             min_slot_cos=c, max_abs_err=err,
                             max_abs_ref=scale)
                    if C != Cr or not c >= 0.9999 or not err <= 1e-2 * scale:
                        raise AssertionError(f"K2 disagrees with its plain "
                                             f"version: {p}")
                    p["ms"] = median([gpu_ms(
                        lambda v: fused_stream.mxu_matvec_batch(
                            bm, v, eff, 0, tau=tau), (v,), flush)
                        for v in Vs[T]])
                    p["plain_ms"] = median([gpu_ms(
                        lambda v: fused_stream.mxu_matvec_batch_ref(
                            bm, v, eff, 0, tau=tau), (v,), flush)
                        for v in Vs[T]])
                    p["bytes"] = k2_bytes(bm, C, T)
                    p["flops"] = 2 * T * C * bm.chunk_rows * o
                    bytes_ms = p["bytes"] / HBM_BYTES_PER_S * 1e3
                    flops_ms = p["flops"] / BF16_FLOPS * 1e3
                    p["bound_ms"] = max(bytes_ms, flops_ms)
                    p["bound_by"] = ("bytes" if bytes_ms >= flops_ms
                                     else "operations")
                    p["library_ms"] = lib_ms[T]
                    if (dtype, tau) == (SUMMARY_BATCH[0], SUMMARY_BATCH[2]):
                        # where a call's device time goes (selection,
                        # stream, split sum): the mean over PROFILE_CALLS
                        # calls, as one short call's trace can come back
                        # empty
                        prof = device_profile(lambda: [
                            fused_stream.mxu_matvec_batch(bm, v, eff, 0,
                                                          tau=tau)
                            for v in Vs[T][:PROFILE_CALLS]])["kernel_ms"]
                        p["parts_ms"] = per_call(prof, PROFILE_CALLS)
                    points.append(p)
                    emit({"phase": "kernels_batch", **p})
            del bm
        del wt, Vs
        torch.cuda.empty_cache()
    return points


def attention_inputs(case: dict, g: torch.Generator):
    """K3's inputs at one of ATTN_CASES: the case's dims (T, start,
    mask_from, window, H, KV, D), its cache slots S, the bf16 caches [S,
    KV, D] and RUNS queries [T, H*D] (N(0, 4)), drawn from g in that
    order."""
    dims = (case["T"], case["start_slot"], case["mask_from"], case["window"],
            case.get("H", 32), case.get("KV", 8), case.get("D", 128))
    T, H, KV, D = dims[0], *dims[4:]
    S = case.get("S", ATTN_SLOTS)
    kc = torch.randn((S, KV, D), generator=g, device="cuda").to(
        torch.bfloat16)
    vc = torch.randn((S, KV, D), generator=g, device="cuda").to(
        torch.bfloat16)
    Qs = [torch.randn((T, H * D), generator=g, device="cuda") * 2.0
          for _ in range(RUNS)]
    return dims, S, kc, vc, Qs


def attention_agreement(dims: tuple, y: torch.Tensor,
                        yr: torch.Tensor) -> dict:
    """K3's output y against its plain version's yr at one case: the least
    row cosine over the queries with a live key, max|dy|, max|y_ref|,
    whether the queries with none are exactly 0, and whether all of that
    passes K3's gate (cos >= 0.9999, max|dy| <= PV_F32_TOL max|y_ref|)."""
    T, start, mf, _, H, _, D = dims
    dead = start + torch.arange(T, device="cuda") < mf
    rows, rows_r = y.reshape(T * H, D), yr.reshape(T * H, D)
    live_rows = (~dead).repeat_interleave(H)
    c = float(min_row_cos(rows[live_rows], rows_r[live_rows]))
    err = float((y - yr).abs().max())
    scale = float(yr.abs().max())
    dead_zero = not bool(y[dead].any())
    return dict(dead_rows=int(dead.sum()), min_row_cos=c, max_abs_err=err,
                max_abs_ref=scale, dead_rows_zero=dead_zero,
                ok=c >= 0.9999 and err <= PV_F32_TOL * scale and dead_zero)


def phase_attention(flush: torch.Tensor) -> list:
    """K3 against its plain version at ATTN_CASES (a 512-slot cache unless
    a case names its slots), in the forward_seq layout, with pv_f32 (P
    kept to about 24 bits, as three bf16 parts), as forward_seq calls it.
    Times are taken with L2 flushed, as K1's and K2's are."""
    g = torch.Generator(device="cuda")
    g.manual_seed(99)
    points = []
    for case in ATTN_CASES:
        dims, S, kc, vc, Qs = attention_inputs(case, g)
        T, start, mf, win, H, KV, D = dims

        def run(q, plain=False):
            return flash_attention_seq(q, kc, vc, start, mf, H, D,
                                       window=win, plain=plain)
        y, yr = run(Qs[0]), run(Qs[0], plain=True)
        torch.cuda.synchronize()
        slot = start + torch.arange(T, device="cuda")
        p = dict(case=case["name"], T=T, S=S, H=H, KV=KV, D=D,
                 start_slot=start, mask_from=mf, window=win,
                 **attention_agreement(dims, y, yr))
        # PV_F32_TOL: P V keeps P to about 24 bits under pv_f32; one bf16
        # part of P reads above it (scripts/torch_k3_plans.py)
        if not p.pop("ok"):
            raise AssertionError(f"K3 disagrees with its plain version: {p}")
        # the live keys of each query, for the bound
        k_ids = torch.arange(S, device="cuda")
        live = (k_ids[None] <= slot[:, None]) & (k_ids[None] >= mf)
        if win:
            live &= k_ids[None] > slot[:, None] - win
        n_live = int(live.sum())
        keys = int(live.any(dim=0).sum())
        p["bytes"] = 2 * T * H * D * 4 + 2 * keys * KV * D * 2
        p["flops"] = 4 * H * D * n_live
        bytes_ms = p["bytes"] / HBM_BYTES_PER_S * 1e3
        flops_ms = p["flops"] / BF16_FLOPS * 1e3
        p["bound_ms"] = max(bytes_ms, flops_ms)
        p["bound_by"] = "bytes" if bytes_ms >= flops_ms else "operations"
        p["ms"] = median([gpu_ms(run, (q,), flush) for q in Qs])
        p["plain_ms"] = median([gpu_ms(lambda q: run(q, True), (q,), flush)
                                for q in Qs])
        # yardstick only: torch's SDPA with the same boolean mask
        kf = kc.permute(1, 0, 2).repeat_interleave(H // KV, 0)[None]
        vf = vc.permute(1, 0, 2).repeat_interleave(H // KV, 0)[None]
        qb = [q.reshape(T, H, D).permute(1, 0, 2)[None].to(torch.bfloat16)
              for q in Qs]
        sdpa = torch.nn.functional.scaled_dot_product_attention
        p["library_ms"] = median([gpu_ms(
            lambda q: sdpa(q, kf, vf, attn_mask=live), (q,), flush)
            for q in qb])
        points.append(p)
        emit({"phase": "attention", **p})
    return points


def decode_inputs(case: dict, g: torch.Generator):
    """K8's inputs at one of DECODE_CASES: the bf16 caches [B, S, KV, D],
    RUNS queries [B, H*D] (N(0, 1)), the positions and left pads ([B]
    int32) and the live mask [B, S]."""
    B, S, KV, rep, D = (case[k] for k in ("B", "S", "KV", "rep", "D"))
    k = torch.randn((B, S, KV, D), generator=g, device="cuda").to(
        torch.bfloat16)
    v = torch.randn((B, S, KV, D), generator=g, device="cuda").to(
        torch.bfloat16)
    qs = [torch.randn((B, KV * rep * D), generator=g, device="cuda")
          for _ in range(RUNS)]
    if case["pos"] == "serve":
        pos = torch.linspace(40, 660, B).round().to(torch.int32)
        offs = (torch.arange(B, dtype=torch.int32) * 7) % 31
    else:
        pos = torch.tensor(case["pos"], dtype=torch.int32)
        offs = torch.zeros(B, dtype=torch.int32)
    pos, offs = pos.cuda(), offs.cuda()
    t = torch.arange(S, device="cuda")
    live = (t <= pos[:, None]) & (t >= offs[:, None])
    return k, v, qs, pos, offs, live


def phase_decode_attention(flush: torch.Tensor) -> list:
    """K8 against its plain version at DECODE_CASES, times with L2 flushed
    beside the bound (the live rows' bytes and q, out once) and SDPA."""
    g = torch.Generator(device="cuda")
    g.manual_seed(98)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    points = []
    for case in DECODE_CASES:
        B, S, KV, rep, D = (case[k] for k in ("B", "S", "KV", "rep", "D"))
        H = KV * rep
        k, v, qs, pos, offs, live = decode_inputs(case, g)

        def run(q):
            return decode_attention(q, k, v, pos, offs)

        def plain(q):
            return attn_core(q, k.float(), v.float(), live, KV, rep, D)
        y, yr = run(qs[0]), plain(qs[0])
        torch.cuda.synchronize()
        err, scale = float((y - yr).abs().max()), float(yr.abs().max())
        c = float(min_row_cos(y.reshape(B * H, D), yr.reshape(B * H, D)))
        if not err <= K8_TOL * scale:
            raise AssertionError(f"K8 disagrees with its plain version at "
                                 f"{case['name']}: max|dy| {err}, max|y| "
                                 f"{scale}")
        n_live = int(live.sum())
        plan = decode_plan(B, KV, rep, S, D, sms)
        p = dict(case=case["name"], B=B, S=S, KV=KV, rep=rep, D=D,
                 live_rows=n_live, live_share=n_live / (B * S),
                 chunk=plan.chunk, n_chunks=plan.n_chunks, max_abs_err=err,
                 max_abs_ref=scale, min_row_cos=c)
        p["bytes"] = 2 * n_live * KV * D * 2 + 2 * B * H * D * 4
        p["flops"] = 4 * H * D * n_live
        p["bound_ms"] = p["bytes"] / HBM_BYTES_PER_S * 1e3
        p["bound_by"] = "bytes"
        p["ms"] = median([gpu_ms(run, (q,), flush) for q in qs])
        p["plain_ms"] = median([gpu_ms(plain, (q,), flush) for q in qs])
        # yardstick only: torch's SDPA with the same boolean mask
        kf = k.permute(0, 2, 1, 3).repeat_interleave(rep, 1)
        vf = v.permute(0, 2, 1, 3).repeat_interleave(rep, 1)
        qb = [q.reshape(B, H, 1, D).to(torch.bfloat16) for q in qs]
        mask = live[:, None, None, :]
        sdpa = torch.nn.functional.scaled_dot_product_attention
        p["library_ms"] = median([gpu_ms(
            lambda q: sdpa(q, kf, vf, attn_mask=mask), (q,), flush)
            for q in qb])
        del kf, vf
        points.append(p)
        emit({"phase": "decode_attention", **p})
    return points


def build_model():
    """Mistral-7B width and depth, int8 row-prefix buckets, fused wqkv and
    w13, int8 LM head, dense copies kept; random calibrated weights from
    seed 0. Returns (cfg, w, engine, prompts); every model phase uses it."""
    cfg = mistral_7b(n_layers=32, max_seq_len=512)
    bcfg = BucketConfig(bucket_size=1, chunk_rows=128, dtype="int8")
    t0 = time.perf_counter()
    w = quantize_head(init_random_weights(cfg, bcfg, seed=0, calibrate=True,
                                          fuse=True, keep_dense=True,
                                          device="cuda"))
    torch.cuda.synchronize()
    emit({"phase": "model_setup", "seconds": time.perf_counter() - t0,
          "weights_gib": torch.cuda.memory_allocated() / 2**30})
    g = torch.Generator().manual_seed(7)
    prompts = [torch.randint(3, cfg.vocab_size, (n,), generator=g).tolist()
               for n in PROMPT_LENS]
    return cfg, w, Engine(w, cfg, eos_id=-1), prompts


def check_replies(replies, cfg, n_new: int, what: str) -> None:
    for toks in replies:
        if len(toks) != n_new or not all(0 <= t < cfg.vocab_size
                                         for t in toks):
            raise AssertionError(f"bad reply ({what}): {toks}")


def check_launches(got: dict, want: dict, what: str) -> None:
    """Every kernel's count in one run of a path against the count the path
    must give (kernels the path must not reach are given as 0)."""
    bad = {k: (got[k], n) for k, n in want.items() if got[k] != n}
    if bad:
        raise AssertionError(f"launches (got, expected) in {what}: {bad}")


def routes(eng, w, cfg, **kw):
    """(route, engine) pairs of a decode phase: the captured steps (eng,
    each step a replayed CUDA graph) and the same steps run eagerly."""
    return (("graph", eng),
            ("eager", Engine(w, cfg, eos_id=-1, capture=False, **kw)))


def warm(engines, prompt, efforts) -> None:
    """One short request a key, so no capture falls in a timed run."""
    for e in engines:
        for effort in efforts:
            e.generate(prompt, n_new=2, effort=effort)


def same_tokens(a: list, b: list, what: str) -> None:
    """The graph route's replies against the eager route's."""
    if [r.token_ids for r in a] != [r.token_ids for r in b]:
        raise AssertionError(f"graph and eager tokens part ({what})")


def phase_generate(cfg, w, eng, prompts):
    """Single-stream decode, the prompt fed token by token (K1): each
    effort through the captured steps and then through the eager ones
    (capture=False), CUDA events around the four requests; both give the
    same tokens and the same launch counts."""
    steps = sum(padded(n, eng.pad_to) + N_NEW - 1 for n in PROMPT_LENS)
    pairs = routes(eng, w, cfg)
    warm([e for _, e in pairs], prompts[0], (0.25, 1.0))
    results, replies = [], {}
    for effort in (0.25, 0.5, 1.0):
        for route, e in pairs:
            torch.cuda.synchronize()
            reset_launches()            # the path's run starts here ...
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = [e.generate(p, n_new=N_NEW, effort=effort)
                   for p in prompts]
            end.record()
            end.synchronize()
            launches = dict(LAUNCHES)   # ... and is read here
            ms = start.elapsed_time(end)
            want = 4 * cfg.n_layers * steps if effort < 0.999 else 0
            r = dict(route=route, effort=effort, requests=len(prompts),
                     steps=steps, ms=ms, ms_per_token=ms / steps,
                     launches=launches, first_tokens=out[0].token_ids[:8])
            results.append(r)
            emit({"phase": "generate", **r})
            check_replies([rep.token_ids for rep in out], cfg, N_NEW,
                          f"generate, {route}, effort {effort}")
            check_launches(launches, {"mxu_matvec": want,
                                      "mxu_matvec_batch": 0,
                                      "flash_attention": 0,
                                      "decode_attention":
                                          cfg.n_layers * steps},
                           f"generate ({route}) at effort {effort}")
            if route == "graph":
                replies[effort] = out
            else:
                same_tokens(replies[effort], out, f"generate {effort}")
    if not sum(r["launches"]["mxu_matvec"] for r in results):
        raise AssertionError("K1 was not launched on the decode path")
    return results, replies


# the ported kernels' own CUDA kernels, by a part of their profiler names
# (K1's and K2's live in anonymous namespaces; torch's own reductions are
# named reduce_kernel too)
KERNEL_PARTS = {"k1_select": "namespace)::k1_select_kernel",
                "k1_stream": "namespace)::k1_stream_kernel",
                "k1_reduce": "namespace)::k1_reduce_kernel",
                "k2_select": "namespace)::select_batch_kernel",
                "k2_stream": "namespace)::mma_stream_kernel",
                "k2_reduce": "namespace)::reduce_batch_kernel",
                "k3": "namespace)::flash_kernel",
                "k4_select": "namespace)::grid_select_kernel",
                "k4_k5_stream": "rank_prefix::ring_stream_kernel",
                "split_sum": "rank_prefix::reduce_splits",    # K4-K7's
                "k6_k7_gather": "block_gather::ring_gather_kernel",
                "k8": "namespace)::decode_kernel",
                # PyTorch's dtype copies (torch ops, not a ported kernel;
                # the plain decode attention's cache widening, where the
                # int8 and ring caches take it)
                "copies": "direct_copy_kernel_cuda"}
K1_PARTS = ("k1_select", "k1_stream", "k1_reduce")
# K1's parts as the kernels line names them: the stream and the split sum
# are programmatic dependents, so their device time includes their wait
# (griddepcontrol.wait) behind the launch before, not their work alone
K1_PART_KEYS = {"k1_select": "k1_select",
                "k1_stream": "k1_stream_incl_wait",
                "k1_reduce": "k1_reduce_incl_wait"}


PROFILE_TRIES = 3


def device_kernels(fn) -> dict:
    """{kernel name: (device ms, launches)} of one traced run of fn()
    (torch.profiler, device activity only, summed over the raw trace
    events: host events and the profiler's own event tree cost the run
    tens of seconds a pass and add nothing to these sums). Empty where the
    profiler delivered no device activity."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    by_name, spans = {}, []
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == DeviceType.CUDA and e.duration_ns() > 0:
            ms, n = by_name.get(e.name(), (0.0, 0))
            by_name[e.name()] = (ms + e.duration_ns() / 1e6, n + 1)
            spans.append((e.start_ns(), e.start_ns() + e.duration_ns()))
    if by_name:
        by_name[UNION] = (union_ms(spans), len(spans))
    return by_name


# device_kernels' entry for the time the card ran any kernel at all: the
# union of the kernels' spans (a programmatic dependent's span starts
# while the launch before it still runs, so the sum counts that wait twice)
UNION = "(union of kernel spans)"


def union_ms(spans: list) -> float:
    total, end = 0, None
    for a, b in sorted(spans):
        if end is None or a > end:
            total += b - a
            end = b
        elif b > end:
            total += b - end
            end = b
    return total / 1e6


def device_profile(fn, need=()) -> dict:
    """Where the time of fn() goes: device time by kernel (device_kernels)
    against the wall time of fn() run again without the profiler; the
    card's busy share is their ratio (device_busy_share, the sum over
    kernels, as earlier runs read it; device_union_share, the union of the
    kernels' spans, which counts a programmatic dependent's wait behind the
    launch before it once). A trace with no device activity at
    all (the profiler delivers none now and then, and none where another
    tool holds the card's activity tracing) is taken again, up to
    PROFILE_TRIES times; if every one is empty, the device numbers are None
    (not measured) and `traced` is false. Raises if a trace holds kernels
    but a part of KERNEL_PARTS named in `need` matches none of them (a
    renamed kernel must not read as 0)."""
    for _ in range(PROFILE_TRIES):
        by_name = device_kernels(fn)
        if by_name:
            break
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    if not by_name:
        print(f"chip_smoke: {PROFILE_TRIES} traces held no device activity; "
              "device time by kernel not measured", file=sys.stderr)
        return dict(wall_ms=wall_ms, device_ms=None, device_busy_share=None,
                    device_union_ms=None, device_union_share=None,
                    kernel_ms=None, top=[], traced=False)
    union = by_name.pop(UNION)[0]
    kernels = sorted(((k, ms, n) for k, (ms, n) in by_name.items()),
                     key=lambda k: -k[1])
    device_ms = sum(k[1] for k in kernels)
    parts = {part: sum(k[1] for k in kernels if sub in k[0])
             for part, sub in KERNEL_PARTS.items()}
    missing = [part for part in need if not parts[part]]
    if missing:
        raise AssertionError(f"no kernel matches the parts {missing} "
                             f"(KERNEL_PARTS); the trace's kernels: "
                             f"{[k[0][:60] for k in kernels]}")
    return dict(wall_ms=wall_ms, device_ms=device_ms,
                device_busy_share=device_ms / wall_ms,
                device_union_ms=union, device_union_share=union / wall_ms,
                kernel_ms={k: v for k, v in parts.items() if v},
                top=[(name[:60], ms, n) for name, ms, n in kernels[:8]],
                traced=True)


def per_call(kernel_ms, calls: int):
    """A profile's kernel_ms over `calls` calls, per call (None where the
    profile was not measured)."""
    if kernel_ms is None:
        return None
    return {k: ms / calls for k, ms in kernel_ms.items()}


def sum_parts(parts: list, keys, names=None):
    """The sum over points of their parts_ms at `keys` (named names[k] in
    the result), or None where a point's parts were not measured."""
    if any(q is None for q in parts):
        return None
    names = names or {}
    return {names.get(k, k): sum(q.get(k, 0.0) for q in parts) for k in keys}


def profile_routes(phase: str, pairs, prompt, effort: float = 0.25,
                   need=K1_PARTS) -> dict:
    """Where one request's time goes (8 new tokens at `effort`), through
    the captured steps and the eager ones: {route: device_profile}."""
    n_new, out = 8, {}
    for route, e in pairs:
        e.generate(prompt, n_new=2, effort=effort)          # warm key
        out[route] = dict(steps=padded(len(prompt), e.pad_to) + n_new - 1,
                          effort=effort, **device_profile(
                              lambda e=e: e.generate(prompt, n_new=n_new,
                                                     effort=effort),
                              need=need))
        emit({"phase": phase, "route": route, **out[route]})
    return out


def phase_profile(cfg, w, eng, prompt) -> dict:
    """Where one request's time goes: one request of 8 new tokens at
    effort 0.25 on the token-loop engine, graph and eager."""
    return profile_routes("profile", routes(eng, w, cfg), prompt)


def phase_teacher(cfg, w, tokens) -> list:
    """The kernel route against the kernel's plain version ("plain") and
    against the reference route, at tau = 1, over the same tokens. At every
    step all routes read the same history (the kernel route's KV cache; the
    others run on copies), so the logits differ only by this step's layers.

    Required: kernel vs plain, cos >= 0.999 at every step at depth 4. The
    reference route is another function: it keeps u in f32 where the
    kernel rounds u to bf16, and searches its cutoff with 0.62**j instead
    of the kernel's exp table; the discrete row selection turns those
    last-bit differences into whole rows at low effort, so its cosine is
    printed, not required. Cosines are of logits through the exact bf16
    head (the int8 head rounds h to 255 levels per tensor, so a last-bit
    change in h moves whole rounding steps outside its rescored top 16);
    the int8 head's cosine and argmax agreement are printed beside them."""
    saved = fused_stream._TAU
    fused_stream._TAU = 1.0
    rows = []

    def h_final(cfg_d, tok, pos, kv, eq, impl):
        h = forward_layers(w, cfg_d, embed(w, tok), pos, *kv, effort=eq,
                           impl=impl)
        return rms_norm(h, w.norm, cfg.norm_eps)

    try:
        for depth in (4, 32):
            cfg_d = dataclasses.replace(cfg, n_layers=depth)
            steps = tokens if depth == 4 else tokens[:DEEP_TEACHER_STEPS]
            for effort in (0.25, 0.5):
                eq = effort_q16(effort, "cuda")
                kv = make_kv_cache(cfg_d, "cuda")
                c = {k: [] for k in ("plain", "plain_int8", "reference")}
                agree, finite = 0, True
                for pos, tok in enumerate(steps):
                    h = {impl: h_final(cfg_d, tok, pos,
                                       tuple(x.clone() for x in kv),
                                       eq, impl)
                         for impl in ("plain", "reference")}
                    h["kernel"] = h_final(cfg_d, tok, pos, kv, eq, "kernel")
                    exact = {k: dense_matvec(x, w.output)
                             for k, x in h.items()}
                    lk, lp = head_logits(w, h["kernel"]), head_logits(
                        w, h["plain"])
                    finite &= bool(torch.isfinite(lk).all())
                    c["plain"].append(cos(exact["kernel"], exact["plain"]))
                    c["plain_int8"].append(cos(lk, lp))
                    c["reference"].append(cos(exact["kernel"],
                                              exact["reference"]))
                    agree += int(lk.argmax() == lp.argmax())
                n = len(steps)
                r = dict(depth=depth, effort=effort, steps=n,
                         min_cos_plain=min(c["plain"]),
                         mean_cos_plain=sum(c["plain"]) / n,
                         min_cos_plain_int8_head=min(c["plain_int8"]),
                         argmax_agreement_plain=agree / n,
                         min_cos_reference=min(c["reference"]),
                         mean_cos_reference=sum(c["reference"]) / n,
                         finite=finite, required=depth == 4)
                rows.append(r)
                emit({"phase": "teacher", **r})
                if not finite or (depth == 4
                                  and not r["min_cos_plain"] >= 0.999):
                    raise AssertionError(f"kernel route vs plain: {r}")
    finally:
        fused_stream._TAU = saved
    return rows


def prefill_run(pre, cfg, prompts, effort: float, n_new: int = N_NEW,
                phase: str = "prefill") -> dict:
    """One effort of Engine(prefill=True) (pre) over the prompts: each runs
    through one forward_seq pass (K2 per projection below effort 1, dense
    copies at 1; K3 per layer), then greedy decode (K1). Time to first
    token: the wall time of a call asking for one token (the reply read
    back on the host included); decode ms per token: the rest of an
    n_new-token call over its n_new - 1 steps. Launches exact: K3 once a
    layer a call, K2 four times a layer a call and K1 four times a layer a
    decode step below effort 1."""
    L, ttft, decode, replies = cfg.n_layers, {}, [], []
    torch.cuda.synchronize()
    reset_launches()                    # the path's run starts here ...
    for p in prompts:
        t0 = time.perf_counter()
        first = pre.generate(p, n_new=1, effort=effort).token_ids
        t1 = time.perf_counter()
        rep = pre.generate(p, n_new=n_new, effort=effort).token_ids
        t2 = time.perf_counter()
        ttft.setdefault(padded(len(p)), []).append((t1 - t0) * 1e3)
        decode.append(((t2 - t1) - (t1 - t0)) * 1e3 / (n_new - 1))
        replies.append(rep)
        if rep[:1] != first:
            raise AssertionError(f"prefill's first token differs between "
                                 f"two calls ({phase}): {first} {rep}")
    launches = dict(LAUNCHES)           # ... and is read here
    calls, low = 2 * len(prompts), effort < 0.999
    r = dict(effort=effort, requests=len(prompts),
             ttft_ms={P: median(v) for P, v in ttft.items()},
             ttft_ms_all={P: v for P, v in ttft.items()},
             decode_ms_per_token=median(decode), launches=launches,
             first_tokens=replies[0][:8])
    emit({"phase": phase, **r})
    check_replies(replies, cfg, n_new, f"{phase}, effort {effort}")
    check_launches(launches, {
        "flash_attention": L * calls,
        "mxu_matvec_batch": 4 * L * calls if low else 0,
        "mxu_matvec": 4 * L * len(prompts) * (n_new - 1) if low else 0},
        f"{phase} at effort {effort}")
    return r


def phase_prefill(cfg, w, eng, prompts) -> list:
    """Engine(prefill=True) on the four prompts at efforts 0.25, 0.5 and
    1.0 (prefill_run), beside the token-loop engine's time to first token;
    then device time by kernel over one 64-token prefill at 0.25."""
    pre = Engine(w, cfg, eos_id=-1, prefill=True)
    pre.generate(prompts[0], n_new=2, effort=0.25)       # warm-up
    results = []
    for effort in (0.25, 0.5, 1.0):
        r = prefill_run(pre, cfg, prompts, effort)
        results.append(r)
        # beside it, the token-loop engine's time to first token on the
        # same prompts (every prompt slot one decode step)
        loop = {}
        for p in prompts:
            t0 = time.perf_counter()
            eng.generate(p, n_new=1, effort=effort)
            loop.setdefault(padded(len(p)), []).append(
                (time.perf_counter() - t0) * 1e3)
        r["ttft_token_loop_ms"] = {P: median(v) for P, v in loop.items()}
        emit({"phase": "prefill_vs_token_loop", "effort": effort,
              "ttft_ms": r["ttft_ms"],
              "ttft_token_loop_ms": r["ttft_token_loop_ms"]})
    # where the time to first token goes: the 64-token prompt at 0.25
    prof = device_profile(lambda: pre.generate(prompts[-1], n_new=1,
                                               effort=0.25))
    emit({"phase": "prefill_profile", "prompt_len": len(prompts[-1]),
          **prof})
    results[0]["profile"] = prof
    return results


def min_row_cos(y: torch.Tensor, yr: torch.Tensor) -> torch.Tensor:
    """rows_agree on the device, with no wait: the least cosine over rows
    as a scalar tensor; a row that is 0 in yr counts 1 if it is 0 in y
    too, else 0."""
    y, yr = y.double(), yr.double()
    c = torch.nn.functional.cosine_similarity(y, yr, dim=-1)
    zero_ok = torch.where(y.abs().amax(-1) > 0, 0.0, 1.0).double()
    return torch.where(yr.abs().amax(-1) > 0, c, zero_ok).min()


def same_input_layers(seq, cfg_d, eff, k2_per_layer=None) -> dict:
    """One kernel-route pass of forward_seq in which every K2 and K3 call is
    also run through its plain version on the very inputs it was given: per
    layer, the least row cosine of its K2 calls and of its K3 call, and
    whether each K2 call's C equals the plain version's. A fault that shows
    only at later layers (a stale or strided cache read) shows here.
    k2_per_layer(): the K2 calls of each layer, known after the pass (4 a
    layer unless given: an MoE layer's depend on its routing)."""
    k2, k3 = bucketmul.mxu_matvec_batch, transformer.flash_attention_seq
    k2_cos, k2_c, k3_cos = [], [], []
    D = cfg_d.head_dim

    def k2_both(bm, V, efforts, expert=0, tau=None):
        y, C = k2(bm, V, efforts, expert, tau, return_len=True)
        yr, Cr = fused_stream.mxu_matvec_batch_ref(bm, V, efforts, expert,
                                                   tau, return_len=True)
        k2_cos.append(min_row_cos(y, yr))
        k2_c.append((C == Cr).all())
        return y

    def k3_both(*args, **kw):
        y = k3(*args, **kw)
        yr = k3(*args, **{**kw, "plain": True})
        k3_cos.append(min_row_cos(y.reshape(-1, D), yr.reshape(-1, D)))
        return y

    bucketmul.mxu_matvec_batch = k2_both
    transformer.flash_attention_seq = k3_both
    try:
        seq(cfg_d, eff, "kernel", "flash")
    finally:
        bucketmul.mxu_matvec_batch, transformer.flash_attention_seq = k2, k3
    L = cfg_d.n_layers
    per = k2_per_layer() if k2_per_layer else [4] * L
    if len(k2_cos) != sum(per) or len(per) != L or len(k3_cos) != L:
        raise AssertionError(f"{len(k2_cos)} K2 and {len(k3_cos)} K3 calls "
                             f"in {L} layers")
    k2_cos, k2_c = torch.stack(k2_cos), torch.stack(k2_c)
    ends = torch.tensor(per).cumsum(0).tolist()
    return dict(k2_min_cos=[float(k2_cos[e - n:e].min())
                            for n, e in zip(per, ends)],
                k2_c_equal=[bool(k2_c[e - n:e].all())
                            for n, e in zip(per, ends)],
                k3_min_cos=torch.stack(k3_cos).tolist())


def phase_prefill_teacher(cfg, w, eng, prompts) -> list:
    """forward_seq over one left-padded prompt (17 tokens in 32 slots) at
    tau = 1: the kernel route (K2, K3) against the plain route (both plain
    versions), and the dense forward_seq against dense forward_token steps
    over the same tokens, by the cosine of each real position's logits
    (exact bf16 head). Required at depth 4: >= 0.999 everywhere; depth 32
    is printed only. Two witnesses of why depth 32 parts: every layer's K2
    and K3 calls against their plain versions on the same inputs (required:
    cos >= 0.9999, equal C, at each of the 32 layers), and the plain route
    against itself with each attention-norm weight moved by a relative
    2^-20 x N(0, 1), about 16 f32 ulps (printed only)."""
    saved = fused_stream._TAU
    fused_stream._TAU = 1.0
    prompt = prompts[1]
    P = padded(len(prompt))
    off = P - len(prompt)
    ids = torch.tensor([0] * off + prompt, dtype=torch.int32, device="cuda")
    rows = []
    g = torch.Generator(device="cuda")
    g.manual_seed(7)
    nudge = torch.randn(w.layers.attn_norm.shape, generator=g, device="cuda")
    w_nudged = dataclasses.replace(w, layers=dataclasses.replace(
        w.layers, attn_norm=w.layers.attn_norm * (1 + 2.0**-20 * nudge)))

    def seq(cfg_d, effort, impl, attn_impl, weights=w):
        return forward_seq(weights, cfg_d, ids,
                           *make_kv_cache(cfg_d, "cuda"), rope_offset=off,
                           mask_from=off, effort=effort, impl=impl,
                           attn_impl=attn_impl)[off:]

    def token_loop(cfg_d):
        kv = make_kv_cache(cfg_d, "cuda")
        out = []
        for pos in range(off, P):
            h = forward_layers(w, cfg_d, embed(w, ids[pos]), pos, *kv,
                               effort=1.0, impl="dense", rope_offset=off,
                               mask_from=off)
            out.append(dense_matvec(rms_norm(h, w.norm, cfg.norm_eps),
                                    w.output))
        return torch.stack(out)

    try:
        for depth in (4, 32):
            cfg_d = dataclasses.replace(cfg, n_layers=depth)
            pairs = {}
            for effort in (0.25, 0.5):
                eff = torch.tensor(effort, device="cuda")
                plain = seq(cfg_d, eff, "plain", "plain")
                pairs[f"kernel_vs_plain_{effort}"] = (
                    seq(cfg_d, eff, "kernel", "flash"), plain)
                pairs[f"plain_nudged_vs_plain_{effort}"] = (
                    seq(cfg_d, eff, "plain", "plain", w_nudged), plain)
            pairs["dense_seq_vs_token"] = (seq(cfg_d, 1.0, "dense", "flash"),
                                           token_loop(cfg_d))
            for what, (a, b) in pairs.items():
                cs = [cos(x, y) for x, y in zip(a, b)]
                r = dict(depth=depth, pair=what, positions=len(cs),
                         min_cos=min(cs), mean_cos=sum(cs) / len(cs),
                         argmax_agreement=float(
                             (a.argmax(-1) == b.argmax(-1)).float().mean()),
                         finite=bool(torch.isfinite(a).all()),
                         required=depth == 4 and "nudged" not in what)
                rows.append(r)
                emit({"phase": "prefill_teacher", **r})
                if not r["finite"] or (r["required"]
                                       and not r["min_cos"] >= 0.999):
                    raise AssertionError(f"prefill teacher check: {r}")
            if depth == 32:
                for effort in (0.25, 0.5):
                    r = dict(depth=depth, pair=f"same_input_{effort}",
                             **same_input_layers(
                                 seq, cfg_d, torch.tensor(effort,
                                                          device="cuda")))
                    r["min_cos"] = min(r["k2_min_cos"] + r["k3_min_cos"])
                    r["required"] = True
                    rows.append(r)
                    emit({"phase": "prefill_teacher", **r})
                    if not (r["min_cos"] >= 0.9999 and all(r["k2_c_equal"])):
                        raise AssertionError(f"same-input check: {r}")
    finally:
        fused_stream._TAU = saved
    return rows


SERVE_LENS = (5, 64, 17, 40, 9, 33, 60, 24)
SERVE_EFFORTS = (0.25, 0.5, 1.0, 0.25, 0.5, 1.0, 0.25, 0.5)


def serve_requests(cfg) -> list:
    """The serving phases' 8 prompts (SERVE_LENS tokens), from a seed."""
    g = torch.Generator().manual_seed(11)
    return [torch.randint(3, cfg.vocab_size, (n,), generator=g).tolist()
            for n in SERVE_LENS]


def serve_batch(cfg, w, reqs, efforts, n_new: int, phase: str) -> tuple:
    """BatchEngine(batch_size=4) + ContinuousBatcher serve the requests
    through 4 slots at their efforts, n_new tokens each (after a 2-token
    warm-up request): tokens/s, ms a step and the run's launches (K2 4 a
    layer a step and an admission, K3 once a layer an admission, K1
    never); the step must be a captured graph. Returns (result, batcher)."""
    be = BatchEngine(w, cfg, batch_size=4, eos_id=-1)
    cb = ContinuousBatcher(be)
    cb.submit(reqs[0], 2, 0.25, lambda toks: None)        # warm-up
    cb.run_until_drained()
    done = {}
    for i, (p, e) in enumerate(zip(reqs, efforts)):
        cb.submit(p, n_new, e, lambda toks, i=i: done.__setitem__(i, toks))
    torch.cuda.synchronize()
    reset_launches()                    # the path's run starts here ...
    t0 = time.perf_counter()
    ticks = 0
    while cb.has_work():
        cb.tick()
        ticks += 1
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(LAUNCHES)           # ... and is read here
    L, admits = cfg.n_layers, len(reqs)
    r = dict(requests=admits, slots=4, new_tokens=n_new, steps=ticks,
             wall_s=wall, tokens_per_s=admits * n_new / wall,
             ms_per_step=wall * 1e3 / ticks, launches=launches,
             captured=be._graph is not None,
             first_tokens=done.get(0, [])[:8])
    emit({"phase": phase, **r})
    check_replies([done.get(i) or [] for i in range(admits)], cfg, n_new,
                  phase)
    check_launches(launches, {"mxu_matvec_batch": 4 * L * (ticks + admits),
                              "flash_attention": L * admits,
                              "mxu_matvec": 0}, phase)
    if not r["captured"]:
        raise AssertionError(f"{phase}: the batched step was not captured")
    return r, cb


def phase_serve(cfg, w, eng, prompts) -> list:
    """Continuous batching (serve_batch): 8 requests through 4 slots
    (prompt lengths 5-64, efforts mixed, 32 new tokens each), then device
    time by kernel over four 8-token requests, a teacher check of one
    batched step against the single-stream K1 route, then the HTTP server
    in batch mode."""
    reqs = serve_requests(cfg)
    r, cb = serve_batch(cfg, w, reqs, SERVE_EFFORTS, N_NEW, "serve")

    # where serving time goes: four requests of 8 tokens filling the slots
    def wave():
        for p, e in zip(reqs[:4], SERVE_EFFORTS):
            cb.submit(p, 8, e, lambda toks: None)
        cb.run_until_drained()
    r["profile"] = device_profile(wave)
    emit({"phase": "serve_profile", "requests": 4, "new_tokens": 8,
          **r["profile"]})
    r["teacher"] = serve_teacher(cfg, w, reqs)
    r["http"] = serve_http(cfg, w)
    return [r]


def serve_teacher(cfg, w, reqs, phase: str = "serve_teacher") -> list:
    """At depth 4 and tau = 1, one batched decode step's logits for each
    slot against forward_token on the single-stream K1 route at the slot's
    effort, both reading copies of the same cache (exact bf16 head)."""
    saved = fused_stream._TAU
    fused_stream._TAU = 1.0
    cfg4 = dataclasses.replace(cfg, n_layers=4)
    w_exact = dataclasses.replace(w, output_q=None, output_qscale=None)
    try:
        be = BatchEngine(w_exact, cfg4, batch_size=4, eos_id=-1)
        for b in range(4):
            be.admit(b, b, reqs[b], N_NEW, SERVE_EFFORTS[b])
        for _ in range(3):
            be.step()
        kc, vc = be.k_cache.clone(), be.v_cache.clone()
        lb = forward_token_batch(be.w, cfg4, be.tokens, be.pos, kc, vc,
                                 be.efforts, offs=be.offs, impl="kernel")
        rows = []
        for b in range(4):
            kv = (be.k_cache[:, b].clone(), be.v_cache[:, b].clone())
            pos, off = int(be.pos[b]), int(be.offs[b])
            ls = forward_token(be.w, cfg4, be.tokens[b], pos, *kv,
                               effort=effort_q16(SERVE_EFFORTS[b], "cuda"),
                               impl="kernel", rope_offset=off, mask_from=off)
            rows.append(dict(slot=b, effort=SERVE_EFFORTS[b], pos=pos,
                             cos=cos(lb[b], ls),
                             argmax_equal=bool(lb[b].argmax()
                                               == ls.argmax())))
        emit({"phase": phase, "slots": rows})
        if not all(x["cos"] >= 0.999 for x in rows):
            raise AssertionError(f"batched step vs single stream: {rows}")
    finally:
        fused_stream._TAU = saved
    return rows


def serve_http(cfg, w, phase: str = "serve_http") -> dict:
    """make_batch_server on 127.0.0.1 (a free port), in this process: four
    concurrent /q requests, one stream=1 request and one /v1/completions
    request. Every answer must be 200 with its full token count (or end at
    the end-of-sequence id 2)."""
    import asyncio
    import urllib.request
    n = 8

    def fetch(port, path, payload=None):
        req = urllib.request.Request(
            f"http://127.0.0.1:{port}{path}",
            data=None if payload is None else json.dumps(payload).encode(),
            headers={"content-type": "application/json"})
        with urllib.request.urlopen(req, timeout=300) as resp:
            return resp.status, resp.read().decode()

    def full(toks):
        return len(toks) == n or (0 < len(toks) < n and toks[-1] == 2)

    async def run():
        srv = make_batch_server(w, cfg, batch_size=4, port=0)
        await srv.start()
        loop = asyncio.get_running_loop()
        try:
            t0 = time.perf_counter()
            got = await asyncio.gather(*[
                loop.run_in_executor(None, fetch, srv.port,
                                     f"/q?query=hello{i}&effort={e}"
                                     f"&numtokens={n}")
                for i, e in enumerate((25, 50, 100, 25))])
            concurrent_s = time.perf_counter() - t0
            streamed = await loop.run_in_executor(
                None, fetch, srv.port,
                f"/q?query=stream&effort=50&numtokens={n}&stream=1")
            completion = await loop.run_in_executor(
                None, fetch, srv.port, "/v1/completions",
                {"prompt": "hello", "max_tokens": n, "effort": 0.5})
        finally:
            await srv.stop()
        return got, streamed, completion, concurrent_s

    got, streamed, completion, concurrent_s = asyncio.run(run())
    ok = all(st == 200 and full(json.loads(body)["token_ids"])
             for st, body in got)
    st, body = streamed
    events = [e for e in body.split("\n\n") if e.strip()]
    data = [json.loads(e.split("data: ", 1)[1]) for e in events
            if e.startswith("data: ")]
    final = [json.loads(e.split("data: ", 1)[1]) for e in events
             if e.startswith("event: done")]
    ok &= (st == 200 and len(final) == 1 and full(final[0]["token_ids"])
           and [d["token"] for d in data] == final[0]["token_ids"])
    st, body = completion
    obj = json.loads(body)
    ok &= (st == 200 and obj["object"] == "text_completion"
           and full(json.loads(obj["choices"][0]["text"])))
    r = dict(concurrent_q=[st for st, _ in got], concurrent_s=concurrent_s,
             stream_events=len(data), completion=obj["choices"][0], ok=ok)
    emit({"phase": phase, **r})
    if not ok:
        raise AssertionError(f"batch server: {r}")
    return r

def rank_bytes(bm, tiles: int, tgb: int, selection: bool) -> int:
    """Bytes K4 or K5 must move: values and packed positions of the live
    tiles, y written once, and K4's v, probes, stats and scales (selection)
    or K5's u [K, in] f32."""
    vrow = bm.vals.shape[2] * bm.vals.element_size()
    streamed = tiles * tgb * bm.chunk_rows * (vrow + bm.pos.shape[2])
    K = bm.n_ranks
    if selection:
        inputs = (bm.in_dim * 4 * (1 + K * (1 + (bm.scales is not None)))
                  + bm.probes.shape[1] * 4)
    else:
        inputs = K * bm.in_dim * 4
    return streamed + inputs + bm.out_dim * 4


def gather_bytes(bm, n_ids: int, pos_row_bytes: int) -> int:
    """Bytes K6 or K7 must move for n_ids real blocks: their values and
    positions, their ids, u [K, in] f32, y written once."""
    vrow = bm.vals.shape[2] * bm.vals.element_size()
    return (n_ids * bm.chunk_rows * (vrow + pos_row_bytes) + n_ids * 4
            + bm.n_ranks * bm.in_dim * 4 + bm.out_dim * 4)


def held(what: str, y, yr, extra: dict, c_min: float = 0.9999) -> dict:
    """cos and max|dy| of a kernel against its plain version (and whether
    the two are equal bit for bit, as K4-K7 and theirs add in one order);
    raises past cos c_min or max|dy| > 1e-2 max|y_ref|."""
    err = float((y - yr).abs().max())
    scale = float(yr.abs().max())
    p = dict(extra, cos=cos(y, yr), max_abs_err=err, max_abs_ref=scale,
             bitwise_equal=bool(torch.equal(y, yr)))
    if not p["cos"] >= c_min or not err <= 1e-2 * scale:
        raise AssertionError(f"{what} disagrees with its plain version: {p}")
    return p


def timed(p: dict, flush, fn, plain, args: list, nbytes: int,
          lib_ms: float) -> dict:
    """ms (median over the fresh args, L2 flushed), plain_ms (over the
    first PLAIN_RUNS of them: the plain versions add row by row, in the
    kernels' order), the bytes bound and the library time."""
    p["ms"] = median([gpu_ms(fn, a, flush) for a in args])
    p["plain_ms"] = median([gpu_ms(plain, a, flush)
                            for a in args[:PLAIN_RUNS]])
    p["bytes"] = nbytes
    p["bound_ms"] = nbytes / HBM_BYTES_PER_S * 1e3
    p["library_ms"] = lib_ms
    return p


def phase_kernels_rank(flush: torch.Tensor) -> dict:
    """K4 and K5 at the four fused projections x {bf16, int8, int4} x
    RANK_EFFORTS x TAUS; K6 and K7 at {bf16, int8} x RANK_EFFORTS; each
    against its plain version on the same selection, K5 against K4 and K7
    against K6."""
    g = torch.Generator(device="cuda")
    g.manual_seed(2468)
    out = {k: [] for k in ("k4", "k5", "k6", "k7")}
    inst0 = torch.zeros((), dtype=torch.int32, device="cuda")
    for name, (i, o) in SHAPES.items():
        rms = torch.exp(torch.randn(i, generator=g, device="cuda") * 1.2)
        pi = calib_row_order(rms)
        wt = torch.randn((i, o), generator=g, device="cuda") * 0.02
        dense = wt[pi.long()].to(torch.bfloat16)
        vs = [rms[pi.long()] * torch.randn(i, generator=g, device="cuda")
              for _ in range(RUNS)]
        lib_ms = median([gpu_ms(lambda a: torch.mm(a, dense),
                                (v.to(torch.bfloat16)[None],), flush)
                         for v in vs])
        del dense
        for dtype in DTYPES:
            bm = bucketize(wt, BucketConfig(dtype=dtype, **RANK_BUCKETS),
                           in_perm=pi)
            tgb = bucketmul._tile_blocks(bm)
            base = dict(shape=name, in_dim=i, out_dim=o, dtype=dtype,
                        n_chunks=bm.n_chunks, tile_blocks=tgb)
            for effort in RANK_EFFORTS:
                eq = effort_q16(effort, "cuda")
                for tau in TAUS:
                    pt = dict(base, effort=effort, tau=tau)
                    y, C, sel = fused_stream.fused_matvec(
                        bm, vs[0], eq, 0, tgb, tau, return_selection=True)
                    yr, Cr, _ = fused_stream.fused_matvec_ref(
                        bm, vs[0], eq, 0, tgb, tau, return_selection=True)
                    y5 = prefix_stream.stream_matvec(bm, sel, tgb)
                    torch.cuda.synchronize()
                    C, Cr = C.tolist(), Cr.tolist()
                    tiles = int(sel.cum_tiles[-1])
                    p4 = held("K4", y, yr, dict(pt, C=C, C_plain=Cr,
                                                 tiles=tiles))
                    p4["k5_on_k4_selection_max_abs_diff"] = float(
                        (y5 - y).abs().max())
                    if C != Cr or not p4["bitwise_equal"] or not p4[
                            "k5_on_k4_selection_max_abs_diff"] <= 1e-5:
                        raise AssertionError(f"K4 (C_k, y bit for bit, or "
                                             f"K5 on its selection): {p4}")
                    out["k4"].append(timed(
                        p4, flush,
                        lambda v: fused_stream.fused_matvec(bm, v, eq, 0,
                                                            tgb, tau),
                        lambda v: fused_stream.fused_matvec_ref(
                            bm, v, eq, 0, tgb, tau),
                        [(v,) for v in vs],
                        rank_bytes(bm, tiles, tgb, True), lib_ms))
                    if (dtype, effort, tau) == SUMMARY_RANK:
                        p4["ms_device_instance"] = median([gpu_ms(
                            lambda v: fused_stream.fused_matvec(
                                bm, v, eq, inst0, tgb, tau),
                            (v,), flush) for v in vs])
                        # where a call's device time goes (selection,
                        # stream, split sum): the mean over PROFILE_CALLS
                        # calls
                        prof = device_profile(lambda: [
                            fused_stream.fused_matvec(bm, v, eq, 0, tgb,
                                                      tau)
                            for v in vs[:PROFILE_CALLS]])["kernel_ms"]
                        p4["parts_ms"] = per_call(prof, PROFILE_CALLS)
                    emit({"phase": "kernels_rank", "kernel": "K4", **p4})
                    sels = [prefix_stream.select_stream(bm, v, eq, 0, tgb,
                                                        tau=tau)
                            for v in vs]
                    y5 = prefix_stream.stream_matvec(bm, sels[0], tgb)
                    y5r = prefix_stream.stream_matvec_ref(bm, sels[0], tgb)
                    tiles5 = (sels[0].cum_tiles[1:]
                              - sels[0].cum_tiles[:-1]).tolist()
                    p5 = held("K5", y5, y5r, dict(pt, tiles_per_rank=tiles5))
                    if not p5["bitwise_equal"]:
                        raise AssertionError(f"K5 not bit for bit: {p5}")
                    out["k5"].append(timed(
                        p5, flush,
                        lambda s: prefix_stream.stream_matvec(bm, s, tgb),
                        lambda s: prefix_stream.stream_matvec_ref(bm, s,
                                                                  tgb),
                        [(s,) for s in sels],
                        rank_bytes(bm, sum(tiles5), tgb, False), lib_ms))
                    emit({"phase": "kernels_rank", "kernel": "K5", **p5})
                if dtype == "int4":
                    continue
                gather_points(bm, base, effort, vs, flush, lib_ms, out)
            del bm
        del wt, vs
        torch.cuda.empty_cache()
    return out


def gather_points(bm, base, effort, vs, flush, lib_ms, out) -> None:
    """K6 and K7 at one effort: the gather route's capacity, one selection
    per fresh input, each kernel against its plain version and K7 against
    K6, all bit for bit."""
    cap = bucketmul.gather_capacity(bm, effort)
    pos7 = gather_mul.unpacked_positions(bm)
    sels = [select_blocks(bm, v, effort, 0, cap) for v in vs]
    y6 = gather_dma.gather_matvec_dma(bm, sels[0])
    y6r = gather_dma.gather_matvec_dma_ref(bm, sels[0])
    y7 = gather_mul.gather_bucket_matvec(bm, sels[0], pos7)
    y7r = gather_mul.gather_bucket_matvec_ref(bm, sels[0], pos7)
    torch.cuda.synchronize()
    n_blocks = int(sels[0].n_blocks)
    real = min(n_blocks, cap)           # the bound counts no pad block
    pt = dict(base, effort=effort, max_blocks=cap, n_blocks=n_blocks,
              blocks=bm.blocks_per_expert)
    p6 = held("K6", y6, y6r, dict(pt))
    p7 = held("K7", y7, y7r, dict(pt))
    p7["k7_vs_k6_max_abs_diff"] = float((y7 - y6).abs().max())
    if not 1 <= n_blocks <= bm.blocks_per_expert or not torch.equal(y7, y6) \
            or not p6["bitwise_equal"] or not p7["bitwise_equal"]:
        raise AssertionError(f"K6/K7 selection, y bit for bit, or K7 "
                             f"against K6: {p6} {p7}")
    out["k6"].append(timed(
        p6, flush, lambda s: gather_dma.gather_matvec_dma(bm, s),
        lambda s: gather_dma.gather_matvec_dma_ref(bm, s),
        [(s,) for s in sels], gather_bytes(bm, real, bm.pos.shape[2]),
        lib_ms))
    emit({"phase": "kernels_rank", "kernel": "K6", **p6})
    out["k7"].append(timed(
        p7, flush, lambda s: gather_mul.gather_bucket_matvec(bm, s, pos7),
        lambda s: gather_mul.gather_bucket_matvec_ref(bm, s, pos7),
        [(s,) for s in sels], gather_bytes(bm, real, pos7.shape[2]), lib_ms))
    emit({"phase": "kernels_rank", "kernel": "K7", **p7})


def build_rank_model():
    """Mistral-7B width and depth, int8 rank-prefix buckets (B = 4, G =
    16), fused wqkv and w13, int8 LM head, no dense copies (so effort 1.0
    runs K4 at full coverage); random calibrated weights from seed 0."""
    cfg = mistral_7b(n_layers=32, max_seq_len=512)
    bcfg = BucketConfig(dtype="int8", **RANK_BUCKETS)
    t0 = time.perf_counter()
    w = quantize_head(init_random_weights(cfg, bcfg, seed=0, calibrate=True,
                                          fuse=True, device="cuda"))
    torch.cuda.synchronize()
    emit({"phase": "rank_model_setup", "seconds": time.perf_counter() - t0,
          "weights_gib": torch.cuda.memory_allocated() / 2**30})
    return cfg, w


RANK_ROUTES = {"auto": "fused_matvec", "stream": "stream_matvec",
               "gather": "gather_matvec_dma"}


def only(name: str, steps: int, L: int, per_layer: int = 4) -> dict:
    """The launch counts of a decode path whose projections run kernel
    `name` alone: per_layer launches a layer a step (4 projections of a
    dense layer; 6 of an MoE layer: wqkv, wo, and w13, w2 of its two
    experts), every other projection and prefill kernel 0; and K8, the
    decode attention, once a layer a step."""
    want = {k: (per_layer * L * steps if k == name else 0) for k in LAUNCHES}
    want["decode_attention"] = L * steps
    return want


def phase_rank_decode(cfg, w, prompts) -> dict:
    """Single-stream decode on the rank-prefix model: the four prompts at
    efforts 0.25, 0.5 and 1.0 through "auto" (K4; captured steps, and at
    0.25 eager ones too, with the same tokens), one prompt of a few
    tokens through "stream" (K5) and "gather" (K6), each with exact launch
    counts; then one request under the profiler."""
    L, out = cfg.n_layers, {"decode": [], "routes": []}
    eng = Engine(w, cfg, eos_id=-1)
    pairs = routes(eng, w, cfg)
    warm([e for _, e in pairs], prompts[0], (0.25,))
    steps = sum(padded(n, eng.pad_to) + N_NEW - 1 for n in PROMPT_LENS)
    for effort in (0.25, 0.5, 1.0):
        # eager beside the graph at the profiled effort only (time)
        for route, e in pairs[:2 if effort == 0.25 else 1]:
            torch.cuda.synchronize()
            reset_launches()            # the path's run starts here ...
            t0 = time.perf_counter()
            reps = [e.generate(p, n_new=N_NEW, effort=effort)
                    for p in prompts]
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
            launches = dict(LAUNCHES)   # ... and is read here
            r = dict(route=route, effort=effort, requests=len(prompts),
                     steps=steps, ms=ms, ms_per_token=ms / steps,
                     launches=launches, first_tokens=reps[0].token_ids[:8])
            out["decode"].append(r)
            emit({"phase": "rank_decode", **r})
            check_replies([x.token_ids for x in reps], cfg, N_NEW,
                          f"rank decode, {route}, effort {effort}")
            check_launches(launches, only("fused_matvec", steps, L),
                           f"rank decode ({route}) at effort {effort}")
            if route == "graph":
                graph_reps = reps
            else:
                same_tokens(graph_reps, reps, f"rank decode {effort}")
    out["replies"] = graph_reps
    n_new, pad = 4, 8
    for impl in ("stream", "gather"):
        e = Engine(w, cfg, impl=impl, eos_id=-1, pad_to=pad)
        e.generate(prompts[0], n_new=2, effort=0.25)     # warm-up
        torch.cuda.synchronize()
        reset_launches()
        t0 = time.perf_counter()
        rep = e.generate(prompts[0], n_new=n_new, effort=0.25)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        launches = dict(LAUNCHES)
        st = padded(len(prompts[0]), pad) + n_new - 1
        r = dict(impl=impl, effort=0.25, steps=st, ms_per_token=ms / st,
                 launches=launches, tokens=rep.token_ids)
        out["routes"].append(r)
        emit({"phase": "rank_decode_route", **r})
        check_replies([rep.token_ids], cfg, n_new, f"rank decode, {impl}")
        check_launches(launches, only(RANK_ROUTES[impl], st, L),
                       f"rank decode through {impl}")
        if impl == "gather":
            # K6's share of the route's device time, over two tokens
            r["profile"] = device_profile(lambda: e.generate(
                prompts[0], n_new=2, effort=0.25))
            r["profile"]["steps"] = padded(len(prompts[0]), pad) + 1
            emit({"phase": "rank_gather_profile", **r["profile"]})
    out["profile"] = profile_routes("rank_profile", pairs, prompts[0],
                                    need=())
    return out


def phase_rank_same_input(cfg, w, prompt, per_layer: int = 4,
                          phase: str = "rank_same_input") -> list:
    """At depth 32, every K4 call of a few decode steps run through its
    plain version too, on the very inputs (and instance) it was given: per
    layer the least cosine and whether every C_k matched (required: >=
    0.9999 and all equal). per_layer: K4 calls a layer a step (6 on an
    MoE layer)."""
    k4 = bucketmul.fused_matvec
    rows = []
    for effort in (0.25, 0.5):
        cs, eq_c = [], []

        def both(bm, v, effort, expert=0, tile_blocks=8, tau=None):
            y, C, _ = k4(bm, v, effort, expert, tile_blocks, tau,
                         return_selection=True)
            yr, Cr, _ = fused_stream.fused_matvec_ref(
                bm, v, effort, expert, tile_blocks, tau,
                return_selection=True)
            cs.append(torch.nn.functional.cosine_similarity(
                y.double(), yr.double(), dim=0))
            eq_c.append((C == Cr).all())
            return y
        bucketmul.fused_matvec = both
        try:
            kv = make_kv_cache(cfg, "cuda")
            eq = effort_q16(effort, "cuda")
            for pos, tok in enumerate(prompt):
                forward_token(w, cfg, tok, pos, *kv, effort=eq, impl="kernel")
        finally:
            bucketmul.fused_matvec = k4
        L = cfg.n_layers
        n = len(prompt)
        if len(cs) != per_layer * L * n:
            raise AssertionError(f"{len(cs)} K4 calls in {n} steps of {L} "
                                 f"layers")
        least = torch.stack(cs).reshape(n, L, per_layer).amin(dim=(0, 2))
        c_ok = torch.stack(eq_c).reshape(n, L, per_layer).all(dim=2).all(
            dim=0)
        r = dict(depth=L, effort=effort, steps=n, calls=len(cs),
                 k4_min_cos=least.tolist(),
                 k4_c_equal=c_ok.tolist(),
                 min_cos=float(least.min()), required=True)
        rows.append(r)
        emit({"phase": phase, **r})
        if not (r["min_cos"] >= 0.9999 and all(r["k4_c_equal"])):
            raise AssertionError(f"rank same-input check: {r}")
    return rows


def phase_rank_teacher(cfg, w, tokens) -> list:
    """At depth 4 and tau = 1, the kernel route (K4) against the plain
    route over the same tokens, both reading the kernel route's history:
    cos >= 0.999 of the exact-head logits at every step."""
    saved = fused_stream._TAU
    fused_stream._TAU = 1.0
    cfg4 = dataclasses.replace(cfg, n_layers=4)
    rows = []
    try:
        for effort in (0.25, 0.5):
            eq = effort_q16(effort, "cuda")
            kv = make_kv_cache(cfg4, "cuda")
            cs = []
            for pos, tok in enumerate(tokens):
                hp = forward_layers(w, cfg4, embed(w, tok), pos,
                                    *(x.clone() for x in kv), effort=eq,
                                    impl="plain")
                hk = forward_layers(w, cfg4, embed(w, tok), pos, *kv,
                                    effort=eq, impl="kernel")
                cs.append(cos(dense_matvec(rms_norm(hk, w.norm,
                                                    cfg.norm_eps), w.output),
                              dense_matvec(rms_norm(hp, w.norm,
                                                    cfg.norm_eps), w.output)))
            r = dict(depth=4, effort=effort, steps=len(tokens),
                     min_cos=min(cs), mean_cos=sum(cs) / len(cs))
            rows.append(r)
            emit({"phase": "rank_teacher", **r})
            if not r["min_cos"] >= 0.999:
                raise AssertionError(f"rank kernel route vs plain: {r}")
    finally:
        fused_stream._TAU = saved
    return rows


def rank_http(cfg, w, kernel: str = "fused_matvec", per_layer: int = 4,
              phase: str = "rank_http", n_queries: int = 3) -> dict:
    """make_server (single flight) on a model at 127.0.0.1 (a free port),
    in this process: /q requests of 8 tokens at efforts 25, 50 and 100
    (the first n_queries), each answered 200 with 8 tokens, `kernel`
    launched per_layer times a layer a step behind the server and no other
    kernel (on the rank-prefix model K4, 4 a layer)."""
    import asyncio
    import urllib.request
    n = 8
    queries = ("hello", "rank prefix", "effort")[:n_queries]
    eng = Engine(w, cfg, eos_id=-1)

    def fetch(port, q, effort):
        url = (f"http://127.0.0.1:{port}/q?query={q.replace(' ', '+')}"
               f"&effort={effort}&numtokens={n}")
        with urllib.request.urlopen(url, timeout=300) as resp:
            return resp.status, json.loads(resp.read().decode())

    async def run():
        srv = make_server(eng, port=0)
        await srv.start()
        loop = asyncio.get_running_loop()
        try:
            return [await loop.run_in_executor(None, fetch, srv.port, q, e)
                    for q, e in zip(queries, (25, 50, 100))]
        finally:
            await srv.stop()

    torch.cuda.synchronize()
    reset_launches()
    got = asyncio.run(run())
    launches = dict(LAUNCHES)
    # the server's prompt: id 1, then one id a character
    steps = sum(padded(1 + len(q)) + n - 1 for q in queries)
    toks = [json.loads(body["reply"]) for _, body in got]
    r = dict(status=[st for st, _ in got], tokens=toks, launches=launches,
             ok=all(st == 200 and len(t) == n for (st, _), t in zip(got,
                                                                  toks)))
    emit({"phase": phase, **r})
    if not r["ok"]:
        raise AssertionError(f"single-flight server ({phase}): {r}")
    check_launches(launches, only(kernel, steps, cfg.n_layers, per_layer),
                   f"the single-flight server ({phase})")
    return r


# ---- the captured decode step ---------------------------------------------

GREEDY = dict(sampled=False, top_k=0, penalized=False, logprobs_k=0)
GRAPH_EFFORTS = (0.25, 1.0)


def phase_graph(what: str, cfg, w, prompt, n_new: int = 8) -> list:
    """The captured decode step against the eager one on a model at full
    width and depth, at efforts 0.25 and 1.0: teacher-forced logits of
    every position of `prompt` (Engine.token_logits: one replay, or one
    eager step, a position) equal bit for bit, or within what the eager
    route parts from itself on the same tokens (eager_vs_eager, taken
    first); a whole generation's launches (prompt and n_new steps) under
    torch.cuda.set_sync_debug_mode("error"), with no host read before its
    end; its tokens and launch counts equal the eager route's."""
    g = Engine(w, cfg, eos_id=-1)
    x = Engine(w, cfg, eos_id=-1, capture=False)
    rows = []
    for effort in GRAPH_EFFORTS:
        lx = x.token_logits(prompt, effort)
        eager_eager = float((x.token_logits(prompt, effort) - lx).abs().max())
        graph_eager = float((g.token_logits(prompt, effort) - lx).abs().max())
        g.generate(prompt, n_new=n_new, effort=effort)   # warm the key
        got = []
        for e in (g, x):
            torch.cuda.synchronize()
            reset_launches()
            if e is g:
                torch.cuda.set_sync_debug_mode("error")
            try:
                out, _ = e._launch(prompt, n_new, effort, GREEDY, {})
            finally:
                torch.cuda.set_sync_debug_mode("default")
            launches = {k: n for k, n in LAUNCHES.items() if n}
            got.append((out["ids"].tolist(), out["preds"].tolist(),
                        launches))
        r = dict(model=what, effort=effort, positions=len(prompt),
                 graph_vs_eager_max_abs=graph_eager,
                 eager_vs_eager_max_abs=eager_eager,
                 bit_equal=graph_eager == 0.0, sync_free_generate=True,
                 tokens_equal=got[0][:2] == got[1][:2],
                 launches_graph=got[0][2], launches_eager=got[1][2],
                 graphs=len(g._graphs))
        rows.append(r)
        emit({"phase": "graph_vs_eager", **r})
        if graph_eager > eager_eager or not r["tokens_equal"] \
                or got[0][2] != got[1][2]:
            raise AssertionError(f"captured step vs eager ({what}): {r}")
    return rows


def phase_batch_graph(what: str, cfg, w, reqs) -> dict:
    """BatchEngine's captured step against its eager step on the same four
    admissions (efforts 0.25, 0.5, 1.0, 0.25), in lockstep for 8 steps:
    each step's logits [4, vocab] equal bit for bit; the launch counts of
    the steps equal; one replay under set_sync_debug_mode("error")."""
    engines = [BatchEngine(w, cfg, batch_size=4, eos_id=-1, capture=c)
               for c in (True, False)]
    for be in engines:
        for b in range(4):
            be.admit(b, b, reqs[b], 64, SERVE_EFFORTS[b])
    worst, launches = 0.0, []
    for be in engines:                  # warm (captures the graph)
        be.step()
    for be in engines:
        for b in range(4):
            be.admit(b, b, reqs[b], 64, SERVE_EFFORTS[b])
    for _ in range(8):
        counts = []
        for be in engines:
            torch.cuda.synchronize()
            reset_launches()
            be.step()
            counts.append({k: n for k, n in LAUNCHES.items() if n})
        launches.append(counts)
        worst = max(worst, float((engines[0].logits
                                  - engines[1].logits).abs().max()))
    torch.cuda.set_sync_debug_mode("error")
    try:
        engines[0]._graph.replay()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    r = dict(model=what, steps=8, max_abs_logits=worst,
             bit_equal=worst == 0.0, sync_free_replay=True,
             launches_graph=launches[0][0], launches_eager=launches[0][1],
             launches_equal=all(a == b for a, b in launches))
    emit({"phase": "batch_graph_vs_eager", **r})
    if not (r["bit_equal"] and r["launches_equal"] and launches[0][0]):
        raise AssertionError(f"captured batched step vs eager: {r}")
    return r


def phase_sampling(cfg, w, prompt) -> dict:
    """Sampling on the card (Mistral-7B row-prefix, captured steps): the
    same seed twice gives the same tokens; temperature 0, top_k = 1 and
    top_p = 1e-9 each give the greedy tokens; new temperature, top_p and
    penalty values capture no new graph; and 10 000 draws of _pick_token
    from one logits vector (the model's after the prompt; temperature 0.8,
    top_k 5, top_p 0.95) fall within 0.02 total variation of the
    truncated softmax (computed in f64)."""
    eng = Engine(w, cfg, eos_id=-1)
    n_new, effort = 16, 0.5
    greedy = eng.generate(prompt, n_new=n_new, effort=effort).token_ids
    same = {}
    for name, kw in (("temperature_0", dict(temperature=0.0)),
                     ("top_k_1", dict(temperature=1.5, top_k=1, seed=3)),
                     ("top_p_tiny", dict(temperature=1.5, top_p=1e-9,
                                         seed=3))):
        same[name] = eng.generate(prompt, n_new=n_new, effort=effort,
                                  **kw).token_ids == greedy
    kw = dict(temperature=0.8, top_p=0.9, seed=5)
    a = eng.generate(prompt, n_new=n_new, effort=effort, **kw).token_ids
    b = eng.generate(prompt, n_new=n_new, effort=effort, **kw).token_ids
    eng.generate(prompt, n_new=n_new, effort=effort, presence_penalty=0.5)
    n_graphs = len(eng._graphs)
    for kw in (dict(temperature=1.1, top_p=0.7, seed=6),
               dict(temperature=0.6, top_p=0.95, seed=7),
               dict(presence_penalty=0.9, frequency_penalty=0.3)):
        eng.generate(prompt, n_new=n_new, effort=effort, **kw)
    n_after = len(eng._graphs)
    logits = eng.token_logits(prompt, effort)[-1]
    temp, top_k, top_p, n = 0.8, 5, 0.95, 10000
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    draws = torch.stack([_pick_token(logits, gen, True, top_k, temp, top_p)
                         for _ in range(n)])
    freq = torch.bincount(draws.long(), minlength=cfg.vocab_size).double() / n
    lg = logits.double() / temp
    lg = torch.where(lg >= torch.topk(lg, top_k).values[-1], lg, -math.inf)
    srt = torch.sort(lg, descending=True).values
    pr = torch.softmax(srt, 0)
    cut = srt[(torch.cumsum(pr, 0) - pr) < top_p].min()
    want = torch.softmax(torch.where(lg >= cut, lg, -math.inf), 0)
    tv = 0.5 * float((freq - want).abs().sum())
    r = dict(same_seed_same_tokens=a == b, greedy_equivalents=same,
             graphs_before=n_graphs, graphs_after=n_after,
             draws=n, kept=int((want > 0).sum()), total_variation=tv,
             tokens=a[:8])
    emit({"phase": "sampling", **r})
    if not (r["same_seed_same_tokens"] and all(same.values())
            and n_graphs == n_after and tv <= 0.02):
        raise AssertionError(f"sampling: {r}")
    return r


def nudged(w):
    """w with the attention-norm weights moved by a relative 2^-20 x N(0,
    1) (about 16 f32 ulps): the noise floor of a logits comparison."""
    g = torch.Generator(device="cuda")
    g.manual_seed(7)
    nudge = torch.randn(w.layers.attn_norm.shape, generator=g, device="cuda")
    return dataclasses.replace(w, layers=dataclasses.replace(
        w.layers, attn_norm=w.layers.attn_norm * (1 + 2.0**-20 * nudge)))


def min_cos(a, b) -> float:
    return min(cos(x, y) for x, y in zip(a, b))


def kv_bytes(kv) -> int:
    return sum(t.numel() * t.element_size() for side in kv[:2]
               for t in (side if isinstance(side, tuple) else (side,)))


INT8_POSITIONS = 128


def build_plain_model(cfg):
    """The KV-cache phases' model: Mistral-7B width and depth, int8
    row-prefix buckets, fused projections, dense copies (effort 1.0 takes
    them, with no selection that a last-bit change could move), exact
    bf16 LM head, random weights from seed 1 WITHOUT the calibrated
    outlier imprint. On the calibrated model a cache's own rounding moves
    the logits by more than the comparison of two caches can tell apart
    (its bf16 cache against an f32 one parts to cos 0.995 at depth 4;
    int8_kv prints it), so the caches are held against each other
    here."""
    t0 = time.perf_counter()
    w = init_random_weights(cfg, BucketConfig(bucket_size=1, chunk_rows=128,
                                              dtype="int8"),
                            seed=1, fuse=True, keep_dense=True,
                            device="cuda")
    torch.cuda.synchronize()
    emit({"phase": "plain_model", "seconds": time.perf_counter() - t0})
    return w


def f32_cache_logits(cfg, w, toks, effort) -> torch.Tensor:
    """Teacher-forced logits (exact head) of eager forward_token steps
    over an f32 KV cache."""
    kv = make_kv_cache(cfg, "cuda", torch.float32)
    return torch.stack([head_logits(w, rms_norm(forward_layers(
        w, cfg, embed(w, t), p, *kv, effort=effort), w.norm, cfg.norm_eps))
        for p, t in enumerate(toks)])


def int8_same_input(cfg, w, toks) -> list:
    """At every layer and position of a teacher-forced pass (eager steps,
    effort 1.0) the int8 cache's attention read against the bf16 cache's
    on the same query and the same new K/V rows (written to both), so no
    difference carries from one layer or position to the next: the least
    cos a layer."""
    kc, vc = make_kv_cache(cfg, "cuda")
    kq, vq = make_quant_kv_cache(cfg, "cuda")
    q_upd, q_attn = quant_kv_hooks(cfg)
    worst = torch.ones(cfg.n_layers, dtype=torch.float64, device="cuda")

    def upd(k_cache, v_cache, l, pos, k, v):
        write_row(k_cache, l, pos, k)
        write_row(v_cache, l, pos, v)
        q_upd(kq, vq, l, pos, k, v)

    def attn(q, k_cache, v_cache, l, pos):
        a = _attention(q, k_cache[l], v_cache[l], pos, cfg)
        c = torch.nn.functional.cosine_similarity(
            a.double(), q_attn(q, kq, vq, l, pos).double(), dim=0)
        worst[l] = torch.minimum(worst[l], c)
        return a
    for p, t in enumerate(toks):
        forward_token(w, cfg, t, p, kc, vc, effort=1.0, kv_update_fn=upd,
                      attn_fn=attn)
    return worst.tolist()


def phase_int8_kv(cfg, w, w_plain) -> dict:
    """The int8 KV cache at Mistral-7B width and depth: its bytes under
    0.6x the bf16 cache's; required, at each of the 32 layers and 128
    teacher-forced positions, its attention read against the bf16 cache's
    on the same inputs (int8_same_input): cos >= 0.999. Printed, through
    the captured steps: end-to-end logits against the bf16 cache's on the
    same tokens at efforts 1.0 and 0.25, on the uncalibrated model
    (build_plain_model), each beside its noise floor (the bf16 cache
    against itself with the weights nudged, nudged()) and at 1.0 beside
    the bf16 cache against an f32 one; and the same at 1.0 on the
    calibrated model (exact head). A random model of this depth carries a
    last-bit difference into whole logits (the noise floors), so the
    end-to-end numbers are no gate. Then BatchEngine(kv_dtype="int8") on
    the calibrated model serves the 8 requests of `serve` through 4 slots
    (K2 4 * 32 times a step and an admission, K3 32 times an
    admission)."""
    g = torch.Generator().manual_seed(13)
    toks = torch.randint(3, cfg.vocab_size, (INT8_POSITIONS,),
                         generator=g).tolist()
    r = dict(positions=INT8_POSITIONS,
             same_input_min_cos=int8_same_input(cfg, w_plain, toks))
    q8 = Engine(w_plain, cfg, eos_id=-1, quant_kv=True)
    bf = Engine(w_plain, cfg, eos_id=-1)
    for effort in (1.0, 0.25):
        ref = bf.token_logits(toks, effort)
        r[f"min_cos_{effort}"] = min_cos(q8.token_logits(toks, effort), ref)
        r[f"noise_floor_min_cos_{effort}"] = min_cos(Engine(
            nudged(w_plain), cfg, eos_id=-1).token_logits(toks, effort), ref)
    r["bf16_vs_f32_cache_min_cos_1.0"] = min_cos(
        f32_cache_logits(cfg, w_plain, toks, 1.0), bf.token_logits(toks, 1.0))
    r["bytes_int8"], r["bytes_bf16"] = kv_bytes(q8._kv("int8")), kv_bytes(
        bf._kv("full"))
    r["bytes_ratio"] = r["bytes_int8"] / r["bytes_bf16"]
    w_exact = dataclasses.replace(w, output_q=None, output_qscale=None)
    cal = Engine(w_exact, cfg, eos_id=-1).token_logits(toks, 1.0)
    r["calibrated_min_cos_1.0"] = min_cos(Engine(
        w_exact, cfg, eos_id=-1, quant_kv=True).token_logits(toks, 1.0), cal)
    r["calibrated_bf16_vs_f32_cache_min_cos_1.0"] = min_cos(
        f32_cache_logits(cfg, w_exact, toks, 1.0), cal)
    del q8, bf, cal
    reqs = serve_requests(cfg)
    be = BatchEngine(w, cfg, batch_size=4, eos_id=-1, kv_dtype="int8")
    cb = ContinuousBatcher(be)
    cb.submit(reqs[0], 2, 0.25, lambda toks: None)        # warm-up
    cb.run_until_drained()
    done = {}
    for i, (q, e) in enumerate(zip(reqs, SERVE_EFFORTS)):
        cb.submit(q, N_NEW, e, lambda t, i=i: done.__setitem__(i, t))
    torch.cuda.synchronize()
    reset_launches()                    # the path's run starts here ...
    t0 = time.perf_counter()
    ticks = 0
    while cb.has_work():
        cb.tick()
        ticks += 1
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(LAUNCHES)           # ... and is read here
    L, admits = cfg.n_layers, len(reqs)
    r["serve"] = dict(requests=admits, slots=4, steps=ticks, wall_s=wall,
                      tokens_per_s=admits * N_NEW / wall,
                      ms_per_step=wall * 1e3 / ticks, launches=launches)
    emit({"phase": "int8_kv", **r})
    check_replies([done.get(i) or [] for i in range(admits)], cfg, N_NEW,
                  "int8 serve")
    check_launches(launches, {"mxu_matvec_batch": 4 * L * (ticks + admits),
                              "flash_attention": L * admits,
                              "mxu_matvec": 0}, "int8 serve")
    if not (r["bytes_ratio"] < 0.6
            and min(r["same_input_min_cos"]) >= 0.999):
        raise AssertionError(f"int8 KV cache: {r}")
    return r


RING_POSITIONS = 4160
# 4 of Mistral-7B's 32 layers: the phase steps 4 x 4160 positions (220 s
# of the run at 32 layers, 112.8 s at 16), and the cut keeps the whole run,
# with the Llama and full-context phases, inside its time limit; the ring
# of 4096 slots and the 4160 positions past it are what the phase tests
RING_LAYERS = 4


def phase_ring_kv(cfg, w) -> dict:
    """The ring KV cache at Mistral-7B width and its window (4096 slots),
    RING_LAYERS layers (captured steps) on the uncalibrated model
    (build_plain_model): teacher-forced logits of 4160 positions, past the
    window, against a full cache of
    max_seq_len 4224 (the same window) on the same tokens, over the
    positions >= 4096: cos >= 0.999 at every one at effort 1.0, printed at
    0.25."""
    W = cfg.sliding_window
    cfg_r = dataclasses.replace(cfg, n_layers=RING_LAYERS)
    cfg_f = dataclasses.replace(cfg_r, max_seq_len=RING_POSITIONS + 64)
    g = torch.Generator().manual_seed(17)
    toks = torch.randint(3, cfg.vocab_size, (RING_POSITIONS,),
                         generator=g).tolist()
    ring = Engine(w, cfg_r, eos_id=-1, ring_kv=True)
    full = Engine(w, cfg_f, eos_id=-1)
    r = dict(window=W, positions=RING_POSITIONS, layers=RING_LAYERS,
             ring_slots=ring._kv("ring")[0].shape[1])
    for effort in (1.0, 0.25):
        t0 = time.perf_counter()
        a = ring.token_logits(toks, effort)[W:]
        torch.cuda.synchronize()
        r[f"ring_s_{effort}"] = time.perf_counter() - t0
        r[f"min_cos_{effort}"] = min_cos(a, full.token_logits(
            toks, effort)[W:])
    emit({"phase": "ring_kv", **r})
    if not (r["ring_slots"] == W and r["min_cos_1.0"] >= 0.999):
        raise AssertionError(f"ring KV cache: {r}")
    return r


# ---- MoE (Mixtral-8x7B) ---------------------------------------------------

# containers of the K1/K4 instance check
INSTANCES = 3


def phase_instances() -> list:
    """K1 at the Mixtral-8x7B expert shapes (w13 4096 -> 28672, w2 14336 ->
    4096) x {bf16, int8, int4} and K4 at the four projection shapes (int8,
    RANK_BUCKETS), on containers of INSTANCES instances, at efforts 0.25
    and 1.0: every instance given as an int and as a 0-d int32 CUDA tensor
    (read by the kernel on the card) gives y, C (C_k) and u equal bit for
    bit, and the tensor form agrees with the plain version of that
    instance (K1: equal C, cos >= 0.9999; K4: y bit for bit)."""
    g = torch.Generator(device="cuda")
    g.manual_seed(97)
    cases = ([("K1", name, dtype) for name in ("w13", "w2")
              for dtype in DTYPES]
             + [("K4", name, "int8") for name in SHAPES])
    rows = []
    for kernel, name, dtype in cases:
        i, o = SHAPES[name]
        rms = torch.exp(torch.randn(i, generator=g, device="cuda") * 1.2)
        pi = calib_row_order(rms)
        v = rms[pi.long()] * torch.randn(i, generator=g, device="cuda")
        wt = torch.randn((INSTANCES, i, o), generator=g, device="cuda") * 0.02
        if kernel == "K1":
            bc = BucketConfig(bucket_size=1, chunk_rows=128, dtype=dtype)
            bc = dataclasses.replace(bc, chunk_rows=pick_chunk_rows(bc, i, o))
        else:
            bc = BucketConfig(dtype=dtype, **RANK_BUCKETS)
        bm = bucketize(wt, bc, in_perm=pi)
        del wt
        tgb = bucketmul._tile_blocks(bm)
        for e in range(INSTANCES):
            inst = torch.full((), e, dtype=torch.int32, device="cuda")
            for effort in (0.25, 1.0):
                eq = effort_q16(effort, "cuda")
                outs = []
                for x in (e, inst):
                    if kernel == "K1":
                        y, C = fused_stream.mxu_matvec(bm, v, eq, x,
                                                       return_len=True)
                        u = fused_stream.mxu_scratch("cuda")["u"][:i].clone()
                        outs.append((y, C, u))
                    else:
                        y, C, sel = fused_stream.fused_matvec(
                            bm, v, eq, x, tgb, return_selection=True)
                        outs.append((y, C) + tuple(sel))
                if kernel == "K1":
                    yr, Cr = fused_stream.mxu_matvec_ref(bm, v, eq, e,
                                                         return_len=True)
                    plain_ok = (torch.equal(outs[1][1], Cr)
                                and cos(outs[1][0], yr) >= 0.9999)
                else:
                    yr = fused_stream.fused_matvec_ref(bm, v, eq, e, tgb)
                    plain_ok = torch.equal(outs[1][0], yr)
                torch.cuda.synchronize()
                r = dict(kernel=kernel, shape=name, in_dim=i, out_dim=o,
                         dtype=dtype, instance=e, effort=effort,
                         C=outs[0][1].tolist(),
                         bitwise_equal=all(torch.equal(a, b)
                                           for a, b in zip(*outs)),
                         agrees_with_plain=bool(plain_ok))
                rows.append(r)
                if not (r["bitwise_equal"] and r["agrees_with_plain"]):
                    raise AssertionError(f"device instance: {r}")
        del bm
        torch.cuda.empty_cache()
    emit({"phase": "instances", "points": len(rows),
          "all_bitwise_equal": all(r["bitwise_equal"] for r in rows)})
    return rows


def build_moe_model():
    """Mixtral-8x7B width and depth (32 layers, 8 experts, top 2), int8
    row-prefix buckets, fused wqkv and w13, int8 LM head, no dense copies
    (so effort 1.0 runs K1 at full coverage); random calibrated weights
    from seed 0. Returns (cfg, w, engine)."""
    cfg = mixtral_8x7b(n_layers=32, max_seq_len=512)
    bcfg = BucketConfig(bucket_size=1, chunk_rows=128, dtype="int8")
    t0 = time.perf_counter()
    w = quantize_head(init_random_weights(cfg, bcfg, seed=0, calibrate=True,
                                          fuse=True, device="cuda"))
    torch.cuda.synchronize()
    emit({"phase": "moe_model", "seconds": time.perf_counter() - t0,
          "weights_gib": torch.cuda.memory_allocated() / 2**30})
    return cfg, w, Engine(w, cfg, eos_id=-1)


def moe_one_step_no_sync(cfg, w, effort: float = 0.25) -> None:
    """One forward_token step of the MoE model under
    torch.cuda.set_sync_debug_mode("error"): the routed instances stay on
    the card, so nothing in the step may wait on a host read."""
    kv = make_kv_cache(cfg, "cuda")
    eq = effort_q16(effort, "cuda")
    tok = torch.full((), 7, dtype=torch.int32, device="cuda")
    forward_token(w, cfg, tok, 0, *kv, effort=eq)          # warm-up
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        forward_token(w, cfg, tok, 1, *kv, effort=eq)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()


def phase_moe_decode(cfg, w, eng, prompts) -> list:
    """Single-stream MoE decode (K1 with the routed instance on the card):
    the four prompts, 32 new tokens each, at efforts 0.25, 0.5 and 1.0;
    ms a token by CUDA events; K1 6 * 32 times a step and no other kernel;
    then one step under set_sync_debug_mode("error")."""
    steps = sum(padded(n, eng.pad_to) + N_NEW - 1 for n in PROMPT_LENS)
    pairs = routes(eng, w, cfg)
    warm([e for _, e in pairs], prompts[0], (0.25,))
    results = []
    for effort in MOE_EFFORTS:
        # eager beside the graph at the profiled effort only (time)
        for route, e in pairs[:2 if effort == 0.25 else 1]:
            torch.cuda.synchronize()
            reset_launches()            # the path's run starts here ...
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = [e.generate(p, n_new=N_NEW, effort=effort)
                   for p in prompts]
            end.record()
            end.synchronize()
            launches = dict(LAUNCHES)   # ... and is read here
            ms = start.elapsed_time(end)
            r = dict(route=route, effort=effort, requests=len(prompts),
                     steps=steps, ms=ms, ms_per_token=ms / steps,
                     launches=launches, first_tokens=out[0].token_ids[:8])
            results.append(r)
            emit({"phase": "moe_decode", **r})
            check_replies([x.token_ids for x in out], cfg, N_NEW,
                          f"moe decode, {route}, effort {effort}")
            check_launches(launches, only("mxu_matvec", steps, cfg.n_layers,
                                          MOE_PER_LAYER),
                           f"moe decode ({route}) at effort {effort}")
            if route == "graph":
                graph_out = out
            else:
                same_tokens(graph_out, out, f"moe decode {effort}")
    moe_one_step_no_sync(cfg, w)
    emit({"phase": "moe_no_sync", "forward_token_steps": 1,
          "sync_debug_mode": "error", "raised": False})
    results[0]["replies"] = graph_out
    return results


def phase_moe_profile(cfg, w, eng, prompt) -> dict:
    """Where one MoE request's time goes: 8 new tokens after a 5-token
    prompt (39 steps) at efforts 0.25 and 0.5, through the captured steps
    and the eager ones: wall and device ms, the busy share
    and K1's parts; the gate's product (the library's matrix kernels) and
    the top-k (every other kernel of route(): the sort, the softmax, the
    casts) from a trace of the routing alone, route() at every layer of
    39 steps on a normed decode input (the decode's shapes; the decode's
    attention products are matrix kernels too, so its own trace cannot
    tell them apart); the rest is the device time left."""
    pairs = routes(eng, w, cfg)
    out = {f"{route}_{effort}": r for effort in (0.25, 0.5)
           for route, r in profile_routes("moe_profile", pairs, prompt,
                                          effort).items()}
    steps = out["graph_0.25"]["steps"]
    x = rms_norm(embed(w, prompt[0]), w.layers.ffn_norm[0], cfg.norm_eps)
    by_name = device_kernels(lambda: [
        transformer.route(w.layers, l, x, cfg) for _ in range(steps)
        for l in range(cfg.n_layers)])
    by_name.pop(UNION, None)

    def matrix(name):
        return any(k in name.lower() for k in (
            "gemm", "gemv", "nvjet", "xmma", "cutlass", "splitk"))
    for r in out.values():
        if by_name and r["traced"]:
            gate = sum(ms for k, (ms, _) in by_name.items() if matrix(k))
            topk = sum(ms for k, (ms, _) in by_name.items()
                       if not matrix(k))
            k1 = sum(r["kernel_ms"].get(k, 0.0) for k in K1_PARTS)
            r.update(gate_ms=gate, topk_ms=topk,
                     rest_ms=r["device_ms"] - k1 - gate - topk)
        else:
            r.update(gate_ms=None, topk_ms=None, rest_ms=None)
    emit({"phase": "moe_profile_parts",
          **{k: {q: r[q] for q in ("gate_ms", "topk_ms", "rest_ms")}
             for k, r in out.items()},
          "routing_kernels": sorted((k[:60], ms, n) for k, (ms, n)
                                    in by_name.items())})
    return out


def routes_of(fn, forced=None):
    """fn() with every call of transformer.route recorded: (fn's result,
    the experts [..., k] of each call in order). forced {layer: experts
    [n, k]}: a call at that layer takes those experts for its last n rows
    (the gates the softmax of its own logits at them), so two routes can
    be compared with the same routing."""
    route, seen = transformer.route, []

    def record(layer, l, x, cfg):
        gates, idx = route(layer, l, x, cfg)
        if forced is not None and l in forced:
            idx = idx.clone()
            idx[-forced[l].shape[0]:] = forced[l]
            logits = bucketmul.mm_f32(
                x.to(torch.bfloat16).reshape(-1, cfg.dim),
                layer.ffn_gate[l]).reshape(idx.shape[0], -1)
            gates = torch.softmax(torch.gather(logits, -1, idx.long()), -1)
        seen.append(idx)
        return gates, idx
    transformer.route = record
    try:
        return fn(), seen
    finally:
        transformer.route = route


def expert_sets(idx: torch.Tensor) -> torch.Tensor:
    """The top-k experts as sets (sorted): the gated sum does not depend
    on their order beyond the rounding of one f32 addition."""
    return torch.sort(idx, dim=-1).values


def rel_margins(w, cfg, xs) -> list:
    """(second - third largest gate logit) / |largest| of each layer's
    input x [dim] in xs [(l, x)]: how near a routing is to a change."""
    out = []
    for l, x in xs:
        lg = bucketmul.mm_f32(x.to(torch.bfloat16)[None],
                              w.layers.ffn_gate[l])[0]
        top = torch.sort(lg, descending=True).values
        out.append(float((top[1] - top[2]) / top[0].abs()))
    return out


def moe_route_teacher(cfg4, w, tokens, phase: str) -> list:
    """At depth 4 and tau = 1, the kernel route against the plain route
    over the same tokens, both reading the kernel route's history: the same
    top-2 experts at every layer and step, and cos >= 0.999 of the exact
    bf16 head's logits at every step."""
    saved = fused_stream._TAU
    fused_stream._TAU = 1.0
    rows = []
    try:
        for effort in (0.25, 0.5):
            eq = effort_q16(effort, "cuda")
            kv = make_kv_cache(cfg4, "cuda")
            cs, same = [], []
            for pos, tok in enumerate(tokens):
                hp, rp = routes_of(lambda: forward_layers(
                    w, cfg4, embed(w, tok), pos, *(x.clone() for x in kv),
                    effort=eq, impl="plain"))
                hk, rk = routes_of(lambda: forward_layers(
                    w, cfg4, embed(w, tok), pos, *kv, effort=eq,
                    impl="kernel"))
                same.append(torch.equal(expert_sets(torch.stack(rp)),
                                        expert_sets(torch.stack(rk))))
                cs.append(cos(dense_matvec(rms_norm(hk, w.norm,
                                                    cfg4.norm_eps), w.output),
                              dense_matvec(rms_norm(hp, w.norm,
                                                    cfg4.norm_eps),
                                           w.output)))
            r = dict(depth=cfg4.n_layers, effort=effort, steps=len(tokens),
                     min_cos=min(cs), mean_cos=sum(cs) / len(cs),
                     same_experts_every_step=all(same),
                     steps_with_other_experts=[i for i, x in enumerate(same)
                                               if not x])
            rows.append(r)
            emit({"phase": phase, **r})
            if not (r["min_cos"] >= 0.999 and r["same_experts_every_step"]):
                raise AssertionError(f"MoE kernel route vs plain: {r}")
    finally:
        fused_stream._TAU = saved
    return rows


def phase_moe_teacher(cfg, w, tokens) -> dict:
    """The kernel route against the plain route: at depth 4 over a prompt
    and its reply (moe_route_teacher); at depth 32, every K1 call of two
    decode steps also run through its plain version on the very inputs
    and instance it was given: per layer the least cosine and whether
    every C matched (required: >= 0.9999 and all equal)."""
    out = {"depth4": moe_route_teacher(
        dataclasses.replace(cfg, n_layers=4), w, tokens, "moe_teacher")}
    k1 = bucketmul.mxu_matvec
    L, rows = cfg.n_layers, []
    for effort in (0.25, 0.5):
        cs, eq_c = [], []

        def both(bm, v, effort, expert=0, tau=None):
            y, C = k1(bm, v, effort, expert, tau, return_len=True)
            yr, Cr = fused_stream.mxu_matvec_ref(bm, v, effort, expert, tau,
                                                 return_len=True)
            cs.append(torch.nn.functional.cosine_similarity(
                y.double(), yr.double(), dim=0))
            eq_c.append((C == Cr).all())
            return y
        bucketmul.mxu_matvec = both
        try:
            kv = make_kv_cache(cfg, "cuda")
            eq = effort_q16(effort, "cuda")
            for pos, tok in enumerate(tokens[:2]):
                forward_token(w, cfg, tok, pos, *kv, effort=eq, impl="kernel")
        finally:
            bucketmul.mxu_matvec = k1
        n = len(cs) // (MOE_PER_LAYER * L)
        if len(cs) != MOE_PER_LAYER * L * n or n != 2:
            raise AssertionError(f"{len(cs)} K1 calls in 2 steps of {L} "
                                 f"layers")
        per_layer = torch.stack(cs).reshape(n, L, MOE_PER_LAYER).amin(
            dim=(0, 2))
        c_ok = torch.stack(eq_c).reshape(n, L, MOE_PER_LAYER).all(
            dim=2).all(dim=0)
        r = dict(depth=L, effort=effort, steps=n, calls=len(cs),
                 k1_min_cos=per_layer.tolist(), k1_c_equal=c_ok.tolist(),
                 min_cos=float(per_layer.min()), required=True)
        rows.append(r)
        emit({"phase": "moe_same_input", **r})
        if not (r["min_cos"] >= 0.9999 and all(r["k1_c_equal"])):
            raise AssertionError(f"MoE same-input check: {r}")
    out["same_input"] = rows
    return out


def grouped_k2_launches(groups: list) -> int:
    """K2 launches of prefill passes whose grouped routings were recorded
    (one [T, k] experts tensor a layer): wqkv and wo, and w13 and w2 once
    per expert that has tokens."""
    return sum(2 + 2 * len(set(idx.reshape(-1).tolist())) for idx in groups)


def phase_moe_prefill(cfg, w, prompts) -> dict:
    """Engine(prefill=True) on the MoE model: the four prompts (32- and
    64-token padded) at efforts 0.25 and 0.5, one token each: time to first
    token; per pass K3 32 times, K2 2 + 2 g_l times a layer (g_l the
    experts with tokens in layer l, from the routing recorded here), one
    host read of the routing a layer, K1 never. Then the prefill against
    the token loop (moe_prefill_teacher) at depths 4 (printed) and 32
    (the same-input gates)."""
    pre = Engine(w, cfg, eos_id=-1, prefill=True)
    pre.generate(prompts[0], n_new=2, effort=0.25)       # warm-up
    L, out = cfg.n_layers, {"runs": []}
    for effort in (0.25, 0.5):
        ttft = {}

        def run():
            for p in prompts:
                t0 = time.perf_counter()
                pre.generate(p, n_new=1, effort=effort)
                ttft.setdefault(padded(len(p)), []).append(
                    (time.perf_counter() - t0) * 1e3)
        torch.cuda.synchronize()
        reset_launches()                # the path's run starts here ...
        transformer.HOST_READS["moe_routing"] = 0
        _, seen = routes_of(run)
        launches = dict(LAUNCHES)       # ... and is read here
        reads = transformer.HOST_READS["moe_routing"]
        groups = [idx for idx in seen if idx.ndim == 2]
        calls = len(prompts)
        r = dict(effort=effort, requests=calls,
                 ttft_ms={P: median(v) for P, v in ttft.items()},
                 ttft_ms_all=ttft, launches=launches,
                 routing_host_reads=reads,
                 experts_with_tokens=[len(set(idx.reshape(-1).tolist()))
                                      for idx in groups])
        out["runs"].append(r)
        emit({"phase": "moe_prefill", **r})
        check_launches(launches, {
            "mxu_matvec_batch": grouped_k2_launches(groups),
            "flash_attention": L * calls, "mxu_matvec": 0},
            f"moe prefill at effort {effort}")
        if len(groups) != L * calls or reads != L * calls:
            raise AssertionError(f"{len(groups)} grouped routings and "
                                 f"{reads} host reads in {calls} passes")
    out["teacher"] = [r for depth in (4, 32) for r in moe_prefill_teacher(
        dataclasses.replace(cfg, n_layers=depth), w, prompts[1])]
    return out


def moe_prefill_teacher(cfg_d, w, prompt) -> list:
    """The prefill pass against the token loop on one left-padded prompt
    (tau = 1). At depth 4, printed: at efforts 1.0 and 0.25 the logits
    (exact bf16 head) of forward_seq (the grouped MoE FFN on K2) against
    those of forward_layers a position (the per-token FFN on K1, the
    decode attention): with the token loop's experts (routes_of forced)
    and f32 attention ("xla", the decode attention's arithmetic), through
    K3 with them, and with the prefill's own routing through K3 (where
    its expert sets part from the token loop's, and the relative margin
    of that layer input); beside them the noise floor: the token loop
    against itself with the attention-norm weights moved by a relative
    2^-20 x N(0, 1) (about 16 f32 ulps). At effort 0.25 the selections
    turn last-bit differences into whole rows and the routing into whole
    experts, and the differences grow from layer to layer and position to
    position (my chip runs: the nudged token loop falls to cos 0.67 at
    depth 4), so the end-to-end comparison is no gate. At depth 32,
    required (what the prefill adds, held on its own inputs, where no
    difference can grow): every K2 and K3 call of a kernel pass against
    its plain version (cos >= 0.9999, equal C), and at every layer the
    grouped MoE FFN against the per-token FFN (K1 a row, the routed
    instance on the card) on the same rows: the same experts and cos >=
    0.9999 for every row."""
    saved = fused_stream._TAU
    fused_stream._TAU = 1.0
    n, L = len(prompt), cfg_d.n_layers
    P = padded(n)
    off = P - n
    ids = torch.tensor([0] * off + prompt, dtype=torch.int32, device="cuda")
    g = torch.Generator(device="cuda")
    g.manual_seed(7)
    nudge = torch.randn(w.layers.attn_norm.shape, generator=g, device="cuda")
    w_nudged = dataclasses.replace(w, layers=dataclasses.replace(
        w.layers, attn_norm=w.layers.attn_norm * (1 + 2.0**-20 * nudge)))
    rows = []

    def loop(effort, xs, weights=w):
        kv = make_kv_cache(cfg_d, "cuda")
        eq = effort_q16(effort, "cuda")
        ffn = transformer._ffn

        def keep(layer, l, x, *args):      # each layer's FFN input
            xs.append((l, x))
            return ffn(layer, l, x, *args)
        transformer._ffn = keep
        try:
            return torch.stack([dense_matvec(rms_norm(forward_layers(
                weights, cfg_d, embed(weights, ids[off + q]), q, *kv,
                effort=eq, impl="kernel"), weights.norm, cfg_d.norm_eps),
                weights.output) for q in range(n)])
        finally:
            transformer._ffn = ffn

    def seq(cfg_s, eff, impl="auto", attn_impl="auto"):
        return forward_seq(w, cfg_s, ids, *make_kv_cache(cfg_s, "cuda"),
                           rope_offset=off, mask_from=off, effort=eff,
                           impl=impl, attn_impl=attn_impl)[off:]

    def versus(a, b):
        cs = [cos(x, y) for x, y in zip(a, b)]
        return dict(min_cos=min(cs), mean_cos=sum(cs) / len(cs),
                    first_token_equal=bool(a[-1].argmax() == b[-1].argmax()))
    try:
        for effort in ((1.0, 0.25) if L == 4 else ()):
            eff = torch.tensor(effort, device="cuda")
            xs = []
            lt, seen_t = routes_of(lambda: loop(effort, xs))
            tok = torch.stack(seen_t).reshape(n, L, -1)   # [pos, layer, k]
            forced = {l: tok[:, l] for l in range(L)}
            lf, seen_f = routes_of(lambda: seq(cfg_d, eff))
            free = torch.stack(seen_f)[:, off:].transpose(0, 1)
            where = (expert_sets(free) != expert_sets(tok)).any(
                -1).nonzero().tolist()
            margins = rel_margins(w, cfg_d, xs)
            r = dict(depth=L, effort=effort, positions=n, routings=n * L,
                     forced_f32_attention=versus(routes_of(
                         lambda: seq(cfg_d, eff, attn_impl="xla"),
                         forced=forced)[0], lt),
                     forced_k3=versus(routes_of(lambda: seq(cfg_d, eff),
                                                forced=forced)[0], lt),
                     own_routing_k3=versus(lf, lt),
                     own_routing_differs_at=where,
                     margins_where_differs=[margins[q * L + l]
                                            for q, l in where],
                     least_margin=min(margins),
                     token_loop_nudged=versus(loop(effort, [], w_nudged),
                                              lt),
                     required=False)
            rows.append(r)
            emit({"phase": "moe_prefill_teacher", **r})
        if L == 32:
            eff = torch.tensor(0.25, device="cuda")
            seen = []

            def per_layer():
                return [2 + 2 * len(set(idx.reshape(-1).tolist()))
                        for idx in seen]

            def run(*args):
                out, got = routes_of(lambda: seq(*args))
                seen.extend(got)
                return out
            r = dict(depth=L, pair="same_input_k2_k3_0.25",
                     **same_input_layers(run, cfg_d, eff, per_layer))
            r["min_cos"] = min(r["k2_min_cos"] + r["k3_min_cos"])
            r["required"] = True
            rows.append(r)
            emit({"phase": "moe_prefill_teacher", **r})
            if not (r["min_cos"] >= 0.9999 and all(r["k2_c_equal"])):
                raise AssertionError(f"MoE same-input check: {r}")
            r = same_input_moe_ffn(seq, cfg_d, eff)
            rows.append(r)
            emit({"phase": "moe_prefill_teacher", **r})
            if not (r["min_cos"] >= 0.9999 and r["same_experts"]):
                raise AssertionError(f"MoE same-input FFN check: {r}")
    finally:
        fused_stream._TAU = saved
    return rows


def same_input_moe_ffn(seq, cfg_d, eff) -> dict:
    """One kernel-route prefill pass in which every layer's grouped MoE
    FFN (_moe_grouped: K2 once per expert) is also run token by token
    (_moe_rows: K1 a row and expert, the routed instance on the card) on
    the very rows it was given: per layer the least row cosine and whether
    the two routed every row to the same experts."""
    grouped, rows_ffn = transformer._moe_grouped, transformer._moe_rows
    cs, same = [], []

    def both(layer, l, X, pe, cfg, impl):
        (y, g_idx), (yr, r_idx) = (
            routes_of(lambda: grouped(layer, l, X, pe, cfg, impl)),
            routes_of(lambda: rows_ffn(layer, l, X, pe, cfg, "kernel")))
        cs.append(min_row_cos(yr, y))
        same.append(torch.equal(expert_sets(g_idx[0]),
                                expert_sets(torch.stack(r_idx))))
        return y
    transformer._moe_grouped = both
    try:
        seq(cfg_d, eff, "kernel", "flash")
    finally:
        transformer._moe_grouped = grouped
    if len(cs) != cfg_d.n_layers:
        raise AssertionError(f"{len(cs)} grouped FFN calls in "
                             f"{cfg_d.n_layers} layers")
    per_layer = torch.stack(cs).tolist()
    return dict(depth=cfg_d.n_layers, pair="same_input_moe_ffn_0.25",
                ffn_min_cos=per_layer, min_cos=min(per_layer),
                same_experts=all(same), required=True)


def time_batch_ffn(be, steps: int) -> float:
    """ms of `steps` batched decode steps (host clock to the card's end)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        be.step()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / steps


def phase_moe_serve(cfg, w, prompts) -> dict:
    """Continuous batching on the MoE model: BatchEngine(batch_size=4) +
    ContinuousBatcher, 8 requests (prompts of 5-64 tokens, mixed efforts,
    32 new tokens each) through 4 slots: tokens/s; per decode step K1 4
    times a slot a layer (w13 and w2 of two experts, the routed instance
    on the card) and K2 twice a layer; per admission K2 2 + 2 g_l and K3
    once a layer. Then the two ways of a batched step's MoE FFN timed in
    turns (slot by slot with K1, the shipped path; grouped by expert with
    K2 after a host read), one batched step against the single-stream
    route at depth 4, tau = 1 (cos >= 0.999 per slot), make_batch_server
    and make_server answering HTTP."""
    reqs = serve_requests(cfg)
    be = BatchEngine(w, cfg, batch_size=4, eos_id=-1)
    cb = ContinuousBatcher(be)
    cb.submit(reqs[0], 2, 0.25, lambda toks: None)        # warm-up
    cb.run_until_drained()
    done = {}
    for i, (p, e) in enumerate(zip(reqs, SERVE_EFFORTS)):
        cb.submit(p, N_NEW, e, lambda toks, i=i: done.__setitem__(i, toks))
    ticks = [0]

    def run():
        while cb.has_work():
            cb.tick()
            ticks[0] += 1
        torch.cuda.synchronize()
    torch.cuda.synchronize()
    reset_launches()                    # the path's run starts here ...
    t0 = time.perf_counter()
    _, seen = routes_of(run)
    wall = time.perf_counter() - t0
    launches = dict(LAUNCHES)           # ... and is read here
    L, admits, steps = cfg.n_layers, len(reqs), ticks[0]
    groups = [idx for idx in seen if idx.ndim == 2]
    r = dict(requests=admits, slots=4, new_tokens=N_NEW, steps=steps,
             wall_s=wall, tokens_per_s=admits * N_NEW / wall,
             ms_per_step=wall * 1e3 / steps, launches=launches,
             first_tokens=done.get(0, [])[:8])
    emit({"phase": "moe_serve", **r})
    check_replies([done.get(i) or [] for i in range(admits)], cfg, N_NEW,
                  "moe serve")
    check_launches(launches, {
        "mxu_matvec": 4 * be.B * L * steps,
        "mxu_matvec_batch": 2 * L * steps + grouped_k2_launches(groups),
        "flash_attention": L * admits}, "moe serve")
    # the batched step's MoE FFN two ways, in turns on the same slots, as
    # eager steps (the captured step holds the FFN it was captured with,
    # and the grouped FFN reads the routing to the host)
    be.capture = False
    for b in range(be.B):
        be.admit(b, b, reqs[b], 128, SERVE_EFFORTS[b])
    rows_ffn = transformer._moe_rows
    ways = {"slot_by_slot_k1": rows_ffn,
            "grouped_k2": transformer._moe_grouped}
    ms = {k: [] for k in ways}
    try:
        for k in ("slot_by_slot_k1", "grouped_k2", "grouped_k2",
                  "slot_by_slot_k1", "slot_by_slot_k1", "grouped_k2"):
            transformer._moe_rows = ways[k]
            be.step()                   # warm-up of this way
            ms[k].append(time_batch_ffn(be, 10))
    finally:
        transformer._moe_rows = rows_ffn
    r["batch_ffn_ms_per_step"] = ms
    emit({"phase": "moe_serve_ffn_ways", "ms_per_step": ms})
    r["teacher"] = serve_teacher(cfg, w, reqs, phase="moe_serve_teacher")
    r["http_batch"] = serve_http(cfg, w, phase="moe_serve_http")
    r["http_single"] = rank_http(cfg, w, "mxu_matvec", MOE_PER_LAYER,
                                 "moe_http", n_queries=2)
    return r


def build_moe_rank_model():
    """Mixtral-8x7B width and depth with int8 rank-prefix buckets
    (RANK_BUCKETS: about 1.25 bytes a weight), fused projections, int8 LM
    head, no dense copies; random calibrated weights from seed 0."""
    cfg = mixtral_8x7b(n_layers=32, max_seq_len=512)
    t0 = time.perf_counter()
    w = quantize_head(init_random_weights(
        cfg, BucketConfig(dtype="int8", **RANK_BUCKETS), seed=0,
        calibrate=True, fuse=True, device="cuda"))
    torch.cuda.synchronize()
    emit({"phase": "moe_rank_model", "seconds": time.perf_counter() - t0,
          "weights_gib": torch.cuda.memory_allocated() / 2**30})
    return cfg, w


def phase_moe_rank(prompts) -> dict:
    """The rank-prefix MoE model: "auto" decode (K4 with the routed
    instance on the card, 6 * 32 launches a step, no other kernel) on the
    four prompts at efforts 0.25, 0.5 and 1.0, one step under
    set_sync_debug_mode("error"), at depth 32 every K4 call of two steps
    against its plain version on the same inputs and instance, and at
    depth 4 the kernel route against the plain route at tau = 1
    (moe_route_teacher)."""
    cfg, w = build_moe_rank_model()
    eng = Engine(w, cfg, eos_id=-1)
    eng.generate(prompts[0], n_new=2, effort=0.25)       # warm-up
    steps = sum(padded(n, eng.pad_to) + N_NEW - 1 for n in PROMPT_LENS)
    out = {"decode": []}
    for effort in MOE_EFFORTS:
        torch.cuda.synchronize()
        reset_launches()                # the path's run starts here ...
        t0 = time.perf_counter()
        reps = [eng.generate(p, n_new=N_NEW, effort=effort) for p in prompts]
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        launches = dict(LAUNCHES)       # ... and is read here
        r = dict(effort=effort, requests=len(prompts), steps=steps, ms=ms,
                 ms_per_token=ms / steps, launches=launches,
                 first_tokens=reps[0].token_ids[:8])
        out["decode"].append(r)
        emit({"phase": "moe_rank_decode", **r})
        check_replies([x.token_ids for x in reps], cfg, N_NEW,
                      f"moe rank decode, effort {effort}")
        check_launches(launches, only("fused_matvec", steps, cfg.n_layers,
                                      MOE_PER_LAYER),
                       f"moe rank decode at effort {effort}")
    moe_one_step_no_sync(cfg, w)
    emit({"phase": "moe_rank_no_sync", "raised": False})
    out["same_input"] = phase_rank_same_input(
        cfg, w, prompts[0][:2], MOE_PER_LAYER, "moe_rank_same_input")
    out["teacher"] = moe_route_teacher(
        dataclasses.replace(cfg, n_layers=4), w,
        prompts[0] + reps[0].token_ids[:8], "moe_rank_teacher")
    return out


# ---- speculative decode -----------------------------------------------------

K3_SLOT_TS = (4, 8, 64)
K3_SLOT_STARTS = (0, 37, 448)
K3_SLOT_RUNS = 5
SPEC_KS = (4, 8)
SPEC_DRAFTS = (0.25, 0.5, 1.0)
SPEC_PROMPT = 32
SPEC_NEW = 64
# the trainer's argmax gate holds where its top two logits lie more than
# NEAR_TIE apart (served_gate). The speculative phases' token gates take
# no constant: a first divergence passes only where the spec token is the
# reference route's runner-up and the reference's top-two gap lies within
# the two routes' measured disagreement there (tie_reading)
NEAR_TIE = 0.05


def phase_k3_device_slots(flush: torch.Tensor) -> list:
    """K3 with start_slot and mask_from as 0-d int32 CUDA tensors (read on
    the card) against the same launch with ints, at T in K3_SLOT_TS x
    start slots K3_SLOT_STARTS and a 128-slot window (start 448),
    Mistral-7B heads over a 512-slot cache: y bit for bit, K3's gate
    against its plain version, and each form's device ms (L2 flushed,
    medians of K3_SLOT_RUNS queries)."""
    g = torch.Generator(device="cuda")
    g.manual_seed(101)
    H, KV, D, S = 32, 8, 128, ATTN_SLOTS
    kc = torch.randn((S, KV, D), generator=g, device="cuda").to(
        torch.bfloat16)
    vc = torch.randn((S, KV, D), generator=g, device="cuda").to(
        torch.bfloat16)
    zero = torch.zeros((), dtype=torch.int32, device="cuda")
    points = []
    for T in K3_SLOT_TS:
        Qs = [torch.randn((T, H * D), generator=g, device="cuda") * 2.0
              for _ in range(K3_SLOT_RUNS)]
        for start, win in [(s, 0) for s in K3_SLOT_STARTS] + [(448, 128)]:
            dev = torch.full((), start, dtype=torch.int32, device="cuda")

            def run(q, s, m, plain=False):
                return flash_attention_seq(q, kc, vc, s, m, H, D,
                                           window=win, plain=plain)
            equal = all(torch.equal(run(q, start, 0), run(q, dev, zero))
                        for q in Qs)
            agree = attention_agreement((T, start, 0, win, H, KV, D),
                                        run(Qs[0], dev, zero),
                                        run(Qs[0], start, 0, plain=True))
            p = dict(T=T, start_slot=start, window=win, bit_equal=equal,
                     min_row_cos=agree["min_row_cos"],
                     max_abs_err=agree["max_abs_err"],
                     ms_int=median([gpu_ms(run, (q, start, 0), flush)
                                    for q in Qs]),
                     ms_device=median([gpu_ms(run, (q, dev, zero), flush)
                                       for q in Qs]))
            points.append(p)
            emit({"phase": "k3_device_slots", **p})
            if not (equal and agree["ok"]):
                raise AssertionError(f"K3 with device slots: {p}, {agree}")
    return points


def timed_ms(fn):
    """(fn(), device-queue milliseconds between CUDA events around it)."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    out = fn()
    end.record()
    end.synchronize()
    return out, start.elapsed_time(end)


def first_divergence(ref: list, got: list, gaps) -> dict:
    """Where `got` first parts from the reference tokens `ref`, or None;
    gaps(i) gives tie_reading's (gap, runner-up, route gap) at index i. A
    near tie passes: `got` the runner-up, the gap within the route gap."""
    i = next((j for j, (a, b) in enumerate(zip(ref, got)) if a != b), None)
    if i is None:
        return None if len(ref) == len(got) else dict(
            index=min(len(ref), len(got)), near_tie=False,
            why="lengths differ")
    gap, runner, route_gap = gaps(i)
    return dict(index=i, ref=ref[i], got=got[i], gap=gap,
                route_gap=route_gap, got_is_runner_up=got[i] == runner,
                near_tie=got[i] == runner and gap <= route_gap)


def tie_reading(ref: torch.Tensor, other: torch.Tensor) -> tuple:
    """(top-1 minus top-2 of the reference route's logits `ref`, its
    runner-up token, the largest |ref - other|): `other` the logits of the
    route that parted from it, teacher-forced over the same tokens. Two
    routes that round differently can swap two tokens whose gap lies
    within the logits' measured difference, and no others."""
    top = torch.topk(ref.float(), 2)
    v, i = top.values.tolist(), top.indices.tolist()
    return v[0] - v[1], i[1], float((ref.float() - other.float()).abs()
                                    .max())


def route_witness(what: str, cfg, w, eng, prompt: list, ref: list,
                  n_new: int) -> dict:
    """Why spec tokens part from the greedy tokens: the decode step's
    logits teacher-forced over prompt + ref with K8 (eng's) and with the
    plain attention (an engine captured with transformer.k8_route off),
    each against the verify's route (forward_seq: K3, bf16 queries), their
    largest logit difference over the positions and the positions whose
    argmax parts; and the plain attention's own greedy tokens against
    K8's, their first divergence read as the gate reads spec's. Printed,
    not gated."""
    ids = prompt + ref
    n = len(ids)
    k8 = eng.token_logits(ids, 1.0)
    saved = transformer.k8_route
    transformer.k8_route = lambda *a: False
    try:
        plain_eng = Engine(w, cfg, eos_id=-1)
        plain = plain_eng.token_logits(ids, 1.0)
        plain_ref = plain_eng.generate(prompt, n_new=n_new,
                                       effort=1.0).token_ids
    finally:
        transformer.k8_route = saved
    k3 = eng._forward_seq(ids, 1.0)[-n:]

    def parts(a, b):
        return dict(max_abs=float((a - b).abs().max()),
                    argmax_parts=int((a.argmax(-1) != b.argmax(-1)).sum()))
    at = len(prompt) - 1
    r = dict(model=what, positions=n, k8_vs_plain=parts(k8, plain),
             k8_vs_k3=parts(k8, k3), plain_vs_k3=parts(plain, k3),
             plain_greedy_vs_k8=first_divergence(
                 ref, plain_ref, lambda i: tie_reading(k8[at + i],
                                                       plain[at + i])))
    emit({"phase": "spec_route_witness", **r})
    return r


def spec_launches_want(cfg, eng, k: int, draft: float, rounds: int,
                       n: int) -> dict:
    """The kernels' launches of one speculative generation: n prompt steps
    at 1.0, then per round k drafts (K1 per projection unless the dense
    copies take the draft) and one verify (K3 a layer; K2 per attention
    projection, and the dense FFN's, unless the dense copies take effort
    1.0; an MoE FFN's experts through K1, a row and expert at a time)."""
    L, moe = cfg.n_layers, cfg.n_experts > 1
    per_step = (2 + 2 * cfg.n_experts_per_tok) * L if moe else 4 * L
    dense_1 = eng._dense(1.0, eng.impl)
    k1 = 0 if dense_1 else n * per_step
    k1 += 0 if eng._dense(draft, eng.impl) else rounds * k * per_step
    k2 = 0
    if not dense_1:
        k2 = rounds * (2 if moe else 4) * L
        if moe:
            k1 += rounds * k * 2 * cfg.n_experts_per_tok * L
    return {"mxu_matvec": k1, "mxu_matvec_batch": k2,
            "flash_attention": rounds * L}


def phase_spec(what: str, cfg, w, prompt, ks=SPEC_KS, drafts=SPEC_DRAFTS,
               n_new: int = SPEC_NEW, gate_tokens: bool = True) -> dict:
    """Engine.generate_speculative on one model: for each k and draft
    effort, tokens a round, ms a token (CUDA events around the call; and
    the rounds' own, the prompt pass taken off), host reads a round,
    launches; beside it the captured greedy decode at 1.0. Gates: the
    tokens are that decode's (a first divergence only at a near tie,
    first_divergence against the routes' measured disagreement there;
    printed only with gate_tokens=False; route_witness beside it); at
    draft 1.0 at least
    k - 1 tokens a round; one status read a round, no routing read, exact
    launch counts; a generation's rounds replayed equal the eager rounds
    (capture=False) bit for bit (ids, status, the last verify logits) with
    equal launches; one round's replay under
    set_sync_debug_mode("error")."""
    eng = Engine(w, cfg, eos_id=-1)
    n = len(prompt)
    steps = padded(n, eng.pad_to) + n_new - 1
    eng.generate(prompt, n_new=2, effort=1.0)               # warm the key
    ref, ref_ms = timed_ms(lambda: eng.generate(prompt, n_new=n_new,
                                                effort=1.0).token_ids)
    _, prompt_ms = timed_ms(lambda: eng._decode(prompt, n_new, 1.0, {}, {},
                                                steps=n))
    gap_cache = {}

    def gaps(i):
        """The greedy route (the decode step: K8) at index i against the
        verify's (forward_seq: K3), teacher-forced over the same tokens."""
        if i not in gap_cache:
            ids = prompt + ref[:i]
            gap_cache[i] = tie_reading(eng.token_logits(ids, 1.0)[-1],
                                       eng._forward_seq(ids, 1.0)[-1])
        return gap_cache[i]
    out = dict(model=what, prompt=n, new_tokens=n_new,
               decode_ms_per_token=ref_ms / steps, prompt_pass_ms=prompt_ms,
               rows=[])
    emit({"phase": "spec_reference", **out})
    out["witness"] = route_witness(what, cfg, w, eng, prompt, ref, n_new)
    for k in ks:
        for de in drafts:
            eng.generate_speculative(prompt, n_new=4, draft_effort=de, k=k)
            reset_launches()
            HOST_READS["spec_status"] = 0
            HOST_READS["moe_routing"] = 0
            rep, ms = timed_ms(lambda: eng.generate_speculative(
                prompt, n_new=n_new, draft_effort=de, k=k))
            launches = dict(LAUNCHES)
            reads = dict(HOST_READS)
            rounds = round(n_new / rep.spec_tokens_per_iter)
            loop_ms = ms - prompt_ms
            div = first_divergence(ref, rep.token_ids, gaps)
            r = dict(model=what, k=k, draft_effort=de,
                     tokens_per_round=rep.spec_tokens_per_iter,
                     rounds=rounds, ms=ms, ms_per_token=ms / n_new,
                     rounds_ms_per_token=loop_ms / (n_new - 1),
                     ms_per_round=loop_ms / rounds,
                     k_decode_steps_ms=k * ref_ms / steps,
                     decode_ms_per_token=ref_ms / steps,
                     host_reads_per_round=reads["spec_status"] / rounds,
                     routing_reads=reads["moe_routing"],
                     launches={x: c for x, c in launches.items() if c},
                     divergence=div)
            out["rows"].append(r)
            emit({"phase": "spec", **r})
            if gate_tokens and div is not None and not div["near_tie"]:
                raise AssertionError(f"spec tokens part from greedy at 1.0 "
                                     f"({what}): {r}")
            if de == 1.0:
                r["short_rounds"] = short_rounds(eng, prompt, n_new, k)
                emit({"phase": "spec_short_rounds", "model": what, "k": k,
                      **r["short_rounds"]})
                if rep.spec_tokens_per_iter < k - 1 \
                        and not r["short_rounds"]["all_near_ties"]:
                    raise AssertionError(f"a draft at 1.0 accepted too "
                                         f"few, not at near ties: {r}")
            if reads["spec_status"] != rounds or reads["moe_routing"]:
                raise AssertionError(f"host reads in the rounds: {r}")
            check_launches(launches, spec_launches_want(
                cfg, eng, k, de, rounds, n), f"spec ({what}) k={k} {de}")
    out["graph"] = spec_graph_vs_eager(what, cfg, w, eng, prompt)
    return out


def short_rounds(eng, prompt, n_new: int, k: int) -> dict:
    """The rounds of a speculative generation with drafts at 1.0 that
    accept fewer than k - 1 drafts before n_new: a draft at 1.0 (the
    decode step: K8, f32) and the verify (K3: queries rounded to bf16)
    part only where the verify's top two logits nearly tie, so each such
    round must stop at a near tie with the draft the verify's runner-up:
    the verify's gap within its logits' largest difference from the
    decode step's, teacher-forced over the same tokens after the run
    (tie_reading). One status read more a round (inspection, not the
    timed run)."""
    n, rounds, missed = len(prompt), [], []
    last = [1]

    def on_round(sp):
        n_gen = int(sp.status[0])
        emitted, last[0] = n_gen - last[0], n_gen
        rounds.append(emitted)
        if emitted >= k or n_gen >= n_new:
            return
        j = emitted - 1                 # the verify's pick the draft missed
        missed.append((n + n_gen - 1, j, sp.logits[j].clone(),
                       int(sp.consumed[j + 1])))
    st, _, _ = eng._spec_launch(prompt, n_new, 1.0, k, on_round=on_round)
    ids = st.ids[:n + n_new].tolist()
    gaps = []
    for at, j, verify, draft in missed:
        gap, runner, route_gap = tie_reading(
            verify, eng.token_logits(ids[:at], 1.0)[-1])
        gaps.append(dict(at=j, gap=gap, route_gap=route_gap,
                         draft_is_runner_up=draft == runner))
    return dict(rounds=len(rounds), short=len(gaps),
                max_gap=max((g["gap"] for g in gaps), default=0.0),
                all_near_ties=all(g["draft_is_runner_up"]
                                  and g["gap"] <= g["route_gap"]
                                  for g in gaps))


def spec_graph_vs_eager(what: str, cfg, w, eng, prompt, k: int = 4,
                        de: float = 0.25, n_new: int = 16) -> dict:
    """A speculative generation's rounds replayed against the same rounds
    run eagerly: ids, status and the last round's verify logits bit for
    bit, launches equal; then one replay with no host read."""
    x = Engine(w, cfg, eos_id=-1, capture=False)
    got = []
    for e in (eng, x):
        torch.cuda.synchronize()
        reset_launches()
        st, sp, _ = e._spec_launch(prompt, n_new, de, k)
        torch.cuda.synchronize()
        got.append((st.ids[:len(prompt) + n_new].clone(), sp.status.clone(),
                    sp.logits.clone(),
                    {c: n for c, n in LAUNCHES.items() if n}))
    (ig, sg, lg, cg), (ie, se, le, ce) = got
    graph = eng._graphs[next(key for key in eng._graphs
                             if key.loop == "spec" and key.spec_k == k
                             and key.dense == eng._dense(de, eng.impl))]
    torch.cuda.set_sync_debug_mode("error")
    try:
        graph.replay()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    r = dict(model=what, k=k, draft_effort=de, new_tokens=n_new,
             rounds=int(sg[2]), ids_equal=torch.equal(ig, ie),
             status_equal=torch.equal(sg, se),
             verify_logits_max_abs=float((lg - le).abs().max()),
             bit_equal=torch.equal(lg, le), launches_graph=cg,
             launches_eager=ce, sync_free_round=True)
    emit({"phase": "spec_graph_vs_eager", **r})
    if not (r["ids_equal"] and r["status_equal"] and r["bit_equal"]
            and cg == ce):
        raise AssertionError(f"spec rounds, graph vs eager ({what}): {r}")
    return r


def serve_with_gaps(be, reqs, efforts, n_new: int):
    """Requests through a ContinuousBatcher over `be`; returns (tokens by
    request, {(request, index): logits} of each plain step, steps, wall
    ms)."""
    cb, done, logits = ContinuousBatcher(be), {}, {}
    step = be.step

    def recorded(positions=None):
        act = be.active()
        finished = step(positions)
        if not be.spec_k:
            for b in act:
                st = be.slots[b]
                logits[(st.request_id, len(st.generated) - 1)] = \
                    be.logits[b].clone()
        return finished
    be.step = recorded
    for i, (p, e) in enumerate(zip(reqs, efforts)):
        cb.submit(p, n_new, e, lambda toks, i=i: done.__setitem__(i, toks))
    steps, t0 = 0, time.perf_counter()
    while cb.has_work():
        cb.tick()
        steps += 1
    torch.cuda.synchronize()
    return done, logits, steps, (time.perf_counter() - t0) * 1e3


def phase_batch_spec(what: str, cfg, w, k: int = 4,
                     draft: float = 0.25) -> dict:
    """BatchEngine(batch_size=4, spec_k=k) serving the 8 serving requests
    (efforts 0.25/0.5/1.0, N_NEW tokens) against plain batched decode at
    the same efforts; ms and tokens a step (host clock; the spec steps
    warm first), launches, at the default tau. Gate, at tau = 1: the
    requests at effort 1.0 give the plain tokens, a first divergence only
    at a near tie of the plain step (first_divergence, against the plain
    step's logits' largest difference from the verify's route, K2 and K3,
    teacher-forced over the request's tokens). At tau < 1 K2 streams the
    longest prefix of the rows it is given (the verify's B * k rows, plain
    decode's B), so an effort-1.0 request's logits depend on the requests
    beside it; at tau = 1 every row streams every chunk and only rounding
    parts the two (the verify's K3 takes bf16 queries). Below 1.0 that
    rounding moves which rows the next selection takes, so those tokens
    part at this depth (PERF.md §6). Every first divergence is printed."""
    reqs = serve_requests(cfg)

    def verify_route(ids: list, effort: float) -> torch.Tensor:
        """The last logits of forward_seq over ids as BatchEngine admits
        a prompt: the effort a device scalar (K2 at every effort, on the
        buckets the verify's forward_seq_batch reads), K3 attention."""
        k, v = make_kv_cache(cfg, "cuda")
        return forward_seq(w, cfg, torch.tensor(ids, dtype=torch.int32,
                                                device="cuda"), k, v,
                           effort=torch.full((), float(effort),
                                             device="cuda"))[-1]

    def compare(r: dict) -> dict:
        plain, logits, p_steps, _ = serve_with_gaps(
            BatchEngine(w, cfg, batch_size=4, eos_id=-1), reqs,
            SERVE_EFFORTS, N_NEW)

        def gaps(i, j):
            if (i, j) not in logits:
                return math.inf, -1, 0.0
            return tie_reading(logits[(i, j)], verify_route(
                reqs[i] + plain[i][:j], SERVE_EFFORTS[i]))
        be = BatchEngine(w, cfg, batch_size=4, eos_id=-1, spec_k=k,
                         spec_draft_effort=draft)
        serve_with_gaps(be, reqs[:1], (0.25,), 2)                # warm-up
        torch.cuda.synchronize()
        reset_launches()
        spec, _, steps, ms = serve_with_gaps(be, reqs, SERVE_EFFORTS, N_NEW)
        r.update(launches={x: c for x, c in LAUNCHES.items() if c},
                 steps=steps, ms=ms, plain_steps=p_steps)
        check_replies([spec.get(i) or [] for i in range(len(reqs))], cfg,
                      N_NEW, "batch_spec")
        return {i: d for i in range(len(reqs))
                if (d := first_divergence(
                    plain[i], spec[i], lambda j, i=i: gaps(i, j)))}

    run = {}
    divs = compare(run)
    saved = fused_stream._TAU
    fused_stream._TAU = 1.0
    try:
        divs_tau1 = compare({})
    finally:
        fused_stream._TAU = saved
    steps, launches = run["steps"], run["launches"]
    r = dict(model=what, spec_k=k, draft_effort=draft, requests=len(reqs),
             new_tokens=N_NEW, steps=steps, ms_per_step=run["ms"] / steps,
             tokens_per_step=len(reqs) * N_NEW / steps,
             plain_steps=run["plain_steps"], launches=launches,
             divergences=divs, divergences_tau1=divs_tau1)
    emit({"phase": "batch_spec", **r})
    if any(not d["near_tie"] for i, d in divs_tau1.items()
           if SERVE_EFFORTS[i] >= 1.0):
        raise AssertionError(f"batched spec tokens part from plain batched "
                             f"decode at effort 1.0, tau = 1: {r}")
    if not launches.get("mxu_matvec_batch") or not launches.get(
            "flash_attention"):
        raise AssertionError(f"batched spec skipped K2 or K3: {r}")
    return r


def phase_moe_spec(cfg, w, prompt) -> dict:
    """Speculative decode on Mixtral-8x7B, one request, k = 4, drafts at
    0.25. At full depth (the loaded 32-layer model): tokens a round, ms a
    token, one status read a round, no routing read, exact launches (the
    verify's experts through K1 a row, _moe_rows), graph against eager
    bit for bit, a round with no host read; the tokens against the
    captured greedy decode at 1.0 are printed. The token gate runs at
    depth 4 (the same seed's first 4 layers) at tau = 1: at 1.0 without
    dense copies the verify streams K2's longest-row prefix and the
    decode step K1's own, which part at tau < 1, and at 32 layers the
    verify's K3 (queries in bf16) against the decode step's f32 attention
    moves the routing (PERF.md §6)."""
    out = phase_spec("mixtral_row", cfg, w, prompt, ks=(4,),
                     drafts=(0.25,), gate_tokens=False)
    cfg4 = dataclasses.replace(cfg, n_layers=4)
    w4 = quantize_head(init_random_weights(
        cfg4, BucketConfig(bucket_size=1, chunk_rows=128, dtype="int8"),
        seed=0, calibrate=True, fuse=True, device="cuda"))
    tau = fused_stream._TAU
    fused_stream._TAU = 1.0
    try:
        gate = phase_spec("mixtral_row_depth4_tau1", cfg4, w4, prompt,
                          ks=(4,), drafts=(0.25,))
    finally:
        fused_stream._TAU = tau
    out["rows"] += gate["rows"]
    out["depth4_graph"] = gate["graph"]
    return out


# ---- checkpoints: HF -> convert -> load -> serve --------------------------

# depth of the converted checkpoint: 32 layers are 14.5 GB of bf16 source
# plus about 7.5 GB converted on disk, and every layer's conversion is the
# same code at the same width (depth adds bytes, not coverage)
CKPT_LAYERS = 4
CKPT_EFFORTS = (0.25, 0.5, 1.0)
CKPT_NEW = 16
CKPT_PROMPTS = (5, 17, 32)
# Mistral-7B-Instruct-v0.2's config.json (HF), depth cut to CKPT_LAYERS
HF_MISTRAL = {
    "architectures": ["MistralForCausalLM"], "model_type": "mistral",
    "hidden_size": 4096, "intermediate_size": 14336,
    "num_hidden_layers": CKPT_LAYERS, "num_attention_heads": 32,
    "num_key_value_heads": 8, "vocab_size": 32000, "rms_norm_eps": 1e-5,
    "rope_theta": 1e6, "max_position_embeddings": 32768,
    "sliding_window": None, "tie_word_embeddings": False,
    "torch_dtype": "bfloat16", "bos_token_id": 1, "eos_token_id": 2,
    "hidden_act": "silu"}
CKPT_QUERIES = ("hello there", "tell me a story", "how are you doing",
                "the quick brown fox")
CKPT_HTTP_EFFORTS = (25, 50, 100, 25)


def write_hf(d: Path, seed: int, h: dict = HF_MISTRAL) -> dict:
    """A random HF-format checkpoint in d: h (HF_MISTRAL, or HF_LLAMA3:
    the two families name their tensors alike) as its config.json and
    bf16 tensors ([out, in], HF_NAME_MAPS["mistral"] names) in 5 GB
    shards, as HF ships them; made on the card from a seed. Returns the
    bf16 card tensors by name."""
    dim, hid, L = (h["hidden_size"], h["intermediate_size"],
                   h["num_hidden_layers"])
    hd = dim // h["num_attention_heads"]
    q, kv = h["num_attention_heads"] * hd, h["num_key_value_heads"] * hd
    names = HF_NAME_MAPS["mistral"]
    g = torch.Generator(device="cuda")
    g.manual_seed(seed)

    def rnd(shape, scale=0.02, base=0.0):
        return (base + scale * torch.randn(shape, generator=g,
                                           device="cuda")).to(torch.bfloat16)

    t = {names["embed"]: rnd((h["vocab_size"], dim)),
         names["lm_head"]: rnd((h["vocab_size"], dim)),
         names["norm"]: rnd((dim,), 0.1, 1.0)}
    for l in range(L):
        for p, shape in (("wq", (q, dim)), ("wk", (kv, dim)),
                         ("wv", (kv, dim)), ("wo", (dim, q)),
                         ("w1", (hid, dim)), ("w2", (dim, hid)),
                         ("w3", (hid, dim))):
            t[names[p].format(l=l)] = rnd(shape)
        for p in ("attn_norm", "ffn_norm"):
            t[names[p].format(l=l)] = rnd((dim,), 0.1, 1.0)
    w = SafeTensorWriter(str(d), "model", shard_bytes=5 * 2**30)
    for name, x in t.items():
        w.add(name, x.view(torch.int16).cpu().numpy().view(np.uint16),
              bf16_bits=True)
    w.save()
    with open(d / "config.json", "w") as f:
        json.dump(h, f, indent=1)
    return t


def raw_from_hf(t: dict, cfg) -> dict:
    """assemble_weights' raw dict ([n_inst, in, out] f32 on the card) of
    the same HF tensors the converter read."""
    names, L = HF_NAME_MAPS["mistral"], cfg.n_layers

    def stack(p):
        return torch.stack([t[names[p].format(l=l)].float().T
                            for l in range(L)])
    raw = {p: stack(p) for p in ("wq", "wk", "wv", "wo", "w1", "w2", "w3")}
    raw.update(ffn_gate=None, tok_embeddings=t[names["embed"]].float(),
               output=t[names["lm_head"]].float().T,
               norm=t[names["norm"]].float(),
               **{k: torch.stack([t[names[p].format(l=l)].float()
                                  for l in range(L)])
                  for k, p in (("attn_norm", "attn_norm"),
                               ("ffn_norm", "ffn_norm"))})
    return raw


def write_bpe_tokenizer(path: Path, vocab_size: int) -> None:
    """A SentencePiece-style BPE tokenizer.json: <unk>, <s>, </s>, the 256
    byte-fallback tokens, "▁" and the printable ASCII characters, a few
    merges, and word pieces "▁x<i>" up to vocab_size (so every id a model
    can give decodes to text)."""
    sp = "▁"
    vocab = {"<unk>": 0, "<s>": 1, "</s>": 2}
    vocab.update({f"<0x{b:02X}>": 3 + b for b in range(256)})
    for c in [sp] + [chr(i) for i in range(33, 127)]:
        vocab.setdefault(c, len(vocab))
    merges = [(sp, "t"), ("h", "e"), (sp + "t", "he"), ("e", "r"),
              (sp, "a"), ("o", "r"), ("i", "n"), ("in", "g"), ("l", "l"),
              ("o", "w"), (sp, "h"), (sp + "h", "e"), ("e", "ll")]
    for a, b in merges:
        vocab.setdefault(a + b, len(vocab))
    while len(vocab) < vocab_size:
        vocab[f"{sp}x{len(vocab)}"] = len(vocab)
    with open(path, "w") as f:
        json.dump({"version": "1.0", "model": {
            "type": "BPE", "vocab": vocab, "byte_fallback": True,
            "merges": [f"{a} {b}" for a, b in merges]}}, f)


class Collect(dict):
    """A writer stand-in for _bucketize_and_store: keeps what it adds."""

    def add(self, name, t, bf16_bits=False):
        self[name] = t


def ckpt_conversion_gate(hf: dict, dst: Path, cfg, bcfg, calib) -> dict:
    """Gate 1: layer 0's four fused projections converted again on the
    CPU by the port, from the same source, against the card's conversion
    on disk: vals, pos, probes and the dense copy byte for byte (and
    seg_order, when stored); stats and scales to 1e-6 relative (f32
    reductions run in another order on the card); the largest relative
    difference printed."""
    names = HF_NAME_MAPS["mistral"]
    pi_m = np.argsort(-calib["rms_m"].cpu().numpy()).astype(np.int32)
    pi_f = np.argsort(-calib["rms_f"].cpu().numpy()).astype(np.int32)
    pi_13 = np.concatenate([pi_f, pi_f + cfg.hidden_dim])

    def src(*ps):
        return torch.cat([hf[names[p].format(l=0)].cpu().float()
                          for p in ps])
    col = Collect()
    pre = "layers.0."
    for prefix, w_hf, ip, op in (
            ("attention.wqkv", src("wq", "wk", "wv"), pi_m, None),
            ("attention.wo", src("wo"), None, pi_m),
            ("feed_forward.experts.0.w13", src("w1", "w3"), pi_m, pi_13),
            ("feed_forward.experts.0.w2", src("w2"), pi_f, pi_m)):
        _bucketize_and_store(col, pre + prefix, w_hf, bcfg, True,
                             in_perm=ip, out_perm=op)
    r = MultiShardReader(str(dst))
    exact, rel = [], {}
    for name, want in col.items():
        got = np.array(r[name])
        if got.shape != want.shape or got.dtype != want.dtype:
            raise AssertionError(f"conversion gate: {name} {got.shape} "
                                 f"{got.dtype} vs {want.shape} "
                                 f"{want.dtype}")
        if name.endswith((".stats", ".scales")):
            d = np.abs(got.astype(np.float64) - want) / np.maximum(
                np.abs(want.astype(np.float64)), 1e-30)
            rel[name] = float(d.max())
        else:
            exact.append(name)
            if not np.array_equal(got, want):
                raise AssertionError(f"conversion gate: {name} differs "
                                     f"between the card and the CPU")
    r.close()
    out = dict(byte_equal=sorted(exact), max_rel=rel,
               max_rel_all=max(rel.values()))
    emit({"phase": "ckpt_conversion_gate", **out})
    if not out["max_rel_all"] <= 1e-6:
        raise AssertionError(f"conversion gate: {out}")
    return out


def differing_fields(a, b) -> list:
    """Fields of two ModelWeights that are not bit for bit equal (meta
    fields of each projection included)."""
    diff = [f for f in ("tok_embeddings", "norm", "output")
            if not torch.equal(getattr(a, f), getattr(b, f))]
    la, lb = a.layers, b.layers
    for f in ("attn_norm", "ffn_norm", "ffn_gate"):
        x, y = getattr(la, f), getattr(lb, f)
        if (x is None) != (y is None) or (x is not None
                                          and not torch.equal(x, y)):
            diff.append(f)
    for p in transformer.PROJ_FIELDS:
        x, y = getattr(la, p), getattr(lb, p)
        if (x is None) != (y is None):
            diff.append(p)
        if x is None or y is None:
            continue
        for f in dataclasses.fields(x):
            u, v = getattr(x, f.name), getattr(y, f.name)
            if u is None or v is None:
                same = u is None and v is None
            elif isinstance(u, torch.Tensor):
                same = (u.dtype == v.dtype and u.shape == v.shape
                        and torch.equal(u, v))
            else:
                same = u == v
            if not same:
                diff.append(f"{p}.{f.name}")
    return diff


def timed_generate(eng, prompts, effort, n_new: int = CKPT_NEW) -> tuple:
    """(replies, ms a token): CUDA events around the prompts' requests."""
    steps = sum(padded(len(p), eng.pad_to) + n_new - 1 for p in prompts)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = [eng.generate(p, n_new=n_new, effort=effort) for p in prompts]
    end.record()
    end.synchronize()
    return out, start.elapsed_time(end) / steps


def ckpt_same_input(cfg, w, prompt, efforts=(0.25, 0.5),
                    phase: str = "ckpt_same_input") -> list:
    """Gate 3 on the loaded model's own inputs: every K1 call of two decode
    steps (forward_token, kernel route) against K1's plain version, and
    every K2 and K3 call of a left-padded prefill of the prompt
    (same_input_layers) against theirs, at each effort: cos >= 0.9999 per
    layer and equal C. The other models' phases hold theirs so too."""
    k1 = bucketmul.mxu_matvec
    L, rows = cfg.n_layers, []
    P = padded(len(prompt))
    off = P - len(prompt)
    ids = torch.tensor([0] * off + prompt, dtype=torch.int32, device="cuda")

    def seq(cfg_d, effort, impl, attn_impl):
        return forward_seq(w, cfg_d, ids, *make_kv_cache(cfg_d, "cuda"),
                           rope_offset=off, mask_from=off, effort=effort,
                           impl=impl, attn_impl=attn_impl)[off:]

    for effort in efforts:
        cs, eq_c = [], []

        def both(bm, v, eff, expert=0, tau=None):
            y, C = k1(bm, v, eff, expert, tau, return_len=True)
            yr, Cr = fused_stream.mxu_matvec_ref(bm, v, eff, expert, tau,
                                                 return_len=True)
            cs.append(torch.nn.functional.cosine_similarity(
                y.double(), yr.double(), dim=0))
            eq_c.append((C == Cr).all())
            return y
        bucketmul.mxu_matvec = both
        try:
            kv = make_kv_cache(cfg, "cuda")
            eq = effort_q16(effort, "cuda")
            for pos, tok in enumerate(prompt[:2]):
                forward_token(w, cfg, tok, pos, *kv, effort=eq,
                              impl="kernel")
        finally:
            bucketmul.mxu_matvec = k1
        if len(cs) != 2 * 4 * L:
            raise AssertionError(f"{len(cs)} K1 calls in 2 steps of {L} "
                                 f"layers")
        k1_cos = torch.stack(cs).reshape(2, L, 4).amin(dim=(0, 2))
        r = dict(effort=effort, k1_min_cos=k1_cos.tolist(),
                 k1_c_equal=torch.stack(eq_c).reshape(2, L, 4).all(
                     dim=2).all(dim=0).tolist(),
                 **same_input_layers(seq, cfg,
                                     torch.tensor(effort, device="cuda")))
        r["min_cos"] = min(r["k1_min_cos"] + r["k2_min_cos"]
                           + r["k3_min_cos"])
        rows.append(r)
        emit({"phase": phase, **r})
        if not (r["min_cos"] >= 0.9999 and all(r["k1_c_equal"])
                and all(r["k2_c_equal"])):
            raise AssertionError(f"same-input check ({phase}): {r}")
    return rows


def ckpt_http(dst: Path, tok_json, batch: int) -> dict:
    """build_server(--ckpt, --tokenizer, --batch) on 127.0.0.1 (a free
    port), in this process: the four CKPT_QUERIES as concurrent /q requests
    of 8 tokens at efforts CKPT_HTTP_EFFORTS, each answered 200 with
    decoded text (batched: the text of its token ids); the launches of the
    run, and the prompt ids the server made of each query. tok_json None:
    no tokenizer, so a reply is its token ids as text."""
    import asyncio
    import urllib.parse
    import urllib.request
    n = 8
    tok_args = ["--tokenizer", str(tok_json)] if tok_json else []
    srv = build_server(parse_args(["--ckpt", str(dst), *tok_args, "--batch",
                                   str(batch), "--port", "0"]))

    def fetch(port, q, effort):
        url = (f"http://127.0.0.1:{port}/q?query={urllib.parse.quote(q)}"
               f"&effort={effort}&numtokens={n}")
        with urllib.request.urlopen(url, timeout=300) as resp:
            return resp.status, json.loads(resp.read().decode())

    async def run():
        await srv.start()
        loop = asyncio.get_running_loop()
        try:
            return await asyncio.gather(*[
                loop.run_in_executor(None, fetch, srv.port, q, e)
                for q, e in zip(CKPT_QUERIES, CKPT_HTTP_EFFORTS)])
        finally:
            await srv.stop()

    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    got = asyncio.run(run())
    seconds = time.perf_counter() - t0
    launches = dict(LAUNCHES)
    tok = srv.tokenizer
    ok = all(st == 200 and isinstance(b.get("reply"), str) and b["reply"]
             for st, b in got)
    if batch and tok is not None:
        # n tokens, or fewer ending at the end-of-sequence id 2
        ok &= all(b["reply"] == tok.decode(b["token_ids"])
                  and (len(b["token_ids"]) == n
                       or b["token_ids"][-1:] == [2]) for _, b in got)
    r = dict(batch=batch, status=[st for st, _ in got], seconds=seconds,
             replies=[b.get("reply") for _, b in got], launches=launches,
             prompts=[srv._encode_query(q) for q in CKPT_QUERIES],
             tokenizer_native=tok.native if tok is not None else None, ok=ok)
    emit({"phase": "ckpt_http", **r})
    del srv
    if not ok:
        raise AssertionError(f"checkpoint server (--batch {batch}): {r}")
    return r


def phase_ckpt() -> dict:
    """HF checkpoint -> convert (on the card) -> load -> serve, at
    Mistral-7B width, CKPT_LAYERS deep (module docstring, `ckpt`)."""
    t_phase = time.perf_counter()
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        src, dst = tmp / "hf", tmp / "buckets"
        src.mkdir()
        t0 = time.perf_counter()
        hf = write_hf(src, seed=12)
        out["write_hf_s"] = time.perf_counter() - t0
        cfg = config_from_hf(str(src))
        want = dataclasses.replace(mistral_7b(n_layers=CKPT_LAYERS,
                                              max_seq_len=4096,
                                              rope_theta=1e6),
                                   name="mistral", sliding_window=None)
        if cfg != want:
            raise AssertionError(f"config_from_hf: {cfg} vs {want}")
        bcfg = BucketConfig(bucket_size=1, chunk_rows=128, dtype="int8")
        g = torch.Generator(device="cuda")
        g.manual_seed(13)
        calib = {"rms_m": torch.exp(1.2 * torch.randn(
                     cfg.dim, generator=g, device="cuda")),
                 "rms_f": torch.exp(1.2 * torch.randn(
                     cfg.hidden_dim, generator=g, device="cuda"))}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        convert_checkpoint(str(src), str(dst), cfg, bcfg, fuse=True,
                           store_core=True, calib=calib, device="cuda",
                           progress=lambda *a: None)
        torch.cuda.synchronize()
        out["convert_s"] = time.perf_counter() - t0
        src_bytes = sum(f.stat().st_size for f in src.iterdir())
        dst_bytes = sum(f.stat().st_size for f in dst.iterdir())
        out.update(src_gb=src_bytes / 1e9, dst_gb=dst_bytes / 1e9,
                   convert_read_gb_s=src_bytes / 1e9 / out["convert_s"],
                   convert_written_gb_s=dst_bytes / 1e9 / out["convert_s"],
                   disk_free_gb=os.statvfs(tmp).f_bavail
                   * os.statvfs(tmp).f_frsize / 1e9)
        t0 = time.perf_counter()
        w, cfg_l, bcfg_l = load_bucketized(str(dst), device="cuda")
        torch.cuda.synchronize()
        out["load_s"] = time.perf_counter() - t0
        out["load_gb_s"] = dst_bytes / 1e9 / out["load_s"]
        if cfg_l != cfg or bcfg_l != bcfg or w.layers.wqkv.dense is None:
            raise AssertionError("loaded config, buckets or dense copies")
        reader = MultiShardReader(str(dst))
        reader._reader("norm")
        out.update(native_lib=native_lib_path() is not None,
                   reader_native=all(x.native
                                     for x in reader._readers.values()))
        reader.close()
        emit({"phase": "ckpt_convert", **out})

        out["conversion_gate"] = ckpt_conversion_gate(hf, dst, cfg, bcfg,
                                                      calib)
        # gate 2: the loaded model against assemble_weights on the same
        # raw arrays and calibration. The two builders break ties of equal
        # rms apart (the converter's numpy argsort, as the JAX package's
        # converter; assemble_weights' stable sort), and a tie moves a row
        # across the chunk order: assemble_weights gets the converter's
        # order, as descending ranks, and the ties are printed
        ranks, ties = {}, {}
        for k, v in calib.items():
            order = torch.from_numpy(np.argsort(-v.cpu().numpy()))
            ranks[k] = torch.empty(len(order)).index_put_(
                (order,), torch.arange(len(order), 0, -1.0)).cuda()
            ties[k] = len(order) - int(torch.unique(v).numel())
        w_ref = assemble_weights(raw_from_hf(hf, cfg), cfg, bcfg,
                                 keep_dense=True, rms_m=ranks["rms_m"],
                                 rms_f=ranks["rms_f"], fuse=True)
        del hf
        diff = differing_fields(w, w_ref)
        out["calib_ties"] = ties
        gen = torch.Generator().manual_seed(11)
        prompts = [torch.randint(3, cfg.vocab_size, (n,),
                                 generator=gen).tolist()
                   for n in CKPT_PROMPTS]
        eng, eng_ref = Engine(w, cfg, eos_id=-1), Engine(w_ref, cfg,
                                                         eos_id=-1)
        warm([eng, eng_ref], prompts[0], CKPT_EFFORTS)
        rows, runs = [], []
        for effort in CKPT_EFFORTS:
            reset_launches()
            got, ms = timed_generate(eng, prompts, effort)
            runs.append(dict(launches=dict(LAUNCHES)))
            ref, ms_ref = timed_generate(eng_ref, prompts, effort)
            toks = [x.token_ids for x in got]
            teacher = prompts[1] + toks[1]
            cs = [cos(a, b) for a, b in zip(
                eng.token_logits(teacher, effort),
                eng_ref.token_logits(teacher, effort))]
            rows.append(dict(effort=effort, ms_per_token=ms,
                             ms_per_token_in_memory=ms_ref,
                             same_tokens=toks == [x.token_ids for x in ref],
                             logits_min_cos=min(cs),
                             first_tokens=toks[0][:8]))
            emit({"phase": "ckpt_decode", **rows[-1]})
        out.update(differing_fields=diff, decode=rows)
        emit({"phase": "ckpt_load_gate", "differing_fields": diff,
              "calib_ties": ties})
        if not all(r["same_tokens"] and r["logits_min_cos"] >= 0.9999
                   for r in rows):
            raise AssertionError(f"loaded vs in-memory model: {rows}, "
                                 f"differing fields {diff}")
        del eng_ref, w_ref
        out["same_input"] = ckpt_same_input(cfg, w, prompts[1])
        del eng, w
        gc.collect()
        tok_json = tmp / "tokenizer.json"
        write_bpe_tokenizer(tok_json, cfg.vocab_size)
        http = [ckpt_http(dst, tok_json, b) for b in (4, 0)]
        out["http"] = http
        runs += [dict(launches=h["launches"]) for h in http]
        # the command line on this checkpoint, before it goes
        out["cli"] = phase_cli(src, dst, tok_json, tmp)
    out["runs"] = runs
    launched = {k: sum(r["launches"].get(k, 0) for r in runs)
                for k in ("mxu_matvec", "mxu_matvec_batch",
                          "flash_attention")}
    out["launches"] = launched
    out["seconds"] = time.perf_counter() - t_phase - out["cli"]["seconds"]
    emit({"phase": "ckpt", "launches": launched, "seconds": out["seconds"],
          **{k: out[k] for k in ("convert_s", "convert_read_gb_s",
                                 "load_s", "src_gb", "dst_gb")}})
    missing = [k for k, n in launched.items() if not n]
    if missing:
        raise AssertionError(f"kernels the checkpoint path never launched: "
                             f"{missing}")
    return out


# ---- the user-facing surface: session, eval harness, command line --------

SESSION_TURNS = (17, 5, 32)        # prompt tokens of the three turns
SESSION_NEW = 16
SESSION_EFFORTS = (0.25, 1.0)
EVAL_TOKENS = 48                   # the eval phase's history
EVAL_EFFORTS = (1.0, 0.5, 0.25)
GOLDEN_TOKENS = 8
TRACED_TOKENS = 4


def seeded_ids(cfg, lens, seed: int) -> list:
    g = torch.Generator().manual_seed(seed)
    return [torch.randint(3, cfg.vocab_size, (n,), generator=g).tolist()
            for n in lens]


def counted(runs: list, fn):
    """fn() with the launches of its run appended to runs."""
    torch.cuda.synchronize()
    reset_launches()
    out = fn()
    torch.cuda.synchronize()
    runs.append(dict(launches=dict(LAUNCHES)))
    return out


def phase_session(cfg, w, eng) -> dict:
    """ChatSession on the 32-layer row-prefix model: three turns (prompts
    of SESSION_TURNS tokens, SESSION_NEW new each) at each of
    SESSION_EFFORTS, each turn's steps replays of one captured step.
    Gates: (a) turns 2 and 3 give Engine.generate's tokens on the
    concatenated history; (b) a capture=False session gives the same
    tokens; (c) turn 2 launches everything under
    set_sync_debug_mode("error"), its one host read after; (d) saved after
    turn 2 and loaded into a fresh session, turn 3 gives the original's
    tokens; (e) turn_stream's chunks (5 a chunk) joined equal turn 1;
    (f) K1 runs 4 * n_layers times a step below effort 1 (0 at 1.0: dense
    copies), K2 and K3 never. Printed: ms a step of turn 3 (host clock,
    ending in the turn's read) beside Engine.generate's on the same
    tokens."""
    turns = seeded_ids(cfg, SESSION_TURNS, 17)
    rows, runs = [], []
    for effort in SESSION_EFFORTS:
        g = ChatSession(w, cfg, eos_id=-1)
        x = ChatSession(w, cfg, eos_id=-1, capture=False)
        got, ref_same, launch_ok = [], [], []
        timing = {}
        with tempfile.TemporaryDirectory() as tmp:
            for i, prompt in enumerate(turns):
                history = list(g.history)
                steps = len(prompt) + SESSION_NEW
                torch.cuda.synchronize()
                reset_launches()
                t0 = time.perf_counter()
                if i == 1:                                   # gate (c)
                    torch.cuda.set_sync_debug_mode("error")
                    try:
                        args = g._start_turn(prompt, SESSION_NEW, effort)
                    finally:
                        torch.cuda.set_sync_debug_mode("default")
                    toks = g._finish(*args)
                else:
                    toks = g.turn(prompt, n_new=SESSION_NEW, effort=effort)
                secs = time.perf_counter() - t0
                runs.append(dict(launches=dict(LAUNCHES)))
                want = 4 * cfg.n_layers * steps if effort < 0.999 else 0
                launch_ok.append(LAUNCHES["mxu_matvec"] == want
                                 and not LAUNCHES["mxu_matvec_batch"]
                                 and not LAUNCHES["flash_attention"])
                got.append(toks)
                if i == 1:
                    g.save(os.path.join(tmp, "s"))
                if i:                                        # gate (a)
                    full = history + prompt
                    torch.cuda.synchronize()
                    reset_launches()
                    t0 = time.perf_counter()
                    ref = eng.generate(full, n_new=SESSION_NEW,
                                       effort=effort).token_ids
                    ref_secs = time.perf_counter() - t0
                    runs.append(dict(launches=dict(LAUNCHES)))
                    ref_same.append(ref == toks)
                    if i == 2:
                        ref_steps = padded(len(full)) + SESSION_NEW - 1
                        timing = dict(
                            session_ms_per_step=secs * 1e3 / steps,
                            engine_ms_per_step=ref_secs * 1e3 / ref_steps,
                            session_steps=steps, engine_steps=ref_steps)
            eager = [counted(runs, lambda p=p: x.turn(
                p, n_new=SESSION_NEW, effort=effort)) for p in turns]
            loaded = ChatSession.load(os.path.join(tmp, "s"), w, cfg,
                                      eos_id=-1)
            after_load = counted(runs, lambda: loaded.turn(
                turns[2], n_new=SESSION_NEW, effort=effort))
        s = ChatSession(w, cfg, eos_id=-1)
        chunks = counted(runs, lambda: list(s.turn_stream(
            turns[0], n_new=SESSION_NEW, chunk=5, effort=effort)))
        r = dict(effort=effort, turns=list(SESSION_TURNS),
                 new=SESSION_NEW, pos=g.pos, graphs=len(g.engine._graphs),
                 engine_tokens=ref_same, eager_tokens=eager == got,
                 sync_free_turn=True, load_tokens=after_load == got[2],
                 stream_tokens=[t for c in chunks for t in c] == got[0],
                 stream_chunks=[len(c) for c in chunks],
                 launches_exact=launch_ok, first_tokens=got[0][:8],
                 **timing)
        rows.append(r)
        emit({"phase": "session", **r})
        if not (all(ref_same) and r["eager_tokens"] and r["load_tokens"]
                and r["stream_tokens"] and all(launch_ok)
                and r["graphs"] == 1):
            raise AssertionError(f"session at effort {effort}: {r}")
        del g, x, loaded, s
    return dict(rows=rows, runs=runs)


def phase_eval(cfg, w, eng, gen_ms: dict) -> dict:
    """The eval harness on the 32-layer row-prefix model, over an
    EVAL_TOKENS-token history: agreement_sweep (32 prompt tokens, 16
    generated) and kl_divergence_sweep over effort_scale() (gates: 100%
    agreement and KL <= 1e-6 at 1.0); decode_speed_sweep at EVAL_EFFORTS
    with dense (each printed beside `generate`'s CUDA-event ms a token);
    streamed_fraction at 0.5 and 0.25, each probed chunk prefix beside the
    C that K1 itself streams on the same input (gate: within one chunk);
    capture_states / save_states / verify_states at 1.0 (gate: passed, no
    drift) and at 0.25 on the kernel route (drift printed); one sweep
    (nll_sweep over TRACED_TOKENS tokens at 0.25) under profiling.trace(),
    its Chrome trace under OUT_DIR (gate: the annotated span in it)."""
    text = seeded_ids(cfg, (EVAL_TOKENS,), 19)[0]
    runs, out = [], {}
    t0 = time.perf_counter()
    agree = counted(runs, lambda: harness.agreement_sweep(
        eng, text[:32], n_tokens=EVAL_TOKENS - 32))
    kl = counted(runs, lambda: harness.kl_divergence_sweep(eng, text))
    out["sweeps_s"] = time.perf_counter() - t0
    out["agreement"] = {str(e): a for e, a in agree.items()}
    out["kl"] = {str(e): k for e, k in kl.items()}
    emit({"phase": "eval_sweeps", "seconds": out["sweeps_s"],
          "agreement": out["agreement"], "kl": out["kl"]})
    if agree[1.0] != 1.0 or not abs(kl[1.0]) <= 1e-6:
        raise AssertionError(f"eval sweeps at effort 1.0: {agree[1.0]}, "
                             f"{kl[1.0]}")

    speed = counted(runs, lambda: harness.decode_speed_sweep(
        w, cfg, efforts=EVAL_EFFORTS, include_dense=True, impl="kernel"))
    slope = {"dense": 1e3 / speed["dense_toks_per_s"]}
    slope.update({e: 1e3 / speed[f"toks_per_s_{int(e * 100)}"]
                  for e in EVAL_EFFORTS})
    out["decode_speed"] = dict(
        sweep=speed, slope_ms={str(k): v for k, v in slope.items()},
        generate_ms={str(k): v for k, v in gen_ms.items()},
        slope_over_generate={
            "dense": slope["dense"] / gen_ms[1.0],
            **{str(e): slope[e] / gen_ms[e] for e in EVAL_EFFORTS
               if e < 0.999}})
    emit({"phase": "eval_decode_speed", **out["decode_speed"]})

    t0 = time.perf_counter()
    sf = harness.streamed_fraction(w, cfg, text, efforts=(0.5, 0.25))
    H = harness.collect_residuals(w, cfg, text)
    bm = w.layers.any_w1
    probes = []
    for e in (0.5, 0.25):
        for li in harness.probe_layers(cfg.n_layers):
            for t in range(len(text) - 8, len(text)):
                hn = rms_norm(torch.from_numpy(H[t][li - 1]).cuda(),
                              w.layers.ffn_norm[li], cfg.norm_eps)
                c_host, _ = harness.chunk_prefix(bm, hn.cpu().numpy(), e,
                                                 li, sf["tau"])
                _, ck = fused_stream.mxu_matvec(bm, hn, effort_q16(e, "cuda"),
                                                li, return_len=True)
                probes.append(dict(effort=e, layer=li, token=t,
                                   C_host=c_host, C_k1=int(ck)))
    worst = max(abs(p["C_host"] - p["C_k1"]) for p in probes)
    k1_frac = {str(e): float(np.mean([p["C_k1"] / bm.n_chunks
                                      for p in probes if p["effort"] == e]))
               for e in (0.5, 0.25)}
    out["streamed_fraction"] = dict(
        harness=sf, k1_streamed_chunk_frac=k1_frac, probes=len(probes),
        max_chunk_gap=worst, n_chunks=bm.n_chunks,
        seconds=time.perf_counter() - t0)
    emit({"phase": "eval_streamed_fraction", **out["streamed_fraction"]})
    if worst > 1:
        raise AssertionError(f"streamed_fraction's prefix vs K1's C: gap "
                             f"{worst} chunks")

    with tempfile.TemporaryDirectory() as tmp:
        ids = text[:GOLDEN_TOKENS]
        tester.save_states(tmp, tester.capture_states(w, cfg, ids, 1.0))
        rep1 = tester.verify_states(tmp, tester.capture_states(w, cfg, ids,
                                                               1.0))
        rep2 = counted(runs, lambda: tester.verify_states(
            tmp, tester.capture_states(w, cfg, ids, 0.25, impl="kernel")))
    out["golden"] = {"effort_1.0": str(rep1), "effort_0.25_kernel":
                     str(rep2), "drift_0.25": rep2.drift,
                     "compared": rep2.compared}
    emit({"phase": "eval_golden", **out["golden"]})
    if not (rep1.passed and rep1.drift == 0):
        raise AssertionError(f"golden states at 1.0: {rep1}")

    trace_dir = OUT_DIR / "eval_trace"
    shutil.rmtree(trace_dir, ignore_errors=True)
    # a short sweep: a captured 32-layer step traces ~2 MB of kernel events
    with profiling.trace(str(trace_dir)):
        with profiling.annotate("eval_traced_sweep"):
            counted(runs, lambda: harness.nll_sweep(
                eng, text[:TRACED_TOKENS], efforts=(0.25,)))
    files = sorted(trace_dir.glob("trace_*.json"))
    body = files[0].read_text() if files else ""
    out["trace"] = dict(file=str(files[0].relative_to(OUT_DIR.parent))
                        if files else None, bytes=len(body),
                        annotated="eval_traced_sweep" in body,
                        k1_kernels_in_trace="k1_select_kernel" in body)
    emit({"phase": "eval_trace", **out["trace"]})
    if not out["trace"]["annotated"]:
        raise AssertionError(f"traced sweep: {out['trace']}")
    out["runs"] = runs
    return out


CLI_TIMEOUT_S = 600
CLI_PROMPT = "Tell me a story about the quick brown fox"
CLI_QUIZ = [{"question": q, "answers": a, "correct": c} for q, a, c in (
    ("What color is a clear daytime sky?", ["blue", "red", "green"], 0),
    ("What is two plus two?", ["three", "four"], 1),
    ("Which animal barks?", ["cat", "fish", "dog", "bird"], 2))]
CLI_SWEEP = {"agreement": r"effort +[0-9.]+%: agreement +[0-9.]+%",
             "kl": r"effort +[0-9.]+%: KL +[0-9.]+ nats",
             "quiz": r"effort +[0-9.]+%: accuracy +[0-9.]+%",
             "bucket": r"effort +[0-9.]+%: cos-sim -?[0-9.]+"}


def cli_start(args: list, stdin: str = None) -> dict:
    """python3 -m effort_tpu_torch ARGS in a subprocess (the checkout on
    its path, the card its device)."""
    env = {**os.environ, "PYTHONPATH": str(OUT_DIR.parent)}
    p = subprocess.Popen([sys.executable, "-m", "effort_tpu_torch", *args],
                         stdin=subprocess.PIPE, stdout=subprocess.PIPE,
                         stderr=subprocess.PIPE, text=True, env=env,
                         cwd=str(OUT_DIR.parent))
    return dict(proc=p, stdin=stdin, t0=time.perf_counter(), args=args)


def cli_wait(run: dict) -> dict:
    out, err = run["proc"].communicate(run["stdin"], timeout=CLI_TIMEOUT_S)
    return dict(args=run["args"], rc=run["proc"].returncode, stdout=out,
                stderr=err[-4000:], seconds=time.perf_counter() - run["t0"])


def sweep_lines(r: dict, kind: str) -> list:
    lines = [x for x in r["stdout"].splitlines() if x.startswith("effort")]
    if len(lines) != 24 or not all(re.fullmatch(CLI_SWEEP[kind], x)
                                   for x in lines):
        raise AssertionError(f"cli {kind}: {r['stdout'][-2000:]}")
    return lines


def autotune_agreement(at: Path, tune: dict) -> dict:
    """autotune's agreements recomputed in this process on its hold-out
    (corpus.npy's tail, as auto_tune takes it): the bf16 control
    (tf_control_preds on the dense copies) against itself at 1.0, and
    tf_agreement_sweep of the bf16 percent_load=1 candidate against it,
    beside the subprocess's points for that candidate (max_gap; tolerance
    one hold-out token, plus the points' rounding to 3 places)."""
    corpus = np.load(at / "corpus.npy")
    split = int(len(corpus) * 0.98)
    hold = corpus[split:split + 500].astype(int).tolist()
    ck = str(at / "ckpt_bf16")
    w, cfg, _ = load_bucketized(ck, load_dense=False)
    ctl = Engine(attach_dense(w), cfg, impl="auto", dynamic_effort=True,
                 eos_id=-1)
    control = harness.tf_control_preds(ctl, hold)
    self_agree = harness.tf_agreement_sweep(ctl, hold, efforts=[1.0],
                                            control=control)[1.0]
    del ctl, w
    w, cfg, _ = load_bucketized(ck, load_dense=False)
    got = {p["effort"]: p["agreement"] for p in tune["points"]
           if p["config"] == "bf16 percent_load=1.000"}
    agr = harness.tf_agreement_sweep(
        Engine(w, cfg, impl="auto", dynamic_effort=True, eos_id=-1), hold,
        efforts=sorted(got), control=control)
    del w
    return dict(hold_tokens=len(hold), control_self_agreement=self_agree,
                in_process={str(e): a for e, a in agr.items()},
                max_gap=max(abs(got[e] - a) for e, a in agr.items()),
                tolerance=1 / len(hold) + 5e-4)


def phase_cli(src: Path, dst: Path, tok_json: Path, tmp: Path) -> dict:
    """The command line on the checkpoint phase's converted 4-layer
    Mistral-width model and BPE tokenizer, each mode a `python3 -m
    effort_tpu_torch` subprocess that must exit 0 (the first nine run at
    once on the card): generate at 0.25; generate --spec-k 4; repl
    --stream fed "Hello", "25", "r"; quiz on a 3-item --quiz-file;
    agreement and kl with --n-tokens 16; bucket at --bucket-size 1
    --chunk-rows 128 --dtype int8 (K1) and at its defaults (K4); convert
    to bf16 (fused, row-prefix), then autotune on it with the int8
    conversion as its ckpt_int8 sibling and a seeded corpus.npy (hold-out
    40 tokens). Gates: the printed line formats; 100% agreement and 0 KL
    at 100% effort; bucket's cos at each effort within 1e-3 of the same
    sweep in this process on the kernels' plain versions ("plain" route),
    the reference route printed beside; autotune's 12 measured points,
    its control agreeing with itself at 1.0 and the bf16 percent_load=1
    candidate's agreements within one hold-out token of the same sweep in
    this process (autotune_agreement). The subprocesses' launches are not
    counted."""
    t_phase = time.perf_counter()
    at = tmp / "autotune"
    at.mkdir()
    qf = tmp / "quiz.json"
    qf.write_text(json.dumps(CLI_QUIZ))
    ck = ["--ckpt", str(dst), "--tokenizer", str(tok_json)]
    b1 = ["--bucket-size", "1", "--chunk-rows", "128", "--dtype", "int8"]
    jobs = {
        "generate": (["generate", *ck, "--effort", "0.25", "--n-tokens",
                      "16"], None),
        "generate_spec": (["generate", *ck, "--spec-k", "4", "--n-tokens",
                           "16"], None),
        "repl": (["repl", "--stream", *ck, "--n-tokens", "12"],
                 "Hello\n25\nr\n"),
        "quiz": (["quiz", *ck, "--quiz-file", str(qf)], None),
        "agreement": (["agreement", *ck, "--n-tokens", "16", "--prompt",
                       CLI_PROMPT], None),
        "kl": (["kl", *ck, "--n-tokens", "16"], None),
        "bucket_k1": (["bucket", *b1], None),
        "bucket_k4": (["bucket"], None),
        "convert": (["convert", "--src", str(src), "--dst",
                     str(at / "ckpt_bf16"), "--model", "auto", *b1[:4],
                     "--dtype", "bf16", "--fuse"], None)}
    started, res = {}, {}
    try:
        for name, (args, stdin) in jobs.items():
            started[name] = cli_start(args, stdin)
        for name, run in started.items():
            res[name] = cli_wait(run)
        os.symlink(dst, at / "ckpt_int8")
        np.save(at / "corpus.npy", np.random.default_rng(23).integers(
            3, 32000, 2000))
        started["autotune"] = cli_start(["autotune", "--ckpt",
                                         str(at / "ckpt_bf16")])
        res["autotune"] = cli_wait(started["autotune"])
    finally:
        for run in started.values():
            if run["proc"].poll() is None:
                run["proc"].kill()
                run["proc"].wait()
    for name, r in res.items():
        emit({"phase": "cli_run", "mode": name, "rc": r["rc"],
              "seconds": r["seconds"],
              "stdout_tail": r["stdout"][-300:]})
        if r["rc"] != 0:
            raise AssertionError(f"cli {name} exited {r['rc']}: "
                                 f"{r['stderr']}")
    out = {"seconds_by_mode": {k: r["seconds"] for k, r in res.items()}}
    gen = res["generate"]["stdout"].splitlines()
    spec = res["generate_spec"]["stdout"].splitlines()
    repl = res["repl"]["stdout"]
    fmt = {
        "generate": len(gen) >= 2 and re.fullmatch(
            r"\[effort 25%: [0-9.]+ ms/token, [0-9.]+ tok/s\]", gen[-1]),
        "generate_spec": len(spec) >= 2 and re.fullmatch(
            r"\[speculative, draft 25%: [0-9.]+ ms/token, [0-9.]+ tok/s, "
            r"[0-9.]+ tok/round\]", spec[-1]),
        "repl": (repl.startswith("query, or 0-100") and repl.count(
            "[effort 100%]") == 1 and repl.count("[effort 25%]") == 2)}
    out["formats"] = {k: bool(v) for k, v in fmt.items()}
    out["generate_reply"] = gen[0] if gen else None
    sweeps = {k: sweep_lines(res[k], k.split("_")[0])
              for k in ("agreement", "kl", "quiz", "bucket_k1",
                        "bucket_k4")}
    out["agreement_at_100"] = sweeps["agreement"][0]
    out["kl_at_100"] = sweeps["kl"][0]
    bucket = {}
    wt, v = cli.bucket_inputs("cuda")
    for name, args in (("bucket_k1", b1), ("bucket_k4", [])):
        a = cli.parse_args(["bucket", *args])
        bm = bucketize(wt, BucketConfig(bucket_size=a.bucket_size,
                                        chunk_rows=a.chunk_rows,
                                        dtype=a.dtype), keep_dense=True)
        got = [float(x.split()[-1]) for x in sweeps[name]]
        plain = list(harness.matrix_quality_sweep(bm, v, impl="plain",
                                                  wt_dense=wt).values())
        ref = list(harness.matrix_quality_sweep(bm, v, impl="reference",
                                                wt_dense=wt).values())
        bucket[name] = dict(
            cos_at_50=got[harness.effort_scale().index(0.5)],
            max_gap_plain=max(abs(g - p) for g, p in zip(got, plain)),
            max_gap_reference=max(abs(g - p) for g, p in zip(got, ref)))
        del bm
    del wt, v
    out["bucket"] = bucket
    tune = json.loads(res["autotune"]["stdout"])
    out["autotune"] = dict(points=len(tune["points"]),
                           chosen=tune["chosen"],
                           dense_toks_per_s=tune["dense_toks_per_s"],
                           stderr_tail=res["autotune"]["stderr"][-400:],
                           **autotune_agreement(at, tune))
    out["seconds"] = time.perf_counter() - t_phase
    emit({"phase": "cli", **{k: v for k, v in out.items()}})
    if not (all(out["formats"].values())
            and out["agreement_at_100"] == "effort 100.0%: agreement 100.0%"
            and out["kl_at_100"] == "effort 100.0%: KL   0.0000 nats"
            and all(b["max_gap_plain"] <= 1e-3 for b in bucket.values())
            and out["autotune"]["points"] == 12
            and out["autotune"]["control_self_agreement"] == 1.0
            and out["autotune"]["max_gap"] <= out["autotune"]["tolerance"]):
        raise AssertionError(f"cli: {out}")
    return out


# ---- training: the trainer at Mistral-7B widths, its export served -------

TRAIN_VOCAB = 8192
TRAIN_CORPUS_BYTES = 8_000_000
TRAIN_SECONDS = 60.0               # the main run's share of the phase
TRAIN_SPEED_STEPS = 3
TRAIN_EFFORTS = (1.0, 0.5, 0.25)
TRAIN_HOLDOUT = 500                # tokens of the quality sweeps
LOSS_RTOL = 1e-4                   # f32 against f64: loss, gradient norm
FP32_FLOPS, TF32_FLOPS = 67e12, 495e12     # H100 SXM data sheet, dense


def wordlm_cfg() -> ModelConfig:
    """The repository's trained configuration (scripts/trained_wordlm.py
    model_cfg, wordlm-500m): Mistral-7B's matrices, 2 layers, a word-level
    vocabulary of 8192."""
    return ModelConfig(name="wordlm-500m", dim=4096, hidden_dim=14336,
                       n_layers=2, n_heads=32, n_kv_heads=8, head_dim=128,
                       vocab_size=TRAIN_VOCAB, max_seq_len=2048,
                       rope_theta=1e6)


def local_text(limit: int) -> str:
    """Text already on the machine, in scripts/trained_wordlm._local_text's
    order: the repository's sources and documents, then the standard
    library's modules, read as bytes (never imported), up to `limit`."""
    import glob
    import sysconfig
    root = str(Path(__file__).resolve().parent)
    paths = []
    for pat in ("effort_tpu/**/*.py", "tests/*.py", "scripts/*.py",
                "docs/*.md", "*.md"):
        paths += sorted(glob.glob(f"{root}/{pat}", recursive=True))
    stdlib = sysconfig.get_paths()["stdlib"]
    paths += sorted(glob.glob(f"{stdlib}/**/*.py", recursive=True))
    chunks, total = [], 0
    for p in paths:
        try:
            with open(p, "rb") as f:
                b = f.read()
        except OSError:
            continue
        chunks.append(b.decode("utf-8", errors="ignore"))
        total += len(b)
        if total >= limit:
            break
    return "".join(chunks)


def word_corpus(text: str, vocab: int) -> tuple:
    """(words, ids): the most frequent word pieces (PIECE_RE) as ids N_BYTE
    and up, byte fallback below, as scripts/trained_wordlm.stage_corpus
    builds them."""
    from collections import Counter
    counts = Counter(PIECE_RE.findall(text))
    words = [w for w, _ in counts.most_common(vocab - N_BYTE)]
    tok = WordTokenizer(words)
    return words, np.asarray(tok.encode(text), np.int32)


def train_flops(cfg, tokens: int, T: int) -> float:
    """Operations of one training step over `tokens` tokens in rows of T:
    the layers' products run forward twice (the recompute in backward)
    and backward once (twice the forward), the head's forward and backward
    once; attention's two products over the full T x T scores."""
    q_out, kv_out = cfg.n_heads * cfg.head_dim, cfg.n_kv_heads * cfg.head_dim
    ffn = 3 * cfg.dim * cfg.hidden_dim * cfg.n_experts
    gate = cfg.dim * cfg.n_experts if cfg.is_moe else 0
    per_layer = (2 * tokens * (cfg.dim * (2 * q_out + 2 * kv_out) + ffn
                               + gate)
                 + 4 * tokens * T * q_out)
    head = 2 * tokens * cfg.dim * cfg.vocab_size
    return 4 * cfg.n_layers * per_layer + 3 * head


def f64_gate(what: str, params: dict, cfg, row: torch.Tensor) -> dict:
    """The trainer's f32 loss and gradient global norm on one row against
    the same functions on a float64 copy, on the card: within LOSS_RTOL
    relative, finite; for MoE the aux term finite and >= 0."""
    out = {}
    for dt in (torch.float32, torch.float64):
        p = {k: ({kk: vv.detach().to(dt) for kk, vv in v.items()}
                 if isinstance(v, dict) else v.detach().to(dt))
             for k, v in params.items()}
        ps = train_leaves(p)
        for t in ps:
            t.requires_grad_(True)
        loss = next_token_loss(p, cfg, row)
        grads = torch.autograd.grad(loss, ps)
        with torch.no_grad():
            aux = float(train_forward(p, cfg, row[:, :-1])[1])
        out[str(dt)[6:]] = dict(loss=float(loss.detach()),
                                grad_norm=float(global_norm(list(grads))),
                                aux=aux)
        del p, ps, loss, grads
    a, b = out["float32"], out["float64"]
    r = dict(what=what, tokens=int(row.shape[1]), **out,
             loss_rel_err=abs(a["loss"] - b["loss"]) / abs(b["loss"]),
             grad_norm_rel_err=abs(a["grad_norm"] - b["grad_norm"])
             / b["grad_norm"], rtol=LOSS_RTOL)
    emit({"phase": "train_f64_gate", **r})
    if not (r["loss_rel_err"] <= LOSS_RTOL
            and r["grad_norm_rel_err"] <= LOSS_RTOL
            and all(math.isfinite(x) for x in a.values())
            and (cfg.n_experts == 1 or a["aux"] >= 0.0)):
        raise AssertionError(f"train f32 vs f64: {r}")
    return r


def train_steps_ms(params, cfg, tcfg, corpus, split, gen, n: int,
                   tf32: bool = False) -> tuple:
    """(ms a step over n steps after one untimed step, the AdamW state):
    run_chunk on `params` in place, host clock around work that ends in a
    synchronize, TF32 products for the timed steps if asked (the flag is
    restored after)."""
    state = adamw_init(train_leaves(params), tcfg.mu_dtype)
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = tf32
    try:
        run_chunk(params, state, cfg, dataclasses.replace(
            tcfg, scan_chunk=1), corpus, split, gen)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run_chunk(params, state, cfg, dataclasses.replace(
            tcfg, scan_chunk=n), corpus, split, gen)
        torch.cuda.synchronize()
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved
    return (time.perf_counter() - t0) * 1e3 / n, state


def all_finite(ts) -> bool:
    return all(bool(torch.isfinite(t).all()) for t in ts)


def train_dense(cfg, corpus: torch.Tensor, smi: str) -> tuple:
    """The dense model: the f64 gate, one chunk with no host read, f32
    and TF32 step times, then train() for about TRAIN_SECONDS. Returns
    (params, history, result)."""
    out = {}
    params = init_params(cfg, seed=0, device="cuda")
    row = corpus[:65][None]
    out["f64_gate"] = f64_gate("dense", params, cfg, row)
    tcfg = TrainConfig(batch=8, seq_len=512, lr=3e-4, warmup=30,
                       scan_chunk=25, holdout_frac=0.02)
    split = int(len(corpus) * (1 - tcfg.holdout_frac))
    gen = torch.Generator(device="cuda")
    gen.manual_seed(7)
    # timing and the sync check run on a copy: the main run starts from
    # the initial parameters
    scratch = {k: ({kk: vv.detach().clone() for kk, vv in v.items()}
                   if isinstance(v, dict) else v.detach().clone())
               for k, v in params.items()}
    state = adamw_init(train_leaves(scratch), tcfg.mu_dtype)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        losses = run_chunk(scratch, state, cfg, tcfg, corpus, split, gen)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    out["no_host_read_chunk"] = dict(steps=tcfg.scan_chunk,
                                     losses=losses.tolist())
    ms, st = train_steps_ms(scratch, cfg, tcfg, corpus, split, gen,
                            TRAIN_SPEED_STEPS)
    ms_tf32, st_tf32 = train_steps_ms(scratch, cfg, tcfg, corpus, split,
                                      gen, TRAIN_SPEED_STEPS, tf32=True)
    moments_finite = all_finite(st.mu + st.nu + st_tf32.mu + st_tf32.nu
                                + state.mu + state.nu)
    del scratch, state, st, st_tf32
    tokens = tcfg.batch * (tcfg.seq_len - 1)
    flops = train_flops(cfg, tokens, tcfg.seq_len - 1)
    out["speed"] = dict(
        ms_per_step=ms, ms_per_step_tf32=ms_tf32,
        tokens_per_s=tokens / ms * 1e3,
        tokens_per_s_tf32=tokens / ms_tf32 * 1e3, flops_per_step=flops,
        share_of_fp32_peak=flops / (ms * 1e-3) / FP32_FLOPS,
        share_of_tf32_peak=flops / (ms_tf32 * 1e-3) / TF32_FLOPS,
        nvidia_smi=smi)
    emit({"phase": "train_speed", **out["speed"]})
    # steps: whole chunks that fill TRAIN_SECONDS at the measured speed
    # (4 to 10 chunks); the deadline stops a run 1.5x slower than that
    chunks = max(4, min(10, round(TRAIN_SECONDS * 1e3
                                  / (ms * tcfg.scan_chunk))))
    tcfg = dataclasses.replace(tcfg, steps=chunks * tcfg.scan_chunk)
    lines = []
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    params, hist = train(cfg, corpus, tcfg, params=params,
                         progress=lines.append,
                         deadline=t0 + 1.5 * max(
                             TRAIN_SECONDS, tcfg.steps * ms / 1e3))
    torch.cuda.synchronize()
    out["run"] = dict(steps_planned=tcfg.steps, steps=hist[-1][0],
                      seconds=time.time() - t0, history=hist,
                      progress_tail=lines[-2:],
                      peak_gib=torch.cuda.max_memory_allocated() / 2**30,
                      params_finite=all_finite(train_leaves(params)),
                      moments_finite=moments_finite)
    emit({"phase": "train_run", **out["run"]})
    holdout = [h[2] for h in hist]
    if not (hist[-1][0] >= 100 and holdout[-1] < holdout[0]
            and holdout[-1] < math.log(TRAIN_VOCAB) - 2
            and out["run"]["params_finite"] and moments_finite):
        raise AssertionError(f"training made no progress: {out['run']}")
    return params, hist, out


def served_gate(params, cfg, w, cfg_l, prompt: list, runs: list) -> dict:
    """The trainer's f32 logits against the served model's at effort 1.0,
    position by position (Engine.token_logits: the captured decode step,
    K1 at tau = 1, so every chunk streams): cos > 0.999, and the same
    argmax wherever the trainer's top-two margin exceeds NEAR_TIE (the
    JAX package's tests/test_train.py gate)."""
    with torch.no_grad():
        ref = train_forward(params, cfg, torch.tensor(
            [prompt], device="cuda"))[0][0]
    saved = fused_stream._TAU
    fused_stream._TAU = 1.0
    try:
        eng = Engine(w, cfg_l, eos_id=-1)
        got = counted(runs, lambda: eng.token_logits(prompt, 1.0))
    finally:
        fused_stream._TAU = saved
    cs, argmax_ok = [], True
    for a, b in zip(got, ref):
        cs.append(cos(a, b))
        top2 = torch.topk(b, 2).values
        if float(top2[0] - top2[1]) > NEAR_TIE:
            argmax_ok &= int(a.argmax()) == int(b.argmax())
    r = dict(positions=len(prompt), min_cos=min(cs), argmax_ok=argmax_ok)
    emit({"phase": "train_served_gate", **r})
    if not (r["min_cos"] > 0.999 and argmax_ok):
        raise AssertionError(f"trained vs served logits: {r}")
    return r


def serve_trained(params, cfg, corpus_np: np.ndarray, split: int,
                  tmp: Path, smi: str) -> dict:
    """export_hf -> calibration (collect_act_rms on the uncalibrated
    assembly) -> convert_checkpoint on the card (row-prefix, B = 1,
    chunk_rows 128, bf16, as the JAX package's bench regenerates its
    trained model) -> load_bucketized -> the served gate, one prefill
    request (K2, K3), and the quality numbers (printed, not gated)."""
    out, runs = {}, []
    t0 = time.perf_counter()
    export_hf(params, cfg, str(tmp / "hf"))
    out["export_s"] = time.perf_counter() - t0
    bcfg = BucketConfig(bucket_size=1, chunk_rows=128, dtype="bf16")
    t0 = time.perf_counter()
    w_uncal = assemble_weights(params_to_raw(params, cfg), cfg, bcfg)
    rng = np.random.default_rng(3)
    seqs = [corpus_np[s:s + 192].tolist()
            for s in rng.integers(0, split - 200, 3)]
    calib = collect_act_rms(w_uncal, cfg, seqs)
    del w_uncal
    out["calibrate_s"] = time.perf_counter() - t0
    cfg_hf = config_from_hf(str(tmp / "hf"))
    if dataclasses.replace(cfg_hf, name=cfg.name) != cfg:
        raise AssertionError(f"exported config: {cfg_hf} vs {cfg}")
    t0 = time.perf_counter()
    convert_checkpoint(str(tmp / "hf"), str(tmp / "b"), cfg_hf, bcfg,
                       calib=calib, device="cuda", progress=lambda *a: None)
    torch.cuda.synchronize()
    out["convert_s"] = time.perf_counter() - t0
    w, cfg_l, bcfg_l = load_bucketized(str(tmp / "b"), device="cuda")
    if bcfg_l != bcfg:
        raise AssertionError(f"loaded buckets {bcfg_l}")
    # mid-holdout text (the corpus tail can be trivially predictable)
    off = max(0, (len(corpus_np) - split - TRAIN_HOLDOUT) // 3)
    hold = corpus_np[split + off:split + off + TRAIN_HOLDOUT].tolist()
    out["served_gate"] = served_gate(params, cfg, w, cfg_l, hold[:8], runs)
    pre = Engine(w, cfg_l, eos_id=-1, prefill=True)
    reply = counted(runs, lambda: pre.generate(hold[:64], n_new=8,
                                                effort=0.5))
    out["prefill"] = dict(prompt=64, tokens=reply.token_ids,
                          launches=runs[-1]["launches"])
    eng = Engine(w, cfg_l, eos_id=-1)
    t0 = time.perf_counter()
    q = counted(runs, lambda: dict(
        agreement=harness.tf_agreement_sweep(eng, hold, TRAIN_EFFORTS),
        nll=harness.nll_sweep(eng, hold, TRAIN_EFFORTS),
        streamed=harness.streamed_fraction(w, cfg_l, hold[:64],
                                           TRAIN_EFFORTS)))
    q["sweep_s"] = time.perf_counter() - t0
    warm([eng], hold[:8], TRAIN_EFFORTS)
    q["decode_ms_per_token"] = {
        e: counted(runs, lambda e=e: timed_generate(eng, [hold[:8]], e))[1]
        for e in TRAIN_EFFORTS}
    q.update(tokens=len(hold), nvidia_smi=smi)
    out["quality"] = q
    emit({"phase": "train_quality", **q})
    out["runs"] = runs
    return out


def phase_train(smi: str) -> dict:
    """The trainer on the card (module docstring, `train`)."""
    t_phase = time.perf_counter()
    out = {}
    t0 = time.perf_counter()
    text = local_text(TRAIN_CORPUS_BYTES)
    words, ids = word_corpus(text, TRAIN_VOCAB)
    out["corpus"] = dict(text_mb=len(text) / 1e6, tokens=len(ids),
                         seconds=time.perf_counter() - t0)
    emit({"phase": "train_corpus", **out["corpus"]})
    corpus = torch.from_numpy(ids).cuda()
    cfg = wordlm_cfg()
    params, hist, out["dense"] = train_dense(cfg, corpus, smi)
    split = int(len(ids) * 0.98)
    with tempfile.TemporaryDirectory() as tmp:
        out["served"] = serve_trained(params, cfg, ids, split, Path(tmp),
                                      smi)
    del params
    free_card()

    cfg_m = mixtral_8x7b(n_layers=1, max_seq_len=512)
    params = init_params(cfg_m, seed=1, device="cuda")
    moe = {"f64_gate": f64_gate("moe", params, cfg_m, corpus[:65][None])}
    torch.cuda.reset_peak_memory_stats()
    tcfg = TrainConfig(batch=2, seq_len=512, steps=10, warmup=2,
                       scan_chunk=1, holdout_frac=0.02)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(8)
    ms, st = train_steps_ms(params, cfg_m, tcfg, corpus, split, gen,
                            TRAIN_SPEED_STEPS)
    with torch.no_grad():
        aux = float(train_forward(params, cfg_m, corpus[:512][None])[1])
    moe.update(ms_per_step=ms, steps=TRAIN_SPEED_STEPS + 1, aux=aux,
               peak_gib=torch.cuda.max_memory_allocated() / 2**30,
               finite=all_finite(train_leaves(params) + st.mu + st.nu),
               flops_per_step=train_flops(cfg_m, 2 * 511, 511),
               nvidia_smi=smi)
    moe["share_of_fp32_peak"] = (moe["flops_per_step"] / (ms * 1e-3)
                                 / FP32_FLOPS)
    out["moe"] = moe
    emit({"phase": "train_moe", **{k: v for k, v in moe.items()
                                   if k != "f64_gate"}})
    del params, st
    if not (moe["finite"] and math.isfinite(aux) and aux >= 0.0):
        raise AssertionError(f"MoE training: {moe}")
    out["runs"] = out["served"]["runs"]
    launched = {k: sum(r["launches"].get(k, 0) for r in out["runs"])
                for k in ("mxu_matvec", "mxu_matvec_batch",
                          "flash_attention")}
    out["launches"] = launched
    out["seconds"] = time.perf_counter() - t_phase
    emit({"phase": "train", "launches": launched,
          "seconds": out["seconds"]})
    missing = [k for k, n in launched.items() if not n]
    if missing:
        raise AssertionError(f"kernels the trained model's serving never "
                             f"launched: {missing}")
    return out


PAR_WORLD = 4
PAR_LAYERS = 4                     # of 32: depth cut to fit the run
PAR_BUCKETS = BucketConfig(bucket_size=1, chunk_rows=128, dtype="int8")
# the tp-sharded modes again in bf16 for gate (b): bf16 rounds each weight
# alone, so a shard's containers are slices of the whole matrix's; int8's
# scale a row is its absmax over the shard's columns only, another
# quantization of the same weights
PAR_BF16 = dataclasses.replace(PAR_BUCKETS, dtype="bf16")
PAR_TP_SHARDED = ("tp", "tp_ep", "tp_sp")
PAR_PROMPT = 17
PAR_NEW = 16
PAR_SEQ = 8192                     # sp, tp x sp: 2048 / 4096 slots a rank
PAR_FILL = 4600                    # seeded slots before the sp steps
PAR_SP_STEPS = 16
PAR_PP_PROMPTS = (5, 17, 32, 64)
PAR_PP_NEW = 8
PAR_EP_TOKENS = 64                 # ep_ffn_tokens: tokens a rank
PAR_CAPACITY = 1.25
# gate (b): cos of the effort-1.0 logits against the single-device model,
# the JAX tests' bounds (tests/test_parallel*.py, test_composed.py), which
# hold bf16 shards; the tp-sharded modes' int8 shards, another
# quantization, go by int8_floor
PAR_COS = {"tp": 0.999, "sp": 0.9999, "ep": 0.9999, "pp": 0.9999,
           "tp_ep": 0.999, "tp_sp": 0.999}
# gate (b)'s routes: the share of route calls where the int8 tp x ep
# ranks' experts may part from the single-device model's (near ties that
# the per-shard int8 scales tip; routes_held); every other run: none
PAR_ROUTES_APART = 0.1
# K1 launches a layer a step on each rank: the 7 unfused projections; ep's
# FFN runs 3 a routed expert on every rank (the owner mask is a
# torch.where), so 4 + 3 * 2
PAR_PER_LAYER = {"tp": 7, "sp": 7, "pp": 7, "tp_sp": 7, "ep": 10,
                 "tp_ep": 10}
# the modes whose decode attention is K8 (sp and tp_sp attend over their
# shard of the sequence through their own hook)
PAR_K8 = ("tp", "pp", "ep", "tp_ep")
# K1 at the shard shapes of Mistral-7B at tp = 4 (the head, bf16 in the
# model, timed as K1 too)
K1_SHARDS = {"wq": (4096, 1024), "wk": (4096, 256), "wv": (4096, 256),
             "wo": (1024, 4096), "w1": (4096, 3584), "w3": (4096, 3584),
             "w2": (3584, 4096), "head": (4096, 8000)}
K1_SHARD_EFFORTS = (0.25, 1.0)


def k1_shard_points() -> list:
    """K1 alone at K1_SHARDS, int8 row-prefix (chunk_rows 128, as the
    parallel builders bucketize), efforts 0.25 and 1.0: against its plain
    version (equal C, cos >= 0.9999, max|dy| <= 1e-2 max|y_ref|), then
    device ms (L2 flushed, RUNS inputs, median) beside the bound, the
    plain version and a dense bf16 torch.mm of the same shape."""
    flush = torch.empty(128 * 2**20, dtype=torch.uint8, device="cuda")
    g = torch.Generator(device="cuda")
    g.manual_seed(4321)
    points = []
    for name, (i, o) in K1_SHARDS.items():
        wt = torch.randn((i, o), generator=g, device="cuda") * 0.02
        dense = wt.to(torch.bfloat16)
        vs = [torch.randn(i, generator=g, device="cuda") for _ in range(RUNS)]
        lib_ms = median([gpu_ms(lambda a: torch.mm(a, dense), (a,), flush)
                         for a in (v.to(torch.bfloat16)[None] for v in vs)])
        bm = bucketize(wt, PAR_BUCKETS)
        del wt, dense
        for effort in K1_SHARD_EFFORTS:
            eq = effort_q16(effort, "cuda")
            y, C = fused_stream.mxu_matvec(bm, vs[0], eq, 0, return_len=True)
            yr, Cr = fused_stream.mxu_matvec_ref(bm, vs[0], eq, 0,
                                                 return_len=True)
            C, Cr = int(C), int(Cr)
            err, scale = float((y - yr).abs().max()), float(yr.abs().max())
            p = dict(shape=name, in_dim=i, out_dim=o, n_chunks=bm.n_chunks,
                     effort=effort, C=C, C_plain=Cr, cos=cos(y, yr),
                     max_abs_err=err, max_abs_ref=scale)
            if C != Cr or not p["cos"] >= 0.9999 or not err <= 1e-2 * scale:
                raise AssertionError(f"K1 disagrees with its plain version "
                                     f"at a shard shape: {p}")
            p["ms"] = median([gpu_ms(lambda v: fused_stream.mxu_matvec(
                bm, v, eq, 0), (v,), flush) for v in vs])
            p["plain_ms"] = median([gpu_ms(lambda v: fused_stream
                                           .mxu_matvec_ref(bm, v, eq, 0),
                                           (v,), flush) for v in vs])
            p["bytes"] = k1_bytes(bm, C)
            p["bound_ms"] = p["bytes"] / HBM_BYTES_PER_S * 1e3
            p["library_ms"] = lib_ms
            points.append(p)
            emit({"phase": "k1_shards", **p})
        del bm, vs
    del flush
    torch.cuda.empty_cache()
    return points


def parallel_jobs() -> list:
    """The six modes' decode jobs for the ranks (parallel/_ranks.py): each
    at full width and PAR_LAYERS deep, seed-0 int8 row-prefix weights
    built on each rank for its shard, the kernel route; effort 1.0 then
    0.25, gate (a) at 0.25."""
    mis = mistral_7b(n_layers=PAR_LAYERS)
    mis_long = mistral_7b(n_layers=PAR_LAYERS, max_seq_len=PAR_SEQ)
    mix = mixtral_8x7b(n_layers=PAR_LAYERS)
    prompt = seeded_ids(mis, [PAR_PROMPT], 15)[0]
    pp_prompts = seeded_ids(mis, PAR_PP_PROMPTS, 16)

    def job(mode, n, cfg, runs, **kw):
        return dict(mode=mode, n=n, cfg=cfg, bcfg=PAR_BUCKETS,
                    weights=("seed", 0), impl="kernel", gate=0.25,
                    all_ranks=False, runs=runs, **kw)

    def bf16(j):
        """j's effort-1.0 run on bf16 shards (gate (b) only)."""
        return dict(j, bcfg=PAR_BF16, gate=None, runs=j["runs"][:1],
                    ffn_tokens=())

    def runs(**kw):
        """At 1.0 with tau = 1 (gate (b), as the teacher phases: a tau
        prefix parts sharded from whole matrices by more than rounding),
        then at 0.25 at the default tau."""
        return [dict(effort=1.0, tau=1.0, record_routing=True, **kw),
                dict(effort=0.25, **kw)]

    dec = runs(tokens=prompt, n_new=PAR_NEW)
    sp_runs = runs(tokens=prompt[:1], start=PAR_FILL, n_new=PAR_SP_STEPS - 1)
    pp_runs = runs(tokens=pp_prompts, n_new=PAR_PP_NEW)
    tokens = [dict(X=("seed", 17, PAR_EP_TOKENS * PAR_WORLD), layer=0,
                   capacity_factor=PAR_CAPACITY, zero_gate=z, effort=1.0)
              for z in (False, True)]
    fill = (PAR_FILL, 5)
    jobs = [job("tp", PAR_WORLD, mis, dec),
            job("sp", PAR_WORLD, mis_long, sp_runs, fill=fill),
            job("ep", PAR_WORLD, mix, dec, ffn_tokens=tokens),
            job("pp", PAR_WORLD, mis, pp_runs),
            job("tp_ep", (2, 2), mix, dec),
            job("tp_sp", (2, 2), mis_long, sp_runs, fill=fill)]
    return jobs + [bf16(j) for j in jobs if j["mode"] in PAR_TP_SHARDED]


def job_key(job: dict) -> str:
    return job["mode"] + ("_bf16" if job["bcfg"].dtype == "bf16" else "")


def int8_sharded(job: dict) -> bool:
    return job["mode"] in PAR_TP_SHARDED and job["bcfg"].dtype == "int8"


def teacher_logits(w, cfg, fed: list, start: int, effort: float,
                   caches, routing=None) -> tuple:
    """The single-device model teacher-forced over fed from slot start
    (K1 on the kernel route at tau = 1): (logits [steps, vocab] on the
    host, routes). routing [steps, layers, k], an MoE model's experts as
    the ranks routed them: each call takes those, gated by the softmax of
    its own gate logits at them (so a near tie that rounding tips either
    way cannot part the two models' experts). routes: the route calls,
    those whose own top-k differed (apart), and the largest gap there
    between the model's own k-th gate logit and its logit at the ranks'
    least chosen expert (max_gap; 0 where none parted)."""
    eq = effort_q16(effort, "cuda")
    saved, fused_stream._TAU = fused_stream._TAU, 1.0
    route0, gaps, n = transformer.route, [], 0
    if routing is not None:
        n = routing.shape[0] * routing.shape[1]
        calls = iter(routing.reshape(-1, routing.shape[-1]))

        def forced(layer, l, x, cfg_):
            _, idx = route0(layer, l, x, cfg_)
            want = torch.as_tensor(next(calls), dtype=idx.dtype,
                                   device=idx.device)
            lg = bucketmul.mm_f32(x.to(torch.bfloat16)[None],
                                  layer.ffn_gate[l])[0]
            if not torch.equal(torch.sort(idx).values,
                               torch.sort(want).values):
                gaps.append(float(lg[idx.long()].min()
                                  - lg[want.long()].min()))
            return torch.softmax(lg[want.long()], dim=-1), want
        transformer.route = forced
    try:
        lg = torch.stack([forward_token(w, cfg, t, start + p, *caches,
                                        effort=eq, impl="kernel")
                          for p, t in enumerate(fed)]).float().cpu()
    finally:
        fused_stream._TAU, transformer.route = saved, route0
    return lg, dict(calls=n, apart=len(gaps), max_gap=max(gaps, default=0.0))


def routes_held(job: dict, routes: dict) -> bool:
    """The ranks' experts are the single-device model's own at every route
    call, except in the int8 tp x ep run: its per-shard int8 scales move
    the router's input, and a near tie may tip there, in at most
    PAR_ROUTES_APART of the calls."""
    if int8_sharded(job):
        return routes["apart"] <= PAR_ROUTES_APART * routes["calls"]
    return routes["apart"] == 0


def held_logits(bound: float, got: np.ndarray, ref: tuple) -> dict:
    ref, routes = ref
    cs = [cos(torch.from_numpy(g), r) for g, r in zip(got, ref)]
    same = sum(int(np.argmax(g)) == int(r.argmax()) for g, r in zip(got, ref))
    return dict(min_cos=min(cs), mean_cos=sum(cs) / len(cs),
                steps=len(cs), argmax_equal=same, bound=bound,
                first_cos=cs[:4], routes=routes)


def mode_references(job: dict, res: list, w) -> dict:
    """Gate (b) of one mode: rank 0's effort-1.0 logits against the
    single-device model w teacher-forced over the same tokens (pp: each
    microbatch's sequence alone)."""
    cfg, run = job["cfg"], res[0]["runs"][0]
    got = run["logits"]
    bound = None if int8_sharded(job) else PAR_COS[job["mode"]]
    if job["mode"] == "pp":
        rows = []
        for m, fed in enumerate(run["fed"]):
            ref = teacher_logits(w, cfg, fed, 0, run["effort"],
                                 make_kv_cache(cfg, "cuda"))
            rows.append(held_logits(bound, got[:, m], ref))
        routes = [r["routes"] for r in rows]
        return dict(min_cos=min(r["min_cos"] for r in rows),
                    argmax_equal=sum(r["argmax_equal"] for r in rows),
                    steps=sum(r["steps"] for r in rows), bound=bound,
                    routes=dict(calls=sum(r["calls"] for r in routes),
                                apart=sum(r["apart"] for r in routes),
                                max_gap=max(r["max_gap"] for r in routes)),
                    microbatches=rows)
    start = job["runs"][0].get("start", 0)
    ref = teacher_logits(w, cfg, run["fed"], start, run["effort"],
                         _ranks.global_caches(job, "cuda"),
                         run.get("routing"))
    return dict(held_logits(bound, got, ref), ref=ref[0])


def int8_floor(job: dict, res: list, w_bf16, single_int8) -> dict:
    """Gate (b) of an int8 tp-sharded mode. A shard's int8 scale a row is
    its absmax over the shard's columns only: another quantization of the
    same weights than the single-device model's, as far from it as two
    quantizations are. So the sharded model and the single-device int8
    model (single_int8, its logits over the same tokens) are both held to
    the bf16 single-device model w_bf16, over the same tokens and the
    ranks' routing: the sharded model's 1 - cos at most twice the
    single-device int8 model's (its quantization's own distance)."""
    run = res[0]["runs"][0]
    ref, routes = teacher_logits(w_bf16, job["cfg"], run["fed"],
                                 job["runs"][0].get("start", 0),
                                 run["effort"],
                                 _ranks.global_caches(job, "cuda"),
                                 run.get("routing"))
    got = min(cos(torch.from_numpy(g), r) for g, r in zip(run["logits"],
                                                           ref))
    floor = min(cos(a, r) for a, r in zip(single_int8, ref))
    return dict(min_cos_vs_bf16=got, int8_floor=floor, routes=routes,
                ok=1 - got <= 2 * (1 - floor) and routes_held(job, routes))


def ep_tokens_reference(job: dict, res: list, w) -> list:
    """The ep_ffn_tokens cases against the single-device model: the
    routing each rank saw equals the model's; each token's kept
    assignments (its rank's first C of each expert, in token order) gated
    and summed, K1 a token and expert; cos >= 0.9999 over all tokens, and
    the drops equal to the count the routing gives."""
    cfg, k = job["cfg"], job["cfg"].n_experts_per_tok
    out = []
    for i, case in enumerate(job["ffn_tokens"]):
        T = case["X"][2]
        X = _ranks.tokens_input(cfg, T, case["X"][1], "cuda")
        lw = w.layers
        if case["zero_gate"]:
            lw = dataclasses.replace(lw,
                                     ffn_gate=torch.zeros_like(lw.ffn_gate))
        gates, idx = transformer.route(lw, case["layer"], X, cfg)
        idx = idx.cpu().numpy()
        got = [r["ffn_tokens"][i] for r in res]
        Tl = got[0]["tokens"]
        C = expert_capacity(Tl, len(res), k, cfg.n_experts,
                            case["capacity_factor"])
        same_routing = all(
            np.array_equal(g["experts"], idx[r * Tl:(r + 1) * Tl])
            for r, g in enumerate(got))
        eq = effort_q16(case["effort"], "cuda")
        pe = transformer.proj_efforts(eq, cfg)
        y_ref = torch.zeros((T, cfg.dim), device="cuda")
        dropped = 0
        for r in range(len(res)):
            seen = {}
            for t in range(r * Tl, (r + 1) * Tl):
                for j in range(k):
                    e = int(idx[t, j])
                    seen[e] = seen.get(e, 0) + 1
                    if seen[e] > C:
                        dropped += 1
                        continue
                    y_ref[t] += gates[t, j] * transformer._expert_ffn(
                        lw, case["layer"] * cfg.n_experts + e, X[t], pe, cfg,
                        "kernel")
        y = torch.from_numpy(np.concatenate([g["y"] for g in got]))
        row = dict(zero_gate=case["zero_gate"], tokens=T, capacity=C,
                   dropped=sum(g["dropped"] for g in got),
                   dropped_want=dropped,
                   cos=cos(y.flatten(), y_ref.flatten().cpu()),
                   ms=max(g["seconds"] for g in got) * 1e3,
                   same_routing=same_routing)
        row["ok"] = (same_routing and row["dropped"] == dropped
                     and row["cos"] >= 0.9999)
        out.append(row)
        emit({"phase": "parallel_ep_tokens", **row})
    return out


def mode_launches(job: dict, res: list) -> dict:
    """Gate (d): every rank's K1 launches in each run equal what the mode
    gives (PAR_PER_LAYER * layers a step; ep tokens 3 a slot of every
    local expert's n_ep * C), K8 once a layer a step where the mode's
    attention is forward_token's (PAR_K8: not the sequence-sharded
    modes'), and no other kernel ran."""
    L, per = job["cfg"].n_layers, PAR_PER_LAYER[job["mode"]]
    total = k8 = 0
    for r in res:
        for run in r["runs"]:
            want = {"mxu_matvec": per * L * run["steps"]}
            if job["mode"] in PAR_K8:
                want["decode_attention"] = L * run["steps"]
            if run["launches"] != want:
                raise AssertionError(f"{job['mode']} rank {r['rank']} "
                                     f"launches {run['launches']}, want "
                                     f"{want}")
            total += want["mxu_matvec"]
            k8 += want.get("decode_attention", 0)
        for c in r["ffn_tokens"]:
            n_ep = job["n"]
            cfg = job["cfg"]
            C = expert_capacity(c["tokens"], n_ep, cfg.n_experts_per_tok,
                                cfg.n_experts, PAR_CAPACITY)
            want = {"mxu_matvec": 3 * cfg.n_experts * C}
            if c["launches"] != want:
                raise AssertionError(f"ep tokens rank {r['rank']} launches "
                                     f"{c['launches']}, want {want}")
            total += want["mxu_matvec"]
    return dict(per_rank_step=per * L, mxu_matvec=total,
                decode_attention=k8)


def phase_parallel() -> dict:
    """Every parallel mode on the card (parallel/): K1 at the shard shapes
    first, then PAR_WORLD ranks, one process each (multihost.spawn), rank
    r on card r % count: NCCL where each rank has a card, else gloo (NCCL
    takes no two ranks on one card); each rank builds its own shard of
    every mode from the seed-0 draws and decodes (parallel_jobs); then the
    single-device references here. Gates: (a) each rank's K1 calls of one
    step against K1's plain version on their own inputs; (b) effort-1.0
    logits against the single-device model teacher-forced over the same
    tokens (PAR_COS; the tp-sharded modes also run on bf16 shards for it,
    their int8 shards held by int8_floor), the MoE routes (routes_held),
    and the ep tokens;
    (c) the greedy tokens at 0.25 recorded; (d) exact K1 and K8 launches
    (mode_launches). Every gate is read before the phase fails. Host ms a
    step and peak GiB a rank are printed; times of ranks sharing a card
    under gloo are labelled so and compare with nothing."""
    t0 = time.perf_counter()
    out = {"k1_shards": k1_shard_points()}
    count = torch.cuda.device_count()
    backend = "nccl" if count >= PAR_WORLD else "gloo"
    ranks_per_card = -(-PAR_WORLD // count)
    out.update(backend=backend, ranks_per_card=ranks_per_card)
    emit({"phase": "parallel_setup", "backend": backend,
          "ranks_per_card": ranks_per_card, "world": PAR_WORLD,
          "cards": count})
    jobs = parallel_jobs()
    t_ranks = time.perf_counter()
    res = multihost.spawn(_ranks.run_jobs, PAR_WORLD, backend,
                          [f"cuda:{r % count}" for r in range(PAR_WORLD)],
                          jobs, timeout=900)
    out["ranks_seconds"] = time.perf_counter() - t_ranks
    emit({"phase": "parallel_ranks", "seconds": out["ranks_seconds"],
          "backend": backend, "ranks_per_card": ranks_per_card})
    label = (f"{backend}, {ranks_per_card} ranks a card" + (
        ", host-staged" if backend == "gloo" else ""))
    modes, failed, refs = {}, [], {}
    launches = {"mxu_matvec": 0, "decode_attention": 0}
    for j, job in enumerate(jobs):
        mres = [r[j] for r in res]
        key = job_key(job)
        count_d = mode_launches(job, mres)
        for kernel in launches:
            launches[kernel] += count_d[kernel]
        m = modes[key] = dict(
            n=job["n"], layers=job["cfg"].n_layers, label=label,
            dtype=job["bcfg"].dtype, launches=count_d,
            ms_per_step={str(r["effort"]): max(
                x["runs"][i]["seconds"] for x in mres) / r["steps"] * 1e3
                for i, r in enumerate(mres[0]["runs"])},
            build_s=max(x["build_s"] for x in mres),
            peak_gib=[x["peak_gib"] for x in mres])
        if job["gate"]:
            gate_a = [x["gate"] for x in mres]
            m["gate_a"] = dict(
                calls=[g["calls"] for g in gate_a],
                min_cos=min(g["min_cos"] for g in gate_a),
                max_rel_err=max(g["max_rel_err"] for g in gate_a),
                c_equal=all(g["c_equal"] for g in gate_a))
            if not (set(m["gate_a"]["calls"]) == {
                    PAR_PER_LAYER[job["mode"]] * job["cfg"].n_layers}
                    and m["gate_a"]["min_cos"] >= 0.9999
                    and m["gate_a"]["max_rel_err"] <= 1e-2
                    and m["gate_a"]["c_equal"]):
                failed.append(f"{key} (a): {m['gate_a']}")
            m["tokens_0p25"] = mres[0]["runs"][1]["fed"]
    # the single-device references, one model at a time
    for base, dtype in ((mistral_7b, "int8"), (mistral_7b, "bf16"),
                        (mixtral_8x7b, "int8"), (mixtral_8x7b, "bf16")):
        todo = [(j, job) for j, job in enumerate(jobs)
                if job["bcfg"].dtype == dtype
                and job["cfg"].is_moe == (base is mixtral_8x7b)]
        if not todo:
            continue
        w, _ = tp.make_tp_weights(base(n_layers=PAR_LAYERS),
                                  todo[0][1]["bcfg"], 1, 0, rank=0,
                                  device="cuda")
        for j, job in todo:
            key, mres = job_key(job), [r[j] for r in res]
            b = modes[key]["gate_b"] = mode_references(job, mres, w)
            refs[key] = b.pop("ref", None)
            if dtype == "bf16":
                # the int8 run of the same mode, against this model
                j8 = next(i for i, x in enumerate(jobs)
                          if x["mode"] == job["mode"]
                          and x["bcfg"].dtype == "int8")
                k8 = job_key(jobs[j8])
                f = modes[k8]["gate_b"]["floor"] = int8_floor(
                    jobs[j8], [r[j8] for r in res], w, refs[k8])
                emit({"phase": "parallel_int8_floor", "mode": k8, **f})
                if not f["ok"]:
                    failed.append(f"{k8} (b): {f}")
            if job.get("ffn_tokens"):
                modes[key]["ep_tokens"] = ep_tokens_reference(job, mres, w)
                failed += [f"{key} tokens: {t}"
                           for t in modes[key]["ep_tokens"] if not t["ok"]]
            emit({"phase": "parallel_" + key,
                  **{k: v for k, v in modes[key].items()
                     if k not in ("ep_tokens", "gate_b")},
                  "gate_b": {k: v for k, v in b.items()
                             if k != "microbatches"}})
            if b["bound"] is not None and not b["min_cos"] >= b["bound"]:
                failed.append(f"{key} (b): {b}")
            if not routes_held(job, b["routes"]):
                failed.append(f"{key} (b) routes: {b}")
        del w
        free_card()
    out["modes"] = modes
    out["launches"] = launches
    out["seconds"] = time.perf_counter() - t0
    emit({"phase": "parallel", "seconds": out["seconds"],
          "launches": out["launches"], "label": label})
    if failed:
        raise AssertionError("parallel gates: " + "; ".join(failed))
    return out


# ---- the Llama families and the full context -----------------------------

# long_ctx: Mistral-7B at its default max_seq_len, on the main model's
# weights; a prompt of LONG_PROMPT tokens decodes to the last slot
LONG_SEQ = 2048
LONG_PROMPT = 1984
LONG_NEW = 64
LONG_EFFORTS = (0.25, 1.0)
# its batched requests: prompts of 500 to 1900 tokens at mixed efforts
LONG_SERVE_LENS = (500, 1900, 1200, 760)
LONG_SERVE_EFFORTS = (0.25, 1.0, 0.5, 0.25)
LONG_SERVE_NEW = 16
# llama2, llama3: the presets at 32 layers and their 4096 positions
FAMILY_PROMPTS = (5, 17)
FAMILY_EFFORTS = (0.25, 0.5, 1.0)
FAMILY_EAGER_NEW = 8
FAMILY_PREFILL = 4032              # + N_NEW new tokens = 4064 of 4096 slots
PREFILL_EFFORTS = (0.25, 1.0)
# Meta-Llama-3-8B's config.json (HF), depth cut to LLAMA3_CKPT_LAYERS
LLAMA3_CKPT_LAYERS = 2
HF_LLAMA3 = {
    "architectures": ["LlamaForCausalLM"], "model_type": "llama",
    "attention_bias": False, "attention_dropout": 0.0,
    "bos_token_id": 128000, "eos_token_id": 128001, "hidden_act": "silu",
    "hidden_size": 4096, "initializer_range": 0.02,
    "intermediate_size": 14336, "max_position_embeddings": 8192,
    "num_attention_heads": 32, "num_hidden_layers": LLAMA3_CKPT_LAYERS,
    "num_key_value_heads": 8, "pretraining_tp": 1, "rms_norm_eps": 1e-5,
    "rope_scaling": None, "rope_theta": 500000.0,
    "tie_word_embeddings": False, "torch_dtype": "bfloat16",
    "use_cache": True, "vocab_size": 128256}
# Llama-2-7B's four fused projections (the points of phase_kernels_llama)
LLAMA2_SHAPES = {"wqkv": (4096, 12288), "wo": (4096, 4096),
                 "w13": (4096, 22016), "w2": (11008, 4096)}
LLAMA_POINT_EFFORTS = (0.25, 1.0)
LLAMA_POINT_TS = (4, 64)


def phase_kernels_llama(flush: torch.Tensor) -> list:
    """K1 and K2 alone at Llama-2-7B's four fused projections, int8
    row-prefix with the chunk rows init_random_weights picks
    (pick_chunk_rows: w2 43 chunks of 256 rows, a probe sample of 3669),
    calibrated rows drawn as phase_kernels draws them, efforts 0.25 and
    1.0 (K2: every slot at the effort, T 4 and 64): against their plain
    versions (equal C, cos >= 0.9999 a slot, max|dy| <= 1e-2 max|y_ref|),
    then device ms (L2 flushed, RUNS inputs, median) beside the bound, the
    plain version and a dense bf16 torch.mm of the same shape."""
    g = torch.Generator(device="cuda")
    g.manual_seed(2468)
    points = []
    for name, (i, o) in LLAMA2_SHAPES.items():
        rms = torch.exp(torch.randn(i, generator=g, device="cuda") * 1.2)
        pi = calib_row_order(rms)
        wt = torch.randn((i, o), generator=g, device="cuda") * 0.02
        dense = wt[pi.long()].to(torch.bfloat16)
        bc = BucketConfig(bucket_size=1, chunk_rows=128, dtype="int8")
        bc = dataclasses.replace(bc, chunk_rows=pick_chunk_rows(bc, i, o))
        bm = bucketize(wt, bc, in_perm=pi)
        del wt
        for T in (1,) + LLAMA_POINT_TS:
            Vs = [rms[pi.long()] * torch.randn((T, i), generator=g,
                                               device="cuda")
                  for _ in range(RUNS)]
            lib_ms = median([gpu_ms(lambda a: torch.mm(a, dense),
                                    (V.to(torch.bfloat16),), flush)
                             for V in Vs])
            for effort in LLAMA_POINT_EFFORTS:
                if T == 1:
                    eq = effort_q16(effort, "cuda")
                    vs = [V[0] for V in Vs]
                    kern = lambda v: fused_stream.mxu_matvec(  # noqa: E731
                        bm, v, eq, 0, return_len=True)
                    plain = lambda v: fused_stream.mxu_matvec_ref(  # noqa
                        bm, v, eq, 0, return_len=True)
                else:
                    eff = torch.full((T,), effort, device="cuda")
                    vs = Vs
                    kern = lambda V: fused_stream.mxu_matvec_batch(  # noqa
                        bm, V, eff, 0, return_len=True)
                    plain = lambda V: (  # noqa: E731
                        fused_stream.mxu_matvec_batch_ref(
                            bm, V, eff, 0, return_len=True))
                (y, C), (yr, Cr) = kern(vs[0]), plain(vs[0])
                torch.cuda.synchronize()
                C, Cr = int(C), int(Cr)
                y, yr = y.reshape(T, -1), yr.reshape(T, -1)
                err = float((y - yr).abs().max())
                scale = float(yr.abs().max())
                p = dict(kernel="mxu_matvec" if T == 1 else
                         "mxu_matvec_batch", shape=name, in_dim=i,
                         out_dim=o, T=T, chunk_rows=bm.chunk_rows,
                         n_chunks=bm.n_chunks, probes=bm.probes.shape[1],
                         effort=effort, C=C, C_plain=Cr,
                         min_slot_cos=rows_agree(y, yr), max_abs_err=err,
                         max_abs_ref=scale)
                if (C != Cr or not p["min_slot_cos"] >= 0.9999
                        or not err <= 1e-2 * scale):
                    raise AssertionError(f"{p['kernel']} disagrees with its "
                                         f"plain version at a Llama-2 "
                                         f"shape: {p}")
                p["ms"] = median([gpu_ms(kern, (v,), flush) for v in vs])
                p["plain_ms"] = median([gpu_ms(plain, (v,), flush)
                                        for v in vs])
                if T == 1:
                    p["bytes"], p["flops"] = k1_bytes(bm, C), 0
                else:
                    p["bytes"] = k2_bytes(bm, C, T)
                    p["flops"] = 2 * T * C * bm.chunk_rows * o
                bytes_ms = p["bytes"] / HBM_BYTES_PER_S * 1e3
                flops_ms = p["flops"] / BF16_FLOPS * 1e3
                p["bound_ms"] = max(bytes_ms, flops_ms)
                p["bound_by"] = ("bytes" if bytes_ms >= flops_ms
                                 else "operations")
                p["library_ms"] = lib_ms
                points.append(p)
                emit({"phase": "kernels_llama", **p})
            del Vs
        del bm, dense
        torch.cuda.empty_cache()
    return points


def widen_bytes(cfg) -> int:
    """The bytes one decode step moves to widen the caches in _attention:
    both sides of every layer's [max_seq_len, KV, D] read in bf16, written
    in f32 and read again by the score and value products."""
    return (cfg.n_layers * 2 * cfg.max_seq_len * cfg.n_kv_heads
            * cfg.head_dim * (2 + 4 + 4))


def decode_profile(phase: str, cfg, eng, prompt) -> dict:
    """device_profile over one request (8 new tokens at 0.25, captured
    steps) at the engine's cache size: the ms a step of PyTorch's dtype
    copies (KERNEL_PARTS' "copies": in a decode step mostly _attention's
    widening of the whole cache; None where not measured) beside
    widen_bytes at the card's memory rate."""
    prof = profile_routes(phase, (("graph", eng),), prompt)["graph"]
    parts = prof["kernel_ms"]
    prof.update(slots=cfg.max_seq_len, copies_ms_per_step=(
        None if parts is None else parts.get("copies", 0.0) / prof["steps"]),
        widen_bound_ms_per_step=widen_bytes(cfg) / HBM_BYTES_PER_S * 1e3)
    emit({"phase": phase, "slots": cfg.max_seq_len,
          "copies_ms_per_step": prof["copies_ms_per_step"],
          "widen_bound_ms_per_step": prof["widen_bound_ms_per_step"]})
    return prof


TEACHER_BLOCK = 32


def teacher_row(phase: str, a, b, **kw) -> dict:
    """The cosines of two passes' logits a position at a time: least,
    mean, how many below 0.999, argmax agreement; emitted."""
    c = torch.nn.functional.cosine_similarity(a.double(), b.double(), dim=-1)
    r = dict(depth=4, **kw, positions=a.shape[0], min_cos=float(c.min()),
             mean_cos=float(c.mean()), below_0999=int((c < 0.999).sum()),
             argmax_agreement=float((a.argmax(-1) == b.argmax(-1)).float()
                                    .mean()),
             finite=bool(torch.isfinite(a).all()))
    emit({"phase": phase, **r})
    return r


def seq_teacher(cfg, w, prompt, phase: str, efforts=(1.0, 0.25)) -> list:
    """The kernel route (K2, K3) against the plain route (their plain
    versions) at tau = 1 and depth 4 on the long prompt (a multiple of
    TEACHER_BLOCK tokens), by the cosine of each position's logits (the
    exact bf16 head), beside the plain route against itself with the
    attention-norm weights moved by a relative 2^-20 (prefill_teacher's
    witness), at each effort given as a device tensor (K2 selects and
    streams at 1.0 too; the dense copies are not used).

    Two spans. "whole": the prompt in one pass a route, each route's
    positions reading its own keys and values, so any difference at one
    position reaches every later one. "last_block": the prompt's last
    TEACHER_BLOCK positions through each route on a copy of one cache
    that the kernel route filled from the positions before, as the
    decode teacher reads one history: the block's K3 reads the whole
    cache, and its differences are the block's own. Required: cos >=
    0.999 at every position of the last block at effort 1.0. The rest is
    printed: below effort 1 a last-bit difference (the kernels sum in
    another order) moves a slot's effort cutoff across one of its
    threshold levels now and then, a few percent of its rows at once, and
    on these random calibrated models the nudged plain route parts from
    the plain route as far (PERF.md §6); the same-input gates hold
    every call to its plain version on the same inputs at every layer."""
    saved = fused_stream._TAU
    fused_stream._TAU = 1.0
    cfg4 = dataclasses.replace(cfg, n_layers=4)
    g = torch.Generator(device="cuda")
    g.manual_seed(7)
    nudge = torch.randn(w.layers.attn_norm.shape, generator=g, device="cuda")
    w_nudged = dataclasses.replace(w, layers=dataclasses.replace(
        w.layers, attn_norm=w.layers.attn_norm * (1 + 2.0**-20 * nudge)))
    routes = {"kernel": (w, "kernel", "flash"),
              "plain": (w, "plain", "plain"),
              "plain_nudged": (w_nudged, "plain", "plain")}
    ids = torch.tensor(prompt, dtype=torch.int32, device="cuda")
    head = len(prompt) - TEACHER_BLOCK
    rows = []
    try:
        for effort in efforts:
            eff = torch.full((), effort, device="cuda")

            def seq(route, ids, kv, start=0):
                wr, impl, attn = routes[route]
                return forward_seq(wr, cfg4, ids, *kv, start_slot=start,
                                   effort=eff, impl=impl, attn_impl=attn)
            kv = make_kv_cache(cfg4, "cuda")
            seq("kernel", ids[:head], kv)
            spans = {"whole": {r: seq(r, ids, make_kv_cache(cfg4, "cuda"))
                               for r in routes},
                     "last_block": {r: seq(r, ids[head:],
                                           tuple(x.clone() for x in kv),
                                           head) for r in routes}}
            for span, out in spans.items():
                for r in ("kernel", "plain_nudged"):
                    rows.append(teacher_row(
                        phase, out[r], out["plain"], effort=effort,
                        span=span, pair=f"{r}_vs_plain",
                        required=(span, r, effort) == ("last_block",
                                                       "kernel", 1.0)))
            del spans, kv
    finally:
        fused_stream._TAU = saved
    bad = [r for r in rows if not r["finite"]
           or (r["required"] and not r["min_cos"] >= 0.999)]
    if bad:
        raise AssertionError(f"kernel route vs plain ({phase}): {bad}")
    return rows


def timed_part(secs: dict, key: str, fn, *args):
    """fn(*args), its wall seconds into secs[key]."""
    t0 = time.perf_counter()
    r = fn(*args)
    secs[key] = time.perf_counter() - t0
    return r


def peak_gib() -> float:
    return torch.cuda.max_memory_allocated() / 2**30


def phase_long_ctx(cfg, w, generate: list, prefill: list) -> dict:
    """Mistral-7B at its default max_seq_len of 2048 on the main model's
    weights (module docstring, `long_ctx`)."""
    torch.cuda.reset_peak_memory_stats()
    cfg_l = dataclasses.replace(cfg, max_seq_len=LONG_SEQ)
    prompt = seeded_ids(cfg, (LONG_PROMPT,), 23)[0]
    out, secs = {}, {}
    pre = Engine(w, cfg_l, eos_id=-1, prefill=True)
    warm([pre], prompt[:32], LONG_EFFORTS)
    out["prefill"] = timed_part(secs, "prefill", lambda: [
        prefill_run(pre, cfg_l, [prompt], e, LONG_NEW, "long_ctx_prefill")
        for e in LONG_EFFORTS])
    for r in out["prefill"]:
        # beside it, the 512-slot cells at the same effort: decode after a
        # prefill (prefill) and the token loop's (generate, graph)
        r["decode_ms_per_token_512"] = next(
            x["decode_ms_per_token"] for x in prefill
            if x["effort"] == r["effort"])
        r["generate_ms_per_token_512"] = next(
            x["ms_per_token"] for x in generate
            if x["effort"] == r["effort"] and x["route"] == "graph")
    del pre
    out["profile"] = timed_part(
        secs, "profile", decode_profile, "long_ctx_profile", cfg_l,
        Engine(w, cfg_l, eos_id=-1), prompt[:5])
    out["same_input"] = timed_part(
        secs, "same_input", ckpt_same_input, cfg_l, w, prompt, (0.25,),
        "long_ctx_same_input")
    out["teacher"] = timed_part(secs, "teacher", seq_teacher, cfg_l, w,
                                prompt, "long_ctx_teacher")
    reqs = seeded_ids(cfg, LONG_SERVE_LENS, 29)
    out["serve"] = timed_part(secs, "serve", lambda: serve_batch(
        cfg_l, w, reqs, LONG_SERVE_EFFORTS, LONG_SERVE_NEW,
        "long_ctx_serve")[0])
    out["runs"] = out["prefill"] + [out["serve"]]
    out.update(peak_gib=peak_gib(), seconds=secs)
    emit({"phase": "long_ctx", "peak_gib": out["peak_gib"],
          "seconds": secs})
    return out


def family_decode(what: str, cfg, w) -> tuple:
    """The token loop on a family's model: the prompts of FAMILY_PROMPTS
    with N_NEW new tokens at FAMILY_EFFORTS through the captured steps
    (CUDA events; K1 4 a layer a step below 1.0, none at 1.0: dense
    copies), then one FAMILY_EAGER_NEW-token request at 0.25 through the
    eager steps, its tokens the graph's first. Returns (rows, engine)."""
    L, prompts = cfg.n_layers, seeded_ids(cfg, FAMILY_PROMPTS, 7)
    steps = sum(padded(n) + N_NEW - 1 for n in FAMILY_PROMPTS)
    eng = Engine(w, cfg, eos_id=-1)
    warm([eng], prompts[0], (0.25, 1.0))
    rows, graph = [], {}
    for effort in FAMILY_EFFORTS:
        torch.cuda.synchronize()
        reset_launches()                # the path's run starts here ...
        out, ms = timed_generate(eng, prompts, effort, N_NEW)
        launches = dict(LAUNCHES)       # ... and is read here
        graph[effort] = [x.token_ids for x in out]
        r = dict(route="graph", effort=effort, steps=steps,
                 ms_per_token=ms, launches=launches,
                 first_tokens=graph[effort][0][:8])
        rows.append(r)
        emit({"phase": f"{what}_decode", **r})
        check_replies(graph[effort], cfg, N_NEW, f"{what} decode {effort}")
        check_launches(launches, {
            "mxu_matvec": 4 * L * steps if effort < 0.999 else 0,
            "mxu_matvec_batch": 0, "flash_attention": 0},
            f"{what} decode at effort {effort}")
    n = FAMILY_EAGER_NEW
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    got = Engine(w, cfg, eos_id=-1, capture=False).generate(
        prompts[0], n_new=n, effort=0.25).token_ids
    r = dict(route="eager", effort=0.25, steps=padded(len(prompts[0])) + n
             - 1, seconds=time.perf_counter() - t0, launches=dict(LAUNCHES),
             first_tokens=got)
    rows.append(r)
    emit({"phase": f"{what}_decode", **r})
    check_launches(r["launches"], {"mxu_matvec": 4 * L * r["steps"],
                                   "mxu_matvec_batch": 0,
                                   "flash_attention": 0},
                   f"{what} eager decode")
    if got != graph[0.25][0][:n]:
        raise AssertionError(f"{what}: eager tokens {got} vs graph "
                             f"{graph[0.25][0][:n]}")
    return rows, eng


def phase_family(what: str, cfg, side=None) -> dict:
    """One Llama preset at 32 layers and its 4096 positions, the main
    model's recipe (module docstring, `llama2` and `llama3`). side(): a
    job started once the timed parts are done (decode, profile, prefill,
    serving), to run beside the gates; its handle is out["side"]."""
    torch.cuda.reset_peak_memory_stats()
    bcfg = BucketConfig(bucket_size=1, chunk_rows=128, dtype="int8")
    t0 = time.perf_counter()
    w = quantize_head(init_random_weights(cfg, bcfg, seed=0, calibrate=True,
                                          fuse=True, keep_dense=True,
                                          device="cuda"))
    torch.cuda.synchronize()
    out = dict(model_setup_s=time.perf_counter() - t0,
               weights_gib=torch.cuda.memory_allocated() / 2**30,
               w2_chunks=w.layers.w2.n_chunks,
               w2_chunk_rows=w.layers.w2.chunk_rows)
    emit({"phase": f"{what}_model", "config": dataclasses.asdict(cfg),
          **out})
    secs = {}
    out["decode"], eng = timed_part(secs, "decode", family_decode, what,
                                    cfg, w)
    out["profile"] = timed_part(secs, "profile", decode_profile,
                                f"{what}_profile", cfg, eng,
                                seeded_ids(cfg, (5,), 7)[0])
    del eng
    prompt = seeded_ids(cfg, (FAMILY_PREFILL,), 31)[0]
    pre = Engine(w, cfg, eos_id=-1, prefill=True)
    warm([pre], prompt[:32], PREFILL_EFFORTS)
    out["prefill"] = timed_part(secs, "prefill", lambda: [
        prefill_run(pre, cfg, [prompt], e, N_NEW, f"{what}_prefill")
        for e in PREFILL_EFFORTS])
    del pre
    out["serve"] = timed_part(secs, "serve", serve_batch, cfg, w,
                              serve_requests(cfg), SERVE_EFFORTS, N_NEW,
                              f"{what}_serve")[0]
    out["serve"]["http"] = timed_part(secs, "http", serve_http, cfg, w,
                                      f"{what}_http")
    out["side"] = timed_part(secs, "side", side) if side else None
    try:
        out["same_input"] = timed_part(secs, "same_input", ckpt_same_input,
                                       cfg, w, prompt, (0.25,),
                                       f"{what}_same_input")
        out["teacher"] = timed_part(secs, "teacher", seq_teacher, cfg, w,
                                    prompt, f"{what}_teacher")
    except BaseException:
        if out["side"]:
            out["side"]["stop"]()
        raise
    out["runs"] = out["decode"] + out["prefill"] + [out["serve"]]
    out.update(peak_gib=peak_gib(), seconds=secs)
    emit({"phase": what, "peak_gib": out["peak_gib"], "seconds": secs})
    return out


def llama3_ckpt_start() -> dict:
    """The first half of `llama3_ckpt`: a random HF-format Llama-3-8B
    checkpoint (HF_LLAMA3: full width, LLAMA3_CKPT_LAYERS deep, bf16,
    seeded) in a temporary directory, config_from_hf's gate, and the
    command line's conversion started on the card (`python3 -m
    effort_tpu_torch convert --model auto`, int8 row-prefix, fused; one
    subprocess), which phase_llama3_ckpt waits for."""
    tmp = tempfile.TemporaryDirectory()
    src, dst = Path(tmp.name) / "hf", Path(tmp.name) / "buckets"
    src.mkdir()
    t0 = time.perf_counter()
    write_hf(src, seed=21, h=HF_LLAMA3)
    out = dict(tmp=tmp, dst=dst, write_hf_s=time.perf_counter() - t0)
    cfg = config_from_hf(str(src))
    want = llama3_8b(n_layers=LLAMA3_CKPT_LAYERS)
    out.update(cfg=cfg, config_fields_apart=[
        f.name for f in dataclasses.fields(cfg)
        if getattr(cfg, f.name) != getattr(want, f.name)])
    if out["config_fields_apart"] != ["name"]:
        tmp.cleanup()
        raise AssertionError(f"config_from_hf: {cfg} vs {want}")
    out["convert"] = cli_start([
        "convert", "--model", "auto", "--src", str(src), "--dst", str(dst),
        "--bucket-size", "1", "--chunk-rows", "128", "--dtype", "int8",
        "--fuse"])
    out["stop"] = lambda: (out["convert"]["proc"].kill(), tmp.cleanup())
    return out


def phase_llama3_ckpt(started: dict) -> dict:
    """The checkpoint of llama3_ckpt_start, converted by the command line
    (module docstring, `llama3_ckpt`). Gates: the conversion exits 0;
    load_bucketized loads it with config_from_hf's config and its
    buckets; build_server (single flight, no tokenizer) answers the four
    CKPT_QUERIES, each reply's tokens those of an Engine in this process
    on the same loaded weights."""
    tmp, dst, cfg = started.pop("tmp"), started.pop("dst"), started.pop("cfg")
    started.pop("stop")
    out, run = started, started.pop("convert")
    try:
        conv = cli_wait(run)
        out["convert"] = {k: conv[k] for k in ("args", "rc", "seconds")}
        if conv["rc"] != 0:
            raise AssertionError(f"cli convert: {conv['stderr']}")
        t0 = time.perf_counter()
        w, cfg_l, bcfg_l = load_bucketized(str(dst), device="cuda")
        torch.cuda.synchronize()
        out["load_s"] = time.perf_counter() - t0
        bcfg = BucketConfig(bucket_size=1, chunk_rows=128, dtype="int8")
        if cfg_l != cfg or bcfg_l != bcfg or w.layers.wqkv is None:
            raise AssertionError(f"loaded {cfg_l} {bcfg_l}")
        http = ckpt_http(dst, None, 0)
        eng = Engine(w, cfg_l)
        served = [json.loads(r) for r in http["replies"]]
        local = [eng.generate(p, n_new=len(toks), effort=e / 100).token_ids
                 for p, toks, e in zip(http["prompts"], served,
                                       CKPT_HTTP_EFFORTS)]
        out.update(http=http, served=served, in_process=local,
                   same_tokens=served == local)
        emit({"phase": "llama3_ckpt", **{k: v for k, v in out.items()
                                          if k != "http"}})
        if not out["same_tokens"] or not all(served):
            raise AssertionError(f"served vs in-process tokens: {served} "
                                 f"{local}")
        del eng, w
    finally:
        if run["proc"].poll() is None:
            run["proc"].kill()
        tmp.cleanup()
    out["runs"] = [dict(launches=http["launches"])]
    if not http["launches"]["mxu_matvec"]:
        raise AssertionError("the served checkpoint never launched K1")
    return out


def free_card() -> None:
    """Release what the last model left on the card: collect unreachable
    objects first (the servers' and batchers' reference cycles keep their
    weights alive until the collector runs), then return the cached
    blocks; prints the GiB still allocated."""
    gc.collect()
    torch.cuda.empty_cache()
    emit({"phase": "free", "allocated_gib":
          torch.cuda.memory_allocated() / 2**30})


def summary_row(name: str, source: str, replaces: str, points: list,
                launches: int, pick) -> dict:
    """One kernel's entry of the `kernels` line: times summed over the
    points `pick` selects (one layer's launches, or one call), the largest
    error over all points."""
    rows = [p for p in points if pick(p)]
    by = {p["bound_by"] for p in rows if "bound_by" in p} or {"bytes"}
    return {"name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches,
            "max_abs_err": max(p["max_abs_err"] for p in points),
            "ms": sum(p["ms"] for p in rows),
            "plain_ms": sum(p["plain_ms"] for p in rows),
            "bound_ms": sum(p["bound_ms"] for p in rows),
            "bound_by": "operations" if by == {"operations"} else "bytes",
            "library_ms": sum(p["library_ms"] for p in rows)}


LLAMA_POINT_KEYS = ("shape", "in_dim", "out_dim", "T", "n_chunks", "effort",
                    "C", "ms", "plain_ms", "bound_ms", "bound_by",
                    "library_ms", "max_abs_err")


def k1_row(points: list, launches: int, shard_points: list,
           llama_points: list) -> dict:
    """K1's entry: one decode layer's four launches (SUMMARY), with where
    they spend their device time (parts_ms: selection, stream and split
    sum, the last two with their waits; K1_PART_KEYS), the parallel
    phase's shard shapes beside it (shard_points: each shape's ms, plain
    ms, bound and library ms at effort 0.25 and 1.0), and Llama-2-7B's
    projections likewise (llama2_points)."""
    pick = lambda p: (p["dtype"], p["effort"], p["tau"]) == SUMMARY  # noqa
    row = summary_row("mxu_matvec", "effort_tpu_torch/csrc/mxu_matvec.cu",
                      "effort_tpu/kernels/fused_stream.py:270", points,
                      launches, pick)
    row["parts_ms"] = sum_parts([p["parts_ms"] for p in points if pick(p)],
                                K1_PARTS, K1_PART_KEYS)
    row["ms_device_instance"] = sum(p["ms_device_instance"] for p in points
                                    if pick(p))
    row["shard_points"] = [
        {k: p[k] for k in ("shape", "in_dim", "out_dim", "effort", "C", "ms",
                           "plain_ms", "bound_ms", "library_ms",
                           "max_abs_err")} for p in shard_points]
    row["llama2_points"] = [{k: p[k] for k in LLAMA_POINT_KEYS}
                            for p in llama_points if p["T"] == 1]
    return row


def k3_row(points: list, launches: int, slots: list) -> dict:
    """K3's entry: one 64-query prefill call (SUMMARY_ATTN), and each
    case's ms, library ms and bound beside it (by_case); the device-slot
    cases' ms with int and with device slots (device_slots)."""
    row = summary_row(
        "flash_attention", "effort_tpu_torch/csrc/flash_attention.cu",
        "effort_tpu/kernels/flash_attention.py:36", points, launches,
        lambda p: p["case"] == SUMMARY_ATTN)
    row["by_case"] = {p["case"]: {k: p[k] for k in ("ms", "plain_ms",
                                                    "library_ms",
                                                    "bound_ms")}
                      for p in points}
    row["device_slots"] = {f"T{p['T']}_at{p['start_slot']}_w{p['window']}":
                           [p["ms_int"], p["ms_device"]] for p in slots}
    return row


def k8_row(points: list, launches: int) -> dict:
    """K8's entry: one chat layer's call (SUMMARY_DECODE), and each case's
    ms, plain ms, library ms and bound beside it (by_case)."""
    row = summary_row(
        "decode_attention", "effort_tpu_torch/csrc/decode_attention.cu",
        "none (XLA in the JAX package: effort_tpu/models/transformer.py:205)",
        points, launches, lambda p: p["case"] == SUMMARY_DECODE)
    row["by_case"] = {p["case"]: {k: p[k] for k in (
        "ms", "plain_ms", "library_ms", "bound_ms", "live_rows", "chunk")}
        for p in points}
    return row


def k2_row(points: list, launches: int, llama_points: list) -> dict:
    """K2's entry: the T = 64 summary, the T = 4 one under "_t4" keys, and
    Llama-2-7B's projections at T = 4 and 64 (llama2_points)."""
    row = summary_row(
        "mxu_matvec_batch", "effort_tpu_torch/csrc/mxu_matvec_batch.cu",
        "effort_tpu/kernels/fused_stream.py:391", points, launches,
        lambda p: (p["dtype"], p["T"], p["tau"]) == SUMMARY_BATCH)
    t4 = summary_row(
        "", "", "", points, 0,
        lambda p: (p["dtype"], p["T"], p["tau"]) == SUMMARY_BATCH_T4)
    row.update({f"{k}_t4": t4[k] for k in ("ms", "plain_ms", "bound_ms",
                                            "bound_by", "library_ms")})
    for key, T in (("parts_ms", SUMMARY_BATCH[1]),
                   ("parts_ms_t4", SUMMARY_BATCH_T4[1])):
        row[key] = sum_parts(
            [p["parts_ms"] for p in points
             if (p["dtype"], p["T"], p["tau"]) == (SUMMARY_BATCH[0], T,
                                                   SUMMARY_BATCH[2])],
            ("k2_select", "k2_stream", "k2_reduce"))
    row["llama2_points"] = [{k: p[k] for k in LLAMA_POINT_KEYS}
                            for p in llama_points if p["T"] > 1]
    return row


def gather_row(name: str, source: str, replaces: str, points: list,
               launches: int) -> dict:
    """K6's or K7's entry, with its ms at each projection of the summary
    (ms_by_shape: one launch each)."""
    pick = lambda p: (p["dtype"], p["effort"]) == SUMMARY_RANK[:2]  # noqa
    row = summary_row(name, source, replaces, points, launches, pick)
    row["ms_by_shape"] = {p["shape"]: p["ms"] for p in points if pick(p)}
    return row


def k4_row(points: list, launches: int) -> dict:
    """K4's entry, with where one layer's four calls spend their device
    time (parts_ms: selection, stream, split sum)."""
    pick = lambda p: (p["dtype"], p["effort"],   # noqa: E731
                      p.get("tau", 0.97)) == SUMMARY_RANK
    row = summary_row(
        "fused_matvec", "effort_tpu_torch/csrc/fused_matvec.cu",
        "effort_tpu/kernels/fused_stream.py:145", points, launches, pick)
    row["parts_ms"] = sum_parts([p["parts_ms"] for p in points if pick(p)],
                                ("k4_select", "k4_k5_stream", "split_sum"))
    row["ms_device_instance"] = sum(p["ms_device_instance"] for p in points
                                    if pick(p))
    return row


def main() -> int:
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: torch.cuda.is_available() is false; this "
                 "script runs on an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()
    name, smi = phase_device()
    phase_build()
    out = {"device": name, "nvidia_smi": smi, "phase_seconds": {}}

    def run(key, fn, *args):
        """fn(*args) into out[key], its wall seconds into phase_seconds."""
        t0 = time.perf_counter()
        out[key] = fn(*args)
        out["phase_seconds"][key] = time.perf_counter() - t0
        return out[key]

    flush = torch.empty(128 * 2**20, dtype=torch.uint8, device="cuda")
    run("points", phase_kernels, flush)
    run("points_batch", phase_kernels_batch, flush)
    run("attention", phase_attention, flush)
    run("k3_device_slots", phase_k3_device_slots, flush)
    run("decode_attention", phase_decode_attention, flush)
    run("points_llama", phase_kernels_llama, flush)
    run("points_rank", phase_kernels_rank, flush)
    del flush
    torch.cuda.empty_cache()
    model = build_model()
    replies = run("generate", phase_generate, *model)[1]
    out["generate"] = out["generate"][0]
    run("profile", phase_profile, *model[:3], model[3][0])
    run("teacher", phase_teacher, *model[:2],
        model[3][0] + replies[0.25][0].token_ids)
    run("prefill", phase_prefill, *model)
    run("prefill_teacher", phase_prefill_teacher, *model)
    run("serve", phase_serve, *model)
    run("graph", phase_graph, "mistral_row", *model[:2], model[3][3])
    run("batch_graph", phase_batch_graph, "mistral_row", *model[:2],
        serve_requests(model[0]))
    run("sampling", phase_sampling, *model[:2], model[3][1])
    run("session", phase_session, *model[:3])
    run("eval", phase_eval, *model[:3],
        {r["effort"]: r["ms_per_token"] for r in out["generate"]
         if r["route"] == "graph"})
    run("long_ctx", phase_long_ctx, *model[:2], out["generate"],
        out["prefill"])
    w_plain = build_plain_model(model[0])
    run("spec", phase_spec, "mistral_plain", model[0], w_plain, model[3][2])
    run("batch_spec", phase_batch_spec, "mistral_plain", model[0], w_plain)
    run("int8_kv", phase_int8_kv, *model[:2], w_plain)
    run("ring_kv", phase_ring_kv, model[0], w_plain)
    del w_plain
    prompts = model[3]
    del model, replies
    free_card()
    run("ckpt", phase_ckpt)
    out["cli"] = out["ckpt"].pop("cli")
    out["phase_seconds"]["cli"] = out["cli"]["seconds"]
    out["phase_seconds"]["ckpt"] -= out["cli"]["seconds"]
    free_card()
    run("train", phase_train, smi)
    free_card()
    run("parallel", phase_parallel)
    free_card()
    run("llama2", phase_family, "llama2", llama2_7b(n_layers=32))
    free_card()
    # the checkpoint's conversion runs beside llama3's gates
    llama3 = run("llama3", phase_family, "llama3", llama3_8b(n_layers=32),
                 llama3_ckpt_start)
    free_card()
    run("llama3_ckpt", phase_llama3_ckpt, llama3.pop("side"))
    free_card()

    cfg, w = build_rank_model()
    rank = run("rank_decode", phase_rank_decode, cfg, w, prompts)
    reply = rank.pop("replies")[0].token_ids
    run("rank_same_input", phase_rank_same_input, cfg, w, prompts[0][:2])
    run("rank_teacher", phase_rank_teacher, cfg, w, prompts[0] + reply[:8])
    run("rank_http", rank_http, cfg, w)
    run("rank_graph", phase_graph, "mistral_rank", cfg, w, prompts[3])
    del w
    free_card()

    run("instances", phase_instances)
    cfg, w, eng = build_moe_model()
    moe = run("moe_decode", phase_moe_decode, cfg, w, eng, prompts)
    reply = moe[0].pop("replies")[0].token_ids
    run("moe_profile", phase_moe_profile, cfg, w, eng, prompts[0])
    run("moe_teacher", phase_moe_teacher, cfg, w, prompts[0] + reply[:8])
    run("moe_prefill", phase_moe_prefill, cfg, w, prompts)
    run("moe_serve", phase_moe_serve, cfg, w, prompts)
    run("moe_graph", phase_graph, "mixtral_row", cfg, w, prompts[3])
    run("moe_batch_graph", phase_batch_graph, "mixtral_row", cfg, w,
        serve_requests(cfg))
    run("moe_spec", phase_moe_spec, cfg, w, prompts[2])
    del w, eng
    free_card()
    run("moe_rank", phase_moe_rank, prompts)
    new = ("long_ctx", "llama2", "llama3", "llama3_ckpt")
    out["new_phase_seconds"] = sum(out["phase_seconds"][k] for k in new)
    emit({"phase": "phase_seconds", **out["phase_seconds"],
          "new_phases": out["new_phase_seconds"]})

    rank_launches = {k: sum(r["launches"][k]
                            for r in rank["decode"] + rank["routes"]
                            + out["moe_rank"]["decode"])
                     + out["rank_http"]["launches"][k]
                     for k in ("fused_matvec", "stream_matvec",
                               "gather_matvec_dma", "gather_bucket_matvec")}
    serve_runs = (out["serve"] + out["moe_prefill"]["runs"]
                  + [out["moe_serve"]])
    spec_runs = (out["spec"]["rows"] + [out["batch_spec"]]
                 + out["moe_spec"]["rows"])
    new_runs = (out["long_ctx"]["runs"] + out["llama2"]["runs"]
                + out["llama3"]["runs"] + out["llama3_ckpt"]["runs"])
    k1_runs = (out["generate"] + out["prefill"] + out["moe_decode"]
               + [out["moe_serve"], out["moe_serve"]["http_single"]]
               + spec_runs + out["ckpt"]["runs"] + out["session"]["runs"]
               + out["eval"]["runs"] + out["train"]["runs"] + new_runs)
    serve_runs += (spec_runs + out["ckpt"]["runs"] + out["train"]["runs"]
                   + new_runs)
    summary_rank = lambda p: (p["dtype"], p["effort"],   # noqa: E731
                              p.get("tau", 0.97)) == SUMMARY_RANK
    out["kernels"] = kernels = [
        k1_row(out["points"], sum(r["launches"].get("mxu_matvec", 0)
                                  for r in k1_runs)
               + out["parallel"]["launches"]["mxu_matvec"],
               out["parallel"]["k1_shards"], out["points_llama"]),
        k2_row(out["points_batch"],
               sum(r["launches"].get("mxu_matvec_batch", 0)
                   for r in out["prefill"] + serve_runs),
               out["points_llama"]),
        k3_row(out["attention"], sum(r["launches"].get("flash_attention", 0)
                                     for r in out["prefill"] + serve_runs),
               out["k3_device_slots"]),
        k4_row(out["points_rank"]["k4"], rank_launches["fused_matvec"]),
        summary_row(
            "stream_matvec", "effort_tpu_torch/csrc/stream_matvec.cu",
            "effort_tpu/kernels/prefix_stream.py:91",
            out["points_rank"]["k5"], rank_launches["stream_matvec"],
            summary_rank),
        gather_row(
            "gather_matvec_dma", "effort_tpu_torch/csrc/gather_dma.cu",
            "effort_tpu/kernels/gather_dma.py:34",
            out["points_rank"]["k6"], rank_launches["gather_matvec_dma"]),
        gather_row(
            "gather_bucket_matvec", "effort_tpu_torch/csrc/gather_mul.cu",
            "effort_tpu/kernels/gather_mul.py:36",
            out["points_rank"]["k7"], rank_launches["gather_bucket_matvec"]),
        k8_row(out["decode_attention"], sum(
            r["launches"].get("decode_attention", 0) for r in {
                id(r): r for r in k1_runs + serve_runs + rank["decode"]
                + rank["routes"] + out["moe_rank"]["decode"]
                + [out["rank_http"]]}.values())
            + out["parallel"]["launches"]["decode_attention"])]
    out["seconds"] = time.perf_counter() - t_start
    OUT_DIR.mkdir(exist_ok=True)
    with open(OUT_DIR / "chip_smoke.json", "w") as f:
        json.dump(out, f, indent=1)
    emit({"phase": "done", "seconds": out["seconds"]})
    emit({"kernels": kernels})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": name,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
