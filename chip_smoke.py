#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one CUDA card and hold its kernels to
their plain versions.

    python3 chip_smoke.py                 # every phase, one card
    python3 chip_smoke.py --kernels-only  # build + kernel checks only
    python3 chip_smoke.py --phase moe     # build + one phase (serve,
                                          # batching, mixed, graph,
                                          # quant, kvcache, surface,
                                          # speculative, fleet, chain,
                                          # server, vision, native,
                                          # parallel, moe), no result
                                          # lines

Run from the root of a checkout.  Phases, each printing one JSON line:

1. device   the card (``nvidia-smi`` name and power limit) and the build
            of every kernel from the sources under
            ``distributed_inference_demo_tpu_torch/csrc/`` (all sources
            compiled at once, one ``nvcc`` each);
2. kernels  each kernel against its plain PyTorch version on the card at
            the main paths' shapes, with the stated tolerance, and its
            time beside the plain version's, the bound's and one PyTorch
            library call's (a yardstick the port never calls).  ``ms``
            is device time (calls replayed from a CUDA graph);
            ``eager_ms`` is per eager call, host launch cost included.
            The flash kernel (chunks of 16-512 tokens, the 2048-token
            prompt, ragged rows with ALiBi, one token either side of its
            instance threshold; each bf16 row names the instance the
            wrapper took and holds and times the other one too), then
            the two paged kernels (decode and
            chunk prefill) over shuffled page tables with sentinels, on
            full-width pages and on int8 pages (their int8 instances),
            the prefill kernel on a mixed dispatch's 4-row slab and on a
            1024-row chunk, decode rows around the split boundaries;
            each row of the 8-slot bf16 decode launch bit-equal to the
            row launched alone;
3. serve    the plain path: ``InferenceHTTPServer`` over
            ``InferenceEngine`` at full TinyLlama-1.1B width (random
            weights from a seed) answers a greedy, a streamed and a
            sampled request; the launch counts show the prefill went
            through the flash kernel's 16-row instance; the prefill
            logits are held against an engine on plain attention, for
            the 64-token prompt and for a 1500-token one, whose prefill
            takes the 64-row instance in every layer;
4. batching the serving path: ``InferenceHTTPServer`` over
            ``ContinuousBatchingEngine`` (8 slots, paged KV, chunked
            admission) at full TinyLlama-1.1B width answers 8 concurrent
            greedy requests, one streamed and two sharing a prefix; the
            paged kernels' launch counts equal what the routing predicts;
            at bf16 the logits of a chunked prefill and of decode steps
            through the engine's kernels are held against the same
            engine configuration on the gather path; at f32 the tokens
            equal a plain-attention ``InferenceEngine``'s; no page leaks;
            throughput, TTFT, step time and the device's idle share;
5. mixed    the mixed prefill+decode dispatch over int8 pages: the same 8
            requests to ``ContinuousBatchingEngine`` with
            ``mixed_token_budget`` 288 (4 segments of 64 tokens beside 8
            rows x 4 decode steps) and ``kv_dtype`` int8; the int8
            kernels' launch counts equal L x decode steps and L x slab
            forwards; at bf16 the logits through the int8 kernels are held
            against the gather path's, as in the batching phase; at f32
            the tokens equal the same configuration's on the gather path;
            no page leak; an int4 request gathers with no
            launch; throughput, TTFT, step time, idle share, the
            teacher-forced logit gap between a prefill chunk run in a mixed slab and run alone,
            through the kernels and through the gather path; the K/V
            pages the 1000-, 150- and 20-token prompts write, chunk by
            chunk, serialized and in a mixed slab, compared bit for bit,
            with whether layer 0's dense products give a chunk's rows
            bit-equal at the two row counts (ROADMAP C 2);
6. serve_model  plain serve, as in phase 3, of each model at the kernels'
            other head dims, at full width: gemma-2b (hd 256), bloom3b
            (hd 80) and bloom1b1 (hd 96): one greedy request, the flash
            kernel's launch count, the prefill logits against plain
            attention, decode ms/token;
7. batching, mixed  phases 4 and 5 for gemma-2b (at f32 its batching
            tokens through the kernels equal the gather path's), and
            phase 4 for bloom3b (bf16 only);
8. graph    every decode step of phases 3-7 replays a captured CUDA graph
            (the engines' default); this phase runs five paths with the
            graph and with ``cuda_graph=False``, one engine each on the
            same weights: TinyLlama plain serve (b=1), 8-slot batching
            and 8-slot mixed int8, gemma-2b batching, bloom3b plain
            serve (ALiBi).  For each: ms/token or ms per step, the
            device's idle share (``torch.profiler``), replays against the
            decode steps, paged decode launches against L per step, and
            greedy bf16 tokens and logprobs of the two equal bit for bit
            (TinyLlama plain also greedy and sampled at f32); the dense
            kernel's launches (none on these float models) against the
            routing;
9. quant    int8 / int4 weights through the dequantizing dense kernels
            (``csrc/quant_dense.cu``: the decode kernel for bf16 M <= 16,
            the prefill kernel above, the f32 kernel for f32).  Its rows
            (with phase 2): each kernel against its plain version at
            TinyLlama's seven weight shapes, M = 1, 8 and 256, int8 and
            int4, bf16 and f32 activations, M = 16 and 17 (the routing
            boundary) in bf16, M = 1500 for w_up in bf16, and at
            llama-3-8b's four, M = 1 and 64, int8, bf16 (every shape the
            phase serves), each naming its kernel and split count, with
            device ms warm (one weight, replayed) and cold (a captured
            pass over enough copies of the weight to exceed 100 MB, so
            every call finds it out of the L2), eager ms, the plain
            version's, ``torch.matmul`` over the weight dequantized
            beforehand (what the bf16 model pays) warm and cold, the
            bound and the instance's registers and spills; every row of
            an 8-row decode launch bit-equal to the same row launched
            alone, at TinyLlama's and llama-3-8b's decode shapes; the
            kernels' SASS conversion counts (``cuobjdump``).  Then, as
            phase 8 runs them, with the graph and with
            ``cuda_graph=False``: tinyllama-1.1b-int8 plain serve and
            8-slot batching and tinyllama-1.1b-int4 plain serve: the
            dense kernels' launches equal 7 x L a forward (the decode
            kernel's: 7 x L a decode step), tokens and logprobs
            bit-equal, and
            prefill and decode logits held against a float twin whose
            weights are the same codes dequantized (plain serve through
            the plain engine's forward, batching through the batching
            engine's paged forward); llama-3-8b-int8 and llama-3-8b plain
            serve (graph only): init peak memory, ms/token, device ms a
            step and the dense kernel's share, and the int8 model's
            logits against its twin;
            ``serve --model tinyllama-1.1b-int8 --checkpoint DIR`` over a
            full-width HF state dict written as two safetensors shards:
            the served codes bit-equal to ``maybe_quantize(
            params_from_state_dict(...))`` of the same tensors, one
            greedy request over HTTP;
10. moe     mixtral at full width (random bf16 weights from seed 0):
            mixtral-tpu-1b (8 experts of top 2, g = 4, hd 64) plain serve
            as phase 6 with the LONG_PROMPT_LEN-token prefill too, then
            as phase 8 (graph and eager bit-equal; ms/token, device ms a
            step, idle share); its -dense twin the same way, and the
            ratio of their device ms a step; 8-slot batching as phases 4
            and 8; mixtral-tpu-1b-int8 plain serve as phase 9 (224 dense
            launches a decode step, the twin check); mixtral-8x7b-int8
            plain serve, graph only, as phase 9's llama-3-8b (init peak,
            896 dense launches a decode step), its twin check on a depth
            cut of MOE_TWIN_LAYERS layers at full width (its bf16 twin of
            all 32 layers does not fit the card);
11. kvcache  the engines' KV options at TinyLlama's full width:
            ``InferenceEngine`` with a prefix pool of KV_POOL_BLOCKS
            16-token pages (bf16, the flash kernel, 64-token chunks):
            KV_PROMPTS prompts sharing a KV_PREFIX-token prefix; prefill
            wall time cold, on a miss and warm (one chunk prefilled, L
            flash launches at q_start KV_PREFIX), the warm logits and a
            warm request's tokens and logprobs against the cold
            engine's, a blocking and a streamed HTTP request, hits, pool
            bytes, no leak; int8 and int4 pools' warm logits against
            their twin's (the cold engine over the same codes) at the
            twin tolerance, int8's also against the bf16 pool's (int4's
            reported); each pool's blocks exported and adopted back
            bit-equal; 8-slot batching over float8 e4m3 pages as phases
            4 (the e4m3 instances' launches against the routing, bf16
            logits against the gather path, f32 tokens, at
            FP8_F32_LAYERS (6) of the layers and full width, against the
            gather path's: equal, or parting only at near ties) and 8
            (replayed = eager, ms a step, idle share); the plain engine
            over a float8 cache (plain attention; ms/token, device ms a
            step);
    (phase 2 holds the e4m3 instances to their plain versions at the
    decode rows, the 64-token chunk at 200, the slab, the split
    boundaries and gemma-2b's heads, and the flash kernel at the warm
    prefill's shape)
12. surface  the serving surface at TinyLlama's full width: a crafted
            32000-piece sentencepiece model (``build_model_proto``)
            written to a file and loaded as ``--tokenizer`` does; an
            ``InferenceHTTPServer`` over a plain engine (the flash
            kernel) and one over an 8-slot batching engine (the paged
            kernels), both with it: text prompts equal their ids,
            ``text`` their decode and stream deltas the blocking text
            (24- and 1500-token prompts); a stop string from mid-output
            cuts blocking and streamed answers alike, with logprobs too,
            leaving no slot or page held; ``/metrics`` counters equal
            what the phase sent, traced requests' spans sit within their
            e2e, one ``/timeline`` record a request, ``/debugz`` and a
            byte-stable ``/sketch``; the paged kernels' launches for 8
            concurrent text requests against the routing's prediction,
            the flash kernel's for the plain server's; the ``generate``,
            ``classify`` and ``chat --ids`` commands as subprocesses;
            the sampled dispatch profiler's decode step at least
            PROFILER_SYNC_SHARE of torch.profiler's device ms a step;
            encode ms, TTFT of text against ids, tok/s, and the decode
            ms a step at every profiler cadence (the default's is the
            telemetry-on step);
13. speculative  speculation at TinyLlama's full width, the catalog's
            8-layer ``mixtral-tpu-1b-dense`` as the draft (hd 64, g = 4,
            TinyLlama's vocab), K = 4: ``SpeculativeEngine`` with that
            draft and with TinyLlama as its own draft, and
            ``PromptLookupEngine`` on a 64-token span repeated four
            times, b=1, 128 new tokens: acceptance, tokens a round, ms
            per emitted token against a plain engine's, device ms a
            round and idle share (SPEC_ROUNDS_PROFILED rounds), the
            flash kernel's launches = L a prefill, the first 32 tokens
            replayed = eager bit for bit, bf16 greedy streams equal to
            the plain engine's or parting at a reported near tie
            (``spec_partings``), f32 token-exact (the target at
            SPEC_F32_LAYERS of its layers, full width); 8-slot
            batching over the batching phase's prompts with either proposer,
            serialized (``decode_block`` 4) and mixed over int8 pages
            (budget 288, adaptive K), and prompt lookup over float8
            pages: the paged kernels' launches against the routing
            (``rounds_by_width``: the draft's decode kernel L_d x (k + 1)
            a round, the verify's prefill kernel L a round, the
            admissions'), and in the window after the last admission,
            read between two dispatches on the scheduler's thread, the
            verify's own launches = L x that window's rounds; no page
            left in either pool, the ``/stats`` fragment, the K_row
            buckets visited, greedy tokens against the plain batching
            engine's (partings at near ties, ``_batch_partings``),
            replayed = eager, tok/s, ms a round, idle share; in f32
            (the target at SPEC_F32_LAYERS, 6, of its 22 layers, full
            width), the batching phase's requests with either proposer,
            serialized and mixed, token-exact against a plain batching
            engine's, and the kernels against the gather path; ``serve
            --draft-model`` and ``serve --batch-slots 8
            --prompt-lookup`` over HTTP, blocking and streamed (the
            streamed request's prefix hit beside the plain ``serve
            --batch-slots 8`` server's own blocking/streamed pair);
            ``generate --prompt-lookup`` on tinyllama-1.1b-int8 (the
            dense kernels under the verify: 7 x L a round);
    (phase 2 holds the paged prefill kernel at the verify shape, 8 rows
    of K + 1 tokens at starts 20-1999 with one freed slot, on full-width,
    int8 and e4m3 pages, and the draft's decode rows on int8 pages)
14. fleet   KV movement and the fleet at TinyLlama's full width (bf16,
            random weights from seed 0, 8 slots, 16-token pages, one
            loopback fabric): (a) a 96-block pool with a host ring and a
            disk segment below it (16 and 64 MiB of bf16 blocks, the
            same block counts over int8 pages): a 1088-token prompt, 3
            prompts that evict its 1024-token prefix, then a prompt
            sharing it, whose blocks promote, some from the disk; the
            promoted pages bit-equal to their bits at demotion, tokens
            and logprobs bit-equal to a device prefix hit's,
            ``dwt_kvcache_h2d_bytes_total`` = promoted blocks x block
            bytes, the tier's accounting; TTFT promoted, re-prefilled
            and hit, demote and promote ms; (b) a ``PrefillWorker`` (the
            flash kernel, L x chunks) streaming 4 requests of 20-1500
            tokens to a ``DecodeWorker`` on a fresh engine (every
            prompt block adopted and decoded over, the paged kernels
            as the routing predicts, 0 bytes host to device), tokens
            against a colocated engine's (bf16 partings at near ties
            only; f32 on two requests, exact); (c) a request decoding
            beside 3 others moves between two engines at its 16th
            token, over bf16 and int8 pages: the stream unbroken,
            tokens bit-equal to the unmigrated run, at most one step
            replayed, no page leaked; the handoff pause, each phase's
            bytes; (d) ``GatewayHTTPServer`` over two
            ``InferenceHTTPServer`` replicas: A dies mid-stream (a
            ``comm/faults`` ``crash_after`` rule), greedy and sampled
            streams resume on B equal to the unfailed answer; death to
            the first resumed token; a prefix A's tier holds routes to
            A (``host_tier``, from its ``/stats`` digest) and promotes;
15. parallel  multiple devices on ``torch.distributed``, on the one card
            (it prints ``torch.cuda.device_count()``; the ranks are
            processes, rank 0 drives, gloo through pinned host memory,
            since NCCL refuses two ranks on one device), each check on a
            line of its own: an NCCL group of size 1 whose all-reduce,
            all-gather and all-to-all at TinyLlama's 8-slot shapes are
            captured in a CUDA graph and replayed equal to eager; on
            one tp=2 mesh (its ranks started once):
            TinyLlama bf16 tp=2 8-slot ``--batch-slots`` serving, at full
            width and PAR_BATCHING_LAYERS of its 22 layers, of the
            batching phase's 8 requests over HTTP: tokens against the
            tp=1 engine on the card (partings at near ties only), both
            ranks' paged launches against the routing, no page leak, ms a
            step at tp=2 and tp=1 (both eager), rank 0's device ms a step
            and idle share, the collectives' ms and staged bytes, an f32
            cross-check on two prompts; llama-3-8b and llama-3-8b-int8
            at full width and PAR_GENERATE_LAYERS of their 32 layers,
            plain ``generate`` at tp=2: prefill logits against tp=1
            within the bf16 tolerance, tokens (partings at near ties),
            both ranks' flash launches (L a prefill) and dense launches
            (7 x L a forward, on the sliced int8 weights), ms/token at
            both widths; mixtral-tpu-1b f32 at ep=2 (4 experts a rank)
            against the all-experts path; TinyLlama f32 sp=2 at
            SP_LAYERS (6) of its 22 layers, full width, ring and
            Ulysses, on a SP_PROMPT_LEN-token prompt: tokens equal the
            single-device engine's at that depth, Ulysses' flash
            launches (L a rank);
    (phase 2 holds the per-rank instances: one tp=2 rank of TinyLlama's
    heads at the paged kernels' 8-slot decode and 64-token chunk, of
    llama-3-8b's at the flash kernel's 64-token prompt, and llama-3-8b's
    sliced int8 weights at the dense kernels)
16. chain   the ring pipeline at TinyLlama's full width and CHAIN_LAYERS
            (6) of its 22 layers (bf16, random weights from seed 0; the
            engines it is held to at the same depth): CHAIN_STAGES
            elastic stages of ``split_layer_ranges(6, 3)``, each on the
            card in a thread
            of this process over ``LoopbackTransport`` (the card machine
            has no pyzmq), under an ``ElasticHeader``; four greedy
            requests of 20-1500 tokens, 32 new each, interleaved
            (``pool_size`` 4), then two of them over HTTP through
            ``HeaderBackend``: each stage's own paged kernel launches
            (its seam's counters, not the process-wide ones) equal its
            layers x its chunks, and sum to the wrappers' counts; tokens
            equal the single-device ``InferenceEngine``'s (bf16
            partings at near ties only), the HTTP answers the window's;
            no page left in any stage's pool; the window again with a
            reshard 3 -> 2 stages mid-generation and back to 3, equal
            to the unbroken run (near ties only); f32, two requests:
            exact, resharded too.  Reported: the chain's ms a token
            against the eager and graph engines on one prompt, each
            stage's compute and wire ms a hop, bytes a hop and its
            device-to-host copies, the 1500-token prompt's TTFT, device
            ms a token and idle share;
    (phase 2 holds the paged kernels at the chain's stage shapes: one
    token at the longest request's last length, the 1500-token chunk)
17. server  the root server (``server_app.py``) at TinyLlama's full width
            and depth (bf16, random weights from seed 0): ``ServerApp``'s
            own steps with one header and two workers in threads of this
            process over ``LoopbackTransport``, the registration,
            monitor and lifecycle services answering through their
            handlers (no pyzmq on the card machine): each device's
            ``memory_info`` and ``flops_probe`` on the card and its
            latency and bandwidth probes of its ring successor over
            localhost TCP; the plan over the measured profiles covers
            the 22 layers with the header as stage 0, and ``cli plan``
            on the same profiles prints it; each worker's stage params
            after its chunked ``stage:<id>`` blob are bit-equal to its
            slice (bytes, serialize and deserialize seconds); the chain
            phase's four prompts over HTTP through ``HeaderBackend``:
            each stage's paged launches = its layers x chunks and x
            hops, tokens against the graph engine (near ties only), two
            again under ``--pool-size`` 2, ``/classify``, ``/stats``
            roles, pools whole, ms a token against the eager and graph
            engines; ``tinyllama-1.1b-int8`` through the same steps (float
            blobs, each stage quantizing its slice): one request, each
            stage's dense decode launches = its layers x 7 x its hops;
            ``cli bench`` in process: flash launches = L x prefills;
    (phase 2 holds the flash kernel at bench's shape, 8 rows of 64 tokens)
18. vision  ``serve --vision --vision-preset llava15`` at full width and
            depth: the CLIP-ViT-L/14-336 tower (24 layers of 1024, 576
            patches, bf16) and its projector in front of TinyLlama,
            random weights from ``--weights-seed`` 0, built by the CLI's
            ``build_vision_backend``.  Over HTTP, counted from 0, a
            336 x 336 x 3 JSON image request and a text request: flash
            launches = L x 2 prefills (the image's 600-row prefix in one
            forward), graph replays = the decode steps, the image answer
            = ``MultimodalEngine.generate``'s tokens and the text answer
            = a plain ``InferenceEngine``'s, exactly; ``/stats``, a bad
            shape's 400 and an image stream's 501.  The bf16 tower
            against its weights in f32 on the card (max |diff| within
            VISION_TOWER_TOL_REL of the largest value, relative RMS
            within VISION_TOWER_RMS_REL); the prefix logits through the
            flash kernel against plain attention on the same embeds
            (bf16 tolerance), the greedy image stream against plain
            attention's (near ties only); ``MultimodalHeader`` +
            ``VisionWorker`` + a ``PipelineWorker`` (two paged stages)
            over ``LoopbackTransport`` threads: an image and a text
            request, tokens = the engine's up to near ties, each stage's
            paged launches = its layers x chunks and x hops, pools
            whole.  Reported: the tower's ms an image, the prefix
            prefill's ms, the graph decode's ms a token, the host's
            seconds to parse the JSON image;
    (phase 2 holds the flash kernel at the 600-row prefix, and the paged
    kernels at the ring stages' prefix chunk and last decode token)
19. native  the native library (``comm/native``) built with g++ from the
            port's own sources into ``build/native/``: codec frames =
            ``comm/wire.py``'s byte for byte on every wire dtype (a bf16
            hidden chunk from the card included), decoded back equal, a
            corrupted frame rejected; native tokenizer ids and text =
            the python backend's on a bytelevel and a metaspace
            ``tokenizer.json`` the phase writes (special tokens, byte
            fallback); the build's seconds, each codec's µs a frame and
            each tokenizer backend's encode µs per 1 KB of text;
20. train   training on the card (``parallel/pipeline.py``,
            ``checkpoint.py``) at TinyLlama's full width: pp = 1, full
            depth, bf16, one process: TRAIN_STEPS AdamW steps (state in
            bf16) on a fixed 8 x 128-token batch in two microbatches, the
            loss finite and falling, ms a step and tokens/s; on one pp =
            2 mesh (two ranks over gloo on the one card): f32 at
            TRAIN_PP_LAYERS (2) of 22 layers, ``pipeline_apply``'s loss
            and one ``sgd(1.0)`` step's change of ``wq``, ``w_down`` and
            the embedding against the single-process autograd
            reference's loss and gradient, the step's ms against pp =
            1's at the same depth and the bytes it staged through host
            memory; ``tinyllama-1.1b-int8``'s forward through the
            pipeline (the dense kernel) against its dequantised twin,
            the last rank's logits within LOGIT_TOL_REL of the twin's
            largest, each rank's dense launches = 7 x
            its 11 layers x 2 microbatches; the circular decode, f32 at
            full depth, greedy tokens against ``InferenceEngine``'s
            (near ties only); ``TrainCheckpointManager`` on the pp = 1
            run's params and AdamW state (6.6 GB): a save and a restore
            in a fresh manager, bit for bit, seconds and GB/s each way,
            ``load_or_init`` on ``save_params``' directory bit for bit,
            ``max_to_keep`` on a small tree;
    (phase 9's kernel rows hold the dense kernel at the train phase's
    256-row products: TinyLlama's w_up, M = 256)
21. the ``{"kernels": [...]}`` line, then the card's nvidia-smi line, then
   the ``{"ok": true, "device": {...}}`` line.

Phases 10 to 20 run in the order 11, 12, 13, 14, 16, 17, 18, 19, 20, 15,
10:
the moe phase last, after the earlier phases freed their memory.  Every phase line carries
its wall ``seconds``.  Exits non-zero, printing no
result, without CUDA or outside a checkout, and on any failed check.
"""

import json
import os
import subprocess
import sys
import time
import traceback
import urllib.error
import urllib.request

SERVE_MODEL = "tinyllama-1.1b"
MAX_SEQ = 2048
PROMPT_LEN = 64
NEW_TOKENS = 32
# the serve phase's long prompt: its prefill takes the flash kernel's
# 64-row instance
LONG_PROMPT_LEN = 1500
# the graph phase's plain paths: decode rate (t(1 + n) - t(1)) / n, n
# steps; the profiled decode, as many steps
GRAPH_DECODE_TOKENS = 64
PROFILE_DECODE_STEPS = GRAPH_DECODE_TOKENS
# the eager twins' depth: an eager step is host bound (35-60 ms for
# TinyLlama, twice that on a slow host), so the eager side of the graph
# comparisons times and profiles fewer steps; its tokens and logprobs are
# still held to the replayed side's over NEW_TOKENS
EAGER_DECODE_TOKENS = 16
EAGER_WINDOW_STEPS = (8, 4)      # decode_window's timed, profiled steps
# kernel vs plain: |kernel - plain| <= atol + rtol * |plain|, elementwise.
# f32: both sum the same f32 products in another order (~1e-6 apart).
# bf16: the plain versions compute in f32 and round once to bf16.  The
# bf16-q instances of all three kernels also round each probability to
# bf16 (2^-9 relative) for the P V product on the tensor cores, and the
# paged ones on int8 pages apply the f32 per-token scale to the score
# column and to the probability (the codes are exact in bf16).  So each
# output, a convex mix of unit-scale V values, moves by up to about 2^-9
# times the spread of V, before its own bf16 rounding: under 2e-2.
TOL = {"float32": (1e-4, 1e-4), "bfloat16": (2e-2, 2e-2)}
# prefill logits, kernel engine vs plain-attention engine, both bf16: the
# attention outputs round differently in places and 22 layers carry it on
LOGIT_TOL_REL = 5e-2      # of max(1, max |plain logit|)
# the same in f32: only summation order differs
LOGIT_TOL_F32 = 1e-3
# published H100 SXM peaks (dense): bf16 tensor cores, f32 without them,
# device memory bandwidth
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
PEAK_BYTES = 3.35e12
CSRC = "distributed_inference_demo_tpu_torch/csrc/"
KERNEL_SOURCE = CSRC + "flash_attention.cu"
KERNEL_REPLACES = "distributed_inference_demo_tpu/ops/flash_attention.py:49"
PAGED_SOURCE = CSRC + "paged_attention.cu"
PAGED_REPLACES = {
    "paged_decode": "distributed_inference_demo_tpu/ops/paged_attention.py:136",
    "paged_prefill":
        "distributed_inference_demo_tpu/ops/paged_attention.py:326"}
QUANT_SOURCE = CSRC + "quant_dense.cu"
QUANT_REPLACES = ("distributed_inference_demo_tpu/ops/quant.py:333 (dense: "
                  "the counterpart of an XLA fusion, not of a Pallas kernel)")
# the quant phase's kernel rows: plain decode, 8-slot decode, a mixed
# slab's rows (TinyLlama); bf16 only, either side of the routing boundary
# and a long prompt's chunk (w_up); the large model served b=1 there
QUANT_ROWS = (1, 8, 256)
QUANT_BOUNDARY_ROWS = (16, 17)
QUANT_LONG_ROWS = 1500
# cold rows: a captured pass over this many bytes of weight copies
COLD_BYTES = 100_000_000
LARGE_MODEL = "llama-3-8b"
# the int8 instances replace the same kernels' quantized branches
PAGED_REPLACES["paged_decode_int8"] = PAGED_REPLACES["paged_decode"]
PAGED_REPLACES["paged_prefill_int8"] = PAGED_REPLACES["paged_prefill"]
# the same int8 prefill instance at the shape the mixed path launches it
PAGED_REPLACES["paged_prefill_int8_slab"] = PAGED_REPLACES["paged_prefill"]
# the e4m3 instances replace the same kernels over float8 pages, which
# they upcast like a page of any dtype
PAGED_REPLACES["paged_decode_fp8"] = PAGED_REPLACES["paged_decode"]
PAGED_REPLACES["paged_prefill_fp8"] = PAGED_REPLACES["paged_prefill"]
# the batching phase: 8 slots, pages of 16 tokens, 64-token admission
# chunks, 8 concurrent requests of these prompt lengths, 32 new tokens
SLOTS = 8
BLOCK_TOKENS = 16
PREFILL_CHUNK = 64
BATCH_PROMPTS = (20, 64, 100, 150, 300, 600, 1000, 1500)
SHARED_PREFIX = 256         # the 300- and 600-token prompts share it
# the mixed phase: 4 decode steps per dispatch and a budget of 8 x 4 +
# 4 x 64 tokens (the README's formula: 4 prefill segments per dispatch)
MIXED_DECODE_BLOCK = 4
MIXED_BUDGET = SLOTS * MIXED_DECODE_BLOCK + 4 * PREFILL_CHUNK
# the slab case: 4 rows of 64-token segments, the last unused (start 0,
# all-sentinel table, marked None)
SLAB_STARTS = (0, 64, 448, None)
# the catalog's models at the kernels' other head dims, at full width:
# gemma-2b (hd 256, 8 q heads on 1 kv head, GeGLU, embedding scale) and
# bloom3b (hd 80, ALiBi, 32 heads) through plain serve, 8-slot batching
# and (gemma-2b) the mixed dispatch over int8 pages; bloom1b1 (hd 96,
# ALiBi) through plain serve
HEAD_DIM_MODELS = ("gemma-2b", "bloom3b", "bloom1b1")
# the kvcache phase: KV_PROMPTS prompts of a shared "system prompt" of
# KV_PREFIX tokens and PREFILL_CHUNK tokens of their own, a prefix pool
# of KV_POOL_BLOCKS pages of BLOCK_TOKENS
KV_PREFIX = 1024
KV_POOL_BLOCKS = 256
KV_PROMPTS = 6
# the moe phase: mixtral-tpu-1b (hd 64, 16 q heads on 4 kv heads, 8
# experts of top 2) and its -dense twin (the same active FLOPs a token)
# at full width and depth; mixtral-8x7b-int8 (hd 128, g = 4) at full
# width and depth, its twin check at a depth cut of MOE_TWIN_LAYERS (the
# bf16 twin of all 32 layers, ~93 GB, does not fit the card)
MOE_MODEL = "mixtral-tpu-1b"
MOE_LARGE = "mixtral-8x7b-int8"
MOE_TWIN_LAYERS = 2
# the float8-page batching's f32 gather check at 6 layers, full width:
# f32 streams part only at near ties at any depth (pays for the train
# phase with the speculative phase's single-request f32 check at
# SPEC_F32_LAYERS and one tp mesh for the parallel phase's tp checks)
FP8_F32_LAYERS = 6
# the speculative phase: TinyLlama with the catalog's 8-layer dense
# llama as its draft (hd 64, g = 4, TinyLlama's vocab), K proposals a
# round; the prompt-lookup prompt repeats a SPEC_SPAN-token span; the
# verify kernel case: 8 rows of K + 1 tokens at per-row starts, one freed
SPEC_DRAFT = "mixtral-tpu-1b-dense"
SPEC_K = 4
SPEC_NEW = 128
SPEC_SPAN = 64
SPEC_REPEATS = 4
SPEC_ROUNDS_PROFILED = 4
SPEC_F32_LAYERS = 6      # the f32 speculative checks' depth cut
SPEC_EAGER_NEW = 16      # tokens of an eager run held to the graph's
VERIFY_STARTS = (20, 150, 300, 600, 1000, 1500, 1999, None)
# the parallel phase: tp=2 ranks as processes on the one card (gloo
# through host memory; NCCL refuses two ranks on one device), ep=2 on
# mixtral-tpu-1b, sp=2 ring and Ulysses on a SP_PROMPT_LEN-token prompt
PAR_TP = 2
PAR_GENERATE_NEW = 16
# the tp=2 llama-3-8b generate (of 32 layers) and the tp=2 TinyLlama
# 8-slot serve (of 22) run at full width and these depths: their kernels
# launch at their shapes, their launch checks scale with L
PAR_GENERATE_LAYERS = 4
PAR_BATCHING_LAYERS = 6
SP_PROMPT_LEN = 3072
SP_LAYERS = 6          # the sp check's depth cut (full width, f32)
# the vision phase's prefix: the llava15 tower's 576 patches and the text
VISION_PATCHES = 576
VISION_TEXT = 24
VISION_NEW = 32
VISION_PREFIX = VISION_PATCHES + VISION_TEXT
SP_NEW = 8
SP_MAX_SEQ = 3200


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout
    return out.strip().splitlines()[0]


def eager_ms(torch, fn, iters: int = 50, warmup: int = 5) -> float:
    """Mean time of ``fn`` over ``iters`` back-to-back eager calls, by
    CUDA events.  At small shapes the host's launch cost, not the device,
    sets this number."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def _graph_counters(torch):
    """The dense kernel's arrival counters of one timing graph, allocated
    before its capture (a capture of a dense product needs its own)."""
    from distributed_inference_demo_tpu_torch.ops import quant_dense as qd
    return qd.counters_scope(qd.new_counters(
        torch.device("cuda", torch.cuda.current_device())))


def device_ms(torch, fn, iters: int = 50) -> float:
    """Mean device time of ``fn``: ``iters`` calls captured in one CUDA
    graph and replayed, so no host launch cost sits between them."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    # the graph keeps the counters' address: they live while it does
    with _graph_counters(torch) as counters, torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


# ---------------------------------------------------------------------------
# phase 1: device + build
# ---------------------------------------------------------------------------

def ptxas_report(log: str) -> list:
    """Each kernel instance's registers and spill bytes from nvcc's
    ``-Xptxas -v`` output, its name demangled by ``c++filt`` where the
    machine has it."""
    import re
    rows, name, spill = [], None, (0, 0)
    for ln in log.splitlines():
        m = re.search(r"Function properties for (\S+)", ln)
        if m:
            name, spill = m.group(1), (0, 0)
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      ln)
        if m:
            spill = (int(m.group(1)), int(m.group(2)))
            continue
        m = re.search(r"Used (\d+) registers", ln)
        if m and name is not None:
            rows.append({"kernel": name, "registers": int(m.group(1)),
                         "spill_stores": spill[0], "spill_loads": spill[1]})
            name = None
    try:
        names = subprocess.run(
            ["c++filt"], input="\n".join(r["kernel"] for r in rows),
            capture_output=True, text=True, timeout=60,
            check=True).stdout.splitlines()
        if len(names) == len(rows):
            for r, n in zip(rows, names):
                r["kernel"] = n.replace("(anonymous namespace)::", "")
    except (OSError, subprocess.SubprocessError):
        pass
    return rows


def phase_device(torch, smi: str) -> dict:
    from concurrent.futures import ThreadPoolExecutor

    from distributed_inference_demo_tpu_torch.ops import _build
    from distributed_inference_demo_tpu_torch.ops import flash_attention as fa
    from distributed_inference_demo_tpu_torch.ops import \
        paged_attention as pa
    from distributed_inference_demo_tpu_torch.ops import quant_dense as qd

    t0 = time.perf_counter()
    sources = (fa.SOURCE, pa.SOURCE, qd.SOURCE)
    # one nvcc per source, all started together
    with ThreadPoolExecutor(len(sources)) as pool:
        list(pool.map(_build.build, sources))
    fa._kernel_fn()
    pa._kernel_fns()
    qd._kernel_fn()
    build_s = time.perf_counter() - t0
    ptxas = {src: ptxas_report(_build.build_logs.get(src, ""))
             for src in sources}
    return {"phase": "device", "nvidia_smi": smi,
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
            "torch": torch.__version__, "cuda": torch.version.cuda,
            "build_s": build_s, "ptxas": ptxas}


# ---------------------------------------------------------------------------
# phase 2: kernel vs plain
# ---------------------------------------------------------------------------

def model_heads(name: str):
    """(nh, nkv, hd, alibi) of a catalog model."""
    from distributed_inference_demo_tpu_torch.models.registry import \
        get_model_config
    cfg = get_model_config(name)
    return cfg.num_heads, cfg.num_kv_heads, cfg.head_dim, cfg.use_alibi


def kernel_cases():
    """(label, b, chunk, q_start, nh, nkv, hd, alibi) at the main path's
    shapes: TinyLlama heads over a 2048 cache, plus one ALiBi case with
    bloom-560m's heads and one hd=128 case with llama-3-8b's; the longest
    plain-serve prompt (2048 tokens at 0); ragged rows (bloom-560m, g = 1,
    37 tokens at 7, ALiBi); 256 and 257 tokens at 0, whose 2048 and 2056
    TinyLlama rows sit either side of the instance threshold (32 and 33
    64-row blocks per kv head, 128 and 132 in all); the serve prefill
    (64 tokens at 0) of each HEAD_DIM_MODELS model, at hd 256, 80, 96;
    the moe phase's (mixtral-tpu-1b at 64 and 2048 tokens, mixtral-8x7b
    at 64); and the kvcache phase's warm prefill (64 tokens at
    KV_PREFIX)."""
    cases = []
    for b in (1, 4):
        for chunk in (16, 64, 512):
            for q_start in (0, 100):
                cases.append(("tinyllama", b, chunk, q_start, 32, 4, 64,
                              False))
    cases.append(("bloom560m-alibi", 1, 64, 100, 16, 16, 64, True))
    cases.append(("llama3-8b-hd128", 1, 64, 100, 32, 8, 128, False))
    # the kvcache phase's warm prefill: the 64-token suffix after a seeded
    # KV_PREFIX-token prefix
    cases.append(("tinyllama-prefix-hit", 1, PREFILL_CHUNK, KV_PREFIX, 32, 4,
                  64, False))
    cases.append(("tinyllama-long", 1, MAX_SEQ, 0, 32, 4, 64, False))
    # the server phase's bench: 8 rows of a PROMPT_LEN-token prompt
    cases.append(("tinyllama-bench", 8, PROMPT_LEN, 0, 32, 4, 64, False))
    # the vision phase's multimodal prefix: 576 patches + the text, one
    # prefill at 0
    cases.append(("tinyllama-vision", 1, VISION_PREFIX, 0, 32, 4, 64,
                  False))
    cases.append(("bloom560m-ragged", 1, 37, 7, 16, 16, 64, True))
    for chunk in (256, 257):
        cases.append(("tinyllama-threshold", 1, chunk, 0, 32, 4, 64, False))
    for name in HEAD_DIM_MODELS:
        cases.append((name, 1, PROMPT_LEN, 0, *model_heads(name)))
    # the moe phase's prefills: mixtral-tpu-1b (g = 4, hd 64) at the serve
    # prompt and the long one's 2048-token bound, mixtral-8x7b (hd 128)
    # at the serve prompt
    cases += [(MOE_MODEL, 1, PROMPT_LEN, 0, *model_heads(MOE_MODEL)),
              (MOE_MODEL + "-long", 1, MAX_SEQ, 0, *model_heads(MOE_MODEL)),
              ("mixtral-8x7b", 1, PROMPT_LEN, 0,
               *model_heads("mixtral-8x7b"))]
    # the parallel phase: one tp=2 rank of llama-3-8b (16 q heads on 4 kv
    # heads) at its generate prompt
    nh, nkv, hd, alibi = model_heads(LARGE_MODEL)
    cases.append((LARGE_MODEL + "-tp2", 1, PROMPT_LEN, 0, nh // PAR_TP,
                  nkv // PAR_TP, hd, alibi))
    return cases


def flash_work(b, chunk, q_start, nh, nkv, hd, elt):
    """(flops, bytes) the function needs on these inputs: every query
    attends q_start + i + 1 keys (QK and PV, 2 flops each per multiply-
    add); q and out once, the live K/V prefix once."""
    kv_len = q_start + chunk
    keys = chunk * q_start + chunk * (chunk + 1) // 2
    flops = 4 * b * nh * hd * keys
    nbytes = elt * (2 * b * chunk * nh * hd + 2 * b * nkv * kv_len * hd)
    return flops, nbytes


def phase_kernels(torch) -> dict:
    import torch.nn.functional as F
    from torch.nn.attention.bias import causal_lower_right

    from distributed_inference_demo_tpu_torch.ops import flash_attention as fa
    from distributed_inference_demo_tpu_torch.ops.attention import \
        alibi_slopes
    from distributed_inference_demo_tpu_torch.ops.flash_attention import (
        flash_attention, flash_attention_plain)

    dev = torch.device("cuda")
    sm_count = torch.cuda.get_device_properties(dev).multi_processor_count
    gen = torch.Generator(device=dev).manual_seed(0)
    results, failures = [], []
    for label, b, chunk, q_start, nh, nkv, hd, alibi in kernel_cases():
        for dtype in (torch.float32, torch.bfloat16):
            dname = str(dtype).split(".")[1]
            q = torch.randn((b, chunk, nh, hd), generator=gen, device=dev
                            ).to(dtype)
            kc = torch.randn((b, nkv, MAX_SEQ, hd), generator=gen,
                             device=dev).to(dtype)
            vc = torch.randn((b, nkv, MAX_SEQ, hd), generator=gen,
                             device=dev).to(dtype)
            slopes = alibi_slopes(nh, device=dev) if alibi else None
            kv_len = q_start + chunk

            def kern():
                return flash_attention(q, kc, vc, q_start, kv_len, slopes)

            def plain():
                return flash_attention_plain(q, kc, vc, q_start, kv_len,
                                             slopes)

            wide = flash_attention.wide_launches
            got, want = kern(), plain()
            torch.cuda.synchronize()
            err = (got.float() - want.float()).abs()
            atol, rtol = TOL[dname]
            ok = bool(torch.isfinite(got.float()).all()) and bool(
                (err <= atol + rtol * want.float().abs()).all())
            # the bf16 instance the wrapper took, by its count, against the
            # rule (f32 has one instance)
            g = nh // nkv
            rule = fa.flash_rows_per_block(b, nkv, chunk * g, sm_count)
            rows_per_block, other = None, {}
            if dtype == torch.bfloat16:
                rows_per_block = (64 if flash_attention.wide_launches > wide
                                  else 16)
                ok = ok and rows_per_block == rule
                # the instance the rule did not pick, checked and timed
                # on the same inputs: the evidence for the threshold
                o_rows = 16 if rows_per_block == 64 else 64

                def kern_other():
                    return fa._launch(q, kc, vc, q_start, kv_len, slopes,
                                      o_rows)

                o_err = (kern_other().float() - want.float()).abs()
                o_ok = bool(torch.isfinite(o_err).all()) and bool(
                    (o_err <= atol + rtol * want.float().abs()).all())
                ok = ok and o_ok
                other = {"other_rows_per_block": o_rows,
                         "other_max_abs_err": float(o_err.max()),
                         "other_ms": device_ms(torch, kern_other)}

            # yardstick: SDPA on the live prefix, K/V expanded to nh heads
            # beforehand (outside the timed call).  Without ALiBi the mask
            # is SDPA's own causal one aligned to the last key (plain
            # is_causal where q_start is 0), so it may take its flash
            # backend and skip the tiles past the diagonal; with ALiBi
            # the bias is a tensor, built beforehand too.
            qt = q.transpose(1, 2).contiguous()
            kt = kc[:, :, :kv_len].repeat_interleave(g, dim=1)
            vt = vc[:, :, :kv_len].repeat_interleave(g, dim=1)
            if slopes is None:
                mask = causal_lower_right(chunk, kv_len)
            else:
                qpos = q_start + torch.arange(chunk, device=dev)
                kpos = torch.arange(kv_len, device=dev)
                dist = (qpos[:, None] - kpos[None, :]).float()
                mask = (torch.where(dist >= 0, 0.0, float("-inf"))[None]
                        - slopes[:, None, None] * dist[None])[None].to(dtype)

            def sdpa():
                return F.scaled_dot_product_attention(qt, kt, vt,
                                                      attn_mask=mask)

            lib_err = float((sdpa().transpose(1, 2).float()
                             - want.float()).abs().max())
            flops, nbytes = flash_work(b, chunk, q_start, nh, nkv, hd,
                                       q.element_size())
            t_ops = flops / PEAK_FLOPS[dname]
            t_bytes = nbytes / PEAK_BYTES
            row = {"case": label, "dtype": dname, "b": b, "chunk": chunk,
                   "q_start": q_start, "nh": nh, "nkv": nkv, "hd": hd,
                   "rows_per_block": rows_per_block,
                   "max_abs_err": float(err.max()), "tol": [atol, rtol],
                   "ok": ok,
                   "ms": device_ms(torch, kern), **other,
                   "plain_ms": device_ms(torch, plain),
                   "library_ms": device_ms(torch, sdpa),
                   "library_mask": "causal" if slopes is None
                   else "alibi bias",
                   "eager_ms": eager_ms(torch, kern),
                   "plain_eager_ms": eager_ms(torch, plain),
                   "library_max_abs_err": lib_err,
                   "bound_ms": max(t_ops, t_bytes) * 1e3,
                   "bound_by": "operations" if t_ops >= t_bytes
                   else "bytes", "flops": flops, "bytes": nbytes}
            results.append(row)
            if not ok:
                failures.append(f"{label} {dname} b={b} chunk={chunk} "
                                f"q_start={q_start}: max err "
                                f"{row['max_abs_err']}, rows_per_block "
                                f"{rows_per_block} (rule {rule}), "
                                f"other instance {other}")
            del q, kc, vc, kt, vt
    return {"phase": "kernels", "cases": results, "failures": failures}


def paged_cases():
    """(label, kind, nh, nkv, hd, alibi, per-row lens or (chunk, starts),
    pages), at pages of BLOCK_TOKENS tokens, "full" width (q's dtype) or
    "int8": TinyLlama heads for decode at b=1 and b=8 (ragged lengths: 1,
    a page boundary, mid-page, ~2000; two freed slots with all-sentinel
    tables and stale lengths) and for prefill chunks of 16/32/64 tokens
    at start 0, mid-page and several pages in; one ALiBi case with
    bloom-560m heads and one hd-128 case with llama-3-8b heads for each
    kernel; the same shapes' int8 instances; the mixed slab (4 rows of
    64 tokens at distinct starts, one unused) on both page types; decode
    rows one key either side of the bf16 kernel's split boundaries and
    two splits plus 9 on both page types; a 128-token chunk (1024 rows,
    above the reference's 512-row cap, which the card's routing does not
    keep: the serialized admission's finals padded to 128 tokens); and
    each HEAD_DIM_MODELS model's heads (hd 256, 80, 96) at the 8-slot
    decode and the 64-token chunk at 200 on both page types, and
    gemma-2b's at the mixed slab over int8 pages; mixtral-tpu-1b's heads
    (g = 4) at the 8-slot decode and the 64-token chunk at 200 on
    full-width pages; and float8 e4m3 pages ("fp8", the e4m3 instances) at
    TinyLlama's decode rows, 64-token chunk at 200, mixed slab and split
    boundaries, and gemma-2b's decode rows and chunk."""
    from distributed_inference_demo_tpu_torch.ops.paged_attention import \
        KV_SPLIT
    serve = (1, 16, 37, 1999, 512, 130, -300, -5)   # negative: freed slot
    splits = (KV_SPLIT - 1, KV_SPLIT, KV_SPLIT + 1, 2 * KV_SPLIT + 9)
    cases = [("tinyllama", "decode", 32, 4, 64, False, (1000,)),
             ("tinyllama", "decode", 32, 4, 64, False, serve)]
    for chunk in (16, 32, 64):
        for start in (0, 7, 200):
            cases.append(("tinyllama", "prefill", 32, 4, 64, False,
                          (chunk, (start,))))
    cases += [("bloom560m-alibi", "decode", 16, 16, 64, True, serve),
              ("bloom560m-alibi", "prefill", 16, 16, 64, True,
               (32, (7,))),
              ("llama3-8b-hd128", "decode", 32, 8, 128, False, serve),
              ("llama3-8b-hd128", "prefill", 32, 8, 128, False,
               (32, (200,))),
              ("tinyllama-splits", "decode", 32, 4, 64, False, splits),
              ("tinyllama-1024rows", "prefill", 32, 4, 64, False,
               (2 * PREFILL_CHUNK, (200,)))]
    cases = [c + ("full",) for c in cases]
    int8 = [("tinyllama", "decode", 32, 4, 64, False, (1000,)),
            ("tinyllama", "decode", 32, 4, 64, False, serve),
            ("tinyllama", "prefill", 32, 4, 64, False, (16, (0,))),
            ("tinyllama", "prefill", 32, 4, 64, False, (64, (200,))),
            ("bloom560m-alibi", "decode", 16, 16, 64, True, serve),
            ("bloom560m-alibi", "prefill", 16, 16, 64, True, (32, (7,))),
            ("llama3-8b-hd128", "decode", 32, 8, 128, False, serve),
            ("llama3-8b-hd128", "prefill", 32, 8, 128, False,
             (32, (200,))),
            ("tinyllama-splits", "decode", 32, 4, 64, False, splits)]
    cases += [c + ("int8",) for c in int8]
    for pages in ("full", "int8"):
        cases.append(("tinyllama-slab", "prefill", 32, 4, 64, False,
                      (PREFILL_CHUNK, SLAB_STARTS), pages))
    for name in HEAD_DIM_MODELS:
        heads = model_heads(name)
        for pages in ("full", "int8"):
            cases += [(name, "decode", *heads, serve, pages),
                      (name, "prefill", *heads, (PREFILL_CHUNK, (200,)),
                       pages)]
    cases.append(("gemma-2b-slab", "prefill", *model_heads("gemma-2b"),
                  (PREFILL_CHUNK, SLAB_STARTS), "int8"))
    # the e4m3 instances (the kvcache phase's float8 pool): TinyLlama's
    # decode rows, its 64-token chunk at 200, the mixed slab and the split
    # boundaries, and gemma-2b's heads (hd 256)
    gemma = model_heads("gemma-2b")
    fp8 = [("tinyllama", "decode", 32, 4, 64, False, serve),
           ("tinyllama", "prefill", 32, 4, 64, False,
            (PREFILL_CHUNK, (200,))),
           ("tinyllama-slab", "prefill", 32, 4, 64, False,
            (PREFILL_CHUNK, SLAB_STARTS)),
           ("tinyllama-splits", "decode", 32, 4, 64, False, splits),
           ("gemma-2b", "decode", *gemma, serve),
           ("gemma-2b", "prefill", *gemma, (PREFILL_CHUNK, (200,)))]
    cases += [c + ("fp8",) for c in fp8]
    # the moe phase's 8-slot batching (full-width pages, g = 4)
    cases += [(MOE_MODEL, "decode", *model_heads(MOE_MODEL), serve, "full"),
              (MOE_MODEL, "prefill", *model_heads(MOE_MODEL),
               (PREFILL_CHUNK, (200,)), "full")]
    # the speculative phase: the [8, K+1] verify on every page type, and
    # the draft's decode rows (g = 4, hd 64, as MOE_MODEL's) on int8
    # pages, the mixed speculative dispatch's draft pool
    cases += [("tinyllama-verify", "prefill", 32, 4, 64, False,
               (SPEC_K + 1, VERIFY_STARTS), pages)
              for pages in ("full", "int8", "fp8")]
    cases.append((SPEC_DRAFT, "decode", *model_heads(SPEC_DRAFT), serve,
                  "int8"))
    # the parallel phase: one tp=2 rank of TinyLlama (16 q heads on 2 kv
    # heads) at the 8-slot decode and the 64-token chunk at 200
    nh, nkv, hd, alibi = model_heads(SERVE_MODEL)
    tp2 = (SERVE_MODEL + "-tp2", nh // PAR_TP, nkv // PAR_TP, hd, alibi)
    cases += [(tp2[0], "decode", *tp2[1:], serve, "full"),
              (tp2[0], "prefill", *tp2[1:], (PREFILL_CHUNK, (200,)),
               "full")]
    # the chain phase's stage shapes (every stage holds all of TinyLlama's
    # heads): one row's one-token hop at the longest request's last
    # length, and the longest prompt's whole chunk at 0
    longest = max(CHAIN_PROMPTS)
    cases += [(SERVE_MODEL + "-chain", "decode", nh, nkv, hd, alibi,
               (longest + CHAIN_NEW - 1,), "full"),
              (SERVE_MODEL + "-chain", "prefill", nh, nkv, hd, alibi,
               (longest, (0,)), "full")]
    # the vision phase's ring stages: the multimodal prefix's chunk at 0,
    # and one token at its last length
    cases += [(SERVE_MODEL + "-vision", "decode", nh, nkv, hd, alibi,
               (VISION_PREFIX + VISION_NEW - 1,), "full"),
              (SERVE_MODEL + "-vision", "prefill", nh, nkv, hd, alibi,
               (VISION_PREFIX, (0,)), "full")]
    return cases


def _paged_inputs(torch, gen, dev, dtype, lens, nkv, hd, W, pages="full"):
    """A pool holding exactly the live pages of ``lens`` (a negative
    length: a freed slot, all-sentinel table) under shuffled ids, plus a
    few spare pages; tables [b, W] int32 with sentinels N and N + 7.
    ``pages`` "int8": int8 pages quantized from the same random draw;
    "fp8": float8 e4m3 pages cast from it (``cast_kv``)."""
    bt = BLOCK_TOKENS
    need = [-(-l // bt) if l > 0 else 0 for l in lens]
    N = sum(need) + 5
    perm = torch.randperm(N, generator=torch.Generator().manual_seed(N))
    tables = torch.full((len(lens), W), N, dtype=torch.int32)
    nxt = 0
    for i, n in enumerate(need):
        tables[i, :n] = perm[nxt:nxt + n].to(torch.int32)
        tables[i, n + 1:] = N + 7
        nxt += n
    pk = torch.randn((N, nkv, bt, hd), generator=gen, device=dev)
    pv = torch.randn((N, nkv, bt, hd), generator=gen, device=dev)
    if pages == "int8":
        from distributed_inference_demo_tpu_torch.ops.quant import \
            quantize_kv_pages
        return (quantize_kv_pages(pk, 8), quantize_kv_pages(pv, 8),
                tables.to(dev))
    if pages == "fp8":
        from distributed_inference_demo_tpu_torch.ops.quant import (
            FLOAT8, cast_kv)
        return cast_kv(pk, FLOAT8), cast_kv(pv, FLOAT8), tables.to(dev)
    return pk.to(dtype), pv.to(dtype), tables.to(dev)


def paged_work(kind, nh, nkv, hd, elt, lens, chunk=1, pages="full"):
    """(flops, bytes) on these inputs: per query, its keys (QK and PV, 2
    flops per multiply-add each); q and out once (``elt`` bytes an
    element), each row's live K/V once: ``elt * hd`` bytes per (token, kv
    head) and tensor for full-width pages, ``hd + 4`` (codes and the f32
    scale) for int8 pages, ``hd`` for float8 pages.  Decode ``lens`` as in
    :func:`paged_cases`: a
    freed slot (negative length) computes over its stale length, but
    every key of its all-sentinel table clamps to one page, so it moves
    at most one page of K/V per kv head.  Prefill ``lens`` are the rows'
    starts; an unused slab row (None) computes its chunk from 0 over one
    clamped page."""
    if kind == "decode":
        keys = sum(abs(l) for l in lens)
        kv = sum(l if l > 0 else min(-l, BLOCK_TOKENS) for l in lens)
        nq = len(lens)
    else:
        starts = [s or 0 for s in lens]
        keys = sum(chunk * s + chunk * (chunk + 1) // 2 for s in starts)
        kv = sum(s + chunk if s is not None else min(chunk, BLOCK_TOKENS)
                 for s in lens)
        nq = len(lens) * chunk
    kv_elt = {"int8": hd + 4, "fp8": hd}.get(pages, elt * hd)
    return (4 * nh * hd * keys,
            elt * 2 * nq * nh * hd + 2 * nkv * kv_elt * kv)


def phase_paged_kernels(torch) -> dict:
    import torch.nn.functional as F

    from distributed_inference_demo_tpu_torch.ops import \
        paged_attention as pa
    from distributed_inference_demo_tpu_torch.ops.attention import \
        alibi_slopes

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    W = MAX_SEQ // BLOCK_TOKENS
    results, failures, invariance = [], [], []
    for label, kind, nh, nkv, hd, alibi, shape, pages in paged_cases():
        for dtype in (torch.float32, torch.bfloat16):
            dname = str(dtype).split(".")[1]
            if kind == "decode":
                lens = [abs(x) for x in shape]
                live = list(shape)
                chunk, b = 1, len(lens)
            else:
                # an unused slab row (None): start 0, all-sentinel table
                chunk, row_starts = shape
                starts = [s or 0 for s in row_starts]
                lens = [s + chunk for s in starts]
                live = [s + chunk if s is not None else -1
                        for s in row_starts]
                b = len(starts)
            pk, pv, tables = _paged_inputs(torch, gen, dev, dtype, live,
                                           nkv, hd, W, pages)
            q = torch.randn((b, chunk, nh, hd), generator=gen, device=dev
                            ).to(dtype)
            slopes = alibi_slopes(nh, device=dev) if alibi else None
            if kind == "decode":
                per_row = torch.tensor(lens, dtype=torch.int32, device=dev)
                kern_fn, plain_fn = (pa.paged_flash_attention,
                                     pa.paged_flash_attention_plain)
                qpos = per_row.long()[:, None] - 1
            else:
                per_row = torch.tensor(starts, dtype=torch.int32,
                                       device=dev)[:, None]
                kern_fn, plain_fn = (pa.paged_prefill_attention,
                                     pa.paged_prefill_attention_plain)
                qpos = per_row.long() + torch.arange(chunk, device=dev)

            def kern():
                return kern_fn(q, pk, pv, tables, per_row, slopes)

            def plain():
                return plain_fn(q, pk, pv, tables, per_row, slopes)

            got, want = kern(), plain()
            torch.cuda.synchronize()
            err = (got.float() - want.float()).abs()
            atol, rtol = TOL[dname]
            ok = bool(torch.isfinite(got.float()).all()) and bool(
                (err <= atol + rtol * want.float().abs()).all())

            # yardstick: SDPA over the pages gathered beforehand into a
            # linear view, K/V expanded to nh heads, the causal (and
            # ALiBi) mask built outside the timed call
            S = max(lens)
            g = nh // nkv
            # (int8 pages: gathered, then dequantized, beforehand; float8
            # pages gathered, then upcast)
            kt = pa._linear_view(pk, tables)[:, :, :S].to(
                dtype).repeat_interleave(g, dim=1)
            vt = pa._linear_view(pv, tables)[:, :, :S].to(
                dtype).repeat_interleave(g, dim=1)
            qt = q.transpose(1, 2).contiguous()
            dist = (qpos[:, :, None]
                    - torch.arange(S, device=dev)).float()   # [b, c, S]
            mask = torch.where(dist >= 0, 0.0, float("-inf"))[:, None]
            if slopes is not None:
                mask = mask - slopes[None, :, None, None] * dist[:, None]
            mask = mask.to(dtype)

            def sdpa():
                return F.scaled_dot_product_attention(qt, kt, vt,
                                                      attn_mask=mask)

            lib_err = float((sdpa().transpose(1, 2).float()
                             - want.float()).abs().max())
            flops, nbytes = paged_work(kind, nh, nkv, hd, q.element_size(),
                                       shape if kind == "decode"
                                       else row_starts, chunk, pages)
            t_ops = flops / PEAK_FLOPS[dname]
            t_bytes = nbytes / PEAK_BYTES
            row = {"case": label, "kind": kind, "dtype": dname,
                   "pages": pages, "b": b,
                   "chunk": chunk, "lens": list(shape) if kind == "decode"
                   else None, "starts": None if kind == "decode"
                   else list(row_starts), "nh": nh, "nkv": nkv, "hd": hd,
                   "block_tokens": BLOCK_TOKENS,
                   "max_abs_err": float(err.max()), "tol": [atol, rtol],
                   "ok": ok,
                   "ms": device_ms(torch, kern),
                   "plain_ms": device_ms(torch, plain),
                   "library_ms": device_ms(torch, sdpa),
                   "eager_ms": eager_ms(torch, kern),
                   "plain_eager_ms": eager_ms(torch, plain),
                   "library_max_abs_err": lib_err,
                   "bound_ms": max(t_ops, t_bytes) * 1e3,
                   "bound_by": "operations" if t_ops >= t_bytes
                   else "bytes", "flops": flops, "bytes": nbytes}
            results.append(row)
            if not ok:
                failures.append(f"{label} {kind} {dname} {pages} {shape}: "
                                f"max err {row['max_abs_err']}")
            if dname == "bfloat16" and label in (
                    "tinyllama", "gemma-2b", "bloom3b") and \
                    kind == "decode" and b == SLOTS:
                invariance.append(batch_invariance(
                    torch, kern_fn, label, q, pk, pv, tables, per_row,
                    slopes, got, pages))
            del q, pk, pv, kt, vt
    for inv in invariance:
        if inv["rows_bit_equal"] != inv["rows"]:
            failures.append(f"batch invariance, {inv['case']}, "
                            f"{inv['pages']} pages: "
                            f"{inv['rows_bit_equal']} of {inv['rows']} rows "
                            "bit-equal")
    return {"phase": "paged_kernels", "cases": results,
            "batch_invariance": invariance, "failures": failures}


def batch_invariance(torch, kern_fn, label, q, pk, pv, tables, per_row,
                     slopes, got, pages) -> dict:
    """Each row of the 8-slot decode launch against the same row launched
    alone: bit-equal, since the kernel's splits sit at fixed positions."""
    same = 0
    for i in range(q.shape[0]):
        one = kern_fn(q[i:i + 1], pk, pv, tables[i:i + 1], per_row[i:i + 1],
                      slopes)
        same += bool(torch.equal(one, got[i:i + 1]))
    return {"case": label, "pages": pages,
            "dtype": str(q.dtype).split(".")[1],
            "rows": q.shape[0], "rows_bit_equal": same}


# ---------------------------------------------------------------------------
# phase 3: the main path
# ---------------------------------------------------------------------------

def _post(port: int, body: dict):
    return _post_path(port, "/generate", body)


def _post_path(port: int, path: str, body: dict):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}", data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=600) as resp:
        return resp.status, resp.read().decode()


def _post_status(port: int, body: dict):
    """``POST /generate`` that returns an error status instead of raising
    it: (status, body text)."""
    try:
        return _post(port, body)
    except urllib.error.HTTPError as e:
        return e.code, e.read().decode()


def _get(port: int, path: str):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                timeout=60) as resp:
        return resp.status, json.loads(resp.read().decode())


def _check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


class moe_routing:
    """Within the block, every MoE routing decision
    (``models.decoder.moe_route``) in call order: recorded into ``log``
    (the experts each token chose, and the gap between its k-th and
    (k+1)-th router logit), or with ``replay`` taken from ``log`` (a
    softmax over this call's own logits at the recorded experts), so
    that two paths compare at the same expert choices."""

    def __init__(self, log: list, replay: bool = False):
        self.log, self.replay = log, replay

    def __enter__(self):
        import torch

        from distributed_inference_demo_tpu_torch.models import decoder
        self.decoder, self.real = decoder, decoder.moe_route
        calls = iter(list(self.log))

        def route(logits, k):
            # an engine's first call may capture its decode step: the
            # graph takes the real routing, and the log skips it
            if logits.is_cuda and torch.cuda.is_current_stream_capturing():
                return self.real(logits, k)
            if self.replay:
                topi = next(calls)["topi"]
                w = torch.softmax(torch.gather(logits, -1, topi), dim=-1)
                return torch.zeros_like(logits).scatter(-1, topi, w)
            v, i = torch.sort(logits, dim=-1, descending=True, stable=True)
            self.log.append({"topi": i[..., :k],
                             "gap": v[..., k - 1] - v[..., k]})
            return self.real(logits, k)

        decoder.moe_route = route
        return self

    def __exit__(self, *exc):
        self.decoder.moe_route = self.real


def moe_pinned(cfg, run_ref, run_test):
    """(reference logits, test logits, routing report) of two paths over
    the same tokens.  For a model with experts, the test runs twice:
    with its own routing (reported: how many of the reference's routing
    decisions it flipped, the reference's router-logit gap at the top-k
    boundary at the first call that flips, its logit gap) and with the
    reference's expert choices pinned, the logits the caller holds to
    its tolerance.  A top-k choice is discontinuous: where two router
    logits nearly tie, the two paths' rounding picks different experts
    and the token's MLP output jumps, which no logit tolerance bounds.
    Without experts: one run each, no report."""
    import numpy as np

    if not cfg.num_experts:
        return run_ref(), run_test(), None
    # an engine's first forward may capture its decode step after an
    # eager warm-up step, whose routing is no part of the comparison
    run_ref()
    run_test()
    ref_log, own_log = [], []
    with moe_routing(ref_log):
        lr = run_ref()
    with moe_routing(own_log):
        own = run_test()
    with moe_routing(ref_log, replay=True):
        lt = run_test()
    flips, first = 0, None
    for i, (a, b) in enumerate(zip(ref_log, own_log)):
        d = (a["topi"].sort(-1).values != b["topi"].sort(-1).values).any(-1)
        flips += int(d.sum())
        if first is None and bool(d.any()):
            # the first call that flips: no earlier flip fed its inputs,
            # so only rounding parted the two paths' router logits
            first = {"call": i, "flips": int(d.sum()),
                     "max_router_gap": float(a["gap"][d].max())}
    return lr, lt, {
        "routing_decisions": sum(int(x["gap"].numel()) for x in ref_log),
        "routing_flips": flips, "first_flip": first,
        "unpinned_logit_max_abs_err": float(np.abs(own - lr).max()),
        "unpinned_argmax_agreement": int((own.argmax(-1)
                                          == lr.argmax(-1)).sum()),
        "held": "logits with the reference path's expert choices"}


def phase_serve(torch) -> dict:
    import numpy as np

    from distributed_inference_demo_tpu_torch.models.decoder import \
        init_full_params
    from distributed_inference_demo_tpu_torch.models.registry import \
        get_model_config
    from distributed_inference_demo_tpu_torch.ops.flash_attention import (
        flash_attention, flash_rows_per_block)
    from distributed_inference_demo_tpu_torch.ops.sampling import \
        SamplingParams
    from distributed_inference_demo_tpu_torch.runtime.engine import \
        InferenceEngine
    from distributed_inference_demo_tpu_torch.runtime.http_server import \
        InferenceHTTPServer

    cfg = get_model_config(SERVE_MODEL)
    L = cfg.num_layers
    t0 = time.perf_counter()
    params = init_full_params(
        torch.Generator(device="cuda").manual_seed(0), cfg, "cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    greedy = InferenceEngine(cfg, params, max_seq=MAX_SEQ,
                             sampling=SamplingParams(greedy=True),
                             attn_backend="auto", device="cuda")
    sampled = InferenceEngine(cfg, params, max_seq=MAX_SEQ,
                              attn_backend="auto", device="cuda")
    _check(greedy.attn_backend == "flash" == sampled.attn_backend,
           f"auto backend resolved to {greedy.attn_backend}")
    prompt = np.random.RandomState(1).randint(
        0, cfg.vocab_size, (1, PROMPT_LEN)).tolist()
    long_prompt = np.random.RandomState(3).randint(
        0, cfg.vocab_size, (1, LONG_PROMPT_LEN)).tolist()
    sm_count = torch.cuda.get_device_properties(0).multi_processor_count
    g = cfg.num_heads // cfg.num_kv_heads
    servers = [InferenceHTTPServer(e, "127.0.0.1", 0, model_name=SERVE_MODEL,
                                   default_max_new=NEW_TOKENS)
               for e in (greedy, sampled)]
    for s in servers:
        s.start()
    out = {"phase": "serve", "device": torch.cuda.get_device_name(0),
           "model": SERVE_MODEL, "layers": L,
           "params_bytes": params.nbytes(), "init_s": init_s}
    try:
        gport, sport = servers[0].port, servers[1].port
        torch.cuda.reset_peak_memory_stats()
        # ---- the main path: counts from zero, three requests ----
        flash_attention.launches = flash_attention.wide_launches = 0
        t0 = time.perf_counter()
        code, body = _post(gport, {"prompt_ids": prompt,
                                   "max_new_tokens": NEW_TOKENS})
        out["greedy_request_s"] = time.perf_counter() - t0
        _check(code == 200, f"greedy request: HTTP {code}")
        toks = json.loads(body)["tokens"]
        _check(np.asarray(toks).shape == (1, NEW_TOKENS),
               f"greedy tokens shape {np.asarray(toks).shape}")
        _check(flash_attention.launches == L,
               f"greedy prefill launched {flash_attention.launches}, "
               f"expected {L}")
        code, body = _post(gport, {"prompt_ids": prompt,
                                   "max_new_tokens": NEW_TOKENS,
                                   "stream": True})
        _check(code == 200, f"stream request: HTTP {code}")
        lines = [json.loads(ln) for ln in body.splitlines() if ln.strip()]
        _check([ln["step"] for ln in lines] == list(range(NEW_TOKENS)),
               "stream steps")
        stream_toks = [ln["tokens"][0] for ln in lines]
        _check(stream_toks == toks[0], "streamed greedy tokens differ "
               "from the blocking request's")
        _check(flash_attention.launches == 2 * L, "stream prefill launches")
        code, body = _post(sport, {"prompt_ids": prompt,
                                   "max_new_tokens": NEW_TOKENS, "seed": 7,
                                   "logprobs": True})
        _check(code == 200, f"sampled request: HTTP {code}")
        res = json.loads(body)
        lps = np.asarray(res["logprobs"])
        _check(np.asarray(res["tokens"]).shape == (1, NEW_TOKENS)
               and lps.shape == (1, NEW_TOKENS), "sampled shapes")
        _check(bool(np.isfinite(lps).all() and (lps <= 0).all()),
               "sampled logprobs not finite and <= 0")
        launches = flash_attention.launches
        _check(launches == 3 * L, f"{launches} launches, expected {3 * L}")
        # the 64-token prefill's instance: 16 rows a block on the H100
        wide = 3 * L if flash_rows_per_block(
            1, cfg.num_kv_heads, PROMPT_LEN * g, sm_count) == 64 else 0
        _check(flash_attention.wide_launches == wide,
               f"{flash_attention.wide_launches} 64-row launches, "
               f"expected {wide}")
        out.update(launches=launches,
                   wide_launches=flash_attention.wide_launches,
                   greedy_tokens=toks[0],
                   sampled_tokens=res["tokens"][0],
                   peak_mem_bytes=torch.cuda.max_memory_allocated())
        code, health = _get(gport, "/health")
        _check(code == 200 and health["device"]
               == torch.cuda.get_device_name(0), f"/health {health}")
    finally:
        for s in servers:
            s.shutdown()

    # ---- against an engine on plain attention, same weights ----
    plain = InferenceEngine(cfg, params, max_seq=MAX_SEQ,
                            sampling=SamplingParams(greedy=True),
                            attn_backend="plain", device="cuda")
    lk = greedy.prefill_logits(prompt)
    lp = plain.prefill_logits(prompt)
    scale = max(1.0, float(np.abs(lp).max()))
    logit_err = float(np.abs(lk - lp).max())
    plain_toks = plain.generate(prompt, NEW_TOKENS).tokens[0].tolist()
    agree = sum(a == b for a, b in zip(plain_toks, toks[0]))
    lead = next((i for i, (a, b) in enumerate(zip(plain_toks, toks[0]))
                 if a != b), NEW_TOKENS)
    out.update(logit_max_abs_err=logit_err, logit_scale=scale,
               logit_tol=LOGIT_TOL_REL * scale,
               greedy_agreement=agree / NEW_TOKENS,
               greedy_leading_agreement=lead)
    _check(bool(np.isfinite(lk).all()), "kernel-engine logits not finite")
    _check(logit_err <= LOGIT_TOL_REL * scale,
           f"prefill logits differ by {logit_err} (> {LOGIT_TOL_REL} x "
           f"{scale})")

    # ---- the long prompt: one whole-prompt prefill, counts from zero;
    # every layer launches the 64-row instance; logits against plain ----
    out.update(long_prefill_check(torch, greedy, plain, long_prompt))
    _check(out["long_wide_launches"] == L, "the long prefill took the "
           "16-row instance")
    # wall time of one warm prefill each, host clock (the logits come
    # back to the host, which waits for the card)
    for name, p in (("prefill_s", prompt), ("long_prefill_s", long_prompt)):
        t0 = time.perf_counter()
        greedy.prefill_logits(p)
        out[name] = time.perf_counter() - t0

    # ---- the same check in f32 (same seed), where the kernel and the
    # plain path should agree to f32 rounding, not bf16's ----
    del plain
    cfg32 = cfg.replace(dtype_name="float32")
    p32 = init_full_params(
        torch.Generator(device="cuda").manual_seed(0), cfg32, "cuda")
    k32 = InferenceEngine(cfg32, p32, max_seq=MAX_SEQ,
                          sampling=SamplingParams(greedy=True),
                          attn_backend="auto", device="cuda")
    q32 = InferenceEngine(cfg32, p32, max_seq=MAX_SEQ,
                          sampling=SamplingParams(greedy=True),
                          attn_backend="plain", device="cuda")
    lk32, lp32 = k32.prefill_logits(prompt), q32.prefill_logits(prompt)
    err32 = float(np.abs(lk32 - lp32).max())
    scale32 = max(1.0, float(np.abs(lp32).max()))
    t_k = k32.generate(prompt, NEW_TOKENS).tokens[0].tolist()
    t_p = q32.generate(prompt, NEW_TOKENS).tokens[0].tolist()
    out.update(f32_logit_max_abs_err=err32, f32_logit_tol=LOGIT_TOL_F32 *
               scale32, f32_greedy_agreement=sum(
                   a == b for a, b in zip(t_k, t_p)) / NEW_TOKENS)
    _check(err32 <= LOGIT_TOL_F32 * scale32,
           f"f32 prefill logits differ by {err32}")
    del k32, q32, p32
    torch.cuda.empty_cache()

    # ---- decode rate: (t(1 + n) - t(1)) / n, b=1, after warm-up ----
    n = 128
    greedy.generate(prompt, 1)
    t_one = greedy.generate(prompt, 1).seconds
    t_many = greedy.generate(prompt, 1 + n).seconds
    ms_tok = (t_many - t_one) / n * 1e3
    out.update(decode_ms_per_token=ms_tok, decode_tok_s=1e3 / ms_tok,
               prefill_plus_one_token_s=t_one)
    # the device idle share comes only from this profile: a run that
    # cannot produce it fails rather than look like one that did
    out["profile"] = profile_generate(torch, greedy, prompt)
    return out


def long_prefill_check(torch, engine, plain, prompt) -> dict:
    """One whole-prompt prefill of the long ``prompt`` through the flash
    engine, counts from zero: every layer launches the kernel once, in
    the instance its rule names; the logits against ``plain``'s (plain
    attention, the same weights) at LOGIT_TOL_REL (an MoE model's with
    the plain engine's expert choices, :func:`moe_pinned`)."""
    import numpy as np

    from distributed_inference_demo_tpu_torch.ops.flash_attention import (
        flash_attention, flash_rows_per_block)

    cfg = engine.cfg
    L, g = cfg.num_layers, cfg.num_heads // cfg.num_kv_heads
    counts = []

    def kernel():
        _reset_launches(flash_attention)
        out = engine.prefill_logits(prompt)
        counts.append((flash_attention.launches,
                       flash_attention.wide_launches))
        return out

    lp, lk, routing = moe_pinned(
        cfg, lambda: plain.prefill_logits(prompt), kernel)
    launches, wide = counts[0]
    scale = max(1.0, float(np.abs(lp).max()))
    err = float(np.abs(lk - lp).max())
    rule = flash_rows_per_block(
        1, cfg.num_kv_heads, len(prompt[0]) * g,
        torch.cuda.get_device_properties(0).multi_processor_count)
    _check(launches == L and wide == (L if rule == 64 else 0),
           f"the long prefill launched {launches}, {wide} of them 64-row, "
           f"expected {L} of the {rule}-row instance")
    _check(bool(np.isfinite(lk).all()), "long-prompt logits not finite")
    _check(err <= LOGIT_TOL_REL * scale,
           f"long-prompt prefill logits differ by {err} (> "
           f"{LOGIT_TOL_REL} x {scale})")
    return {"long_prompt_len": len(prompt[0]), "long_launches": launches,
            "long_wide_launches": wide, "long_rows_per_block": rule,
            "long_logit_max_abs_err": err, "long_logit_scale": scale,
            "long_logit_tol": LOGIT_TOL_REL * scale,
            "long_routing": routing}


def phase_serve_model(torch, name: str, long_prompt: bool = False) -> dict:
    """Plain serve of a HEAD_DIM_MODELS model at full width (random
    weights from seed 0): ``InferenceHTTPServer`` over an
    ``InferenceEngine`` on "auto", which resolves to the flash kernel,
    answers one greedy request (a PROMPT_LEN-token prompt, NEW_TOKENS new
    tokens); the counts show every layer's prefill launched the kernel,
    in the instance its rule names; the prefill logits are held against
    an engine on plain attention (an MoE model's with its expert
    choices, :func:`moe_pinned`; ``long_prompt``: a LONG_PROMPT_LEN-token
    prompt's too, :func:`long_prefill_check`); decode ms/token."""
    import numpy as np

    from distributed_inference_demo_tpu_torch.models.decoder import \
        init_full_params
    from distributed_inference_demo_tpu_torch.models.registry import \
        get_model_config
    from distributed_inference_demo_tpu_torch.ops.flash_attention import (
        flash_attention, flash_rows_per_block)
    from distributed_inference_demo_tpu_torch.ops.sampling import \
        SamplingParams
    from distributed_inference_demo_tpu_torch.runtime.engine import \
        InferenceEngine
    from distributed_inference_demo_tpu_torch.runtime.http_server import \
        InferenceHTTPServer

    cfg = get_model_config(name)
    L, g = cfg.num_layers, cfg.num_heads // cfg.num_kv_heads
    greedy = SamplingParams(greedy=True)
    params = init_full_params(
        torch.Generator(device="cuda").manual_seed(0), cfg, "cuda")
    engine = InferenceEngine(cfg, params, max_seq=MAX_SEQ, sampling=greedy,
                             attn_backend="auto", device="cuda")
    _check(engine.attn_backend == "flash",
           f"{name}: auto backend resolved to {engine.attn_backend}")
    prompt = np.random.RandomState(1).randint(
        0, cfg.vocab_size, (1, PROMPT_LEN)).tolist()
    sm_count = torch.cuda.get_device_properties(0).multi_processor_count
    out = {"phase": "serve_model", "device": torch.cuda.get_device_name(0),
           "model": name, "layers": L, "head_dim": cfg.head_dim,
           "heads": [cfg.num_heads, cfg.num_kv_heads],
           "alibi": cfg.use_alibi, "attn_backend": engine.attn_backend,
           "params_bytes": params.nbytes()}
    server = InferenceHTTPServer(engine, "127.0.0.1", 0, model_name=name,
                                 default_max_new=NEW_TOKENS)
    server.start()
    try:
        # ---- the main path: counts from zero, one request ----
        _reset_launches(flash_attention)
        t0 = time.perf_counter()
        code, body = _post(server.port, {"prompt_ids": prompt,
                                         "max_new_tokens": NEW_TOKENS})
        out["greedy_request_s"] = time.perf_counter() - t0
        _check(code == 200, f"{name} greedy request: HTTP {code}")
        toks = json.loads(body)["tokens"]
        _check(np.asarray(toks).shape == (1, NEW_TOKENS),
               f"{name} greedy tokens shape {np.asarray(toks).shape}")
        launches = flash_attention.launches
        wide = flash_attention.wide_launches
        rule = flash_rows_per_block(1, cfg.num_kv_heads, PROMPT_LEN * g,
                                    sm_count)
        out.update(launches=launches, wide_launches=wide,
                   rows_per_block=rule, greedy_tokens=toks[0])
        _check(launches == L, f"{name}: the prefill launched {launches}, "
               f"expected {L}")
        _check(wide == (L if rule == 64 else 0),
               f"{name}: {wide} 64-row launches, rule {rule}")
    finally:
        server.shutdown()
    plain = InferenceEngine(cfg, params, max_seq=MAX_SEQ, sampling=greedy,
                            attn_backend="plain", device="cuda")
    lp, lk, routing = moe_pinned(cfg, lambda: plain.prefill_logits(prompt),
                                 lambda: engine.prefill_logits(prompt))
    scale = max(1.0, float(np.abs(lp).max()))
    err = float(np.abs(lk - lp).max())
    plain_toks = plain.generate(prompt, NEW_TOKENS).tokens[0].tolist()
    out.update(logit_max_abs_err=err, logit_scale=scale, routing=routing,
               logit_tol=LOGIT_TOL_REL * scale,
               greedy_agreement=sum(a == b for a, b in
                                    zip(plain_toks, toks[0])) / NEW_TOKENS)
    _check(bool(np.isfinite(lk).all()), f"{name}: kernel logits not finite")
    _check(err <= LOGIT_TOL_REL * scale,
           f"{name}: prefill logits differ by {err} (> {LOGIT_TOL_REL} x "
           f"{scale})")
    if long_prompt:
        out.update(long_prefill_check(
            torch, engine, plain, np.random.RandomState(3).randint(
                0, cfg.vocab_size, (1, LONG_PROMPT_LEN)).tolist()))
    # ---- decode rate: (t(1 + n) - t(1)) / n, b=1, after warm-up ----
    n = NEW_TOKENS
    engine.generate(prompt, 1)
    t_one = engine.generate(prompt, 1).seconds
    t_many = engine.generate(prompt, 1 + n).seconds
    out.update(decode_ms_per_token=(t_many - t_one) / n * 1e3,
               prefill_plus_one_token_s=t_one)
    del engine, plain, params
    torch.cuda.empty_cache()
    return out


def _batch_prompts(vocab: int, seed: int = 2):
    """The 8 prompts of the batching phase (seeded): lengths
    BATCH_PROMPTS; the 300- and 600-token prompts share their first
    SHARED_PREFIX tokens, so whichever admits second hits the radix
    tree (both stream their chunks, one stream at a time)."""
    import numpy as np
    rng = np.random.RandomState(seed)
    prompts = [rng.randint(0, vocab, n).tolist() for n in BATCH_PROMPTS]
    i300, i600 = BATCH_PROMPTS.index(300), BATCH_PROMPTS.index(600)
    prompts[i300][:SHARED_PREFIX] = prompts[i600][:SHARED_PREFIX]
    return prompts


def predicted_paged_launches(engine, admits, L: int) -> dict:
    """The card's routing's prediction from the engine's admissions
    (prompt length, matched prefix): the decode kernel L times per decode
    step; the prefill kernel L times per mid chunk and per final suffix
    padded to its bucket (on the card the routing keeps no row cap, so
    a 128-token bucket's 1024 rows at g = 8 take the kernel too)."""
    from distributed_inference_demo_tpu_torch.ops.paged_attention import \
        paged_route
    cfg = engine.cfg
    g = cfg.num_heads // cfg.num_kv_heads
    bt = engine.kv_cache.block_tokens
    C = engine.prefill_chunk
    prefill = 0
    for plen, m in admits:
        suffix = plen - m
        n_mid = max(0, -(-suffix // C) - 1) if suffix > C else 0
        final = engine._bucket(suffix - n_mid * C)
        prefill += n_mid * (paged_route(True, C, g, bt, max_rows=None)
                            == "prefill")
        prefill += paged_route(True, final, g, bt, max_rows=None) == "prefill"
    return {"paged_decode": L * engine.loop_stats["device_loop_steps"],
            "paged_prefill": L * prefill}


def _wait_steps(engine, n: int, timeout: float = 300.0) -> None:
    """Poll until the scheduler has run ``n`` more decode steps."""
    goal = engine._step_count + n
    t_end = time.monotonic() + timeout
    while engine._step_count < goal:
        _check(time.monotonic() < t_end, "decode steps did not advance")
        time.sleep(0.001)


def _no_page_leak(engine) -> bool:
    """Every page is free or an evictable radix leaf: allocating the
    whole pool succeeds (evicting the tree), and freeing it brings
    ``free_blocks`` back to the total."""
    mgr = engine.kv_cache
    ids = mgr.alloc(mgr.num_blocks)
    if ids is None:
        return False
    mgr.free(ids)
    return mgr.free_blocks == mgr.num_blocks


def _serve_all(port: int, prompts) -> list:
    """The batching phases' requests, all at once over HTTP, greedy,
    NEW_TOKENS each, the 150-token prompt's streamed: [tokens] per
    prompt."""
    import threading

    stream_i = BATCH_PROMPTS.index(150)
    out = [None] * len(prompts)

    def one(i):
        body = {"prompt_ids": [prompts[i]], "max_new_tokens": NEW_TOKENS}
        if i == stream_i:
            body["stream"] = True
        code, text = _post(port, body)
        _check(code == 200, f"batched request {i}: HTTP {code}")
        if i == stream_i:
            lines = [json.loads(ln) for ln in text.splitlines()
                     if ln.strip()]
            _check([ln["step"] for ln in lines] == list(range(NEW_TOKENS)),
                   "stream steps")
            out[i] = [ln["tokens"][0] for ln in lines]
        else:
            out[i] = json.loads(text)["tokens"][0]

    threads = [threading.Thread(target=one, args=(i,))
               for i in range(len(prompts))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=900)
    _check(all(o is not None and len(o) == NEW_TOKENS for o in out),
           "a batched request did not complete")
    return out


def _reset_launches(*wrappers) -> None:
    for w in wrappers:
        w.launches = 0
        for extra in ("int8_launches", "fp8_launches", "wide_launches"):
            if hasattr(w, extra):
                setattr(w, extra, 0)


def _paged_logits(torch, engine, seq, n_decode: int,
                  pad_final: bool = False):
    """The logits of ``seq``, teacher forced, through a closed batching
    engine's paged forward as its scheduler runs it: all but the last
    ``n_decode`` tokens as a chunked prefill (chunks of ``prefill_chunk``,
    the last one shorter, or with ``pad_final`` zero-padded to its prompt
    bucket and routed by that length, as the serialized admission's final
    prefill is), then ``n_decode`` one-token decode steps, on pages taken
    from the engine's own pool and given back after.  Returns
    [n_decode + 1, vocab] f32: the prefill's last position, then each
    decode step's."""
    import numpy as np
    mgr = engine.kv_cache
    n_pre = len(seq) - n_decode
    pages = mgr.alloc(-(-len(seq) // mgr.block_tokens))
    _check(pages is not None, "no free pages for the logit check")
    table = np.full((1, engine._table_width), engine._page_sentinel,
                    np.int32)
    table[0, :len(pages)] = pages
    tables = engine._upload(table)
    out, start = [], 0
    try:
        while start < len(seq):
            n = min(engine.prefill_chunk, n_pre - start) if start < n_pre \
                else 1
            width = (engine._bucket(n) if pad_final and start < n_pre
                     and start + n == n_pre else n)
            ids = torch.zeros((1, width), dtype=torch.int64,
                              device=engine.device)
            ids[0, :n] = torch.tensor(seq[start:start + n])
            pos = start + torch.arange(width, device=engine.device)[None]
            engine._bind(tables)
            # a padded chunk's logits at every position, as the engine's
            logits, _ = engine._fwd(engine.params, ids, engine._pool(), pos,
                                    width == n)
            start += n
            if start >= n_pre:
                out.append(logits[0, -1 if width == n else n - 1]
                           .float().cpu().numpy())
    finally:
        mgr.free(pages)
    return np.stack(out)


def paged_logit_check(torch, kernel_engine, plain_engine, seq,
                      n_decode: int = 8) -> dict:
    """bf16 logits of the kernels against the gather path: the same
    ``seq`` through both closed engines (same weights, same pool
    configuration, ``attn_backend`` "auto" and "plain"); the kernel
    engine's logits must be finite and within LOGIT_TOL_REL of the
    gather path's largest logit, as the serve phase holds the flash
    kernel (an MoE model's with the gather path's expert choices,
    :func:`moe_pinned`)."""
    import numpy as np
    lp, lk, routing = moe_pinned(
        kernel_engine.cfg,
        lambda: _paged_logits(torch, plain_engine, seq, n_decode),
        lambda: _paged_logits(torch, kernel_engine, seq, n_decode))
    scale = max(1.0, float(np.abs(lp).max()))
    err = np.abs(lk - lp).max(axis=1)
    res = {"tokens": len(seq), "decode_steps": n_decode,
           "logit_max_abs_err": float(err.max()),
           "prefill_logit_max_abs_err": float(err[0]),
           "logit_scale": scale, "logit_tol": LOGIT_TOL_REL * scale,
           "argmax_agreement": int((lk.argmax(1) == lp.argmax(1)).sum()),
           "argmax_agreement_of": len(err), "routing": routing}
    _check(bool(np.isfinite(lk).all()), "paged kernel logits not finite")
    _check(res["logit_max_abs_err"] <= res["logit_tol"],
           f"paged kernel logits differ from the gather path's by "
           f"{res['logit_max_abs_err']} (> {LOGIT_TOL_REL} x {scale})")
    return res


def _slab_logits(torch, engine, seq, n_decode: int):
    """As :func:`_paged_logits`, but each prefill chunk runs as the mixed
    dispatch runs it: row 0 of a slab of the engine's ``_mixed_seg_cap``
    rows of ``prefill_chunk`` tokens (the last chunk zero-padded, its
    logits read at its last real token; padded positions write past the
    prompt, which decode overwrites or which drop), the other rows unused
    (all-sentinel tables, start 0).  The decode steps are
    :func:`_paged_logits`' own."""
    import numpy as np
    mgr = engine.kv_cache
    C, n_seg, dev = engine.prefill_chunk, engine._mixed_seg_cap, engine.device
    n_pre = len(seq) - n_decode
    pages = mgr.alloc(-(-len(seq) // mgr.block_tokens))
    _check(pages is not None, "no free pages for the slab logits")
    table = np.full((n_seg, engine._table_width), engine._page_sentinel,
                    np.int32)
    table[0, :len(pages)] = pages
    tables, one = engine._upload(table), engine._upload(table[:1])
    out, start = [], 0
    try:
        while start < len(seq):
            if start < n_pre:
                n = min(C, n_pre - start)
                ids = np.zeros((n_seg, C), np.int64)
                ids[0, :n] = seq[start:start + n]
                starts = torch.zeros(n_seg, dtype=torch.int64, device=dev)
                starts[0] = start
                logits, _ = engine._slab_body(
                    engine.params, engine._pool(),
                    torch.from_numpy(ids).to(dev), tables, starts)
                last = logits[0, n - 1]
            else:
                n = 1
                engine._bind(one)
                logits, _ = engine._fwd(
                    engine.params,
                    torch.tensor([[seq[start]]], device=dev),
                    engine._pool(), torch.tensor([[start]], device=dev),
                    True)
                last = logits[0, -1]
            start += n
            if start >= n_pre:
                out.append(last.float().cpu().numpy())
    finally:
        mgr.free(pages)
    return np.stack(out)


def slab_vs_chunk(torch, engine, seq, n_decode: int = 8,
                  pad_final: bool = False) -> dict:
    """The gap between the mixed slab's and the serialized chunk's
    teacher-forced logits of ``seq`` on one closed engine (a report, no
    check): the prefill's last position and ``n_decode`` decode steps;
    ``pad_final`` as in :func:`_paged_logits`."""
    import numpy as np
    slab = _slab_logits(torch, engine, seq, n_decode)
    chunk = _paged_logits(torch, engine, seq, n_decode, pad_final)
    err = np.abs(slab - chunk).max(axis=1)
    return {"tokens": len(seq), "decode_steps": n_decode,
            "pad_final": pad_final,
            "logit_max_abs_gap": float(err.max()),
            "logit_scale": max(1.0, float(np.abs(chunk).max())),
            "argmax_agreement": int((slab.argmax(1)
                                     == chunk.argmax(1)).sum()),
            "argmax_agreement_of": len(err)}


def _token_leaves(pool, pages, lo: int, hi: int):
    """Each leaf of a page pool (a tensor, or an int8/int4 pool's codes,
    scales and zeros) at tokens ``lo``..``hi`` - 1 of a sequence held on
    ``pages``: [L, nkv, hi - lo, ·] each."""
    import torch
    leaves = pool.leaves() if hasattr(pool, "leaves") else [pool]
    idx = torch.tensor(pages, device=leaves[0].device)
    out = []
    for t in leaves:
        L, _, nkv, bt, d = t.shape
        lin = t[:, idx].permute(0, 2, 1, 3, 4).reshape(L, nkv, -1, d)
        out.append(lin[:, :, lo:hi])
    return out


def kv_pages_slab_vs_chunk(torch, engine, seq) -> dict:
    """ROADMAP C 2: the prompt ``seq`` admitted twice on one closed
    engine, chunk by chunk in lockstep, each copy on its own pages: as
    the serialized admission runs it (one [1, C] forward a chunk, the
    final one zero-padded to its prompt bucket: every dense product at M
    = C or the bucket) and as row 0 of a mixed slab (M =
    ``_mixed_seg_cap`` x C rows, the other rows unused).  After each
    chunk, the K and V pages it wrote (every leaf, every layer), bit for
    bit; and whether each of layer 0's seven dense products (random
    rows, the engine's weights) gives a chunk's rows bit-equal at the
    two M.  The paged kernels' rows do not depend on other rows, so
    pages can differ only in chunks where some product's rows do."""
    import numpy as np

    from distributed_inference_demo_tpu_torch.ops.quant import dense

    cfg, mgr, dev = engine.cfg, engine.kv_cache, engine.device
    C, n_seg, bt = engine.prefill_chunk, engine._mixed_seg_cap, \
        mgr.block_tokens
    need = -(-len(seq) // bt) + 1      # + the padded final's spill
    serial, slab = mgr.alloc(need), mgr.alloc(need)
    _check(serial is not None and slab is not None,
           "no free pages for the page comparison")
    tables = []
    for rows, pages in ((1, serial), (n_seg, slab)):
        t = np.full((rows, engine._table_width), engine._page_sentinel,
                    np.int32)
        t[0, :need] = pages
        tables.append(engine._upload(t))
    lp0 = engine.params.layer(0)
    gen = torch.Generator(device=dev).manual_seed(0)
    probe = {w: torch.randn((n_seg * C, lp0[w].shape[0]), generator=gen,
                            device=dev).to(cfg.dtype)
             for w in ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down")
             if w in lp0}

    def rows_equal(width, n):
        """Each product's first ``n`` rows at M = ``width`` and at the
        slab's M, bit for bit."""
        return {w: torch.equal(
            dense(x[None, :width], lp0[w], "bsh,hd->bsd")[0, :n],
            dense(x.view(n_seg, C, -1), lp0[w], "bsh,hd->bsd")[0, :n])
            for w, x in probe.items()}

    per_chunk, start = [], 0
    try:
        with torch.no_grad():
            while start < len(seq):
                n = min(C, len(seq) - start)
                width = engine._bucket(n) if start + n == len(seq) and \
                    n < C else n
                ids = torch.zeros((1, width), dtype=torch.int64, device=dev)
                ids[0, :n] = torch.tensor(seq[start:start + n])
                engine._bind(tables[0])
                engine._fwd(engine.params, ids, engine._pool(),
                            start + torch.arange(width, device=dev)[None],
                            width == n)
                sids = torch.zeros((n_seg, C), dtype=torch.int64,
                                   device=dev)
                sids[0, :n] = ids[0, :n]
                starts = torch.zeros(n_seg, dtype=torch.int64, device=dev)
                starts[0] = start
                engine._slab_body(engine.params, engine._pool(), sids,
                                  tables[1], starts)
                differ = [
                    li for li in range(cfg.num_layers)
                    if not all(torch.equal(x[li], y[li])
                               for pool in (engine._pk, engine._pv)
                               for x, y in zip(
                                   _token_leaves(pool, serial, start,
                                                 start + n),
                                   _token_leaves(pool, slab, start,
                                                 start + n)))]
                rows = rows_equal(width, n)
                per_chunk.append({
                    "start": start, "tokens": n, "serial_rows": width,
                    "differing_layers": len(differ),
                    "first_differing_layer": differ[0] if differ else None,
                    "dense_rows_differ": [w for w, eq in rows.items()
                                          if not eq]})
                start += n
    finally:
        mgr.free(serial)
        mgr.free(slab)
    differs = [c["differing_layers"] > 0 for c in per_chunk]
    m_dependent = [bool(c["dense_rows_differ"]) for c in per_chunk]
    return {"tokens": len(seq), "chunks": len(per_chunk),
            "layers": cfg.num_layers, "slab_rows": n_seg * C,
            "pages_bit_equal_chunks": differs.count(False),
            "m_dependent_chunks": m_dependent.count(True),
            "pages_differ_only_where_m_differs": all(
                m for d, m in zip(differs, m_dependent) if d),
            "per_chunk": per_chunk}


def phase_batching(torch, model: str = SERVE_MODEL,
                   f32: str | None = "engine",
                   kv_cache_dtype: str | None = None,
                   f32_layers: int | None = None) -> dict:
    """The batching path of ``model`` at full width: see the module
    docstring, item 4.  ``f32``: "engine" holds the f32 tokens to a
    plain-attention ``InferenceEngine``'s (requests concurrent), "gather"
    to the same batching configuration's on the gather path (requests
    one after another, the same schedule for both), None skips it;
    ``f32_layers`` cuts that check's depth (full width).
    ``kv_cache_dtype`` "float8_e4m3fn": the pool's pages are float8 and
    the e4m3 instances launch (launch keys ``paged_*_fp8``); the decode
    window is left to :func:`graph_batching`."""
    from distributed_inference_demo_tpu_torch.models.decoder import \
        init_full_params
    from distributed_inference_demo_tpu_torch.models.registry import \
        get_model_config
    from distributed_inference_demo_tpu_torch.ops import \
        paged_attention as pa
    from distributed_inference_demo_tpu_torch.ops.flash_attention import \
        flash_attention
    from distributed_inference_demo_tpu_torch.ops.sampling import \
        SamplingParams
    from distributed_inference_demo_tpu_torch.runtime.batching import \
        ContinuousBatchingEngine
    from distributed_inference_demo_tpu_torch.runtime.engine import \
        InferenceEngine
    from distributed_inference_demo_tpu_torch.runtime.http_server import \
        InferenceHTTPServer
    from distributed_inference_demo_tpu_torch.telemetry.flightrecorder \
        import get_flight_recorder

    cfg = get_model_config(model)
    L = cfg.num_layers
    greedy = SamplingParams(greedy=True)
    prompts = _batch_prompts(cfg.vocab_size)

    fp8 = kv_cache_dtype is not None
    # the counts of the instances this pool takes, and of the others
    attr, other = (("fp8_launches", "launches") if fp8
                   else ("launches", "fp8_launches"))
    suffix = "_fp8" if fp8 else ""

    def engine_for(c, params, **kw):
        return ContinuousBatchingEngine(
            c, params, max_seq=MAX_SEQ, max_batch=SLOTS, sampling=greedy,
            kv_block_tokens=BLOCK_TOKENS, prefill_chunk=PREFILL_CHUNK,
            kv_cache_dtype=kv_cache_dtype, device="cuda", **kw)

    out = {"phase": "batching", "device": torch.cuda.get_device_name(0),
           "kv_cache_dtype": kv_cache_dtype,
           "model": model, "head_dim": cfg.head_dim, "slots": SLOTS,
           "block_tokens": BLOCK_TOKENS, "prefill_chunk": PREFILL_CHUNK,
           "prompt_lens": list(BATCH_PROMPTS), "new_tokens": NEW_TOKENS}
    params = init_full_params(
        torch.Generator(device="cuda").manual_seed(0), cfg, "cuda")
    engine = engine_for(cfg, params)
    _check(engine.attn_backend == "auto", "paged backend")
    server = InferenceHTTPServer(engine, "127.0.0.1", 0,
                                 model_name=model,
                                 default_max_new=NEW_TOKENS)
    server.start()
    flight = get_flight_recorder()
    try:
        # warm the path once (allocator, first launches), then start from
        # a fresh engine state for the counted run
        _post(server.port, {"prompt_ids": [list(range(16))],
                            "max_new_tokens": 2})
        engine.reset_stats()
        _check(_no_page_leak(engine), "warm-up leaked pages")
        flight.clear()
        # ---- the main path: counts from zero, 8 concurrent requests ----
        _reset_launches(pa.paged_flash_attention, pa.paged_prefill_attention,
                        flash_attention)
        t0 = time.perf_counter()
        toks = _serve_all(server.port, prompts)
        wall = time.perf_counter() - t0
        launches = {
            "paged_decode" + suffix: getattr(pa.paged_flash_attention, attr),
            "paged_prefill" + suffix: getattr(pa.paged_prefill_attention,
                                              attr)}
        events = flight.snapshot()
        admits = [(e["prompt_len"], e["prefix_reused"]) for e in events
                  if e["kind"] == "batch_admit"]
        ttft = {e["prompt_len"]: e["ttft_s"] for e in events
                if e["kind"] == "batch_done"}
        predicted = {k + suffix: v for k, v in
                     predicted_paged_launches(engine, admits, L).items()}
        stats = engine.stats()
        out.update(launches=launches, predicted_launches=predicted,
                   flash_launches=flash_attention.launches,
                   wall_s=wall, tok_s=len(prompts) * NEW_TOKENS / wall,
                   decode_steps=engine.loop_stats["device_loop_steps"],
                   admissions=admits, kvcache=stats["kvcache"],
                   chunked_prefill=stats["chunked_prefill"],
                   ttft_shortest_s=ttft.get(min(BATCH_PROMPTS)),
                   ttft_longest_s=ttft.get(max(BATCH_PROMPTS)),
                   tokens=toks)
        _check(launches == predicted and min(launches.values()) > 0,
               f"paged launches {launches}, routing predicts {predicted}")
        _check(flash_attention.launches == 0, "the flash kernel ran")
        _check(pa.paged_flash_attention.int8_launches
               == pa.paged_prefill_attention.int8_launches
               == getattr(pa.paged_flash_attention, other)
               == getattr(pa.paged_prefill_attention, other) == 0,
               "another page type's instance ran")
        _check(stats["kvcache"]["hits"] == 1
               and stats["kvcache"]["partial_hit_tokens"] == SHARED_PREFIX,
               f"radix hit: {stats['kvcache']}")
        _check(len(admits) == len(prompts), f"admissions {admits}")
        out["no_page_leak"] = _no_page_leak(engine)
        _check(out["no_page_leak"], "pages leaked after the drain")

        # ---- decode step time and the device's idle share, 8 slots
        # decoding (short prompts, steps counted by the engine) ----
        if not fp8:
            out.update(decode_window(torch, engine, prompts))
            _check(_no_page_leak(engine), "cancelled requests leaked pages")
    finally:
        server.shutdown()
        engine.close()

    # ---- bf16 logits, the kernels against the gather path: a 1000-token
    # chunked prefill (15 chunks of 64 and one of 40) and 8 decode steps
    with engine_for(cfg, params, attn_backend="plain") as plain_engine:
        pass
    out["logit_check"] = paged_logit_check(
        torch, engine, plain_engine, prompts[BATCH_PROMPTS.index(1500)][:1008])
    del engine, plain_engine, params
    torch.cuda.empty_cache()

    if f32 is None:
        return out
    # ---- f32, same seed: the batching engine (paged kernels) against a
    # plain-attention InferenceEngine, or against the gather path, token
    # for token ----
    cfg32 = cfg.replace(dtype_name="float32",
                        num_layers=f32_layers or cfg.num_layers)
    out["f32_layers"] = cfg32.num_layers
    p32 = init_full_params(
        torch.Generator(device="cuda").manual_seed(0), cfg32, "cuda")
    if f32 == "engine":
        with engine_for(cfg32, p32) as eng32:
            reqs = [eng32.submit(p, NEW_TOKENS) for p in prompts]
            got = [r.wait(timeout=900).tolist() for r in reqs]
            _check(_no_page_leak(eng32), "f32 run leaked pages")
        plain = InferenceEngine(cfg32, p32, max_seq=MAX_SEQ, sampling=greedy,
                                attn_backend="plain", device="cuda")
        want = [plain.generate([p], NEW_TOKENS).tokens[0].tolist()
                for p in prompts]
        del plain
    else:
        runs, engines = {}, {}
        for backend in ("auto", "plain"):
            with engine_for(cfg32, p32, attn_backend=backend) as eng32:
                runs[backend] = [eng32.submit(p, NEW_TOKENS).wait(
                    timeout=900).tolist() for p in prompts]
                _check(_no_page_leak(eng32), "f32 run leaked pages")
            engines[backend] = eng32
        got, want = runs["auto"], runs["plain"]
    agree = [sum(a == b for a, b in zip(g_, w_)) for g_, w_ in
             zip(got, want)]
    out["f32_against"] = f32
    out["f32_greedy_agreement"] = sum(agree) / (len(prompts) * NEW_TOKENS)
    out["f32_agreement_per_request"] = agree
    if fp8 and got != want:
        # float8 pages: each path writes the pages its own forward
        # computes, and K/V that differ in their last f32 bits can round
        # to neighbouring e4m3 codes (1/16 apart), so a greedy stream may
        # part at a near tie (ROADMAP C).  Each parting must be one (see
        # fp8_partings)
        out["f32_partings"] = fp8_partings(torch, engines, prompts, got,
                                           want)
        del engines
    else:
        _check(got == want, f"f32 batching tokens differ from the {f32} "
               f"path's: {agree} of {NEW_TOKENS} per request")
    del p32
    torch.cuda.empty_cache()
    return out


def fp8_partings(torch, engines, prompts, got, want) -> list:
    """Where the f32 greedy streams of the kernels (``got``) and the
    gather path (``want``) over float8 pages part: for each request that
    parts, its first differing step, the two paths' teacher-forced
    logits along the kernels' tokens up to it (:func:`_paged_logits`
    on the closed engines), their largest gap, and the gap between the
    two tokens' logits at that step on the gather path.  A parting must
    sit at a near tie: that margin under the paths' gap, the gap within
    LOGIT_TOL_REL of the largest logit."""
    import numpy as np
    out = []
    for i, (g, w) in enumerate(zip(got, want)):
        if g == w:
            continue
        j = next(k for k in range(len(g)) if g[k] != w[k])
        seq = prompts[i] + g[:j + 1]
        lk = _paged_logits(torch, engines["auto"], seq, j + 1)
        lp = _paged_logits(torch, engines["plain"], seq, j + 1)
        gap = float(np.abs(lk[:j + 1] - lp[:j + 1]).max())
        row = {"request": i, "step": j,
               "margin": float(abs(lp[j, w[j]] - lp[j, g[j]])),
               "logit_gap": gap,
               "logit_tol": LOGIT_TOL_REL * max(1.0,
                                                float(np.abs(lp).max()))}
        out.append(row)
        _check(row["margin"] <= gap <= row["logit_tol"],
               f"f32 float8 streams part away from a near tie: {row}")
    return out


def phase_mixed(torch, model: str = SERVE_MODEL, extras: bool = True
                ) -> dict:
    """The mixed dispatch over int8 pages at ``model``'s full width: see
    the module docstring, item 5.  ``extras``: also the teacher-forced
    slab-vs-chunk logit gap, the int4 pool and the f32 tokens."""
    from distributed_inference_demo_tpu_torch.models.decoder import \
        init_full_params
    from distributed_inference_demo_tpu_torch.models.registry import \
        get_model_config
    from distributed_inference_demo_tpu_torch.ops import \
        paged_attention as pa
    from distributed_inference_demo_tpu_torch.ops.flash_attention import \
        flash_attention
    from distributed_inference_demo_tpu_torch.ops.sampling import \
        SamplingParams
    from distributed_inference_demo_tpu_torch.runtime.batching import \
        ContinuousBatchingEngine
    from distributed_inference_demo_tpu_torch.runtime.http_server import \
        InferenceHTTPServer
    from distributed_inference_demo_tpu_torch.telemetry.flightrecorder \
        import get_flight_recorder

    cfg = get_model_config(model)
    L = cfg.num_layers
    greedy = SamplingParams(greedy=True)
    prompts = _batch_prompts(cfg.vocab_size)
    wrappers = (pa.paged_flash_attention, pa.paged_prefill_attention,
                flash_attention)

    def engine_for(c, params, **kw):
        kw.setdefault("mixed_token_budget", MIXED_BUDGET)
        kw.setdefault("kv_dtype", "int8")
        return ContinuousBatchingEngine(
            c, params, max_seq=MAX_SEQ, max_batch=SLOTS, sampling=greedy,
            kv_block_tokens=BLOCK_TOKENS, prefill_chunk=PREFILL_CHUNK,
            decode_block=MIXED_DECODE_BLOCK, device="cuda", **kw)

    def counts():
        return {"paged_decode": pa.paged_flash_attention.launches,
                "paged_prefill": pa.paged_prefill_attention.launches,
                "paged_decode_int8": pa.paged_flash_attention.int8_launches,
                "paged_prefill_int8":
                    pa.paged_prefill_attention.int8_launches,
                "flash_attention": flash_attention.launches}

    out = {"phase": "mixed", "device": torch.cuda.get_device_name(0),
           "model": model, "head_dim": cfg.head_dim, "slots": SLOTS,
           "block_tokens": BLOCK_TOKENS, "prefill_chunk": PREFILL_CHUNK,
           "decode_block": MIXED_DECODE_BLOCK,
           "mixed_token_budget": MIXED_BUDGET, "kv_dtype": "int8",
           "prompt_lens": list(BATCH_PROMPTS), "new_tokens": NEW_TOKENS}
    params = init_full_params(
        torch.Generator(device="cuda").manual_seed(0), cfg, "cuda")
    engine = engine_for(cfg, params)
    _check(engine._mixed_seg_cap == 4, "the budget packs 4 segments")
    out["pool_bytes"] = engine._pk.nbytes + engine._pv.nbytes
    server = InferenceHTTPServer(engine, "127.0.0.1", 0,
                                 model_name=model,
                                 default_max_new=NEW_TOKENS)
    server.start()
    flight = get_flight_recorder()
    try:
        _post(server.port, {"prompt_ids": [list(range(16))],
                            "max_new_tokens": 2})
        engine.reset_stats()
        _check(_no_page_leak(engine), "warm-up leaked pages")
        flight.clear()
        # ---- the main path: counts from zero, 8 concurrent requests ----
        _reset_launches(*wrappers)
        t0 = time.perf_counter()
        toks = _serve_all(server.port, prompts)
        wall = time.perf_counter() - t0
        launches = counts()
        events = flight.snapshot()
        ttft = {e["prompt_len"]: e["ttft_s"] for e in events
                if e["kind"] == "batch_done"}
        stats = engine.stats()
        # the routing: every decode step launches the decode kernel's
        # int8 instance once a layer; every slab forward (a dispatch that
        # packed a segment) the prefill kernel's, its 64-token segments
        # being 512 rows; nothing else launches
        predicted = {
            "paged_decode": 0, "paged_prefill": 0,
            "paged_decode_int8": L * engine.loop_stats["device_loop_steps"],
            "paged_prefill_int8":
                L * engine.chunk_stats["mixed_slab_forwards"],
            "flash_attention": 0}
        out.update(launches=launches, predicted_launches=predicted,
                   wall_s=wall, tok_s=len(prompts) * NEW_TOKENS / wall,
                   decode_steps=engine.loop_stats["device_loop_steps"],
                   host_dispatches=engine.loop_stats["host_dispatches"],
                   slab_forwards=engine.chunk_stats["mixed_slab_forwards"],
                   mixed=stats["mixed"], kvcache=stats["kvcache"],
                   ttft_shortest_s=ttft.get(min(BATCH_PROMPTS)),
                   ttft_longest_s=ttft.get(max(BATCH_PROMPTS)),
                   tokens=toks)
        _check(launches == predicted
               and min(launches["paged_decode_int8"],
                       launches["paged_prefill_int8"]) > 0,
               f"launches {launches}, routing predicts {predicted}")
        _check(stats["mixed"]["dispatches"] > 0, "no mixed dispatch ran")
        _check(stats["kvcache"]["page_dtype"] == "int8", "page dtype")
        out["no_page_leak"] = _no_page_leak(engine)
        _check(out["no_page_leak"], "pages leaked after the drain")

        # ---- decode step time and the device's idle share, 8 slots
        # decoding (short prompts, steps counted by the engine) ----
        out.update(decode_window(torch, engine, prompts))
        _check(_no_page_leak(engine), "cancelled requests leaked pages")
    finally:
        server.shutdown()
        engine.close()

    # ---- bf16 logits over int8 pages, the int8 kernels against the
    # gather path, as in the batching phase ----
    with engine_for(cfg, params, attn_backend="plain") as plain_engine:
        pass
    seq = prompts[BATCH_PROMPTS.index(1500)][:1008]
    out["logit_check"] = paged_logit_check(torch, engine, plain_engine, seq)
    if not extras:
        del engine, plain_engine, params
        torch.cuda.empty_cache()
        return out
    # ---- teacher forced, bf16 over int8 pages: the same tokens' logits
    # with each prefill chunk in a mixed slab against the serialized
    # chunk, through the kernels and through the gather path; the 1000-
    # and the 100-token prompt (a 40- and a 36-token final chunk, the
    # latter padded to the 128 bucket: 1024 rows, which the serialized
    # admission sends to the gather path) ----
    out["slab_vs_chunk"] = {
        f"{name}_{n}": slab_vs_chunk(torch, e, p[:n + 8], pad_final=True)
        for name, e in (("kernels", engine), ("gather", plain_engine))
        for n, p in ((1000, seq), (100, prompts[BATCH_PROMPTS.index(100)]
                                   + prompts[0][:8]))}
    # ---- ROADMAP C 2: the K/V pages the 1000-token prompt writes, chunk
    # by chunk, serialized against in a mixed slab ----
    # (finals padded to 64 and to 32 rows)
    out["kv_pages_slab_vs_chunk"] = {
        f"{name}_{len(p)}": kv_pages_slab_vs_chunk(torch, e, p)
        for name, e in (("kernels", engine), ("gather", plain_engine))
        for p in (seq[:1000], prompts[BATCH_PROMPTS.index(150)],
                  prompts[BATCH_PROMPTS.index(20)])}
    del engine, plain_engine

    # ---- an int4 pool: the routing sends it to the gather path ----
    _reset_launches(*wrappers)
    with engine_for(cfg, params, kv_dtype="int4") as eng4:
        got4 = eng4.submit(prompts[1], 8).wait(timeout=300).tolist()
        _check(_no_page_leak(eng4), "int4 run leaked pages")
    out["int4_launches"] = counts()
    _check(len(got4) == 8, "int4 request")
    _check(not any(out["int4_launches"].values()),
           f"an int4 pool launched {out['int4_launches']}")
    del params
    torch.cuda.empty_cache()

    # ---- f32, same seed, requests one after another (the same schedule
    # for both): the int8 kernels against the gather path, token for
    # token ----
    cfg32 = cfg.replace(dtype_name="float32")
    p32 = init_full_params(
        torch.Generator(device="cuda").manual_seed(0), cfg32, "cuda")
    runs = {}
    for backend in ("auto", "plain"):
        with engine_for(cfg32, p32, attn_backend=backend) as eng32:
            runs[backend] = [eng32.submit(p, NEW_TOKENS).wait(
                timeout=900).tolist() for p in prompts]
            _check(_no_page_leak(eng32), "f32 run leaked pages")
    agree = [sum(a == b for a, b in zip(g_, w_))
             for g_, w_ in zip(runs["auto"], runs["plain"])]
    out["f32_greedy_agreement"] = sum(agree) / (len(prompts) * NEW_TOKENS)
    out["f32_agreement_per_request"] = agree
    _check(runs["auto"] == runs["plain"],
           f"f32 mixed int8 tokens differ between the kernels and the "
           f"gather path: {agree} of {NEW_TOKENS} per request")
    del p32
    torch.cuda.empty_cache()
    return out


# new tokens per request of a decode window: far more than the window
# runs, so every row decodes through it (16 + 1500 <= MAX_SEQ)
DECODE_WINDOW_NEW = 1500


def _stop(reqs) -> None:
    """Cancel ``reqs`` and wait until the scheduler has dropped them."""
    for r in reqs:
        r.cancel()
    for r in reqs:
        _check(r.done.wait(timeout=120), "a cancelled request hung")


def decode_window(torch, engine, prompts, steps: int = 32,
                  profiled: int = 16, on_timed=None) -> dict:
    """SLOTS rows of a batching engine decoding (each prompt's first 16
    tokens, DECODE_WINDOW_NEW new): the host-clock ms per engine step over
    ``steps`` steps, then :func:`profile_steps` over ``profiled`` more.
    Every request is cancelled and done when it returns;
    ``window_requests`` counts the requests it made.  ``on_timed()``, if
    given, runs once the timed steps are done, before the profile."""
    def submit():
        return [engine.submit(p[:16], DECODE_WINDOW_NEW)
                for p in prompts[:SLOTS]]

    made = []

    def counted():
        made.extend(submit())
        return made[-SLOTS:]

    reqs = counted()
    try:
        _wait_steps(engine, 4)
        t0, k0 = time.perf_counter(), engine._step_count
        _wait_steps(engine, steps)
        ms = (time.perf_counter() - t0) * 1e3 / (engine._step_count - k0)
        if on_timed is not None:
            on_timed()
    finally:
        _stop(reqs)
    prof = profile_steps(torch, engine, profiled, counted)
    return {"decode_ms_per_step": ms, "profile": prof,
            "window_requests": len(made)}


def profile_steps(torch, engine, steps: int, submit,
                  attempts: int = 3) -> dict:
    """torch.profiler over ``steps`` decode steps of a running batching
    engine, the requests ``submit()`` makes: device time by kernel (top
    8), device-busy sum, wall time and the device's idle share 1 - busy /
    wall.  The requests are cancelled, and the scheduler idle, before the
    profiler stops: on the H100 a stop while the scheduler thread replayed
    its graph hung for minutes.  A profile can hold the scheduler
    thread's copies but none of its kernels (seen on the H100 in one run
    of two phases): such a profile is taken again, up to ``attempts``
    times, and if none holds a kernel the busy sum and idle share are
    None, with the reason."""
    for attempt in range(1, attempts + 1):
        reqs = submit()
        try:
            _wait_steps(engine, 4)
            with _device_profile() as prof:
                t0, k0 = time.perf_counter(), engine._step_count
                _wait_steps(engine, steps)
                _stop(reqs)
                torch.cuda.synchronize()
                wall_ms = (time.perf_counter() - t0) * 1e3
                ran = engine._step_count - k0
        finally:
            _stop(reqs)
        out = _profile_summary(prof, wall_ms,
                               {"steps": ran, "attempts": attempt})
        if out["kernels"]:
            return out
    out.update(device_busy_ms=None, device_idle_share=None,
               not_measured="no profile recorded a kernel of the "
               "scheduler thread")
    return out


def profile_decode(torch, engine, prompt,
                   steps: int = PROFILE_DECODE_STEPS) -> dict:
    """torch.profiler over ``steps`` decode steps of a plain engine and
    nothing else: the prompt is prefilled before the profile starts, and
    the engine's decode loop runs inside it.  Device time by kernel (top
    8), the device-busy sum, the wall time, the idle share."""
    import numpy as np

    ids = engine._ids(prompt)
    with engine._lock:
        st, eos = engine._start(np.asarray(prompt), ids, 0)
        torch.cuda.synchronize()
        with _device_profile() as prof:
            t0 = time.perf_counter()
            engine._decode_loop(st, eos, steps, steps)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
    out = _profile_summary(prof, wall_ms, {"decode_steps": steps})
    _check(out["kernels"] > 0, "torch.profiler recorded no kernel")
    return out


def profile_generate(torch, engine, prompt, new_tokens: int = 16) -> dict:
    """Where one request's time goes: torch.profiler over a greedy
    generate (prefill + ``new_tokens`` decode steps).  Device time by
    kernel name (top 8), the device-busy sum, and the wall time; the
    device's idle share is 1 - busy / wall."""

    engine.generate(prompt, new_tokens)         # warm
    with _device_profile() as prof:
        t0 = time.perf_counter()
        engine.generate(prompt, new_tokens)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    out = _profile_summary(prof, wall_ms, {"new_tokens": new_tokens})
    _check(out["kernels"] > 0, "torch.profiler recorded no kernel")
    return out


def _device_profile():
    """torch.profiler recording the device's activity only.  Every number
    read from a profile is a kernel's device time; recording each host op
    as well cost about a minute of post-processing per eager profile
    (~130k ops over 64 decode steps) and added its own host time to the
    wall time that the idle share divides by."""
    from torch.profiler import ProfilerActivity, profile
    return profile(activities=[ProfilerActivity.CUDA])


# the trace event categories of device work (kernels, copies, fills)
DEVICE_TRACE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def _trace_rows(prof) -> list:
    """(device us, name, count) per device row, summed from the
    profile's Chrome trace, which kineto writes in C++."""
    import tempfile

    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f).get("traceEvents", [])
    finally:
        os.remove(path)
    totals = {}
    for ev in events:
        if ev.get("ph") == "X" and ev.get("cat") in DEVICE_TRACE_CATS:
            us, n = totals.get(ev["name"], (0.0, 0))
            totals[ev["name"]] = (us + float(ev.get("dur", 0)), n + 1)
    return [(us, name, n) for name, (us, n) in totals.items() if us > 0]


def _key_average_rows(prof) -> list:
    """The same rows from ``key_averages()``, which builds a Python
    object for each of a profile's events first."""
    rows = []
    for ev in prof.key_averages():
        # kernel rows only: a CPU op's row would count its kernels twice
        if not str(getattr(ev, "device_type", "")).endswith("CUDA"):
            continue
        dev_us = getattr(ev, "self_device_time_total",
                         getattr(ev, "self_cuda_time_total", 0))
        if dev_us > 0:
            rows.append((dev_us, ev.key, ev.count))
    return rows


def _profile_summary(prof, wall_ms: float, head: dict) -> dict:
    """Device time by kernel name (top 8), the device-busy sum, the wall
    time and the device's idle share from a finished profile, and how
    many of its device rows are kernels (not copies or fills; 0 when it
    recorded none: the callers check or take the profile again).  The
    rows come from the profile's Chrome trace (``rows_from`` "trace"),
    or, where that holds no kernel row, from ``key_averages()``, which
    gives the same sums (the same kineto records) at several seconds a
    profile of a decode step's ~2000 kernels: on the H100 the trace of
    an eager mixed dispatch on the scheduler thread held its copies and
    none of its kernels."""
    def n_kernels(rows):
        return sum(1 for r in rows
                   if not r[1].startswith(("Memcpy", "Memset")))

    rows, rows_from = _trace_rows(prof), "trace"
    if not n_kernels(rows):
        rows, rows_from = _key_average_rows(prof), "key_averages"
    rows.sort(reverse=True)
    busy_ms = sum(r[0] for r in rows) / 1e3
    kernels = n_kernels(rows)
    # the dequantizing dense kernels (decode, prefill, f32 and its split
    # reduction): every symbol of csrc/quant_dense.cu starts quant_dense_
    dense_ms = sum(r[0] for r in rows if "quant_dense_" in r[1]) / 1e3
    return {**head, "wall_ms": wall_ms, "kernels": kernels,
            "rows_from": rows_from,
            "device_busy_ms": busy_ms, "quant_dense_ms": dense_ms,
            "device_idle_share": 1.0 - busy_ms / wall_ms,
            "top": [{"kernel": k[:80], "ms": us / 1e3, "count": n}
                    for us, k, n in rows[:8]]}


# ---------------------------------------------------------------------------
# phase 8: the decode step as a CUDA graph against the same step eager
# ---------------------------------------------------------------------------

def dense_per_layer(cfg) -> int:
    """Quantized matmuls in one layer's forward (each one launch of the
    dense kernel): wq, wk, wv, wo and the MLP's three (bloom: two; an
    MoE: three an expert, every expert on every token)."""
    if cfg.quantization == "none":
        return 0
    if cfg.num_experts:
        return 4 + 3 * cfg.num_experts
    return 6 if cfg.family == "bloom" else 7


def _graph_plain_side(torch, engine, prompt) -> dict:
    """One plain engine's numbers: greedy tokens and logprobs, decode
    ms/token over GRAPH_DECODE_TOKENS, the replays and decode steps of
    those calls, the flash kernel's launches (L a prefill: the three
    prefills) and the dense kernel's against the routing (dense_per_layer
    x L a forward: the three prefills and every decode step; counted from
    0), then a profile of PROFILE_DECODE_STEPS decode steps."""
    from distributed_inference_demo_tpu_torch.ops import quant_dense as qd
    from distributed_inference_demo_tpu_torch.ops.flash_attention import \
        flash_attention

    engine.generate(prompt, 2)                   # captures, warms
    r0, s0 = engine.graph_replays, engine.loop_stats["device_loop_steps"]
    qd.quant_dense.launches = qd.quant_dense.decode_launches = 0
    _reset_launches(flash_attention)
    res = engine.generate(prompt, NEW_TOKENS, logprobs=True)
    n = GRAPH_DECODE_TOKENS if engine.cuda_graph else EAGER_DECODE_TOKENS
    t_one = engine.generate(prompt, 1).seconds
    t_many = engine.generate(prompt, 1 + n).seconds
    ms = (t_many - t_one) / n * 1e3
    replays = engine.graph_replays - r0
    steps = engine.loop_stats["device_loop_steps"] - s0
    dense = qd.quant_dense.launches
    decode = qd.quant_dense.decode_launches
    flash = flash_attention.launches
    L = engine.cfg.num_layers
    per_fwd = dense_per_layer(engine.cfg) * L
    want = 3 * L if engine.attn_backend == "flash" else 0
    _check(flash == want, f"{engine.cfg.family}: {flash} flash launches "
           f"over three prefills of {L} layers ({engine.attn_backend})")
    prof = profile_decode(torch, engine, prompt,
                          PROFILE_DECODE_STEPS if engine.cuda_graph
                          else EAGER_DECODE_TOKENS)
    # the PROMPT_LEN-token prefills take the prefill kernel, the one-row
    # decode steps the decode kernel
    return {"tokens": res.tokens[0].tolist(), "logprobs": res.logprobs,
            "flash_launches": flash, "dense_per_forward": per_fwd,
            "dense_launches": dense,
            "predicted_dense_launches": per_fwd * (3 + steps),
            "decode_launches": decode,
            "predicted_decode_launches": per_fwd * steps,
            "device_dense_ms_per_step": prof["quant_dense_ms"]
            / prof["decode_steps"],
            "dense_share": prof["quant_dense_ms"] / prof["device_busy_ms"],
            "ms_per_token": ms, "ms_per_step": ms, "tok_s": 1e3 / ms,
            "replays": replays, "decode_steps": steps,
            "device_ms_per_step": prof["device_busy_ms"]
            / prof["decode_steps"],
            "device_idle_share": prof["device_idle_share"],
            "device_busy_ms": prof["device_busy_ms"],
            "profile_wall_ms": prof["wall_ms"],
            "profile_kernels": prof["kernels"],
            "profile_top": prof["top"][:3]}


def graph_plain(torch, name: str, f32: bool = False) -> dict:
    """Plain serve of ``name`` at b=1, full width, the decode step
    replayed and eager (one engine each, the same weights): see the
    module docstring, item 8.  ``f32``: also greedy and sampled
    (seed 7) tokens and logprobs at f32, bit for bit."""
    import numpy as np

    from distributed_inference_demo_tpu_torch.models.decoder import \
        init_full_params
    from distributed_inference_demo_tpu_torch.models.loader import \
        load_or_init
    from distributed_inference_demo_tpu_torch.models.registry import \
        get_model_config
    from distributed_inference_demo_tpu_torch.ops.sampling import \
        SamplingParams
    from distributed_inference_demo_tpu_torch.runtime.engine import \
        InferenceEngine

    cfg = get_model_config(name)
    greedy = SamplingParams(greedy=True)
    prompt = np.random.RandomState(1).randint(
        0, cfg.vocab_size, (1, PROMPT_LEN)).tolist()
    # the CLI's resolution: random weights from seed 0, quantized during
    # init for an -int8 / -int4 model
    params = load_or_init(name, cfg, None, seed=0, device="cuda")
    out = {"path": f"{name} plain serve, b=1", "model": name,
           "decode_tokens": GRAPH_DECODE_TOKENS,
           "eager_decode_tokens": EAGER_DECODE_TOKENS}
    if cfg.quantization != "none":
        out["twin_check"] = quant_twin_check(torch, cfg, params)
    for key, flag in (("graph", True), ("eager", False)):
        eng = InferenceEngine(cfg, params, max_seq=MAX_SEQ, sampling=greedy,
                              device="cuda", cuda_graph=flag)
        out[key] = _graph_plain_side(torch, eng, prompt)
        del eng
    g, e = out["graph"], out["eager"]
    out["bits_equal"] = (g["tokens"] == e["tokens"] and
                         np.array_equal(g.pop("logprobs"),
                                        e.pop("logprobs")))
    out["speedup"] = e["ms_per_token"] / g["ms_per_token"]
    _check(out["bits_equal"], f"{name}: replayed greedy tokens or logprobs "
           "differ from the eager step's")
    _check(g["replays"] == g["decode_steps"] > 0 and e["replays"] == 0,
           f"{name}: replays {g['replays']} of {g['decode_steps']} steps")
    for side in (g, e):
        _check(side["dense_launches"] == side["predicted_dense_launches"],
               f"{name}: dense launches {side['dense_launches']}, the "
               f"routing predicts {side['predicted_dense_launches']}")
        _check(side["decode_launches"] == side["predicted_decode_launches"],
               f"{name}: decode-kernel launches {side['decode_launches']}, "
               f"the routing predicts {side['predicted_decode_launches']}")
    del params
    torch.cuda.empty_cache()
    if f32:
        cfg32 = cfg.replace(dtype_name="float32")
        p32 = init_full_params(
            torch.Generator(device="cuda").manual_seed(0), cfg32, "cuda")
        for mode, sp in (("greedy", greedy), ("sampled", SamplingParams())):
            got = []
            for flag in (True, False):
                eng = InferenceEngine(cfg32, p32, max_seq=MAX_SEQ,
                                      sampling=sp, device="cuda",
                                      cuda_graph=flag)
                res = eng.generate(prompt, NEW_TOKENS, seed=7, logprobs=True)
                got.append((res.tokens, res.logprobs))
                del eng
            same = all(np.array_equal(a, b) for a, b in zip(*got))
            out[f"f32_{mode}_bits_equal"] = same
            _check(same, f"{name} f32 {mode}: replayed tokens or logprobs "
                   "differ from the eager step's")
        del p32
        torch.cuda.empty_cache()
    return out


def _graph_batching_side(torch, engine, prompts, mixed: bool,
                         attr: str = "launches") -> dict:
    """One batching engine's numbers: 8 short requests together, greedy,
    NEW_TOKENS each (tokens and logprobs); then :func:`decode_window`;
    the replays, decode steps and paged launches of both against L per
    step and L per admission (mixed: per slab forward), counted on the
    wrappers' ``attr`` (the page type's instances)."""
    from distributed_inference_demo_tpu_torch.ops import \
        paged_attention as pa
    from distributed_inference_demo_tpu_torch.ops import quant_dense as qd

    L = engine.cfg.num_layers
    dec, pre = pa.paged_flash_attention, pa.paged_prefill_attention
    # counted from the idle, built engine to the idle engine at the end
    c0 = (getattr(dec, attr), getattr(pre, attr))
    r0, s0 = engine.graph_replays, engine.loop_stats["device_loop_steps"]
    f0 = engine.chunk_stats["mixed_slab_forwards"]
    qd.quant_dense.launches = qd.quant_dense.decode_launches = 0
    reqs = [engine.submit(p, NEW_TOKENS) for p in prompts]
    for r in reqs:
        r.wait(timeout=600)
    toks = [r.tokens for r in reqs]
    lps = [r.lps for r in reqs]
    window = decode_window(torch, engine, prompts,
                           *((32, 16) if engine._graphs.enabled
                             else EAGER_WINDOW_STEPS))
    steps = engine.loop_stats["device_loop_steps"] - s0
    launches = {"paged_decode": getattr(dec, attr) - c0[0],
                "paged_prefill": getattr(pre, attr) - c0[1]}
    # the routing: L decode launches a step; L prefill launches an
    # admission (a 16-token prompt, one dispatch, no radix hit) or, mixed,
    # a slab forward
    admitted = len(prompts) + window["window_requests"]
    predicted = {"paged_decode": L * steps, "paged_prefill": L * (
        engine.chunk_stats["mixed_slab_forwards"] - f0 if mixed
        else admitted)}
    # the dense kernels: dense_per_layer x L a forward, each decode step
    # and each admission (a mixed slab's forwards are not predicted here);
    # the decode kernel's: each SLOTS-row decode step (an admission's
    # 16-token prompt pads to a 32-token bucket: the prefill kernel)
    per_fwd = dense_per_layer(engine.cfg) * L
    dense = qd.quant_dense.launches
    prof = window["profile"]
    busy = prof.get("device_busy_ms")
    return {"tokens": toks, "logprobs": lps,
            "dense_launches": dense,
            "predicted_dense_launches": None if mixed and per_fwd else
            per_fwd * (steps + admitted),
            "decode_launches": qd.quant_dense.decode_launches,
            "predicted_decode_launches": None if mixed and per_fwd else
            per_fwd * steps,
            "device_dense_ms_per_step": (prof["quant_dense_ms"]
                                         / prof["steps"] if busy else None),
            "dense_share": prof["quant_dense_ms"] / busy if busy else None,
            "ms_per_step": window["decode_ms_per_step"],
            "rows": len(prompts), "replays": engine.graph_replays - r0,
            "decode_steps": steps, "launches": launches,
            "predicted_launches": predicted,
            "device_ms_per_step": (prof["device_busy_ms"] / prof["steps"]
                                   if prof.get("device_busy_ms") else None),
            "device_idle_share": prof.get("device_idle_share"),
            "device_busy_ms": prof.get("device_busy_ms"),
            "profile_steps": prof["steps"],
            "profile_wall_ms": prof["wall_ms"],
            "profile_kernels": prof["kernels"],
            "profile_top": prof["top"][:3]}


def graph_batching(torch, name: str, mixed: bool = False,
                   kv_cache_dtype: str | None = None) -> dict:
    """8-slot batching of ``name`` (``mixed``: the mixed dispatch over
    int8 pages, whose decode half is the graph; ``kv_cache_dtype``: over
    float8 pages), full width, the decode step replayed and eager (one
    engine each, the same weights): see the module docstring, item 8."""
    from distributed_inference_demo_tpu_torch.models.loader import \
        load_or_init
    from distributed_inference_demo_tpu_torch.models.registry import \
        get_model_config
    from distributed_inference_demo_tpu_torch.ops.sampling import \
        SamplingParams
    from distributed_inference_demo_tpu_torch.runtime.batching import \
        ContinuousBatchingEngine

    cfg = get_model_config(name)
    params = load_or_init(name, cfg, None, seed=0, device="cuda")
    prompts = [p[:16] for p in _batch_prompts(cfg.vocab_size)]
    kw = (dict(mixed_token_budget=MIXED_BUDGET, kv_dtype="int8",
               decode_block=MIXED_DECODE_BLOCK) if mixed else
          dict(kv_cache_dtype=kv_cache_dtype))
    attr = ("int8_launches" if mixed else
            "fp8_launches" if kv_cache_dtype else "launches")
    kind = ("mixed int8" if mixed else
            f"batching over {kv_cache_dtype} pages" if kv_cache_dtype
            else "batching")
    out = {"path": f"{name} {kind}, {SLOTS} slots", "model": name}

    def engine_for(p, flag):
        return ContinuousBatchingEngine(
            cfg, p, max_seq=MAX_SEQ, max_batch=SLOTS,
            sampling=SamplingParams(greedy=True),
            kv_block_tokens=BLOCK_TOKENS, prefill_chunk=PREFILL_CHUNK,
            device="cuda", cuda_graph=flag, **kw)

    for key, flag in (("graph", True), ("eager", False)):
        with engine_for(params, flag) as eng:
            out[key] = _graph_batching_side(torch, eng, prompts, mixed,
                                            attr)
    if cfg.quantization != "none":
        # the 1500-token prompt's first 1008 tokens: 15 chunks of 64, one
        # of 40, then 8 decode steps
        with engine_for(dequantized_twin(cfg, params), False) as twin_eng:
            pass
        out["twin_check"] = quant_paged_twin_check(
            torch, eng, twin_eng,
            _batch_prompts(cfg.vocab_size)[BATCH_PROMPTS.index(1500)][:1008])
        del twin_eng
    del eng
    g, e = out["graph"], out["eager"]
    out["bits_equal"] = ((g.pop("tokens"), g.pop("logprobs"))
                         == (e.pop("tokens"), e.pop("logprobs")))
    out["speedup"] = e["ms_per_step"] / g["ms_per_step"]
    _check(out["bits_equal"], f"{out['path']}: replayed greedy tokens or "
           "logprobs differ from the eager step's")
    for side in (g, e):
        _check(side["launches"] == side["predicted_launches"],
               f"{out['path']}: paged launches {side['launches']}, "
               f"predicted {side['predicted_launches']}")
        _check(side["predicted_dense_launches"] is None
               or side["dense_launches"] == side["predicted_dense_launches"],
               f"{out['path']}: dense launches {side['dense_launches']}, "
               f"predicted {side['predicted_dense_launches']}")
        _check(side["predicted_decode_launches"] is None
               or side["decode_launches"]
               == side["predicted_decode_launches"],
               f"{out['path']}: decode-kernel launches "
               f"{side['decode_launches']}, predicted "
               f"{side['predicted_decode_launches']}")
    _check(g["replays"] == g["decode_steps"] > 0 and e["replays"] == 0,
           f"{out['path']}: replays {g['replays']} of "
           f"{g['decode_steps']} steps")
    del params
    torch.cuda.empty_cache()
    return out


def phase_graph(torch) -> dict:
    t0 = time.perf_counter()
    paths = [graph_plain(torch, SERVE_MODEL, f32=True),
             graph_batching(torch, SERVE_MODEL),
             graph_batching(torch, SERVE_MODEL, mixed=True),
             graph_batching(torch, "gemma-2b"),
             graph_plain(torch, "bloom3b")]
    return {"phase": "graph", "device": torch.cuda.get_device_name(0),
            "paths": paths, "seconds": time.perf_counter() - t0}


# ---------------------------------------------------------------------------
# phase 9: int8 / int4 weights through the dequantizing dense kernel
# ---------------------------------------------------------------------------

def quant_cases():
    """(model, weight, K, N, M, bits, dtype): TinyLlama's seven matmul
    weights at M = 1 (plain decode), 8 (8-slot decode) and 256 (a mixed
    slab's rows), int8 and int4, bf16 and f32 activations, and at M = 16
    and 17 (the last decode-kernel row count and the first prefill one)
    in bf16; w_up at M = QUANT_LONG_ROWS (a long prompt's chunk) in bf16;
    and llama-3-8b's four weight shapes where its int8 plain serve runs
    them, M = 1 (decode) and PROMPT_LEN (the prefill), int8, bf16 (also
    mixtral-8x7b's), and mixtral-tpu-1b's four the same way."""
    import torch
    from distributed_inference_demo_tpu_torch.models.registry import \
        get_model_config

    def shapes(cfg):
        H, I = cfg.hidden_size, cfg.intermediate_size
        q, kv = cfg.num_heads * cfg.head_dim, cfg.num_kv_heads * cfg.head_dim
        return (("wq", H, q), ("wk", H, kv), ("wv", H, kv), ("wo", q, H),
                ("w_gate", H, I), ("w_up", H, I), ("w_down", I, H))

    tiny = shapes(get_model_config(SERVE_MODEL))
    out = [(SERVE_MODEL, name, k, n, m, bits, dtype)
           for name, k, n in tiny
           for m in QUANT_ROWS for bits in (8, 4)
           for dtype in (torch.bfloat16, torch.float32)]
    out += [(SERVE_MODEL, name, k, n, m, bits, torch.bfloat16)
            for name, k, n in tiny for m in QUANT_BOUNDARY_ROWS
            for bits in (8, 4)]
    out += [(SERVE_MODEL, name, k, n, QUANT_LONG_ROWS, bits, torch.bfloat16)
            for name, k, n in tiny if name == "w_up" for bits in (8, 4)]

    def distinct(weights):
        """One row per distinct shape, named by every weight of it (wq
        and wo, wk and wv, w_gate and w_up share theirs)."""
        rows, seen = [], {}
        for name, k, n in weights:
            if (k, n) in seen:
                rows[seen[(k, n)]][0] += f", {name}"
            else:
                seen[(k, n)] = len(rows)
                rows.append([name, k, n])
        return rows

    large = distinct(shapes(get_model_config(LARGE_MODEL)))
    out += [(LARGE_MODEL, name, k, n, m, 8, torch.bfloat16)
            for name, k, n in large for m in (1, PROMPT_LEN)]
    # mixtral-tpu-1b-int8's four shapes (an expert matrix is the MLP's
    # [H, I] / [I, H]; mixtral-8x7b's are llama-3-8b's four)
    out += [(MOE_MODEL, name, k, n, m, 8, torch.bfloat16)
            for name, k, n in distinct(shapes(get_model_config(MOE_MODEL)))
            for m in (1, PROMPT_LEN)]
    # the parallel phase: one tp=2 rank of llama-3-8b-int8, the column
    # slices at N / 2 (wq, wk, wv, w_gate, w_up), the row slices at K / 2
    # (wo, w_down; their scales stay whole)
    rows = {"wq", "wk", "wv", "w_gate", "w_up"}
    sliced = [(name, k, n // PAR_TP) if name in rows
              else (name, k // PAR_TP, n)
              for name, k, n in shapes(get_model_config(LARGE_MODEL))]
    out += [(LARGE_MODEL + "-tp2", name, k, n, m, 8, torch.bfloat16)
            for name, k, n in distinct(sliced) for m in (1, PROMPT_LEN)]
    return out


def quant_work(m, k, n, bits, elt):
    """(flops, bytes) of one product: x and y once, the codes and the
    scales once (int4: a scale per 64 input rows per column)."""
    scale_bytes = 4 * n * (1 if bits == 8 else k // 64)
    nbytes = m * k * elt + k * n * bits // 8 + scale_bytes + m * n * elt
    return 2 * m * k * n, nbytes


def _quant_instance(kernel: str, bits: int, m: int) -> tuple:
    """The template instance of ``kernel`` that a product of ``m`` rows
    launches: (name, template arguments)."""
    if kernel == "decode":
        return "quant_dense_decode_kernel", (bits, 1 if m <= 8 else 2)
    if kernel == "prefill":
        return "quant_dense_prefill_kernel", (bits,)
    return "quant_dense_kernel", (bits,)


def _ptxas_row(rows: list, name: str, args: tuple):
    """The ptxas row of one kernel instance, demangled or not."""
    demangled = f"{name}<{', '.join(map(str, args))}>"
    mangled = name + "I" + "".join(f"Li{a}E" for a in args) + "E"
    return next((r for r in rows if demangled in r["kernel"]
                 or mangled in r["kernel"]), None)


def sass_counts(torch, source: str) -> dict:
    """Conversion and tensor-core instructions in each kernel of the built
    ``source`` (``cuobjdump -sass``): I2F (integer to float), F2F and
    F2FP (float to float, bf16 packing), PRMT (byte permutes), HMMA /
    HGMMA (mma.sync / wgmma); I2FP (integer to float on the ALU pipe)
    too.  Kernel names as mangled in the library."""
    import re

    from torch.utils.cpp_extension import CUDA_HOME

    from distributed_inference_demo_tpu_torch.ops import _build
    tool = os.path.join(CUDA_HOME or "/usr/local/cuda", "bin", "cuobjdump")
    sass = subprocess.run([tool, "-sass", str(_build.build(source))],
                          capture_output=True, text=True, timeout=300,
                          check=True).stdout
    ops = ("I2F", "I2FP", "F2F", "F2FP", "PRMT", "HMMA", "HGMMA")
    out, fn = {}, None
    for ln in sass.splitlines():
        m = re.search(r"Function : (\S+)", ln)
        if m:
            fn = m.group(1)
            out[fn] = dict.fromkeys(ops, 0)
            continue
        m = re.search(r"\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9]*)[.\s]", ln)
        if fn and m and m.group(1) in ops:
            out[fn][m.group(1)] += 1
    return out


def cold_ms(torch, make, nbytes: int, fn) -> float:
    """Mean device time of ``fn(obj)`` over one captured pass through
    enough fresh objects ``make()`` (each ``nbytes``) to exceed COLD_BYTES,
    so that no call finds its weight in the 50 MB L2."""
    objs = [make() for _ in range(max(2, -(-COLD_BYTES // nbytes)))]
    fn(objs[0])
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with _graph_counters(torch) as counters, torch.cuda.graph(graph):
        for o in objs:
            fn(o)
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    end.synchronize()
    ms = start.elapsed_time(end) / len(objs)
    del graph, objs, counters
    return ms


def quant_decode_row_check(torch, weights) -> list:
    """Every row of an 8-row decode-kernel launch against the same row
    launched alone, bit for bit, at each distinct bf16 weight shape of
    the decode rows (TinyLlama's and llama-3-8b's)."""
    from distributed_inference_demo_tpu_torch.ops import quant_dense as qd

    gen = torch.Generator(device="cuda").manual_seed(3)
    out = []
    for (k, n, bits), wq in weights.items():
        x = torch.randn((8, k), generator=gen,
                        device="cuda").to(torch.bfloat16)
        y8 = qd.quant_dense(x, wq)
        equal = all(torch.equal(qd.quant_dense(x[r:r + 1], wq)[0], y8[r])
                    for r in range(8))
        out.append({"k": k, "n": n, "bits": bits, "rows": 8,
                    "splits": qd.decode_splits(
                        k, n, bits, torch.cuda.get_device_properties(0)
                        .multi_processor_count),
                    "bit_equal": equal})
    return out


def phase_quant_kernels(torch, ptxas: list) -> dict:
    """Each dense kernel against its plain version (x @ w.dequantize) on
    the same codes, at every quant_cases shape: the kernel and split count
    the routing picks, error, device ms warm (graph replayed on one
    weight) and cold (:func:`cold_ms`), eager ms, the plain version's ms,
    the library yardstick (torch.matmul over the weight dequantized
    beforehand, what the float model pays) warm and cold, the bound, the
    shares and the instance's registers and spills; then
    :func:`quant_decode_row_check` and the SASS counts."""
    from distributed_inference_demo_tpu_torch.ops import quant
    from distributed_inference_demo_tpu_torch.ops import quant_dense as qd

    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(0)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    cases, failures, weights = [], [], {}

    def copy_of(wq):
        return type(wq)(**{**vars(wq), "q": wq.q.clone(),
                           "scale": wq.scale.clone()})

    for model, name, k, n, m, bits, dtype in quant_cases():
        key = (k, n, bits)
        if key not in weights:
            w = torch.randn((k, n), generator=gen, device="cuda") * k ** -0.5
            weights[key] = (quant.quantize_array(w) if bits == 8
                            else quant.quantize_array4(w))
        wq = weights[key]
        x = torch.randn((m, k), generator=gen, device="cuda").to(dtype)
        dname = str(dtype).split(".")[-1]
        atol, rtol = TOL[dname]
        got = qd.quant_dense(x, wq)
        want = qd.quant_dense_plain(x, wq)
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs()
        ok = bool(torch.isfinite(got.float()).all()) and bool(
            (err <= atol + rtol * want.float().abs()).all())
        w_deq = wq.dequantize(dtype)
        lib_err = float((torch.matmul(x, w_deq).float()
                         - want.float()).abs().max())
        elt = x.element_size()
        flops, nbytes = quant_work(m, k, n, bits, elt)
        t_bytes = nbytes / PEAK_BYTES * 1e3
        t_ops = flops / PEAK_FLOPS[dname] * 1e3
        kernel = qd.route(m, dtype)
        instance, targs = _quant_instance(kernel, bits, m)
        ms = device_ms(torch, lambda: qd.quant_dense(x, wq))
        row = {"model": model, "weight": name, "k": k, "n": n, "m": m,
               "bits": bits, "dtype": dname, "kernel": kernel,
               "instance": f"{instance}<{', '.join(map(str, targs))}>",
               "splits": qd.splits_for(kernel, m, k, n, bits, sms),
               "max_abs_err": float(err.max()), "atol": atol, "rtol": rtol,
               "ok": ok, "ms": ms,
               "cold_ms": cold_ms(torch, lambda: copy_of(wq),
                                  wq.nbytes, lambda o: qd.quant_dense(x, o)),
               "eager_ms": eager_ms(torch, lambda: qd.quant_dense(x, wq)),
               "plain_ms": device_ms(torch,
                                     lambda: qd.quant_dense_plain(x, wq)),
               "library_ms": device_ms(torch,
                                       lambda: torch.matmul(x, w_deq)),
               "library_cold_ms": cold_ms(
                   torch, w_deq.clone,
                   w_deq.numel() * w_deq.element_size(),
                   lambda o: torch.matmul(x, o)),
               "library": "torch.matmul on the weight dequantized "
                          "beforehand",
               "library_max_abs_err": lib_err,
               "flops": flops, "bytes": nbytes,
               "bound_ms": max(t_bytes, t_ops),
               "bound_by": "bytes" if t_bytes >= t_ops else "operations"}
        row["roofline_share"] = row["bound_ms"] / ms
        row["roofline_share_cold"] = row["bound_ms"] / row["cold_ms"]
        pt = _ptxas_row(ptxas, instance, targs)
        row.update(registers=pt and pt["registers"],
                   spill_stores=pt and pt["spill_stores"],
                   spill_loads=pt and pt["spill_loads"])
        cases.append(row)
        if not ok:
            failures.append(f"quant_dense {model} {name} m={m} int{bits} "
                            f"{dname}: max err {row['max_abs_err']}")
        del x, got, want, w_deq
    decode_rows = quant_decode_row_check(torch, {
        key: wq for key, wq in weights.items()
        if any(c["k"] == key[0] and c["n"] == key[1] and c["bits"] == key[2]
               and c["kernel"] == "decode" for c in cases)})
    failures += [f"decode kernel rows differ from single-row launches at "
                 f"K={r['k']} N={r['n']} int{r['bits']}"
                 for r in decode_rows if not r["bit_equal"]]
    del weights
    torch.cuda.empty_cache()
    return {"phase": "quant_kernels", "device": torch.cuda.get_device_name(0),
            "cases": cases, "decode_row_bit_equal": decode_rows,
            "sass": sass_counts(torch, qd.SOURCE),
            "failures": failures, "seconds": time.perf_counter() - t0}


def _teacher_forced_logits(torch, params, cfg, seq, n_decode: int):
    """Logits of ``seq`` through ``stage_forward`` as the plain engine runs
    it (flash hook, KV cache): the prefill of all but the last
    ``n_decode`` tokens (its last position), then each of those tokens
    as a one-token decode step.  [n_decode + 1, vocab] f32."""
    import numpy as np

    from distributed_inference_demo_tpu_torch.models.base import (
        KVCache, StageSpec)
    from distributed_inference_demo_tpu_torch.models.decoder import \
        stage_forward
    from distributed_inference_demo_tpu_torch.ops.flash_attention import \
        make_flash_attn_impl

    L = cfg.num_layers
    spec, hook = StageSpec(0, 1, 0, L), make_flash_attn_impl()
    cache = KVCache.create(cfg, L, 1, len(seq), device="cuda")
    ids = torch.tensor([seq], device="cuda")
    n_pre = len(seq) - n_decode
    out = []
    with torch.no_grad():
        lg, cache = stage_forward(params, cfg, spec, ids[:, :n_pre], cache,
                                  torch.arange(n_pre, device="cuda")[None],
                                  hook, last_logits_only=True)
        out.append(lg[0, -1].float().cpu().numpy())
        for t in range(n_pre, len(seq)):
            lg, cache = stage_forward(params, cfg, spec, ids[:, t:t + 1],
                                      cache, torch.tensor([[t]],
                                                          device="cuda"),
                                      hook, last_logits_only=True)
            out.append(lg[0, -1].float().cpu().numpy())
    return np.stack(out)


def quant_twin_check(torch, cfg, params, n_decode: int = 8) -> dict:
    """Prefill (PROMPT_LEN tokens) and ``n_decode`` decode-step logits of
    the quantized model (the dense kernel) against its float twin, whose
    weights are the same codes dequantized to the model dtype, held to
    LOGIT_TOL_REL as the kernels' bf16 logit checks: the reference
    defines dense as exactly that product, so only the summation order
    differs."""
    import numpy as np

    from distributed_inference_demo_tpu_torch.ops import quant_dense as qd

    twin = dequantized_twin(cfg, params)
    seq = np.random.RandomState(11).randint(
        0, cfg.vocab_size, PROMPT_LEN + n_decode).tolist()
    launches = []

    def quantized():
        qd.quant_dense.launches = 0
        out = _teacher_forced_logits(torch, params, cfg, seq, n_decode)
        launches.append(qd.quant_dense.launches)
        return out

    lt, lq, routing = moe_pinned(
        cfg, lambda: _teacher_forced_logits(torch, twin, cfg, seq,
                                            n_decode), quantized)
    del twin
    torch.cuda.empty_cache()
    per_fwd = dense_per_layer(cfg) * cfg.num_layers
    return _twin_verdict(cfg, lq, lt, len(seq), launches[0],
                         per_fwd * (1 + n_decode), routing)


def dequantized_twin(cfg, params):
    """The float twin of quantized ``params``: every quantized leaf
    dequantized to the model dtype, the rest shared."""
    from distributed_inference_demo_tpu_torch.models.base import StageParams
    from distributed_inference_demo_tpu_torch.ops import quant

    return StageParams(
        layers={k: v.dequantize(cfg.dtype) if isinstance(
            v, quant.AnyQuantized) else v for k, v in params.layers.items()},
        embed=params.embed, final_norm=params.final_norm,
        lm_head=params.lm_head)


def _twin_verdict(cfg, lq, lt, tokens: int, launches: int,
                  predicted: int, routing=None) -> dict:
    """The quantized model's teacher-forced logits ``lq`` against its
    twin's ``lt`` ([n_decode + 1, vocab]: the prefill's last position,
    then each decode step's), held to LOGIT_TOL_REL of the twin's largest
    logit (an MoE model's with the twin's expert choices,
    :func:`moe_pinned`); the dense kernel's launches against the
    routing's prediction."""
    import numpy as np

    scale = max(1.0, float(np.abs(lt).max()))
    err = np.abs(lq - lt).max(axis=1)
    res = {"tokens": tokens, "decode_steps": len(err) - 1,
           "dense_launches": launches,
           "predicted_dense_launches": predicted,
           "logit_max_abs_err": float(err.max()),
           "prefill_logit_max_abs_err": float(err[0]),
           "logit_scale": scale, "logit_tol": LOGIT_TOL_REL * scale,
           "argmax_agreement": int((lq.argmax(1) == lt.argmax(1)).sum()),
           "argmax_agreement_of": len(err), "routing": routing}
    _check(launches == predicted, f"twin check: {launches} dense launches, "
           f"predicted {predicted}")
    _check(bool(np.isfinite(lq).all()), "quantized logits not finite")
    _check(res["logit_max_abs_err"] <= res["logit_tol"],
           f"{cfg.quantization} logits differ from the dequantized twin's by "
           f"{res['logit_max_abs_err']} (> {LOGIT_TOL_REL} x {scale})")
    return res


def quant_paged_twin_check(torch, engine, twin_engine, seq,
                           n_decode: int = 8) -> dict:
    """As :func:`quant_twin_check`, through the batching engine's paged
    forward (:func:`_paged_logits`: ``prefill_chunk``-token chunks, then
    one-token decode steps): closed ``engine`` on the quantized weights
    against closed ``twin_engine`` on their dequantized twin."""
    from distributed_inference_demo_tpu_torch.ops import quant_dense as qd

    cfg = engine.cfg
    launches = []

    def quantized():
        qd.quant_dense.launches = 0
        out = _paged_logits(torch, engine, seq, n_decode)
        launches.append(qd.quant_dense.launches)
        return out

    lt, lq, routing = moe_pinned(
        cfg, lambda: _paged_logits(torch, twin_engine, seq, n_decode),
        quantized)
    chunks = -(-(len(seq) - n_decode) // engine.prefill_chunk)
    per_fwd = dense_per_layer(cfg) * cfg.num_layers
    return _twin_verdict(cfg, lq, lt, len(seq), launches[0],
                         per_fwd * (chunks + n_decode), routing)


def quant_serve_large(torch, name: str, twin_layers: int | None = None
                      ) -> dict:
    """Plain serve of ``name`` (llama-3-8b bf16 or int8, mixtral-8x7b-int8)
    at b=1, full width, the decode step replayed: init peak memory (an
    init that does not fit the card fails with its peak), ms/token,
    device ms a step and the dense kernel's share of it; a quantized
    model's logits against its dequantized twin, at ``twin_layers`` (a
    depth cut at full width, initialized from the same seed) where the
    twin of the full depth does not fit."""
    import numpy as np

    from distributed_inference_demo_tpu_torch.models.loader import \
        load_or_init
    from distributed_inference_demo_tpu_torch.models.registry import \
        get_model_config
    from distributed_inference_demo_tpu_torch.ops.sampling import \
        SamplingParams
    from distributed_inference_demo_tpu_torch.runtime.engine import \
        InferenceEngine

    import gc

    cfg = get_model_config(name)
    out = {"path": f"{name} plain serve, b=1", "model": name}
    if twin_layers is not None:
        cut = cfg.replace(num_layers=twin_layers)
        params = load_or_init(name, cut, None, seed=0, device="cuda")
        out["twin_check"] = quant_twin_check(torch, cut, params)
        out["twin_check"]["depth_cut"] = (
            f"num_layers {twin_layers} of {cfg.num_layers}, full width, "
            "seed 0")
        del params
    # what earlier phases left allocated is not this init's
    gc.collect()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    try:
        params = load_or_init(name, cfg, None, seed=0, device="cuda")
        torch.cuda.synchronize()
    except torch.cuda.OutOfMemoryError as e:
        raise AssertionError(
            f"{name} does not fit the card: init peak "
            f"{torch.cuda.max_memory_allocated() - base} bytes over "
            f"{base} allocated before it") from e
    out.update(init_s=time.perf_counter() - t0,
               params_bytes=params.nbytes(),
               allocated_before_init_bytes=base,
               init_peak_mem_bytes=torch.cuda.max_memory_allocated() - base)
    if cfg.quantization != "none" and twin_layers is None:
        out["twin_check"] = quant_twin_check(torch, cfg, params)
    prompt = np.random.RandomState(1).randint(
        0, cfg.vocab_size, (1, PROMPT_LEN)).tolist()
    eng = InferenceEngine(cfg, params, max_seq=MAX_SEQ,
                          sampling=SamplingParams(greedy=True),
                          device="cuda")
    side = _graph_plain_side(torch, eng, prompt)
    side.pop("logprobs")
    out.update(side)
    _check(side["dense_launches"] == side["predicted_dense_launches"],
           f"{name}: dense launches {side['dense_launches']}, predicted "
           f"{side['predicted_dense_launches']}")
    _check(side["decode_launches"] == side["predicted_decode_launches"],
           f"{name}: decode-kernel launches {side['decode_launches']}, "
           f"predicted {side['predicted_decode_launches']}")
    _check(side["replays"] == side["decode_steps"] > 0,
           f"{name}: replays {side['replays']} of {side['decode_steps']}")
    del eng, params
    torch.cuda.empty_cache()
    return out


def _hf_state_dict(torch, cfg, seed: int) -> dict:
    """A llama-family HF state dict at ``cfg``'s full width, random bf16
    from ``seed`` (made on the card, held on the host)."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    H, I = cfg.hidden_size, cfg.intermediate_size
    q, kv = cfg.num_heads * cfg.head_dim, cfg.num_kv_heads * cfg.head_dim

    def rnd(*shape, scale, shift=0.0):
        return (torch.randn(shape, generator=g, device="cuda") * scale
                + shift).to(torch.bfloat16).cpu()

    sd = {"model.embed_tokens.weight": rnd(cfg.vocab_size, H, scale=0.02),
          "model.norm.weight": rnd(H, scale=0.05, shift=1.0),
          "lm_head.weight": rnd(cfg.vocab_size, H, scale=H ** -0.5)}
    for i in range(cfg.num_layers):
        p = f"model.layers.{i}."
        sd.update({
            p + "input_layernorm.weight": rnd(H, scale=0.05, shift=1.0),
            p + "post_attention_layernorm.weight": rnd(H, scale=0.05,
                                                       shift=1.0),
            p + "self_attn.q_proj.weight": rnd(q, H, scale=H ** -0.5),
            p + "self_attn.k_proj.weight": rnd(kv, H, scale=H ** -0.5),
            p + "self_attn.v_proj.weight": rnd(kv, H, scale=H ** -0.5),
            p + "self_attn.o_proj.weight": rnd(H, q, scale=q ** -0.5),
            p + "mlp.gate_proj.weight": rnd(I, H, scale=H ** -0.5),
            p + "mlp.up_proj.weight": rnd(I, H, scale=H ** -0.5),
            p + "mlp.down_proj.weight": rnd(H, I, scale=I ** -0.5)})
    return sd


def write_safetensors(torch, path: str, tensors: dict) -> None:
    """The safetensors format: an 8-byte little-endian header length, the
    JSON header (dtype, shape, data offsets from the end of the header),
    the data; the header padded with spaces to 8 bytes."""
    import struct
    names = list(tensors)
    header, off = {"__metadata__": {"format": "pt"}}, 0
    for n in names:
        t = tensors[n]
        size = t.numel() * t.element_size()
        header[n] = {"dtype": {"torch.bfloat16": "BF16",
                               "torch.float32": "F32"}[str(t.dtype)],
                     "shape": list(t.shape), "data_offsets": [off,
                                                              off + size]}
        off += size
    hb = json.dumps(header).encode()
    hb += b" " * (-len(hb) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(hb)))
        f.write(hb)
        for n in names:
            t = tensors[n].contiguous().reshape(-1)
            t.view(torch.uint8).numpy().tofile(f)


def quant_loader_check(torch) -> dict:
    """``serve --model tinyllama-1.1b-int8 --checkpoint DIR``: a
    full-width TinyLlama HF state dict (random bf16 from a seed) written
    as two safetensors shards, served through the CLI's params resolution
    (``load_or_init``); the served codes and every other leaf bit-equal
    to ``maybe_quantize(params_from_state_dict(...))`` of the same
    tensors in memory; one greedy request over HTTP."""
    import tempfile

    import numpy as np

    from distributed_inference_demo_tpu_torch import cli
    from distributed_inference_demo_tpu_torch.models.loader import \
        params_from_state_dict
    from distributed_inference_demo_tpu_torch.models.registry import \
        get_model_config
    from distributed_inference_demo_tpu_torch.ops import quant
    from distributed_inference_demo_tpu_torch.ops import quant_dense as qd
    from distributed_inference_demo_tpu_torch.runtime.http_server import \
        InferenceHTTPServer

    name = SERVE_MODEL + "-int8"
    cfg = get_model_config(name)
    sd = _hf_state_dict(torch, cfg, seed=5)
    keys = list(sd)
    half = keys.index(f"model.layers.{cfg.num_layers // 2}.input_layernorm"
                      ".weight")
    out = {"path": f"serve --model {name} --checkpoint DIR", "model": name}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_ckpt_") as d:
        t0 = time.perf_counter()
        for i, part in enumerate((keys[:half], keys[half:])):
            write_safetensors(torch,
                              f"{d}/model-0000{i + 1}-of-00002.safetensors",
                              {k: sd[k] for k in part})
        out["write_s"] = time.perf_counter() - t0
        args = cli._serve_parser().parse_args(
            ["--model", name, "--checkpoint", d, "--greedy", "--max-seq",
             str(MAX_SEQ), "--http-port", "0"])
        t0 = time.perf_counter()
        _, engine = cli.build_engine(args)
        torch.cuda.synchronize()
        out["load_s"] = time.perf_counter() - t0
    want = quant.maybe_quantize(params_from_state_dict(sd, cfg, "cuda"), cfg)
    del sd
    same = True
    for part in ("layers", "embed", "final_norm", "lm_head"):
        got, exp = getattr(engine.params, part), getattr(want, part)
        same &= sorted(got) == sorted(exp)
        for k, v in exp.items():
            g = got[k]
            if isinstance(v, quant.AnyQuantized):
                same &= (type(g) is type(v) and torch.equal(g.q, v.q)
                         and torch.equal(g.scale, v.scale))
            else:
                same &= (g.dtype == v.dtype and torch.equal(g, v))
    out["codes_bit_equal"] = bool(same)
    del want
    torch.cuda.empty_cache()
    _check(out["codes_bit_equal"], "the checkpoint's served parameters "
           "differ from maybe_quantize(params_from_state_dict(...))")
    server = InferenceHTTPServer(engine, "127.0.0.1", 0, model_name=name,
                                 default_max_new=NEW_TOKENS)
    server.start()
    try:
        prompt = np.random.RandomState(1).randint(
            0, cfg.vocab_size, (1, PROMPT_LEN)).tolist()
        qd.quant_dense.launches = 0
        code, body = _post(server.port, {"prompt_ids": prompt,
                                         "max_new_tokens": NEW_TOKENS})
        _check(code == 200, f"checkpoint request: HTTP {code}")
        toks = json.loads(body)["tokens"]
        _check(np.asarray(toks).shape == (1, NEW_TOKENS),
               f"checkpoint tokens shape {np.asarray(toks).shape}")
        out.update(tokens=toks[0], dense_launches=qd.quant_dense.launches)
        _check(qd.quant_dense.launches > 0, "the checkpoint's request "
               "launched no dense kernel")
    finally:
        server.shutdown()
    del engine
    torch.cuda.empty_cache()
    return out


def phase_quant(torch) -> dict:
    """``-int8`` / ``-int4`` configs end to end (see the module
    docstring, item 9)."""
    t0 = time.perf_counter()
    out = {"phase": "quant", "device": torch.cuda.get_device_name(0)}
    for key, run in (
            ("int8_plain", lambda: graph_plain(torch, SERVE_MODEL + "-int8")),
            ("int8_batching",
             lambda: graph_batching(torch, SERVE_MODEL + "-int8")),
            ("int4_plain", lambda: graph_plain(torch, SERVE_MODEL + "-int4")),
            ("llama3_8b_int8",
             lambda: quant_serve_large(torch, LARGE_MODEL + "-int8")),
            ("llama3_8b_bf16", lambda: quant_serve_large(torch, LARGE_MODEL)),
            ("loader", lambda: quant_loader_check(torch))):
        t1 = time.perf_counter()
        out[key] = run()
        out[key]["seconds"] = time.perf_counter() - t1
    out["seconds"] = time.perf_counter() - t0
    return out


# ---------------------------------------------------------------------------
# phase 10: mixtral, the top-k MoE MLP
# ---------------------------------------------------------------------------

def phase_moe(torch) -> dict:
    """Mixtral end to end (see the module docstring, item 10)."""
    t0 = time.perf_counter()
    out = {"phase": "moe", "device": torch.cuda.get_device_name(0)}
    dense_twin = MOE_MODEL + "-dense"
    for key, run in (
            ("serve", lambda: phase_serve_model(torch, MOE_MODEL,
                                                long_prompt=True)),
            ("graph", lambda: graph_plain(torch, MOE_MODEL)),
            ("dense_serve", lambda: phase_serve_model(torch, dense_twin,
                                                      long_prompt=True)),
            ("dense_graph", lambda: graph_plain(torch, dense_twin)),
            ("batching", lambda: phase_batching(torch, MOE_MODEL, f32=None)),
            ("graph_batching", lambda: graph_batching(torch, MOE_MODEL)),
            ("int8_plain", lambda: graph_plain(torch, MOE_MODEL + "-int8")),
            ("large_int8", lambda: quant_serve_large(
                torch, MOE_LARGE, twin_layers=MOE_TWIN_LAYERS))):
        t1 = time.perf_counter()
        out[key] = run()
        out[key]["seconds"] = time.perf_counter() - t1
    # device ms a decode step, the MoE model over its dense twin (the same
    # active FLOPs a token; every expert's weights read)
    out["moe_over_dense_device_ms"] = (
        out["graph"]["graph"]["device_ms_per_step"]
        / out["dense_graph"]["graph"]["device_ms_per_step"])
    for key, want in (("int8_plain", 224), ("large_int8", 896)):
        side = out[key]["graph"] if key == "int8_plain" else out[key]
        _check(side["dense_per_forward"] == want,
               f"{key}: {side['dense_per_forward']} dense launches a "
               f"forward, expected {want}")
    out["seconds"] = time.perf_counter() - t0
    return out


# ---------------------------------------------------------------------------
# phase 11: the KV options: InferenceEngine's prefix pool, float8 pages
# ---------------------------------------------------------------------------

def _kv_prompts(vocab: int):
    """KV_PROMPTS prompts [[...]]: one KV_PREFIX-token shared prefix (a
    system prompt) and PREFILL_CHUNK tokens of each prompt's own."""
    import numpy as np
    rng = np.random.RandomState(11)
    shared = rng.randint(0, vocab, KV_PREFIX).tolist()
    return [[shared + rng.randint(0, vocab, PREFILL_CHUNK).tolist()]
            for _ in range(KV_PROMPTS)]


def _timed_prefill(torch, engine, prompt):
    """One seeded prefill on the engine's batch-1 state (seed from the
    pool, the rest chunked, store), host clock with the card
    synchronized: (seconds, seeded tokens, last logits f32)."""
    import numpy as np
    ids_np = np.asarray(prompt)
    ids, st = engine._ids(ids_np), engine._state(1)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    start, logits = engine._seeded_prefill(ids_np, ids, st)
    torch.cuda.synchronize()
    return time.perf_counter() - t0, start, logits.float().cpu().numpy()


def _codes_twin_logits(torch, plain, prompt, bits: int):
    """The last logits of the pool-less engine's prefill of ``prompt``
    with its first KV_PREFIX K/V columns replaced by their own quantized
    codes (int8 or int4), dequantized: what a warm prefill over a pool of
    those codes computes, through the cold path."""
    from distributed_inference_demo_tpu_torch.models.base import KVCache
    from distributed_inference_demo_tpu_torch.ops.quant import \
        quantize_kv_pages
    ids, st = plain._ids(prompt), plain._state(1)
    _, cache = plain._run_prefill(
        ids[:, :KV_PREFIX], KVCache(st.cache.keys, st.cache.values, 0))
    for t in (st.cache.keys, st.cache.values):
        cols = t[:, :, :, :KV_PREFIX]
        cols.copy_(quantize_kv_pages(cols, bits).dequantize().to(t.dtype))
    logits, _ = plain._run_prefill(ids, cache, KV_PREFIX)
    return logits.float().cpu().numpy()


def _pool_round_trip(torch, backend, prompt) -> bool:
    """The blocks the pool holds for ``prompt``, exported, adopted into
    free pages and exported again: bit-equal, every leaf."""
    import numpy as np

    from distributed_inference_demo_tpu_torch.ops.quant import (
        QuantizedKVPages, as_bytes)
    from distributed_inference_demo_tpu_torch.runtime.kvcache.device import (
        adopt_blocks_into_pages, export_blocks_from_pages)
    mgr = backend.mgr
    lease = mgr.match(np.asarray(prompt[0]))
    _check(lease is not None, "no stored blocks to export")
    ids = list(lease.block_ids)
    lease.release()
    pk, pv = backend.pool
    blocks = export_blocks_from_pages(pk, pv, ids)
    new = mgr.alloc(len(ids))
    _check(new is not None, "no free pages to adopt into")
    try:
        adopt_blocks_into_pages(pk, pv, *blocks, new)
        again = export_blocks_from_pages(pk, pv, new)
    finally:
        mgr.free(new)

    def leaves(x):
        return x.leaves() if isinstance(x, QuantizedKVPages) else [x]

    return all(torch.equal(as_bytes(a), as_bytes(b))
               for x, y in zip(blocks, again)
               for a, b in zip(leaves(x), leaves(y)))


def kv_prefix_pool(torch) -> dict:
    """TinyLlama's plain engine at full width (bf16, the flash kernel,
    CUDA graphs) with a prefix pool of KV_POOL_BLOCKS pages: KV_PROMPTS
    prompts sharing a KV_PREFIX-token prefix.  Prefill wall time cold
    (no pool), on a miss and warm (the prefix seeded, one 64-token chunk
    prefilled: L flash launches); the warm prefill's logits and a warm
    request's greedy tokens and logprobs against the cold engine's, bit
    for bit where the chunks align; an HTTP request, blocking and
    streamed, through ``InferenceHTTPServer``; int8 and int4 pools'
    warm logits against the bf16 pool's at the twin tolerance; each
    pool's blocks exported and adopted back bit-equal; hits, the pool's
    bytes and the leak invariant.  A quantized pool's warm logits are
    held to their twin's: the cold engine with its prefix K/V replaced by
    the same codes, dequantized."""
    import numpy as np

    from distributed_inference_demo_tpu_torch.models.decoder import \
        init_full_params
    from distributed_inference_demo_tpu_torch.models.registry import \
        get_model_config
    from distributed_inference_demo_tpu_torch.ops.flash_attention import \
        flash_attention
    from distributed_inference_demo_tpu_torch.ops.sampling import \
        SamplingParams
    from distributed_inference_demo_tpu_torch.runtime.engine import \
        InferenceEngine
    from distributed_inference_demo_tpu_torch.runtime.http_server import \
        InferenceHTTPServer

    cfg = get_model_config(SERVE_MODEL)
    L = cfg.num_layers
    params = init_full_params(
        torch.Generator(device="cuda").manual_seed(0), cfg, "cuda")
    greedy = SamplingParams(greedy=True)
    prompts = _kv_prompts(cfg.vocab_size)

    def engine_for(**kw):
        eng = InferenceEngine(cfg, params, max_seq=MAX_SEQ, sampling=greedy,
                              prefill_chunk=PREFILL_CHUNK, device="cuda",
                              **kw)
        eng.generate([[1, 2, 3]], 2)       # captures the decode graph
        return eng

    pool = dict(kv_cache_blocks=KV_POOL_BLOCKS, kv_block_tokens=BLOCK_TOKENS)
    cold_eng = engine_for()
    eng = engine_for(**pool)
    _check(eng.attn_backend == "flash", "the prefix engine's attention")
    out = {"path": f"{SERVE_MODEL} plain serve, b=1, prefix pool "
                   f"{KV_POOL_BLOCKS}x{BLOCK_TOKENS}tok",
           "prefix_tokens": KV_PREFIX, "suffix_tokens": PREFILL_CHUNK,
           "prefill_chunk": PREFILL_CHUNK}
    # the main path, counted from 0: a miss stores the prefix, then warm
    _reset_launches(flash_attention)
    miss_s, miss_start, _ = _timed_prefill(torch, eng, prompts[0])
    miss_flash = flash_attention.launches
    _reset_launches(flash_attention)
    warm_s, warm_start, warm_logits = _timed_prefill(torch, eng, prompts[1])
    warm_flash = flash_attention.launches
    warm2_s, _, _ = _timed_prefill(torch, eng, prompts[2])
    cold_s, _, cold_logits = _timed_prefill(torch, cold_eng, prompts[1])
    chunks = -(-(KV_PREFIX + PREFILL_CHUNK) // PREFILL_CHUNK)
    out.update(miss_prefill_s=miss_s, warm_prefill_s=warm_s,
               warm_prefill_2_s=warm2_s, cold_prefill_s=cold_s,
               cold_over_warm=cold_s / warm_s, miss_seeded=miss_start,
               warm_seeded=warm_start, miss_flash_launches=miss_flash,
               warm_flash_launches=warm_flash)
    _check(miss_start == 0 and warm_start == KV_PREFIX,
           f"seeded {miss_start} then {warm_start} tokens")
    _check(miss_flash == chunks * L and warm_flash == L,
           f"flash launches {miss_flash} (miss) and {warm_flash} (warm), "
           f"predicted {chunks * L} and {L}")
    scale = max(1.0, float(np.abs(cold_logits).max()))
    err = float(np.abs(warm_logits - cold_logits).max())
    out["warm_logits"] = {"bit_equal": bool(np.array_equal(warm_logits,
                                                           cold_logits)),
                          "max_abs_err": err, "logit_scale": scale,
                          "logit_tol": LOGIT_TOL_REL * scale}
    _check(err <= LOGIT_TOL_REL * scale,
           f"warm prefill logits differ from the cold ones by {err}")
    # a warm request's greedy tokens and logprobs, generate and HTTP
    warm = eng.generate(prompts[3], NEW_TOKENS, logprobs=True)
    cold = cold_eng.generate(prompts[3], NEW_TOKENS, logprobs=True)
    out["warm_tokens_bit_equal"] = bool(
        np.array_equal(warm.tokens, cold.tokens)
        and np.array_equal(warm.logprobs, cold.logprobs))
    out["warm_token_agreement"] = int((warm.tokens == cold.tokens).sum())
    server = InferenceHTTPServer(eng, "127.0.0.1", 0, model_name=SERVE_MODEL,
                                 default_max_new=NEW_TOKENS)
    server.start()
    try:
        code, text = _post(server.port, {"prompt_ids": prompts[4],
                                         "max_new_tokens": NEW_TOKENS})
        _check(code == 200, f"HTTP {code}")
        served = json.loads(text)["tokens"][0]
        code, text = _post(server.port, {"prompt_ids": prompts[5],
                                         "max_new_tokens": NEW_TOKENS,
                                         "stream": True})
        _check(code == 200, f"HTTP {code} (stream)")
        streamed = [json.loads(ln)["tokens"][0] for ln in text.splitlines()
                    if ln.strip()]
    finally:
        server.shutdown()
    out["http_tokens_equal_cold"] = [
        served == cold_eng.generate(prompts[4], NEW_TOKENS).tokens[0]
        .tolist(),
        streamed == cold_eng.generate(prompts[5], NEW_TOKENS).tokens[0]
        .tolist()]
    snap = eng.kv_cache.snapshot()
    mgr = eng.kv_cache.mgr
    out.update(kvcache={k: snap[k] for k in (
        "hits", "misses", "stores", "stored_blocks", "blocks_used",
        "blocks_total", "device_resident_bytes", "capacity_bytes",
        "page_dtype")},
        seed_bytes=2 * L * cfg.num_kv_heads * KV_PREFIX * cfg.head_dim * 2,
        no_leak=mgr.used_blocks == mgr.tree.block_count)
    _check(snap["hits"] == KV_PROMPTS - 1 and out["no_leak"],
           f"prefix pool: {snap}")
    _check(all(out["http_tokens_equal_cold"]),
           "served tokens differ from the cold engine's")
    round_trip = {"bf16": _pool_round_trip(torch, eng.kv_cache, prompts[1])}
    # int8 / int4 pools: the warm prefill's logits against their twin's
    # (the cold engine over the same codes, dequantized) and against the
    # bf16 pool's: held for int8; int4's quantization error alone is
    # over the twin tolerance on these random weights, so it is reported
    for kv_dtype, bits in (("int8", 8), ("int4", 4)):
        q_eng = engine_for(kv_dtype=kv_dtype, **pool)
        _timed_prefill(torch, q_eng, prompts[0])
        s, start, logits = _timed_prefill(torch, q_eng, prompts[1])
        twin = _codes_twin_logits(torch, cold_eng, prompts[1], bits)
        twin_scale = max(1.0, float(np.abs(twin).max()))
        twin_err = float(np.abs(logits - twin).max())
        err = float(np.abs(logits - warm_logits).max())
        out[kv_dtype] = {"warm_prefill_s": s, "seeded": start,
                         "twin_logit_max_abs_err": twin_err,
                         "twin_logit_tol": LOGIT_TOL_REL * twin_scale,
                         "logit_max_abs_err_vs_bf16_pool": err,
                         "logit_tol_vs_bf16_pool": LOGIT_TOL_REL * scale,
                         "held_vs_bf16_pool": kv_dtype == "int8",
                         "capacity_bytes":
                         q_eng.kv_cache.snapshot()["capacity_bytes"]}
        _check(start == KV_PREFIX
               and twin_err <= LOGIT_TOL_REL * twin_scale,
               f"{kv_dtype} pool: seeded {start}, logits differ from its "
               f"twin's by {twin_err}")
        _check(kv_dtype != "int8" or err <= LOGIT_TOL_REL * scale,
               f"int8 pool: logits differ from the bf16 pool's by {err}")
        round_trip[kv_dtype] = _pool_round_trip(torch, q_eng.kv_cache,
                                                prompts[1])
        del q_eng
    out["export_adopt_bit_equal"] = round_trip
    _check(all(round_trip.values()), f"export/adopt: {round_trip}")
    del eng, cold_eng, params
    torch.cuda.empty_cache()
    return out


def phase_kvcache(torch) -> dict:
    """The engines' KV options at TinyLlama's full width: the plain
    engine's prefix pool (:func:`kv_prefix_pool`); 8-slot batching over
    float8 pages, served as phase 4 (the e4m3 instances' launches against
    the routing, bf16 logits against the gather path, f32 tokens equal
    the gather path's) and as phase 8 (replayed and eager bit-equal, ms a
    step, idle share); the plain engine over a float8 cache (plain
    attention: ms/token, device ms a step)."""
    from distributed_inference_demo_tpu_torch.models.loader import \
        load_or_init
    from distributed_inference_demo_tpu_torch.models.registry import \
        get_model_config
    from distributed_inference_demo_tpu_torch.ops.sampling import \
        SamplingParams
    from distributed_inference_demo_tpu_torch.runtime.engine import \
        InferenceEngine

    t0 = time.perf_counter()
    out = {"phase": "kvcache", "device": torch.cuda.get_device_name(0)}
    fp8 = "float8_e4m3fn"

    def fp8_plain():
        import numpy as np
        cfg = get_model_config(SERVE_MODEL)
        params = load_or_init(SERVE_MODEL, cfg, None, seed=0, device="cuda")
        eng = InferenceEngine(cfg, params, max_seq=MAX_SEQ,
                              sampling=SamplingParams(greedy=True),
                              kv_cache_dtype=fp8, device="cuda")
        _check(eng.attn_backend == "plain", "a float8 cache's attention")
        prompt = np.random.RandomState(1).randint(
            0, cfg.vocab_size, (1, PROMPT_LEN)).tolist()
        side = _graph_plain_side(torch, eng, prompt)
        del side["logprobs"], eng, params
        torch.cuda.empty_cache()
        return {"path": f"{SERVE_MODEL} plain serve, b=1, {fp8} cache",
                "attn_backend": "plain", "graph": side}

    for key, run in (
            ("prefix_pool", lambda: kv_prefix_pool(torch)),
            ("batching", lambda: phase_batching(
                torch, SERVE_MODEL, f32="gather", kv_cache_dtype=fp8,
                f32_layers=FP8_F32_LAYERS)),
            ("graph_batching", lambda: graph_batching(
                torch, SERVE_MODEL, kv_cache_dtype=fp8)),
            ("fp8_plain", fp8_plain)):
        t1 = time.perf_counter()
        out[key] = run()
        out[key]["seconds"] = time.perf_counter() - t1
    out["seconds"] = time.perf_counter() - t0
    return out


# ---------------------------------------------------------------------------
# phase 12: the serving surface (tokenizer, text, stop strings, telemetry,
# the generate / classify / chat commands)
# ---------------------------------------------------------------------------

# the surface phase: a crafted sentencepiece model of TinyLlama's vocab
# size, prompts of whole-word pieces (one token a word): a short one, a
# long one, and the batching phase's eight lengths
SURFACE_PIECES = 32000
SURFACE_SHORT_WORDS = 24
SURFACE_LONG_WORDS = LONG_PROMPT_LEN
# the sampled profiler's mean decode step against torch.profiler's device
# ms a step over the same window: at least this share
PROFILER_SYNC_SHARE = 0.8
# the decode windows' cadences: every step, none, the default
PROFILE_CADENCES = (1, 0, 64)


def surface_model_proto(seed: int = 0):
    """A SURFACE_PIECES-piece unigram sentencepiece model made here with
    ``sp_tokenizer.build_model_proto``: ``<unk>``, ``<s>``, ``</s>``, the
    256 ``<0xXX>`` byte pieces, the letters with and without the word
    marker, and pieces drawn from ``seed``: words (with the marker) and
    word endings (without).  Returns (the
    model's bytes, the words)."""
    import numpy as np

    from distributed_inference_demo_tpu_torch.sp_tokenizer import (
        BYTE, CONTROL, NORMAL, UNKNOWN, build_model_proto)
    rng = np.random.RandomState(seed)
    letters = "abcdefghijklmnopqrstuvwxyz"
    pieces = [("<unk>", 0.0, UNKNOWN), ("<s>", 0.0, CONTROL),
              ("</s>", 0.0, CONTROL), ("▁", -13.0, NORMAL)]
    pieces += [(f"<0x{b:02X}>", 0.0, BYTE) for b in range(256)]
    for c in letters:
        pieces += [(c, -12.0, NORMAL), ("▁" + c, -11.0, NORMAL)]
    seen = {p for p, _, _ in pieces}
    words = []
    while len(pieces) < SURFACE_PIECES:
        w = "".join(letters[i] for i in rng.randint(0, 26, rng.randint(2, 9)))
        piece = "▁" + w if rng.rand() < 0.7 else w
        if piece in seen:
            continue
        seen.add(piece)
        # a word piece outscores a word piece plus any other piece, so
        # each word of the list is one token
        word = piece.startswith("▁")
        pieces.append((piece, -float(rng.uniform(1.0, 2.0) if word
                                     else rng.uniform(15.0, 20.0)), NORMAL))
        if word:
            words.append(w)
    return build_model_proto(pieces), words


def _post_stream(port: int, body: dict, headers=None):
    """POST /generate, reading the answer as it arrives: (status, the
    seconds to its first line, its text)."""
    import http.client

    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=600)
    try:
        t0 = time.perf_counter()
        conn.request("POST", "/generate", body=json.dumps(body),
                     headers={"Content-Type": "application/json",
                              **(headers or {})})
        resp = conn.getresponse()
        first = resp.readline()
        ttft = time.perf_counter() - t0
        return resp.status, ttft, (first + resp.read()).decode()
    finally:
        conn.close()


def _get_text(port: int, path: str):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                timeout=60) as resp:
        return resp.status, resp.read().decode()


def _exposition(text: str) -> dict:
    """Prometheus text exposition -> {series with labels: value}."""
    out = {}
    for ln in text.splitlines():
        if ln and not ln.startswith("#"):
            key, val = ln.rsplit(" ", 1)
            out[key] = float(val)
    return out


def _unique_stop(text: str, n: int = 4) -> int:
    """The first position p >= len(text) // 2 where text[p:p + n] is
    letters and spaces and occurs nowhere else in ``text``."""
    for p in range(len(text) // 2, len(text) - n + 1):
        s = text[p:p + n]
        if all(c.isascii() and (c.isalpha() or c == " ") for c in s) \
                and text.find(s) == p:
            return p
    raise AssertionError(f"no stop string in the output {text!r}")


def phase_surface(torch, model: str = SERVE_MODEL) -> dict:
    """The serving surface at TinyLlama's full width (bf16, random weights
    from seed 0): a crafted 32000-piece sentencepiece model written to a
    file and loaded as ``--tokenizer`` loads it; an
    ``InferenceHTTPServer`` over a plain engine and one over an 8-slot
    batching engine, both with that tokenizer; (a) text prompts equal
    their ids, ``text`` their decode, stream deltas the blocking text,
    short and long; (b) a stop string taken mid-output cuts blocking and
    streamed answers alike (also with logprobs), with no slot or page
    left held; (c) ``/metrics`` counters equal what the phase sent and
    received; (d) traced requests' spans within their e2e; (e) one
    ``/timeline`` record per request; (f) ``/debugz`` and
    ``/sketch``; (g) the sampled profiler's decode step against
    torch.profiler's; (h) the paged kernels' launches against the
    routing's prediction for 8 concurrent text requests, the flash
    kernel's for the plain server's; (i) ``generate``, ``classify`` and
    ``chat --ids`` as subprocesses; (j) encode ms, TTFT text against
    ids, tok/s of the 8 text requests, the telemetry-on ms a step."""
    import shutil
    import tempfile
    import threading

    import numpy as np

    from distributed_inference_demo_tpu_torch import cli
    from distributed_inference_demo_tpu_torch.models.loader import \
        load_or_init
    from distributed_inference_demo_tpu_torch.models.registry import \
        get_model_config
    from distributed_inference_demo_tpu_torch.ops import \
        paged_attention as pa
    from distributed_inference_demo_tpu_torch.ops.flash_attention import \
        flash_attention
    from distributed_inference_demo_tpu_torch.ops.sampling import \
        SamplingParams
    from distributed_inference_demo_tpu_torch.runtime.batching import \
        ContinuousBatchingEngine
    from distributed_inference_demo_tpu_torch.runtime.engine import \
        InferenceEngine
    from distributed_inference_demo_tpu_torch.runtime.http_server import \
        InferenceHTTPServer
    from distributed_inference_demo_tpu_torch.telemetry import profiling
    from distributed_inference_demo_tpu_torch.telemetry import slo
    from distributed_inference_demo_tpu_torch.telemetry.flightrecorder \
        import get_flight_recorder

    t_phase = time.perf_counter()
    cfg = get_model_config(model)
    L = cfg.num_layers
    greedy = SamplingParams(greedy=True)
    out = {"phase": "surface", "device": torch.cuda.get_device_name(0),
           "model": model, "slots": SLOTS, "block_tokens": BLOCK_TOKENS,
           "prefill_chunk": PREFILL_CHUNK, "new_tokens": NEW_TOKENS}
    # the phase's own ledgers: sketch, profiler, compile ledger, timelines
    profiling.reset_observatory()
    slo.set_slo_ledger(None)
    repo = os.path.dirname(os.path.abspath(__file__))
    tmp = tempfile.mkdtemp(prefix="chip_smoke_surface_")
    procs = []
    servers = {}
    batching = None
    try:
        # ---- the tokenizer, written and loaded as --tokenizer does ----
        blob, words = surface_model_proto()
        tok_path = os.path.join(tmp, "tokenizer.model")
        with open(tok_path, "wb") as f:
            f.write(blob)
        tok = cli._load_tokenizer(tok_path)
        _check(tok.vocab_size() == cfg.vocab_size == SURFACE_PIECES,
               f"tokenizer vocab {tok.vocab_size()}")
        rng = np.random.RandomState(5)
        short = " ".join(rng.choice(words, SURFACE_SHORT_WORDS))
        long_text = " ".join(rng.choice(words, SURFACE_LONG_WORDS))
        batch_texts = [" ".join(rng.choice(words, n)) for n in BATCH_PROMPTS]
        encode_ms = []
        for _ in range(5):
            t0 = time.perf_counter()
            long_ids = tok.encode(long_text)
            encode_ms.append((time.perf_counter() - t0) * 1e3)
        short_ids = tok.encode(short)
        _check(len(short_ids) == SURFACE_SHORT_WORDS
               and len(long_ids) == SURFACE_LONG_WORDS,
               f"prompt tokens {len(short_ids)}, {len(long_ids)}")
        out.update(tokenizer_pieces=tok.vocab_size(),
                   tokenizer_bytes=len(blob),
                   prompt_tokens={"short": len(short_ids),
                                  "long": len(long_ids)},
                   encode_ms_long=sorted(encode_ms)[2])

        # ---- the CLI's generate and classify, in their own processes
        # (they build their own engines on the same seed), started now
        # and read before any timed part of the phase ----
        csv_texts = [" ".join(rng.choice(words, 20 + i)) for i in range(4)]
        csv_path = os.path.join(tmp, "rows.csv")
        with open(csv_path, "w") as f:
            f.write("".join(f"{t},{lab}\n" for t, lab in
                            zip(csv_texts, ("yes", "no", "yes", "no"))))
        label_ids = [int(tok.token_to_id("▁" + w)) for w in words[:2]]
        common = [sys.executable, "-m", "distributed_inference_demo_tpu_torch"]
        engine_flags = ["--model", model, "--tokenizer", tok_path,
                        "--max-seq", str(MAX_SEQ), "--greedy"]
        for argv in ([*common, "generate", *engine_flags, "--prompt", short,
                      "--max-new-tokens", str(NEW_TOKENS)],
                     [*common, "classify", *engine_flags, "--dataset",
                      csv_path, "--label-token-ids",
                      ",".join(map(str, label_ids))]):
            procs.append(subprocess.Popen(argv, cwd=repo, text=True,
                                          stdout=subprocess.PIPE,
                                          stderr=subprocess.PIPE))

        # ---- the engines and servers ----
        params = load_or_init(model, cfg, None, seed=0, device="cuda")
        plain = InferenceEngine(cfg, params, max_seq=MAX_SEQ,
                                sampling=greedy, device="cuda")
        batching = ContinuousBatchingEngine(
            cfg, params, max_seq=MAX_SEQ, max_batch=SLOTS, sampling=greedy,
            kv_block_tokens=BLOCK_TOKENS, prefill_chunk=PREFILL_CHUNK,
            device="cuda")
        _check(plain.attn_backend == "flash"
               and batching.attn_backend == "auto", "attention backends")
        for name, eng in (("plain", plain), ("batching", batching)):
            servers[name] = InferenceHTTPServer(
                eng, "127.0.0.1", 0, tokenizer=tok, model_name=model,
                default_max_new=NEW_TOKENS)
            servers[name].start()
        port = {k: s.port for k, s in servers.items()}
        metrics0 = _exposition(_get_text(port["batching"], "/metrics")[1])
        # what the phase sends: blocking 200s, their tokens, and the
        # batching server's requests (each one an engine request)
        sent = {"blocking_200": 0, "generated_tokens": 0, "batching": 0}
        lock = threading.Lock()

        def call(kind, body, headers=None):
            """One request; the parsed JSON (blocking) or lines (stream)."""
            code, ttft, text = _post_stream(port[kind], body, headers)
            _check(code == 200, f"{kind} {body.get('stream')}: HTTP {code}")
            lines = [json.loads(ln) for ln in text.splitlines() if ln.strip()]
            with lock:
                sent["batching"] += kind == "batching"
                if not body.get("stream"):
                    sent["blocking_200"] += 1
                    if "stop" not in body:
                        sent["generated_tokens"] += sum(
                            len(r) for r in lines[0]["tokens"])
            return (lines if body.get("stream") else lines[0]), ttft

        # warm each path once: captures, allocator, first launches
        for kind in port:
            call(kind, {"prompt": short, "max_new_tokens": 2})

        # ---- (a) text prompts: the plain server counts its flash
        # launches from zero (every prompt here is >= 16 tokens) ----
        _reset_launches(flash_attention)
        plain_prefills = 0
        texts = {}
        for kind in ("plain", "batching"):
            for name, text, ids in (("short", short, short_ids),
                                    ("long", long_text, long_ids)):
                body = {"prompt": text, "max_new_tokens": NEW_TOKENS}
                if kind == "batching":
                    # the later requests all see the same cached prefix
                    call(kind, body)
                blk, _ = call(kind, body)
                by_ids, _ = call(kind, {"prompt_ids": [ids],
                                        "max_new_tokens": NEW_TOKENS})
                lines, _ = call(kind, dict(body, stream=True))
                plain_prefills += 3 * (kind == "plain")
                toks = blk["tokens"][0]
                _check(toks == by_ids["tokens"][0],
                       f"{kind} {name}: text and ids prompts differ")
                _check(blk["text"] == [tok.decode(toks)],
                       f"{kind} {name}: text is not decode(tokens)")
                _check([ln["tokens"][0] for ln in lines if ln["tokens"]]
                       == toks, f"{kind} {name}: streamed tokens")
                _check("".join(ln["text"][0] for ln in lines)
                       == blk["text"][0], f"{kind} {name}: stream deltas")
                texts[(kind, name)] = (toks, blk["text"][0])
        flash_launches = flash_attention.launches
        _check(flash_launches == L * plain_prefills,
               f"flash launches {flash_launches}, predicted "
               f"{L * plain_prefills}")
        out["text_prompts"] = {
            f"{k}_{n}": {"tokens": t, "chars": len(x)}
            for (k, n), (t, x) in texts.items()}

        # ---- (b) stop strings: a substring from mid-output of the
        # greedy run with no stop ----
        stops = {}
        for kind in ("plain", "batching"):
            toks, text = texts[(kind, "short")]
            p = _unique_stop(text)
            stop = text[p:p + 4]
            body = {"prompt": short, "max_new_tokens": NEW_TOKENS,
                    "stop": stop}
            got = {}
            for mode in ("blocking", "stream", "blocking_lp", "stream_lp"):
                b = dict(body, stream=mode.startswith("stream"),
                         logprobs=mode.endswith("_lp"))
                r, _ = call(kind, b)
                final = r[-1] if b["stream"] else r
                cut = ("".join(ln["text"][0] for ln in r[:-1])
                       if b["stream"] else final["text"][0])
                got[mode] = (final["tokens"][0], cut,
                             final["stop_reason"][0],
                             final.get("logprobs", [None])[0])
                _check(cut == text[:p] and final["stop_reason"] == ["stop"],
                       f"{kind} {mode}: stop cut {cut!r}, want {text[:p]!r}")
                _check(final["tokens"][0] == toks[:len(final["tokens"][0])],
                       f"{kind} {mode}: stopped tokens not a prefix")
            _check(got["blocking"][:3] == got["stream"][:3]
                   == got["blocking_lp"][:3] == got["stream_lp"][:3],
                   f"{kind}: blocking and streamed stops differ")
            _check(got["blocking_lp"][3] == got["stream_lp"][3]
                   and len(got["blocking_lp"][3]) == len(got["blocking"][0]),
                   f"{kind}: logprobs of the stopped answers differ")
            stops[kind] = {"stop": stop, "cut_at": p, "chars": len(text),
                           "tokens_kept": len(got["blocking"][0]),
                           "tokens_run": len(toks)}
        # a stop ends the stream early: the scheduler frees the slot
        # within a step, and every page is free or an evictable leaf
        t_end = time.monotonic() + 60
        while batching.stats()["active_slots"] and time.monotonic() < t_end:
            time.sleep(0.005)
        _check(batching.stats()["active_slots"] == 0, "a stopped slot held")
        stops["no_page_leak"] = _no_page_leak(batching)
        _check(stops["no_page_leak"], "a stopped request leaked pages")
        out["stop"] = stops

        # ---- (d) traced requests, blocking and streamed ----
        _get_text(port["batching"], "/trace")             # drain
        trace_ids = {}
        for stream in (False, True):
            tid = f"{0x5eed0 + stream:x}"
            call("batching", {"prompt": short, "max_new_tokens": NEW_TOKENS,
                              "stream": stream},
                 headers={"X-DWT-Trace-Id": tid, "X-DWT-Tenant": "surface"})
            trace_ids[int(tid, 16)] = stream

        # ---- (i) the CLI: generate and classify (started above), chat
        # --ids against the running plain server ----
        results = []
        for proc in procs:
            stdout, stderr = proc.communicate(timeout=600)
            _check(proc.returncode == 0,
                   f"{proc.args[3]} exited {proc.returncode}: "
                   f"{stderr[-2000:]}")
            results.append(json.loads(stdout.strip().splitlines()[-1]))
        gen, cls = results
        _check(gen["tokens"] == [texts[("plain", "short")][0]],
               "generate's tokens differ from the server's")
        want_labels = [int(plain.classify([tok.encode(t)], label_ids)[0])
                       for t in csv_texts]
        _check(cls["predictions"] == want_labels,
               f"classify {cls['predictions']}, engine {want_labels}")
        chat_ids = ",".join(map(str, short_ids))
        chat = subprocess.run(
            [*common, "chat", "--url", f"http://127.0.0.1:{port['plain']}",
             "--ids", "--max-new-tokens", str(NEW_TOKENS)],
            cwd=repo, text=True, capture_output=True, timeout=300,
            input=f"{chat_ids}\n/quit\n")
        _check(chat.returncode == 0 and texts[("plain", "short")][1]
               in chat.stdout, f"chat: {chat.returncode} {chat.stderr[-500:]}")
        out["cli"] = {"generate_tokens": len(gen["tokens"][0]),
                      "generate_tok_s": gen["tokens_per_second"],
                      "classify_predictions": cls["predictions"],
                      "classify_accuracy": cls["accuracy"],
                      "chat_chars": len(chat.stdout)}

        # ---- (j) TTFT, a text prompt against the same prompt's ids,
        # streamed, on the plain server ----
        ttft = {"text": [], "ids": []}
        for _ in range(3):
            for key, b in (("text", {"prompt": long_text}),
                           ("ids", {"prompt_ids": [long_ids]})):
                _, t = call("plain", dict(b, max_new_tokens=4, stream=True))
                ttft[key].append(t)
        out["ttft_long_s"] = {k: sorted(v)[1] for k, v in ttft.items()}

        # ---- (h) the main path: 8 concurrent text requests on the
        # batching server, kernel counts from zero ----
        batching.reset_stats()
        flight = get_flight_recorder()
        flight.clear()
        _reset_launches(pa.paged_flash_attention, pa.paged_prefill_attention,
                        flash_attention)
        results = [None] * len(batch_texts)

        def one(i):
            results[i], _ = call("batching", {"prompt": batch_texts[i],
                                              "max_new_tokens": NEW_TOKENS})

        threads = [threading.Thread(target=one, args=(i,))
                   for i in range(len(batch_texts))]
        t0 = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=900)
        wall = time.perf_counter() - t0
        _check(all(r is not None and len(r["tokens"][0]) == NEW_TOKENS
                   for r in results), "a text request did not complete")
        launches = {"paged_decode": pa.paged_flash_attention.launches,
                    "paged_prefill": pa.paged_prefill_attention.launches}
        admits = [(e["prompt_len"], e["prefix_reused"])
                  for e in flight.snapshot() if e["kind"] == "batch_admit"]
        predicted = predicted_paged_launches(batching, admits, L)
        _check(launches == predicted and min(launches.values()) > 0,
               f"paged launches {launches}, routing predicts {predicted}")
        _check(flash_attention.launches == 0, "the flash kernel ran")
        _check(sorted(a for a, _ in admits)
               == sorted(len(tok.encode(t)) for t in batch_texts),
               f"admissions {admits}")
        out["text_batch"] = {"prompt_tokens": list(BATCH_PROMPTS),
                             "wall_s": wall,
                             "tok_s": len(batch_texts) * NEW_TOKENS / wall,
                             "launches": launches,
                             "predicted_launches": predicted,
                             "decode_steps":
                                 batching.loop_stats["device_loop_steps"]}
        out.update(launches=launches, flash_launches=flash_launches)

        # a request's timeline closes on the scheduler thread just after
        # its answer is released: wait for the last ones
        t_end = time.monotonic() + 30
        while (len(slo.get_slo_ledger().recent(1024)) < sent["batching"]
               and time.monotonic() < t_end):
            time.sleep(0.005)

        # ---- (c) /metrics: what the phase sent and received ----
        code, text = _get_text(port["batching"], "/metrics")
        _check(code == 200, f"/metrics: HTTP {code}")
        metrics = _exposition(text)
        _check(all(k.startswith("dwt_") for k in metrics),
               "a series outside dwt_*")

        def delta(key):
            return metrics.get(key, 0.0) - metrics0.get(key, 0.0)

        slo_requests = sum(v - metrics0.get(k, 0.0) for k, v in
                           metrics.items()
                           if k.startswith("dwt_slo_requests_total{"))
        counters = {
            "http_generate_200": delta(
                'dwt_http_requests_total{route="/generate",code="200"}'),
            "generated_tokens": delta("dwt_http_generated_tokens_total"),
            "slo_requests": slo_requests,
            "batching_completed": metrics.get(
                "dwt_batching_completed_requests_total")}
        _check(counters["http_generate_200"] == sent["blocking_200"]
               and counters["generated_tokens"] == sent["generated_tokens"]
               and counters["slo_requests"] == sent["batching"]
               and counters["batching_completed"] == len(batch_texts),
               f"metrics {counters}, sent {sent}")
        out["metrics"] = {"series": len(metrics), "counters": counters,
                          "sent": dict(sent)}

        # ---- (e) /timeline: one record per request, ttft <= e2e ----
        code, text = _get_text(port["batching"], "/timeline?n=1024")
        recent = json.loads(text)["recent"]
        _check(code == 200 and len(recent) == sent["batching"],
               f"timeline: {len(recent)} records, {sent['batching']} sent")
        _check(all(r["ttft_s"] <= r["e2e_s"] for r in recent),
               "a timeline with ttft > e2e")
        e2e = {int(r["trace_id"], 16): r["e2e_s"] for r in recent
               if r["trace_id"]}

        # ---- (d) the traced requests' spans ----
        code, text = _get_text(port["batching"], "/trace")
        spans = [e for e in json.loads(text)["traceEvents"]
                 if e["ph"] == "X"]
        for tid in trace_ids:
            mine = {e["name"]: e for e in spans
                    if int(e["args"]["trace_id"], 16) == tid}
            _check(sorted(mine) == ["engine.decode", "engine.prefill"],
                   f"trace {tid:x}: spans {sorted(mine)}")
            _check(all(e["dur"] <= e2e[tid] * 1e6 + 1
                       for e in mine.values()),
                   f"trace {tid:x}: a span longer than its request")
        out["trace"] = {"traced_requests": len(trace_ids),
                        "spans": len(spans)}

        # ---- (f) /debugz and /sketch ----
        code, text = _get_text(port["batching"], "/debugz")
        debugz = json.loads(text)
        _check(code == 200 and {"flight", "backend", "postmortem"}
               <= set(debugz), f"/debugz: {code} {sorted(debugz)}")
        c1, sketch1 = _get_text(port["batching"], "/sketch")
        c2, sketch2 = _get_text(port["batching"], "/sketch")
        sketch = json.loads(sketch1)
        _check(c1 == c2 == 200 and sketch1 == sketch2,
               "/sketch: two GETs differ")
        _check(sketch["prompt_tokens"]["count"] == sent["batching"],
               f"sketch counts {sketch['prompt_tokens']['count']} prompts, "
               f"{sent['batching']} sent")
        out["sketch_requests"] = sketch["requests"]

        # ---- (g) the sampled profiler syncs the card: the same decode
        # window at every cadence, the profiler rebuilt from the knob; its
        # snapshot is read when the host-timed steps end, before
        # torch.profiler starts (which slows the steps it records) ----
        prompts = [tok.encode(t) for t in batch_texts]
        windows = {}
        sig = profiling.dispatch_signature("paged_step", batch=SLOTS,
                                           chunk=1, kv_dtype="bf16")
        for n in PROFILE_CADENCES:
            os.environ["DWT_PROFILE_SAMPLE_N"] = str(n)
            profiling.reset_observatory()
            batching._prof = profiling.get_profiler()
            timed = {}
            w = decode_window(torch, batching, prompts, on_timed=lambda: (
                timed.update(batching._prof.snapshot().get(sig, {}))))
            whole = batching._prof.snapshot().get(sig, {})
            prof = w["profile"]
            dev = (prof["device_busy_ms"] / prof["steps"]
                   if prof.get("device_busy_ms") else None)
            windows[n] = {"decode_ms_per_step": w["decode_ms_per_step"],
                          "device_ms_per_step": dev,
                          "device_idle_share": prof["device_idle_share"],
                          "sampled_steps": timed.get("samples", 0),
                          "sampled_mean_ms": timed.get("mean_ms"),
                          "sampled_p50_ms": timed.get("p50_ms"),
                          # the profiled steps included
                          "sampled_steps_all": whole.get("samples", 0),
                          "sampled_mean_ms_all": whole.get("mean_ms")}
        sampled = windows[1]
        _check(sampled["device_ms_per_step"] is not None,
               "torch.profiler recorded no device time")
        _check(sampled["sampled_mean_ms"] >= PROFILER_SYNC_SHARE
               * sampled["device_ms_per_step"],
               f"sampled step {sampled['sampled_mean_ms']} ms against "
               f"{sampled['device_ms_per_step']} device ms")
        _check(windows[0]["sampled_steps"] == 0, "sample_n 0 sampled")
        out["profiler"] = {"signature": sig, "windows": {
            str(n): w for n, w in windows.items()},
            "sync_share": sampled["sampled_mean_ms"]
            / sampled["device_ms_per_step"]}
        out["telemetry_on_ms_per_step"] = windows[64]["decode_ms_per_step"]
        _check(_no_page_leak(batching), "the decode windows leaked pages")
    finally:
        os.environ.pop("DWT_PROFILE_SAMPLE_N", None)
        profiling.reset_observatory()
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        for s in servers.values():
            s.shutdown()
        if batching is not None:
            batching.close()
        shutil.rmtree(tmp, ignore_errors=True)
    torch.cuda.empty_cache()
    out["seconds"] = time.perf_counter() - t_phase
    return out


# ---------------------------------------------------------------------------

# ---------------------------------------------------------------------------
# phase 13: speculation on the card
# ---------------------------------------------------------------------------

def profile_rounds(torch, engine, prompt, rounds: int) -> dict:
    """torch.profiler over ``rounds`` rounds of a single-request
    speculative engine (one dispatch, the prompt prefilled before):
    device ms a round and the device's idle share."""
    import numpy as np
    ids = engine._ids(prompt)
    with engine._lock:
        st = engine._begin(np.asarray(prompt), ids, 0)
        torch.cuda.synchronize()
        with _device_profile() as prof:
            t0 = time.perf_counter()
            engine._dispatch(st, rounds)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
    out = _profile_summary(prof, wall_ms, {"rounds": rounds})
    _check(out["kernels"] > 0, "torch.profiler recorded no kernel")
    out["device_ms_per_round"] = out["device_busy_ms"] / rounds
    return out


def _spec_plain_side(torch, engine, prompt, flash_per_prefill: int) -> dict:
    """One single-request speculative engine: greedy tokens and stats
    over SPEC_NEW tokens, the flash kernel's launches (one prefill:
    ``flash_per_prefill``), the replays, ms per emitted token ((t(1 +
    SPEC_NEW) - t(1)) / SPEC_NEW, prefill cancelled out), and a profile
    of SPEC_ROUNDS_PROFILED rounds; and the tokens and stats of
    SPEC_EAGER_NEW tokens, which the eager twin runs (a host-bound
    eager round costs ~0.1 s)."""
    from distributed_inference_demo_tpu_torch.ops.flash_attention import \
        flash_attention
    res, stats = engine.generate(prompt, SPEC_EAGER_NEW)   # captures
    short = {"tokens": res.tokens[0].tolist(), "stats": vars(stats)}
    if not engine.cuda_graph:
        return {"short": short, "replays": engine.graph_replays}
    _reset_launches(flash_attention)
    r0 = engine.graph_replays
    res, stats = engine.generate(prompt, SPEC_NEW)
    flash, replays = flash_attention.launches, engine.graph_replays - r0
    _check(flash == flash_per_prefill,
           f"{flash} flash launches over one prefill, {flash_per_prefill} "
           "predicted")
    t_one = engine.generate(prompt, 1)[0].seconds
    t_many = engine.generate(prompt, 1 + SPEC_NEW)[0].seconds
    ms = (t_many - t_one) / SPEC_NEW * 1e3
    prof = profile_rounds(torch, engine, prompt, SPEC_ROUNDS_PROFILED)
    return {"tokens": res.tokens[0].tolist(), "short": short,
            "rounds": stats.rounds,
            "acceptance_rate": stats.acceptance_rate,
            "tokens_per_round": stats.tokens_per_round,
            "flash_launches": flash, "replays": replays,
            "ms_per_token": ms, "tok_s": 1e3 / ms,
            "device_ms_per_round": prof["device_ms_per_round"],
            "device_idle_share": prof["device_idle_share"],
            "profile_top": prof["top"][:3]}


def _teacher_logits(torch, engine, seq, plen: int, width: int):
    """The plain engine's logits at the last position of ``seq``, teacher
    forced: the prompt ``seq[:plen]`` prefilled, then the rest fed
    ``width`` tokens a forward (1: decode's M, K+1: the verify's)."""
    ids = torch.tensor([seq], device=engine.device)
    cache = engine.new_cache(1)
    logits, cache = engine._prefill(ids[:, :plen], cache)
    start = plen
    while start < len(seq):
        n = min(width, len(seq) - start)
        lg, cache = engine._fwd(ids[:, start:start + n], cache,
                                engine._positions(1, n, start), False)
        logits, start = lg[:, -1], start + n
    return logits[0].float().cpu().numpy()


def spec_partings(torch, engine, prompt, got, want) -> list:
    """Where a speculative engine's greedy stream ``got`` parts from the
    plain engine's ``want``: the first differing step, the top-two gap
    there on the plain path (``margin``), and the teacher-forced gap
    between the plain engine's logits fed one token a forward and fed
    SPEC_K + 1 a forward (the verify's row count).  A parting must sit at
    a near tie: the margin within LOGIT_TOL_REL of the largest logit."""
    import numpy as np
    if got == want:
        return []
    j = next(k for k in range(len(got)) if got[k] != want[k])
    seq = list(prompt) + want[:j]
    one = _teacher_logits(torch, engine, seq, len(prompt), 1)
    wide = _teacher_logits(torch, engine, seq, len(prompt), SPEC_K + 1)
    row = {"step": j, "margin": float(abs(one[want[j]] - one[got[j]])),
           "teacher_forced_gap": float(np.abs(one - wide).max()),
           "logit_tol": LOGIT_TOL_REL * max(1.0, float(np.abs(one).max()))}
    _check(row["margin"] <= row["logit_tol"],
           f"a speculative stream parts away from a near tie: {row}")
    return [row]


def _spec_batching_run(torch, engine, prompts, draft_layers: int = 0,
                       poll_k: bool = False) -> dict:
    """One counted run of a speculative batching engine from zero: the
    prompts together, NEW_TOKENS each, the paged kernels' launches
    against the routing's prediction (the draft's decode kernel L_d x
    (k + 1) a round of width k; the verify's prefill kernel L a round;
    admission: the serialized chunks and finals, or L a mixed slab
    forward), no page leaked in either pool.  Also the verify window:
    the counts read on the scheduler's thread between two dispatches,
    at the first iteration after every request is admitted, and again
    once all are done; in that window no admission runs, so the prefill
    kernel's launches are the verify's own, L a round
    (``verify_launches``), and the decode kernel's the draft steps'."""
    import threading

    from distributed_inference_demo_tpu_torch.ops import \
        paged_attention as pa
    from distributed_inference_demo_tpu_torch.ops.flash_attention import \
        flash_attention
    from distributed_inference_demo_tpu_torch.telemetry.flightrecorder \
        import get_flight_recorder

    attr = ("int8_launches" if engine.kv_dtype == "int8" else
            "fp8_launches" if engine.kv_cache_dtype is not None
            else "launches")
    engine.submit(list(range(16)), 2).wait(timeout=300)     # warm
    engine.reset_stats()
    flight = get_flight_recorder()
    flight.clear()
    _reset_launches(pa.paged_flash_attention, pa.paged_prefill_attention,
                    flash_attention)
    r0 = engine.graph_replays
    seen, polling = set(), [True]

    def poll():
        while polling[0]:
            seen.update(int(engine._spec_krow[i])
                        for i, r in enumerate(engine._slots) if r is not None)
            time.sleep(0.002)

    poller = threading.Thread(target=poll, daemon=True)
    if poll_k:
        poller.start()

    def counts():
        rbw = dict(engine.rounds_by_width)
        return {"paged_decode": getattr(pa.paged_flash_attention, attr),
                "paged_prefill": getattr(pa.paged_prefill_attention, attr),
                "rounds": sum(rbw.values()),
                "draft_steps": sum((k + 1) * n for k, n in rbw.items())}

    reqs, window = [], []
    sample_hbm = engine._sample_hbm

    def between_dispatches():
        # the top of a scheduler iteration: no dispatch in flight
        if (not window and len(reqs) == len(prompts)
                and all(len(r.tokens) or r.done.is_set() for r in reqs)
                and engine._adm is None and not engine._adms
                and not engine._pending and engine._queue.empty()):
            window.append(counts())
        sample_hbm()

    engine._sample_hbm = between_dispatches
    t0 = time.perf_counter()
    try:
        reqs.extend(engine.submit(p, NEW_TOKENS) for p in prompts)
        toks = [r.wait(timeout=900).tolist() for r in reqs]
    finally:
        polling[0] = False
        engine._sample_hbm = sample_hbm
    wall = time.perf_counter() - t0
    L = engine.cfg.num_layers
    rbw = dict(engine.rounds_by_width)
    rounds = sum(rbw.values())
    if engine.mixed_token_budget:
        admission = L * engine.chunk_stats["mixed_slab_forwards"]
    else:
        admits = [(e["prompt_len"], e["prefix_reused"])
                  for e in flight.snapshot() if e["kind"] == "batch_admit"]
        admission = predicted_paged_launches(engine, admits,
                                             L)["paged_prefill"]
    launches = {"paged_decode": getattr(pa.paged_flash_attention, attr),
                "paged_prefill": getattr(pa.paged_prefill_attention, attr)}
    predicted = {"paged_decode": draft_layers * sum(
                     (k + 1) * n for k, n in rbw.items()),
                 "paged_prefill": L * rounds + admission}
    stats = engine.stats()
    out = {"tokens": toks, "wall_s": wall,
           "tok_s": len(prompts) * NEW_TOKENS / wall,
           "launch_attr": attr, "launches": launches,
           "predicted_launches": predicted,
           "rounds_by_width": {str(k): n for k, n in sorted(rbw.items())},
           "graph_replays": engine.graph_replays - r0,
           "speculative": stats["speculative"],
           "device_loop": stats["device_loop"]}
    if poll_k:
        out["k_row_buckets_visited"] = sorted(seen)
    if engine.mixed_token_budget:
        out["mixed"] = stats["mixed"]
    _check(launches == predicted, f"paged launches {launches}, the "
           f"routing predicts {predicted}")
    _check(bool(window), "no scheduler iteration after the last admission")
    end = counts()
    w = {k: end[k] - window[0][k] for k in end}
    out["verify_window"] = w
    out["verify_launches"] = w["paged_prefill"]
    _check(w["rounds"] > 0 and w["paged_prefill"] == L * w["rounds"]
           and w["paged_decode"] == draft_layers * w["draft_steps"],
           f"verify window: launches {w}, the routing predicts {L} x "
           f"rounds prefill, {draft_layers} x draft steps decode")
    _check(flash_attention.launches == 0, "the flash kernel ran")
    out["no_page_leak"] = _no_page_leak(engine) and (
        engine._proposer != "draft"
        or engine._dmgr.free_blocks == engine._dmgr.num_blocks)
    _check(out["no_page_leak"], "pages leaked after the drain")
    return out


def _batch_partings(torch, engines, prompts, got, want) -> list:
    """Where a speculative batching stream parts from the plain batching
    engine's: the first differing step and the gap between the two
    tokens' logits there, teacher forced through the speculative
    engine's chunked path (``_paged_logits``); for the first parting
    also the gap between that path and the plain engine's one-token
    decode steps over the same tokens (host bound: one eager forward a
    token).  A parting must sit at a near tie (the margin within
    LOGIT_TOL_REL of the largest logit)."""
    import numpy as np
    out = []
    for i, (g, w) in enumerate(zip(got, want)):
        if g == w:
            continue
        j = next(k for k in range(min(len(g), len(w))) if g[k] != w[k])
        seq = prompts[i] + w[:j]
        ls = _paged_logits(torch, engines["spec"], seq, 0)[0]
        gap = None
        if not out:
            lp = _paged_logits(torch, engines["plain"], seq, j)[j]
            gap = float(np.abs(lp - ls).max())
        row = {"request": i, "step": j,
               "margin": float(abs(ls[w[j]] - ls[g[j]])),
               "teacher_forced_gap": gap,
               "logit_tol": LOGIT_TOL_REL * max(1.0,
                                                float(np.abs(ls).max()))}
        out.append(row)
        _check(row["margin"] <= row["logit_tol"],
               f"speculative batching parts away from a near tie: {row}")
    return out


def phase_speculative(torch, ptxas: list) -> dict:
    """Speculation at TinyLlama's full width (random bf16 weights, seed
    0), the draft SPEC_DRAFT (8 layers, hd 64, g = 4, TinyLlama's
    vocab), K = SPEC_K.  See the module docstring, item 13."""
    import contextlib
    import io

    import numpy as np

    from distributed_inference_demo_tpu_torch import cli
    from distributed_inference_demo_tpu_torch.models.decoder import \
        init_full_params
    from distributed_inference_demo_tpu_torch.models.loader import \
        load_or_init
    from distributed_inference_demo_tpu_torch.models.registry import \
        get_model_config
    from distributed_inference_demo_tpu_torch.ops import quant_dense as qd
    from distributed_inference_demo_tpu_torch.ops.sampling import \
        SamplingParams
    from distributed_inference_demo_tpu_torch.runtime.batching import \
        ContinuousBatchingEngine
    from distributed_inference_demo_tpu_torch.runtime.engine import \
        InferenceEngine
    from distributed_inference_demo_tpu_torch.runtime.http_server import \
        InferenceHTTPServer
    from distributed_inference_demo_tpu_torch.runtime.prompt_lookup import \
        PromptLookupEngine
    from distributed_inference_demo_tpu_torch.runtime.speculative import (
        SpeculativeBackend, SpeculativeEngine)

    t_phase = time.perf_counter()
    laps, t_lap = {}, [t_phase]

    def lap(name):
        now = time.perf_counter()
        laps[name], t_lap[0] = now - t_lap[0], now

    greedy = SamplingParams(greedy=True)
    cfg, dcfg = get_model_config(SERVE_MODEL), get_model_config(SPEC_DRAFT)
    Lt, Ld = cfg.num_layers, dcfg.num_layers
    out = {"phase": "speculative", "device": torch.cuda.get_device_name(0),
           "model": SERVE_MODEL, "draft": SPEC_DRAFT, "num_draft": SPEC_K,
           "new_tokens": SPEC_NEW,
           "ptxas": [r for r in ptxas if "64" in r["kernel"] and (
               "prefill" in r["kernel"] or "decode" in r["kernel"])]}
    params = load_or_init(SERVE_MODEL, cfg, None, seed=0, device="cuda")
    dparams = load_or_init(SPEC_DRAFT, dcfg, None, seed=0, device="cuda")
    prompt = np.random.RandomState(1).randint(
        0, cfg.vocab_size, PROMPT_LEN).tolist()
    span = np.random.RandomState(3).randint(0, cfg.vocab_size,
                                            SPEC_SPAN).tolist()
    rep = span * SPEC_REPEATS
    lap("weights")

    # ---- the single-request engines, graph and eager ----
    plain = InferenceEngine(cfg, params, max_seq=MAX_SEQ, sampling=greedy,
                            device="cuda")
    want = {p: plain.generate([q], SPEC_NEW).tokens[0].tolist()
            for p, q in (("draft", prompt), ("rep", rep))}
    t_one = plain.generate([prompt], 1).seconds
    t_many = plain.generate([prompt], 1 + SPEC_NEW).seconds
    out["plain_ms_per_token"] = (t_many - t_one) / SPEC_NEW * 1e3
    lap("plain_engine")
    kw = dict(max_seq=MAX_SEQ, sampling=greedy, num_draft=SPEC_K,
              device="cuda")
    plain_paths = {
        "draft": (lambda f: SpeculativeEngine(cfg, params, dcfg, dparams,
                                              cuda_graph=f, **kw),
                  prompt, want["draft"], Lt + Ld),
        "self_draft": (lambda f: SpeculativeEngine(cfg, params, cfg, params,
                                                   cuda_graph=f, **kw),
                       prompt, want["draft"], 2 * Lt),
        "prompt_lookup": (lambda f: PromptLookupEngine(
            cfg, params, cuda_graph=f, **kw), rep, want["rep"], Lt)}
    partings = {}
    for name, (make, p, w, flash) in plain_paths.items():
        res = {}
        for key, flag in (("graph", True), ("eager", False)):
            eng = make(flag)
            res[key] = _spec_plain_side(torch, eng, [p], flash)
            del eng
            lap(f"{name}_{key}")
        g, e = res["graph"], res["eager"]
        res["bits_equal"] = g["short"] == e["short"]
        _check(res["bits_equal"], f"{name}: replayed rounds differ from "
               "eager ones")
        _check(g["replays"] >= g["rounds"] > 0 and e["replays"] == 0,
               f"{name}: {g['replays']} replays, {g['rounds']} rounds")
        # TinyLlama as its own draft gives the draft-model engine's stream
        key = (str(p), str(g["tokens"]))
        if key not in partings:
            partings[key] = spec_partings(torch, plain, p, g["tokens"], w)
        res["partings"] = partings[key]
        lap(f"{name}_partings")
        res["greedy_agreement"] = sum(
            a == b for a, b in zip(g["tokens"], w)) / SPEC_NEW
        res["ms_per_token_vs_plain"] = (g["ms_per_token"]
                                        / out["plain_ms_per_token"])
        out[name] = res
    del plain
    lap("single_request_engines")
    # f32: the draft-model and prompt-lookup engines token-exact against
    # the plain engine (each on its own weights from seed 0), the target
    # at SPEC_F32_LAYERS of its layers, full width
    cfg32 = cfg.replace(dtype_name="float32", num_layers=SPEC_F32_LAYERS)
    dcfg32 = dcfg.replace(dtype_name="float32")
    out["single_request_f32_layers"] = SPEC_F32_LAYERS
    p32 = init_full_params(torch.Generator(device="cuda").manual_seed(0),
                           cfg32, "cuda")
    d32 = init_full_params(torch.Generator(device="cuda").manual_seed(0),
                           dcfg32, "cuda")
    plain32 = InferenceEngine(cfg32, p32, max_seq=MAX_SEQ, sampling=greedy,
                              device="cuda")
    for name, eng, p in (
            ("draft", SpeculativeEngine(cfg32, p32, dcfg32, d32, **kw),
             prompt),
            ("prompt_lookup", PromptLookupEngine(cfg32, p32, **kw), rep)):
        got = eng.generate([p], SPEC_NEW)[0].tokens[0].tolist()
        w = plain32.generate([p], SPEC_NEW).tokens[0].tolist()
        out[name]["f32_token_exact"] = got == w
        _check(got == w, f"{name} f32 greedy tokens differ from the plain "
               "engine's")
        del eng
    del plain32, p32, d32
    torch.cuda.empty_cache()
    lap("single_request_f32")

    # ---- serve --draft-model over HTTP: blocking and streamed ----
    def http_pair(backend, ids):
        server = InferenceHTTPServer(backend, "127.0.0.1", 0,
                                     model_name=SERVE_MODEL,
                                     default_max_new=NEW_TOKENS)
        server.start()
        try:
            code, text = _post(server.port, {"prompt_ids": [ids],
                                             "max_new_tokens": NEW_TOKENS})
            _check(code == 200, f"HTTP {code}")
            blocking = json.loads(text)["tokens"][0]
            code, text = _post(server.port, {"prompt_ids": [ids],
                                             "max_new_tokens": NEW_TOKENS,
                                             "stream": True})
            _check(code == 200, f"HTTP {code}")
            streamed = [json.loads(ln)["tokens"][0]
                        for ln in text.splitlines() if ln.strip()]
            stats = _get(server.port, "/stats")[1]
        finally:
            server.shutdown()
        return {"tokens": blocking, "streamed": streamed, "stats": stats}

    sargs = ["--model", SERVE_MODEL, "--max-seq", str(MAX_SEQ), "--greedy",
             "--http-port", "0"]
    args = cli._serve_parser().parse_args(sargs + ["--draft-model",
                                                   SPEC_DRAFT])
    backend = SpeculativeBackend(cli.build_spec_engine(args))
    serve = http_pair(backend, prompt)
    _check(serve.pop("streamed") == serve["tokens"],
           "streamed tokens differ from blocking")
    _check(serve["tokens"] == out["draft"]["graph"]["tokens"][:NEW_TOKENS],
           "serve --draft-model tokens differ from the engine's")
    _check(serve["stats"]["speculative"]["rounds"] > 0, "no /stats rounds")
    out["serve_draft_model"] = serve
    del backend
    lap("serve_draft_model")

    # ---- batching: 8 slots, the batching phase's 8 prompts ----
    prompts = _batch_prompts(cfg.vocab_size)
    # the replay-vs-eager and f32 checks: requests one after another, the
    # same schedule for both sides (an eager 8-slot round is host bound)
    seq1 = [prompts[BATCH_PROMPTS.index(150)]]

    def batching(c=cfg, p=params, **kw2):
        return ContinuousBatchingEngine(
            c, p, max_seq=MAX_SEQ, max_batch=SLOTS, sampling=greedy,
            kv_block_tokens=BLOCK_TOKENS, prefill_chunk=PREFILL_CHUNK,
            decode_block=MIXED_DECODE_BLOCK, num_draft=SPEC_K,
            device="cuda", **kw2)

    draft_kw = dict(draft_cfg=dcfg, draft_params=dparams)
    pld_kw = dict(prompt_lookup=True)
    mixed_kw = dict(mixed_token_budget=MIXED_BUDGET, kv_dtype="int8")
    modes = {"draft_serialized": (draft_kw, {}),
             "pld_serialized": (pld_kw, {}),
             "draft_mixed_int8": (draft_kw, mixed_kw),
             "pld_mixed_int8": (pld_kw, mixed_kw)}
    plain_toks = {}
    for key, extra in (("bf16", {}), ("int8_mixed", mixed_kw)):
        with batching(**extra) as eng:
            reqs = [eng.submit(p, NEW_TOKENS) for p in prompts]
            plain_toks[key] = [r.wait(timeout=900).tolist() for r in reqs]
        out.setdefault("plain_batching_engines", []).append(key)
    lap("plain_batching")
    # closed plain engines for the partings, and the partings computed
    batch, closed, partings = {}, {}, {}
    for name, (prop, extra) in modes.items():
        ref_key = "int8_mixed" if extra else "bf16"
        with batching(**prop, **extra) as eng:
            run = _spec_batching_run(
                torch, eng, prompts, poll_k=bool(extra),
                draft_layers=Ld if "draft_cfg" in prop else 0)
            lap(f"{name}_run")
            got, w = run["tokens"], plain_toks[ref_key]
            run["greedy_agreement"] = sum(
                sum(a == b for a, b in zip(g_, w_))
                for g_, w_ in zip(got, w)) / (len(prompts) * NEW_TOKENS)
            # both proposers give the same greedy streams on a page type:
            # a parting is computed once
            key = (ref_key, str(got))
            if got != w and key not in partings:
                if ref_key not in closed:
                    with batching(**extra) as closed[ref_key]:
                        pass
                partings[key] = _batch_partings(
                    torch, {"plain": closed[ref_key], "spec": eng}, prompts,
                    got, w)
            run["partings"] = partings.get(key, [])
            lap(f"{name}_partings")
            run.update(decode_window(torch, eng, prompts, steps=8,
                                     profiled=4))
            _check(_no_page_leak(eng), "cancelled requests leaked pages")
            lap(f"{name}_window")
            replayed = [eng.submit(p, SPEC_EAGER_NEW // 2).wait(
                timeout=900).tolist() for p in seq1]
        with batching(**prop, **extra, cuda_graph=False) as eager:
            eager_toks = [eager.submit(p, SPEC_EAGER_NEW // 2).wait(
                timeout=900).tolist() for p in seq1]
            _check(eager.graph_replays == 0, "the eager engine replayed")
        run["replay_equals_eager"] = replayed == eager_toks
        _check(run["replay_equals_eager"], f"{name}: replayed tokens "
               "differ from the eager rounds'")
        run.pop("tokens")
        batch[name] = run
        del eng, eager
        torch.cuda.empty_cache()
        lap(name)
    # float8 e4m3 pages: prompt lookup, serialized (the e4m3 verify
    # instances on the path)
    with batching(**pld_kw, kv_cache_dtype="float8_e4m3fn") as eng:
        run = _spec_batching_run(torch, eng, prompts)
    run.pop("tokens")
    batch["pld_serialized_fp8"] = run
    del eng, closed
    lap("pld_serialized_fp8")
    # f32, 8 concurrent requests: the draft model serialized and prompt
    # lookup mixed, each token-exact against a plain batching engine's
    # (the round logic), kernels and gather path alike (the attention);
    # the target at SPEC_F32_LAYERS of its layers, full width (the check
    # holds at any depth)
    cut32 = cfg32.replace(num_layers=SPEC_F32_LAYERS)
    p32 = init_full_params(torch.Generator(device="cuda").manual_seed(0),
                           cut32, "cuda")
    d32 = init_full_params(torch.Generator(device="cuda").manual_seed(0),
                           dcfg32, "cuda")
    mixed32 = dict(mixed_token_budget=MIXED_BUDGET)

    def together(**kw2):
        with batching(cut32, p32, **kw2) as eng:
            reqs = [eng.submit(p, NEW_TOKENS) for p in prompts]
            got = [r.wait(timeout=900).tolist() for r in reqs]
        return got

    want32 = together()
    f32 = {}
    for name, prop, disp, extra in (
            ("draft", dict(draft_cfg=dcfg32, draft_params=d32),
             "serialized", {}),
            ("prompt_lookup", pld_kw, "mixed", mixed32)):
        for backend in ("auto", "plain"):
            got = together(attn_backend=backend, **prop, **extra)
            parted = [(i, next(j for j, (a, b) in enumerate(zip(g, w))
                               if a != b))
                      for i, (g, w) in enumerate(zip(got, want32))
                      if g != w]
            key = f"{name}_{disp}" + ("_gather" if backend == "plain"
                                      else "")
            f32[key] = {"token_exact": not parted,
                        "partings": parted}
            _check(not parted, f"f32 {key}: tokens part from the "
                   f"plain batching engine's at (request, step) "
                   f"{parted}")
    out["batching_f32_vs_plain"] = dict(
        f32, layers=SPEC_F32_LAYERS, layers_of_the_model=cfg.num_layers)
    del p32, d32
    torch.cuda.empty_cache()
    out["batching"] = batch
    lap("batching_f32")

    # ---- serve --batch-slots 8 --prompt-lookup over HTTP ----
    args = cli._serve_parser().parse_args(sargs + [
        "--batch-slots", str(SLOTS), "--prompt-lookup", "--prefill-chunk",
        str(PREFILL_CHUNK), "--kv-block-tokens", str(BLOCK_TOKENS)])
    _, eng = cli.build_batching_engine(args)
    try:
        serve = http_pair(eng, rep)
        _check(serve["stats"]["speculative"]["proposer"] == "prompt_lookup"
               and serve["stats"]["speculative"]["rounds"] > 0,
               f"/stats: {serve['stats'].get('speculative')}")
        _check(_no_page_leak(eng), "serve --prompt-lookup leaked pages")
    finally:
        eng.close()
    # the streamed request hits the blocking one's prompt in the radix
    # tree and prefills only its last chunk: at bf16 its stream may part
    # from the blocking one at a near tie, as the plain batching
    # server's own pair may
    out["serve_batching_prompt_lookup"] = {
        "tokens": serve["tokens"],
        "streamed_equal": serve["streamed"] == serve["tokens"],
        "partings": _batch_partings(
            torch, {"plain": eng, "spec": eng}, [rep], [serve["streamed"]],
            [serve["tokens"]]),
        "speculative": serve["stats"]["speculative"]}
    args = cli._serve_parser().parse_args(sargs + [
        "--batch-slots", str(SLOTS), "--prefill-chunk", str(PREFILL_CHUNK),
        "--kv-block-tokens", str(BLOCK_TOKENS)])
    _, eng = cli.build_batching_engine(args)
    try:
        plain_pair = http_pair(eng, rep)
        _check(_no_page_leak(eng), "serve --batch-slots leaked pages")
    finally:
        eng.close()
    out["serve_batching_plain_pair"] = {
        "tokens": plain_pair["tokens"],
        "streamed_equal": plain_pair["streamed"] == plain_pair["tokens"],
        "partings": _batch_partings(
            torch, {"plain": eng, "spec": eng}, [rep],
            [plain_pair["streamed"]], [plain_pair["tokens"]]),
        "prompt_lookup_blocking_equal": plain_pair["tokens"]
        == serve["tokens"]}
    del eng, params, dparams
    torch.cuda.empty_cache()
    lap("serve_batching_prompt_lookup")

    # ---- generate --prompt-lookup on tinyllama-1.1b-int8: the dense
    # kernels under the verify forward (M = K + 1: the decode kernel) ----
    name8 = SERVE_MODEL + "-int8"
    gargs = ["--model", name8, "--max-seq", str(MAX_SEQ), "--greedy",
             "--prompt-ids", ",".join(map(str, rep)), "--prompt-lookup",
             "--max-new-tokens", str(NEW_TOKENS)]
    eng = cli.build_prompt_lookup_engine(cli._generate_parser().parse_args(
        gargs))
    eng.generate([rep], 2)                       # captures, warms
    qd.quant_dense.launches = qd.quant_dense.decode_launches = 0
    r0 = eng.graph_replays
    res, stats = eng.generate([rep], NEW_TOKENS)
    per_fwd = dense_per_layer(eng.cfg) * eng.cfg.num_layers
    rounds = eng.graph_replays - r0
    int8 = {"rounds": stats.rounds, "replays": rounds,
            "acceptance_rate": stats.acceptance_rate,
            "dense_launches": qd.quant_dense.launches,
            "decode_launches": qd.quant_dense.decode_launches,
            "predicted_dense_launches": per_fwd * (1 + rounds),
            "predicted_decode_launches": per_fwd * rounds}
    _check(int8["decode_launches"] == int8["predicted_decode_launches"]
           and int8["dense_launches"] == int8["predicted_dense_launches"],
           f"{name8} generate --prompt-lookup: dense launches {int8}")
    del eng
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(["generate", *gargs])
    cli_out = json.loads(buf.getvalue().strip().splitlines()[-1])
    int8["cli_rc"] = rc
    int8["cli_tokens_equal"] = cli_out["tokens"][0] == res.tokens[0].tolist()
    int8["cli_speculative"] = cli_out["speculative"]
    _check(rc == 0 and int8["cli_tokens_equal"],
           f"generate --prompt-lookup on {name8}: rc {rc}")
    out["generate_prompt_lookup_int8"] = int8
    torch.cuda.empty_cache()
    lap("generate_prompt_lookup_int8")
    out["section_s"] = laps
    out["phase_s"] = time.perf_counter() - t_phase
    return out


# ---------------------------------------------------------------------------
# phase: KV movement and the fleet (tiered KV, disaggregated prefill and
# decode, live migration, failover through the gateway)
# ---------------------------------------------------------------------------

FLEET_POOL_BLOCKS = 96      # the tiered engine's page pool
FLEET_HOST_BLOCKS = 46      # 16 MiB of TinyLlama's 352 KiB bf16 blocks
FLEET_DISK_BLOCKS = 186     # 64 MiB of them
FLEET_SHARED = 1024         # the tier prompts' shared prefix
FLEET_TAIL = 64             # ... and each one's own tail: 1088 tokens
FLEET_FILLERS = 3           # 1024-token prompts that evict the prefix
FLEET_NEW = 16
DISAGG_PROMPTS = (20, 150, 600, 1500)
DISAGG_F32_PROMPTS = (20, 300)
MIGRATION_PROMPTS = (64, 100, 150, 300)
MIGRATION_NEW = 48
MIGRATION_AT = 16           # the moving request's tokens at the move
FAILOVER_PROMPT = 15        # under one page: no prefix is stored
FAILOVER_NEW = 8
FAILOVER_CRASH_AFTER = 3


def _fleet_engine(torch, cfg, params, dev, **kw):
    from distributed_inference_demo_tpu_torch.ops.sampling import \
        SamplingParams
    from distributed_inference_demo_tpu_torch.runtime.batching import \
        ContinuousBatchingEngine
    kw.setdefault("sampling", SamplingParams(greedy=True))
    kw.setdefault("max_seq", MAX_SEQ)
    return ContinuousBatchingEngine(
        cfg, params, max_batch=SLOTS, kv_block_tokens=BLOCK_TOKENS,
        prefill_chunk=PREFILL_CHUNK, device=dev, **kw)


def _idle_pages(engine) -> bool:
    """Idle, every allocated page is tree-owned (bounded wait for the
    scheduler's completions)."""
    t_end = time.monotonic() + 30
    while True:
        s = engine.kv_cache.snapshot()
        if s["blocks_used"] == s["tree_blocks"]:
            return True
        if time.monotonic() > t_end:
            return False
        time.sleep(0.01)


def _run(engine, prompt, n, **kw):
    """Submit one request and wait: (tokens, logprobs, TTFT seconds)."""
    r = engine.submit(prompt, n, **kw)
    r.wait(timeout=600)
    return list(r.tokens), list(r.lps), r.t_first - r.t_submit


def _h2d_metric(stats) -> float:
    """``dwt_kvcache_h2d_bytes_total`` after bridging ``stats``' kvcache
    fragment, as a ``/metrics`` scrape does."""
    from distributed_inference_demo_tpu_torch.telemetry import catalog
    catalog.update_kvcache_series(stats["kvcache"])
    return sum(v for _, _, v in catalog.KVCACHE_H2D_BYTES.samples())


def _bits(torch, x) -> list:
    from distributed_inference_demo_tpu_torch.ops.quant import \
        QuantizedKVPages
    leaves = x.leaves() if isinstance(x, QuantizedKVPages) else [x]
    return [t.detach().cpu().contiguous().view(torch.uint8) for t in leaves]


def fleet_tier(torch, cfg, params, kv_dtype, tmp, dev, hit_engine) -> dict:
    """(a) The tier below a 96-block pool: a 1088-token prompt (1024
    shared), FLEET_FILLERS prompts that evict its prefix into the host
    ring and through it to the disk segment, then a prompt sharing the
    prefix, whose blocks promote (some from the disk).  The promoted
    pages are the bits exported at demotion; its tokens and logprobs
    equal the same two prompts' on ``hit_engine`` (a pool that keeps the
    prefix: a device hit); ``dwt_kvcache_h2d_bytes_total`` is promoted
    blocks x block bytes; the tier's accounting checks.  Returns (the
    tier engine, the migration source of this page type; its prompts;
    the numbers)."""
    import numpy as np

    from distributed_inference_demo_tpu_torch.runtime.kvcache import \
        PagedKVCacheManager
    from distributed_inference_demo_tpu_torch.runtime.kvcache.device \
        import export_blocks_from_pages, payload_to
    from distributed_inference_demo_tpu_torch.runtime.kvcache.tiered \
        import chain_digests

    rs = np.random.RandomState(5)
    shared = rs.randint(0, cfg.vocab_size, FLEET_SHARED).tolist()
    first, warm = (shared + rs.randint(0, cfg.vocab_size,
                                       FLEET_TAIL).tolist()
                   for _ in range(2))
    fillers = [rs.randint(0, cfg.vocab_size, FLEET_SHARED).tolist()
               for _ in range(FLEET_FILLERS)]
    block_bytes = PagedKVCacheManager.for_model(
        cfg, 8, BLOCK_TOKENS, kv_dtype=kv_dtype).block_bytes
    eng = _fleet_engine(
        torch, cfg, params, dev, kv_dtype=kv_dtype,
        kv_cache_blocks=FLEET_POOL_BLOCKS,
        kv_host_tier_bytes=FLEET_HOST_BLOCKS * block_bytes,
        kv_disk_tier_path=os.path.join(tmp, f"tier-{kv_dtype}"),
        kv_disk_tier_bytes=FLEET_DISK_BLOCKS * block_bytes)
    tier = eng._kv_tier
    _check(tier is not None, "the tier engine has no tier")
    # the bits each block had when it was demoted, by chain digest; the
    # hook's time (export gather + copy to the host + insert)
    demoted, demote_ms = {}, []
    real_demote, real_hook = tier.demote, eng.kv_cache.demote_hook

    def demote(path_keys, kb, vb):
        n = int(kb.shape[0])
        for j, dg in enumerate(chain_digests(path_keys)[len(path_keys) - n:]):
            demoted[dg] = _bits(torch, payload_to(kb[j:j + 1], "cpu")) + \
                _bits(torch, payload_to(vb[j:j + 1], "cpu"))
        return real_demote(path_keys, kb, vb)

    def hook(path_keys, block_ids):
        t0 = time.perf_counter()
        real_hook(path_keys, block_ids)
        demote_ms.append((time.perf_counter() - t0) * 1e3)

    promote_ms = []
    real_note = tier.note_promoted

    def note(blocks, nbytes, seconds):
        promote_ms.append(seconds * 1e3)
        return real_note(blocks, nbytes, seconds)

    tier.demote, tier.note_promoted = demote, note
    eng.kv_cache.demote_hook = hook
    _, _, ttft_cold = _run(eng, first, FLEET_NEW)
    for f in fillers:
        _run(eng, f, FLEET_NEW)
    st0 = dict(tier.stats)
    _check(st0["spilled_blocks"] > 0, f"nothing spilled to disk: {st0}")
    h2d0 = eng.stats()["kvcache"]["h2d_bytes"]
    toks, lps, ttft_promoted = _run(eng, warm, FLEET_NEW)
    st = dict(tier.stats)
    promoted = st["promoted_blocks"] - st0["promoted_blocks"]
    _check(promoted > 0 and st["disk_hits"] > 0,
           f"the warm prompt promoted {promoted} blocks, "
           f"{st['disk_hits']} tier reads from the disk")
    stats = eng.stats()
    h2d = stats["kvcache"]["h2d_bytes"] - h2d0
    _check(h2d == promoted * block_bytes,
           f"h2d bytes {h2d} != {promoted} promoted x {block_bytes}")
    metric = _h2d_metric(stats)
    _check(metric == stats["kvcache"]["h2d_bytes"],
           f"dwt_kvcache_h2d_bytes_total {metric}")
    # the promoted pages, bit for bit: the warm prompt's device run
    bt = BLOCK_TOKENS
    keys = [tuple(warm[i * bt:(i + 1) * bt]) for i in range(len(warm) // bt)]
    digests = chain_digests(keys)
    lease = eng.kv_cache.match(np.asarray(warm, np.int32))
    _check(lease is not None, "the promoted prefix is not in the tree")
    try:
        ids = list(lease.block_ids)
        kb, vb = export_blocks_from_pages(eng._pk, eng._pv, ids)
        checked = 0
        for j, dg in enumerate(digests[:len(ids)]):
            if dg not in demoted:
                continue
            got = (_bits(torch, payload_to(kb[j:j + 1], "cpu"))
                   + _bits(torch, payload_to(vb[j:j + 1], "cpu")))
            _check(all(torch.equal(a, b) for a, b in zip(got, demoted[dg])),
                   f"promoted block {j} differs from its demoted bits")
            checked += 1
    finally:
        lease.release()
    _check(checked >= promoted, f"{checked} promoted blocks compared")
    tier.check()
    _check(_idle_pages(eng), "the tier engine leaked pages")
    # the device hit: the same two prompts on a pool that keeps them
    _, _, ttft_hit_first = _run(hit_engine, first, FLEET_NEW)
    h_toks, h_lps, ttft_hit = _run(hit_engine, warm, FLEET_NEW)
    _check(h_toks == toks and h_lps == lps,
           f"promoted tokens / logprobs differ from a device hit's "
           f"({kv_dtype} pages)")
    return eng, [first, warm] + fillers, {
        "kv_dtype": kv_dtype, "pool_blocks": FLEET_POOL_BLOCKS,
        "block_bytes": block_bytes,
        "host_tier_bytes": FLEET_HOST_BLOCKS * block_bytes,
        "disk_tier_bytes": FLEET_DISK_BLOCKS * block_bytes,
        "prompt_tokens": len(first), "shared_tokens": FLEET_SHARED,
        "promoted_blocks": promoted, "promoted_pages_bit_equal": checked,
        "disk_hits": st["disk_hits"], "host_hits": st["host_hits"],
        "demoted_blocks": st["demoted_blocks"],
        "spilled_blocks": st["spilled_blocks"],
        "dropped_blocks": st["dropped_blocks"], "h2d_bytes": h2d,
        "h2d_metric": metric, "bit_equal_to_device_hit": True,
        "ttft_promoted_s": ttft_promoted, "ttft_reprefilled_s": ttft_cold,
        "ttft_device_hit_s": ttft_hit,
        "demote_ms_median": float(np.median(demote_ms)),
        "demote_ms_max": max(demote_ms), "demotions": len(demote_ms),
        "promote_ms": promote_ms,
        "tier": {k: v for k, v in eng.stats()["kvcache"]["tier"].items()
                 if k != "digest"}}


class _Tally:
    """A transport wrapper that books every frame it sends: (tag, bytes)."""

    def __init__(self, inner):
        self._inner = inner
        self.sent = []

    def __getattr__(self, name):
        return getattr(self._inner, name)

    def send(self, peer, tag, payload):
        self.sent.append((tag, len(payload)))
        return self._inner.send(peer, tag, payload)


def _partings(torch, engine, prompts, got, want) -> list:
    """Where bf16 streams part from ``want``: the first differing step
    and the margin between the two tokens' logits there, teacher forced
    through ``engine``'s chunked path; each must sit at a near tie."""
    import numpy as np
    out = []
    for i, (g, w) in enumerate(zip(got, want)):
        if g == w:
            continue
        j = next(k for k in range(min(len(g), len(w))) if g[k] != w[k])
        ls = _paged_logits(torch, engine, list(prompts[i]) + w[:j], 0)[0]
        row = {"request": i, "step": j,
               "margin": float(abs(ls[w[j]] - ls[g[j]])),
               "logit_tol": LOGIT_TOL_REL * max(1.0,
                                                float(np.abs(ls).max()))}
        out.append(row)
        _check(row["margin"] <= row["logit_tol"],
               f"a stream parts away from a near tie: {row}")
    return out


def fleet_disagg(torch, cfg, params, dev, colocated, decoder, lens, new,
                 exact: bool) -> dict:
    """(b) A ``PrefillWorker`` (chunked prefill over a dense row: the
    flash kernel) streams each prompt's whole blocks to a
    ``DecodeWorker`` over ``decoder`` (a fresh 8-slot batching engine),
    a ``DisaggCoordinator`` handing out the requests, one process, one
    loopback fabric.  The same prompts first run colocated on
    ``colocated``, an engine of the same build: the decode side's pool
    holds none of their pages, so every whole prompt block it decodes
    over is one the prefill worker wrote (adopted pages = migrated
    pages, every request premigrated, each admission reusing its
    adopted blocks).  The flash kernel launches L x the prefill chunks,
    the paged kernels what the routing predicts for the decode side's
    joins, the decode side moves no byte host to device; tokens equal
    the colocated run's (``exact``), or part only at near ties."""
    import threading

    import numpy as np

    from distributed_inference_demo_tpu_torch.comm.transport import (
        LoopbackNetwork, LoopbackTransport)
    from distributed_inference_demo_tpu_torch.ops import \
        paged_attention as pa
    from distributed_inference_demo_tpu_torch.ops.flash_attention import \
        flash_attention
    from distributed_inference_demo_tpu_torch.ops.paged_attention import \
        paged_route
    from distributed_inference_demo_tpu_torch.runtime.disagg import (
        DecodeWorker, DisaggCoordinator, PrefillWorker)
    from distributed_inference_demo_tpu_torch.telemetry.flightrecorder \
        import get_flight_recorder

    L = cfg.num_layers
    rs = np.random.RandomState(7)
    prompts = [rs.randint(0, cfg.vocab_size, n).tolist() for n in lens]
    reqs = [colocated.submit(p, new) for p in prompts]
    want = [r.wait(timeout=900).tolist() for r in reqs]
    ttft_colo = [r.t_first - r.t_submit for r in reqs]
    net = LoopbackNetwork()
    tp = _Tally(LoopbackTransport("p0", net))
    pw = PrefillWorker(cfg, params, tp, max_seq=MAX_SEQ,
                       prefill_chunk=PREFILL_CHUNK,
                       kv_block_tokens=BLOCK_TOKENS, device=dev)
    _check(pw.attn_backend == ("flash" if dev == "cuda" else "plain"),
           f"the prefill worker's attention: {pw.attn_backend}")
    dw = DecodeWorker(decoder, LoopbackTransport("d0", net))
    coord = DisaggCoordinator(LoopbackTransport("coord", net), ["p0"], "d0")
    threads = [threading.Thread(target=w.serve_forever, daemon=True)
               for w in (pw, dw)]
    for t in threads:
        t.start()
    flight = get_flight_recorder()
    flight.clear()
    _check(decoder.kv_cache.snapshot()["tree_blocks"] == 0,
           "the decode engine's pool is not empty")
    h2d0 = decoder.stats()["kvcache"]["h2d_bytes"]
    s0 = decoder.loop_stats["device_loop_steps"]
    # counted as differences: the phase counts from its own start
    c0 = (flash_attention.launches, pa.paged_flash_attention.launches,
          pa.paged_prefill_attention.launches)
    try:
        dreqs = [coord.submit(p, new) for p in prompts]
        got = [d.wait(timeout=900).tolist() for d in dreqs]
        t_end = time.monotonic() + 30
        while pw._inflight_rid is not None or pw._backlog:
            _check(time.monotonic() < t_end, "the prefill worker hung")
            time.sleep(0.01)
        flash = flash_attention.launches - c0[0]
        launches = {
            "paged_decode": pa.paged_flash_attention.launches - c0[1],
            "paged_prefill": pa.paged_prefill_attention.launches - c0[2]}
        steps = decoder.loop_stats["device_loop_steps"] - s0
    finally:
        pw.stop()
        dw.stop()
        for t in threads:
            t.join(timeout=30)
        coord.close()
    bt, C = BLOCK_TOKENS, PREFILL_CHUNK
    n_mig = [(len(p) - 1) // bt for p in prompts]
    chunks = sum(-(-(n * bt) // C) for n in n_mig)
    card = dev == "cuda"       # the wrappers count launches on the card
    _check(not card or flash == L * chunks,
           f"prefill-side flash launches {flash}, L x chunks {L * chunks}")
    admits = [(e["prompt_len"], e["prefix_reused"])
              for e in flight.snapshot() if e["kind"] == "batch_admit"]
    g = cfg.num_heads // cfg.num_kv_heads
    pre = sum(paged_route(True, decoder._bucket(plen - m), g, bt,
                          max_rows=None) == "prefill" for plen, m in admits)
    predicted = {"paged_decode": L * steps, "paged_prefill": L * pre}
    _check(len(admits) == len(prompts)
           and (not card or launches == predicted),
           f"decode-side paged launches {launches}, predicted {predicted} "
           f"({admits})")
    # the decode side ran over the prefill worker's pages, and only
    ds = decoder.disagg_stats
    _check(ds["adopted_pages"] == dw.stats["adopted_pages"]
           == pw.stats["migrated_pages"] == sum(n_mig) > 0
           and ds["premigrated_requests"] == len(prompts)
           and sorted(m for _, m in admits) == sorted(n * bt for n in n_mig),
           f"adopted {ds}, {dw.stats['adopted_pages']} pages, migrated "
           f"{pw.stats['migrated_pages']} of {sum(n_mig)} prompt blocks; "
           f"admissions (prompt, reused) {admits}")
    h2d = decoder.stats()["kvcache"]["h2d_bytes"] - h2d0
    _check(h2d == 0, f"the decode side moved {h2d} bytes host to device")
    _check(_idle_pages(decoder), "the decode engine leaked pages")
    frames = [(t, n) for t, n in tp.sent if t.startswith("pg:")]
    out = {"prompt_lens": list(lens), "new_tokens": new,
           "flash_launches": flash, "prefill_chunks": chunks,
           "launches": launches, "predicted_launches": predicted,
           "h2d_bytes": h2d, "page_frames": len(frames),
           "frame_bytes": sum(n for _, n in frames),
           "migrated_pages": pw.stats["migrated_pages"],
           "adopted_pages": ds["adopted_pages"],
           "premigrated_requests": ds["premigrated_requests"],
           "prefix_reused": [m for _, m in admits],
           "migrated_bytes": pw.stats["migrated_bytes"],
           "ttft_disagg_s": [d.ttft_s for d in dreqs],
           "ttft_colocated_s": ttft_colo,
           "tokens_equal": sum(a == b for a, b in zip(got, want))}
    if exact:
        _check(got == want, "f32 disaggregated tokens differ from the "
               "colocated engine's")
    else:
        out["partings"] = _partings(torch, colocated, prompts, got, want)
    return out


def fleet_migration(torch, cfg, src, dst, kv_dtype) -> dict:
    """(c) A request decoding beside 3 others on ``src`` moves to ``dst``
    (both 8-slot engines of this page type, ``MigrationWorker`` each, one
    loopback fabric) once it holds MIGRATION_AT tokens.  Its client
    stream never breaks and equals the same request's unmigrated stream
    (the same 4 requests on ``dst`` first), at most one step replays and
    none is skipped, no page leaks on either engine.  The handoff pause
    and the bytes of each phase."""
    import queue
    import threading

    import numpy as np

    from distributed_inference_demo_tpu_torch.comm.transport import (
        LoopbackNetwork, LoopbackTransport)
    from distributed_inference_demo_tpu_torch.runtime.migration import \
        MigrationWorker

    rs = np.random.RandomState(11)
    prompts = [rs.randint(0, cfg.vocab_size, n).tolist()
               for n in MIGRATION_PROMPTS]
    reqs = [dst.submit(p, MIGRATION_NEW) for p in prompts]
    want = [r.wait(timeout=900).tolist() for r in reqs]
    net = LoopbackNetwork()
    t_src = _Tally(LoopbackTransport("src", net))
    src_w = MigrationWorker(src, t_src, ack_timeout=30.0)
    dst_w = MigrationWorker(dst, LoopbackTransport("dst", net),
                            ack_timeout=30.0)
    threads = [threading.Thread(target=w.serve_forever, daemon=True)
               for w in (src_w, dst_w)]
    for t in threads:
        t.start()
    try:
        reqs = [src.submit(p, MIGRATION_NEW, request_id=f"m{i}")
                for i, p in enumerate(prompts)]
        moving = reqs[0]
        streamed = []

        def drain():
            while True:
                try:
                    tok = moving.stream.get(timeout=600)
                except queue.Empty:
                    return
                if tok is None:
                    return
                streamed.append(tok)

        reader = threading.Thread(target=drain, daemon=True)
        reader.start()
        t_end = time.monotonic() + 300
        while len(moving.tokens) < MIGRATION_AT:
            _check(time.monotonic() < t_end, "the request did not decode")
            time.sleep(0.001)
        before = len(moving.tokens)
        replay0 = src_w.stats["replayed_steps"]
        _check(src_w.migrate_out("m0", "dst") is True, "migrate_out failed")
        got = [r.wait(timeout=900).tolist() for r in reqs]
        reader.join(timeout=60)
        replayed = src_w.stats["replayed_steps"] - replay0
    finally:
        src_w.stop()
        dst_w.stop()
        for t in threads:
            t.join(timeout=30)
    _check(moving.error is None and streamed == got[0],
           "the client stream broke across the move")
    _check(got == want, f"{kv_dtype}: migrated tokens differ from the "
           "unmigrated run's")
    _check(replayed <= 1, f"{replayed} steps replayed")
    _check(_idle_pages(src) and _idle_pages(dst), "pages leaked")
    _check(dst_w.stager._staged == {} and dst_w.staged_bytes == 0,
           "the target's staging did not drain")
    sent = t_src.sent
    cut = next(i for i, (t, _) in enumerate(sent) if t.startswith("rs:"))
    phase1 = sum(n for _, n in sent[:cut + 1])
    phase2 = sum(n for t, n in sent[cut + 1:]
                 if t.startswith(("pg:", "rsd:")))
    return {"kv_dtype": kv_dtype, "prompt_lens": list(MIGRATION_PROMPTS),
            "new_tokens": MIGRATION_NEW, "tokens_at_move": before,
            "bit_equal": True, "replayed_steps": replayed,
            "handoff_pause_ms": moving.migration_pause * 1e3,
            "phase1_bytes": phase1, "phase2_bytes": phase2,
            "moved_pages": src_w.stats["moved_pages"],
            "moved_bytes": src_w.stats["moved_bytes"],
            "migration_ms": src_w.stats["last_migration_ms"]}


class _CrashyBackend:
    """An engine whose token stream consults a ``comm/faults`` plan: its
    ``crash_after`` rule raises mid-stream (a replica dying between decode
    steps), which the replica's server turns into an error line."""

    def __init__(self, inner, plan, rid):
        self._inner, self._plan, self._rid = inner, plan, rid
        self.crashed_at = None

    def __getattr__(self, name):
        return getattr(self._inner, name)

    def generate_stream(self, *a, **kw):
        from distributed_inference_demo_tpu_torch.comm.faults import \
            InjectedCrash
        for item in self._inner.generate_stream(*a, **kw):
            if self._plan.on_recv(self._rid) is not None:
                self.crashed_at = time.perf_counter()
                raise InjectedCrash(f"{self._rid}: injected crash_after")
            yield item


def _stream_lines(port: int, body: dict):
    """POST a streamed /generate: (status, headers, [(arrival, line)])."""
    import http.client
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=600)
    try:
        conn.request("POST", "/generate", body=json.dumps(body),
                     headers={"Content-Type": "application/json"})
        resp = conn.getresponse()
        lines = []
        while True:
            ln = resp.readline()
            if not ln:
                break
            if ln.strip():
                lines.append((time.perf_counter(), json.loads(ln)))
        return resp.status, dict(resp.getheaders()), lines
    finally:
        conn.close()


def fleet_failover(torch, cfg, engines, sampled: bool,
                   tier_prompts=None) -> dict:
    """(d) The port's ``GatewayHTTPServer`` in front of two
    ``InferenceHTTPServer`` replicas over 8-slot batching engines, in
    this process.  Replica A dies mid-stream (a ``crash_after`` rule after
    FAILOVER_CRASH_AFTER tokens); the gateway resumes the stream on B.
    The client's streamed answer equals the unfailed one (B asked
    directly first), steps continuous, B counts one resumed request.
    With ``tier_prompts`` (the prompts A's tier saw), then the tier
    route (:func:`_tier_route`)."""
    import threading

    import numpy as np

    from distributed_inference_demo_tpu_torch.comm.faults import (
        FaultPlan, FaultRule)
    from distributed_inference_demo_tpu_torch.runtime.gateway import (
        GatewayHTTPServer, PrefixAwareRouter, ReplicaRegistry)
    from distributed_inference_demo_tpu_torch.runtime.http_server import \
        InferenceHTTPServer

    plan = FaultPlan(seed=7, rules=[FaultRule(
        kind="crash_after", n_msgs=FAILOVER_CRASH_AFTER, max_count=1)])
    crashy = _CrashyBackend(engines[0], plan, "replicaA")
    servers = [InferenceHTTPServer(b, port=0) for b in (crashy, engines[1])]
    for s in servers:
        s.start()
    registry = ReplicaRegistry([(s.host, s.port) for s in servers],
                               readmit_cooldown_s=60.0)
    router = PrefixAwareRouter(registry, min_prefix_tokens=8,
                               block_tokens=8)
    gw = GatewayHTTPServer(registry, router, port=0, retry_limit=1,
                           resume_limit=1)
    threading.Thread(target=gw.httpd.serve_forever, daemon=True).start()
    rid_a = f"{servers[0].host}:{servers[0].port}"
    resumed0 = engines[1].stats().get("resumed", {}).get("requests", 0)
    try:
        toks = np.random.RandomState(13 + sampled).randint(
            0, cfg.vocab_size, FAILOVER_PROMPT).tolist()
        router.record(rid_a, toks)
        body = {"prompt_ids": [toks], "max_new_tokens": FAILOVER_NEW,
                "stream": True}
        st, _, ref_lines = _stream_lines(servers[1].port, body)
        _check(st == 200, f"replica B: HTTP {st}")
        want = [ln["tokens"][0] for _, ln in ref_lines]
        st, headers, lines = _stream_lines(gw.port, body)
        _check(st == 200 and not any("error" in ln for _, ln in lines),
               f"gateway stream: HTTP {st}, {lines}")
        got = [ln["tokens"][0] for _, ln in lines]
        _check([e["kind"] for e in plan.events] == ["crash_after"],
               f"fault events {plan.events}")
        _check(got == want and [ln["step"] for _, ln in lines]
               == list(range(FAILOVER_NEW)),
               f"resumed stream {got} != unfailed {want}")
        st1 = engines[1].stats()["resumed"]
        _check(st1["requests"] == resumed0 + 1 and st1["diverged"] == 0,
               f"survivor resume stats {st1}")
        resumed_ms = (lines[FAILOVER_CRASH_AFTER][0]
                      - crashy.crashed_at) * 1e3
        out = {"sampled": sampled, "bit_equal": True,
               "death_to_first_resumed_token_ms": resumed_ms,
               "tokens": FAILOVER_NEW, "crash_after": FAILOVER_CRASH_AFTER}
        if tier_prompts is not None:
            out["tier_route"] = _tier_route(registry, router, gw, servers,
                                            engines[0], tier_prompts)
        return out
    finally:
        gw.shutdown()
        for s in servers:
            s.shutdown()


def _tier_route(registry, router, gw, servers, engine, prompts) -> dict:
    """The tier second chance end to end: replica A's ``/stats`` publishes
    the digest of what its tier holds; a request sharing the longest such
    prefix routes to A (policy host_tier) and promotes it there."""
    registry.probe_all()
    rid_a = f"{servers[0].host}:{servers[0].port}"
    tier = engine._kv_tier
    best, best_tokens = None, 0
    for seq in prompts:
        n = router.tier_match_tokens(rid_a, seq)
        if n > best_tokens:
            best, best_tokens = seq, n
    _check(best_tokens >= 32, f"A's tier digest covers {best_tokens} tokens")
    req = best[:best_tokens] + [1, 2, 3]
    d = router.route(req)
    _check(d.policy == "host_tier" and d.rid == rid_a,
           f"route {d.policy} -> {d.rid}")
    p0 = tier.stats["promoted_blocks"]
    st, headers, lines = _stream_lines(gw.port, {
        "prompt_ids": [req], "max_new_tokens": 2, "stream": True})
    _check(st == 200 and headers.get("X-DWT-Replica") == rid_a,
           f"the shared-prefix request went to {headers}")
    promoted = tier.stats["promoted_blocks"] - p0
    _check(promoted > 0, "the routed request promoted nothing")
    return {"policy": d.policy, "match_tokens": d.match_tokens,
            "promoted_blocks": promoted}


def phase_fleet(torch, model: str = SERVE_MODEL, dev: str = "cuda") -> dict:
    """KV movement and the fleet at full width (bf16, random weights from
    seed 0, 16-token pages, 8 slots, loopback transport): (a) the tiered
    KV over bf16 and int8 pages, (b) disaggregated prefill / decode (and
    f32 on two requests), (c) live migration over bf16 and int8 pages,
    (d) failover through the gateway, greedy and sampled, and the tier
    route.  The flash and paged kernels' launches are counted from 0 at
    the phase's start to the end of (d) (the kernels line's ``*_fleet``
    entries: bf16 and int8 pages); the f32 disaggregation counts its
    own (``disagg_f32``, the ``*_f32`` entries)."""
    import shutil
    import tempfile

    from distributed_inference_demo_tpu_torch.models.decoder import \
        init_full_params
    from distributed_inference_demo_tpu_torch.models.registry import \
        get_model_config
    from distributed_inference_demo_tpu_torch.ops import \
        paged_attention as pa
    from distributed_inference_demo_tpu_torch.ops.flash_attention import \
        flash_attention
    from distributed_inference_demo_tpu_torch.ops.sampling import \
        SamplingParams

    t_phase = time.perf_counter()
    cfg = get_model_config(model)
    out = {"phase": "fleet", "device": torch.cuda.get_device_name(0)
           if dev == "cuda" else dev, "model": model, "slots": SLOTS,
           "block_tokens": BLOCK_TOKENS, "prefill_chunk": PREFILL_CHUNK}
    params = init_full_params(
        torch.Generator(device=dev).manual_seed(0), cfg, dev)
    tmp = tempfile.mkdtemp(prefix="fleet-tier-")
    engines = []
    try:
        _reset_launches(flash_attention, pa.paged_flash_attention,
                        pa.paged_prefill_attention)
        pairs, tier_prompts = {}, None
        for kv_dtype in ("bf16", "int8"):
            t1 = time.perf_counter()
            hit = _fleet_engine(torch, cfg, params, dev, kv_dtype=kv_dtype)
            engines.append(hit)
            tier_eng, prompts, res = fleet_tier(torch, cfg, params, kv_dtype,
                                                tmp, dev, hit)
            engines.append(tier_eng)
            pairs[kv_dtype] = (tier_eng, hit)
            tier_prompts = tier_prompts or prompts
            res["seconds"] = time.perf_counter() - t1
            out[f"tier_{kv_dtype}"] = res
        t1 = time.perf_counter()
        decoder = _fleet_engine(torch, cfg, params, dev, kv_dtype="bf16")
        engines.append(decoder)
        out["disagg"] = fleet_disagg(torch, cfg, params, dev,
                                     pairs["bf16"][1], decoder,
                                     DISAGG_PROMPTS, FLEET_NEW, exact=False)
        out["disagg"]["seconds"] = time.perf_counter() - t1
        for kv_dtype in ("bf16", "int8"):
            t1 = time.perf_counter()
            res = fleet_migration(torch, cfg, *pairs[kv_dtype], kv_dtype)
            res["seconds"] = time.perf_counter() - t1
            out[f"migration_{kv_dtype}"] = res
        t1 = time.perf_counter()
        out["failover_greedy"] = fleet_failover(
            torch, cfg, list(pairs["bf16"]), sampled=False,
            tier_prompts=tier_prompts)
        for e in engines:
            e.close()
        engines = [_fleet_engine(
            torch, cfg, params, dev, max_seq=512, seed=3,
            sampling=SamplingParams(temperature=0.9, top_k=40))
            for _ in range(2)]
        out["failover_sampled"] = fleet_failover(torch, cfg, engines,
                                                 sampled=True)
        out["failover_seconds"] = time.perf_counter() - t1
        for e in engines:
            e.close()
        # the bf16 and int8 runs' launches (the f32 run counts its own)
        out["launches"] = {
            "flash": flash_attention.launches,
            "paged_decode": pa.paged_flash_attention.launches,
            "paged_prefill": pa.paged_prefill_attention.launches,
            "paged_decode_int8": pa.paged_flash_attention.int8_launches,
            "paged_prefill_int8": pa.paged_prefill_attention.int8_launches}
        _check(dev != "cuda" or min(out["launches"].values()) > 0,
               f"a kernel did not launch: {out['launches']}")
        # f32 disaggregation on two requests: the decode side's tokens
        # equal the colocated engine's exactly
        t1 = time.perf_counter()
        cfg32 = cfg.replace(dtype_name="float32")
        p32 = init_full_params(
            torch.Generator(device=dev).manual_seed(0), cfg32, dev)
        engines = [_fleet_engine(torch, cfg32, p32, dev, max_seq=512)
                   for _ in range(2)]
        out["disagg_f32"] = fleet_disagg(torch, cfg32, p32, dev, *engines,
                                         DISAGG_F32_PROMPTS, FLEET_NEW,
                                         exact=True)
        _check(dev != "cuda" or min(
            out["disagg_f32"]["flash_launches"],
            *out["disagg_f32"]["launches"].values()) > 0,
            f"an f32 kernel did not launch: {out['disagg_f32']}")
        out["disagg_f32"]["seconds"] = time.perf_counter() - t1
    finally:
        for e in engines:
            e.close()
        shutil.rmtree(tmp, ignore_errors=True)
    out["seconds"] = time.perf_counter() - t_phase
    return out


# ---------------------------------------------------------------------------
# phase 15: multiple devices on torch.distributed
# ---------------------------------------------------------------------------

PARALLEL_NOTE = ("tp/ep/sp ranks are processes sharing the one card over "
                 "gloo, every collective staged through pinned host "
                 "memory; these times say nothing of NCCL across cards")


def _mesh_delta(mesh, before: dict) -> dict:
    """The mesh's collectives since ``before`` (a copy of its stats):
    count, host-timed ms, bytes staged through host memory."""
    st = mesh.stats
    return {"collectives": st["collectives"] - before["collectives"],
            "collective_ms": (st["collective_s"]
                              - before["collective_s"]) * 1e3,
            "staged_bytes": st["staged_bytes"] - before["staged_bytes"]}


def parallel_nccl(torch) -> dict:
    """An NCCL group of size 1 (the card machine has one card): the tp
    step's collectives at TinyLlama's 8-slot shapes, the attention / MLP
    all-reduce, the logits' all-gather and an all-to-all, captured in a
    CUDA graph and replayed, held bit for bit to the same calls eager."""
    import datetime
    from types import SimpleNamespace

    from torch.distributed import PrefixStore, TCPStore

    from distributed_inference_demo_tpu_torch.models.registry import \
        get_model_config
    from distributed_inference_demo_tpu_torch.parallel.mesh import (
        AxisGroup, _make_pg)

    cfg = get_model_config(SERVE_MODEL)
    timeout = datetime.timedelta(seconds=120)
    dev = torch.device("cuda", 0)
    store = TCPStore("127.0.0.1", 0, 1, True, timeout=timeout,
                     wait_for_workers=False)
    pg = _make_pg("nccl", PrefixStore("nccl", store), 0, 1, timeout, dev)
    holder = SimpleNamespace(backend="nccl", stats={
        "staged_bytes": 0, "collectives": 0, "collective_s": 0.0})
    grp = AxisGroup(holder, "tp", pg, 1, 0)
    gen = torch.Generator(device=dev).manual_seed(0)

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device=dev).to(
            torch.bfloat16)

    ar = rnd(SLOTS, 1, cfg.hidden_size)
    ag = rnd(SLOTS, 1, cfg.vocab_size // PAR_TP)
    aa = rnd(1, SLOTS, 1, cfg.hidden_size)

    def step():
        return (grp.all_reduce(ar.clone()), grp.all_gather(ag, dim=-1),
                grp.all_to_all(aa))

    eager = step()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        step()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = step()
    graph.replay()
    torch.cuda.synchronize()
    equal = all(torch.equal(a, b) for a, b in zip(out, eager))
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(20):
        graph.replay()
    end.record()
    end.synchronize()
    res = {"check": "nccl_graph", "world": 1, "backend": "nccl",
           "replay_equals_eager": equal,
           "replay_ms": start.elapsed_time(end) / 20,
           "shapes": {"all_reduce": list(ar.shape),
                      "all_gather": list(ag.shape),
                      "all_to_all": list(aa.shape)}}
    _check(equal, "NCCL graph replay differs from eager")
    del graph
    pg.shutdown() if hasattr(pg, "shutdown") else None
    return res


def parallel_tp_batching(torch, mesh) -> dict:
    """TinyLlama bf16 at full width and PAR_BATCHING_LAYERS layers, tp=2
    over gloo on the one card: 8-slot
    ``--batch-slots`` serving over HTTP of the batching phase's 8
    requests; tokens against the tp=1 engine on the card (partings only
    at near ties, ``_partings``); both ranks' paged launches against the
    routing's prediction; no page leak; ms a step at tp=2 against tp=1
    (both eager: a gloo step cannot be captured), rank 0's device ms a
    step and idle share, the collectives' ms and staged bytes; then an
    f32 cross-check on three of the prompts.  ``mesh``: a tp=PAR_TP
    mesh, the caller's."""
    import numpy as np

    from distributed_inference_demo_tpu_torch.models.decoder import \
        init_full_params
    from distributed_inference_demo_tpu_torch.models.registry import \
        get_model_config
    from distributed_inference_demo_tpu_torch.ops.sampling import \
        SamplingParams
    from distributed_inference_demo_tpu_torch.parallel.tensor import (
        free_tp, rank_launches)
    from distributed_inference_demo_tpu_torch.runtime.batching import \
        ContinuousBatchingEngine
    from distributed_inference_demo_tpu_torch.runtime.http_server import \
        InferenceHTTPServer
    from distributed_inference_demo_tpu_torch.telemetry.flightrecorder \
        import get_flight_recorder

    cfg = get_model_config(SERVE_MODEL).replace(
        num_layers=PAR_BATCHING_LAYERS)
    L = cfg.num_layers
    prompts = _batch_prompts(cfg.vocab_size)
    kw = dict(max_seq=MAX_SEQ, max_batch=SLOTS,
              sampling=SamplingParams(greedy=True),
              kv_block_tokens=BLOCK_TOKENS, prefill_chunk=PREFILL_CHUNK,
              device="cuda", cuda_graph=False)
    out = {"check": "tp_batching", "model": SERVE_MODEL, "tp": PAR_TP,
           "layers": L, "layers_of_the_model":
               get_model_config(SERVE_MODEL).num_layers,
           "dtype": "bfloat16", "slots": SLOTS,
           "prompt_lens": list(BATCH_PROMPTS), "new_tokens": NEW_TOKENS,
           "graph": "off on both sides (a gloo collective cannot be "
                    "captured)"}
    params = init_full_params(
        torch.Generator(device="cuda").manual_seed(0), cfg, "cuda")
    one = ContinuousBatchingEngine(cfg, params, **kw)
    try:
        reqs = [one.submit(p, NEW_TOKENS) for p in prompts]
        want = [r.wait(timeout=900).tolist() for r in reqs]
        out["tp1_window"] = decode_window(torch, one, prompts, steps=8,
                                          profiled=4)
    finally:
        one.close()
    flight = get_flight_recorder()
    out["mesh"] = mesh.describe()
    eng = ContinuousBatchingEngine(cfg, params, mesh=mesh, **kw)
    server = InferenceHTTPServer(eng, "127.0.0.1", 0,
                                 model_name=SERVE_MODEL,
                                 default_max_new=NEW_TOKENS)
    server.start()
    try:
        _post(server.port, {"prompt_ids": [list(range(16))],
                            "max_new_tokens": 2})
        eng.reset_stats()
        flight.clear()
        rank_launches(mesh, reset=True)
        before = dict(mesh.stats)
        t0 = time.perf_counter()
        toks = _serve_all(server.port, prompts)
        wall = time.perf_counter() - t0
        comm = _mesh_delta(mesh, before)
        per_rank = rank_launches(mesh)
        events = flight.snapshot()
        admits = [(e["prompt_len"], e["prefix_reused"]) for e in events
                  if e["kind"] == "batch_admit"]
        predicted = predicted_paged_launches(eng, admits, L)
        launches = [{"paged_decode": r["paged_decode"]["launches"],
                     "paged_prefill": r["paged_prefill"]["launches"]}
                    for r in per_rank]
        steps = eng.loop_stats["device_loop_steps"]
        out.update(launches_by_rank=launches, predicted=predicted,
                   wall_s=wall, tok_s=len(prompts) * NEW_TOKENS / wall,
                   decode_steps=steps, comm=comm,
                   comm_per_step_ms=comm["collective_ms"] / max(1, steps),
                   admissions=admits)
        _check(all(x == predicted for x in launches)
               and min(predicted.values()) > 0,
               f"per-rank paged launches {launches}, routing "
               f"predicts {predicted}")
        out["no_page_leak"] = _no_page_leak(eng)
        _check(out["no_page_leak"], "pages leaked after the drain")
        out["tp2_window"] = decode_window(torch, eng, prompts,
                                          steps=8, profiled=4)
        _check(_no_page_leak(eng), "the window leaked pages")
    finally:
        server.shutdown()
        eng.close()
        free_tp(mesh, eng.params)           # the shared mesh lives on
    out["tokens_equal"] = sum(g == w for g, w in zip(toks, want))
    out["partings"] = _partings(torch, one, prompts, toks, want)
    out["ms_per_step"] = {
        "tp1": out["tp1_window"]["decode_ms_per_step"],
        "tp2": out["tp2_window"]["decode_ms_per_step"]}
    out["rank0_profile"] = {
        k: out["tp2_window"]["profile"].get(k)
        for k in ("device_busy_ms", "wall_ms", "device_idle_share",
                  "steps", "kernels")}
    del params, one
    torch.cuda.empty_cache()
    # ---- f32 cross-check, three of the prompts ----
    cfg32 = cfg.replace(dtype_name="float32")
    p32 = init_full_params(
        torch.Generator(device="cuda").manual_seed(0), cfg32, "cuda")
    few = [prompts[BATCH_PROMPTS.index(n)] for n in (20, 150)]
    one32 = ContinuousBatchingEngine(cfg32, p32, **kw)
    try:
        want32 = [r.wait(timeout=900).tolist()
                  for r in [one32.submit(p, NEW_TOKENS) for p in few]]
    finally:
        one32.close()
    eng32 = ContinuousBatchingEngine(cfg32, p32, mesh=mesh, **kw)
    try:
        got32 = [r.wait(timeout=900).tolist()
                 for r in [eng32.submit(p, NEW_TOKENS) for p in few]]
        _check(_no_page_leak(eng32), "f32 run leaked pages")
    finally:
        eng32.close()
        free_tp(mesh, eng32.params)
    out["f32_tokens_equal"] = sum(g == w for g, w in zip(got32, want32))
    out["f32_partings"] = _partings(torch, one32, few, got32, want32)
    del p32
    torch.cuda.empty_cache()
    return out


def parallel_tp_generate(torch, mesh, name: str) -> dict:
    """Plain ``generate`` of ``name`` (llama-3-8b or its -int8, at full
    width and PAR_GENERATE_LAYERS layers) at tp=2: the prefill logits
    held to the tp=1 engine's within the bf16 logit tolerance, the
    greedy tokens against tp=1's (a parting only at a near tie, margin
    from the tp=1 engine teacher forced), the flash kernel's launches
    (L a prefill) and, int8, the dense kernel's (7 x L a forward, on the
    sliced weights) on both ranks, ms/token tp=2 against tp=1
    (both eager), rank 0's device ms a step and idle share, and the
    collectives."""
    import numpy as np

    from distributed_inference_demo_tpu_torch.models.decoder import \
        init_full_params
    from distributed_inference_demo_tpu_torch.models.registry import \
        get_model_config
    from distributed_inference_demo_tpu_torch.ops.sampling import \
        SamplingParams
    from distributed_inference_demo_tpu_torch.parallel.tensor import (
        free_tp, rank_launches)
    from distributed_inference_demo_tpu_torch.runtime.engine import (
        InferenceEngine, shard_engine_params)

    full_depth = get_model_config(name).num_layers
    cfg = get_model_config(name).replace(num_layers=PAR_GENERATE_LAYERS)
    L = cfg.num_layers
    n = PAR_GENERATE_NEW
    kw = dict(max_seq=MAX_SEQ, sampling=SamplingParams(greedy=True),
              device="cuda", cuda_graph=False)
    prompt = np.random.RandomState(3).randint(0, cfg.vocab_size,
                                              (1, PROMPT_LEN))
    out = {"check": "tp_generate", "model": name, "tp": PAR_TP,
           "layers": L, "layers_of_the_model": full_depth,
           "prompt_len": PROMPT_LEN, "new_tokens": n}
    params = init_full_params(torch.Generator(device="cuda").manual_seed(0),
                              cfg, "cuda",
                              quantize=cfg.quantization != "none")

    def ms_per_token(engine):
        t1 = engine.generate(prompt, 1).seconds
        tn = engine.generate(prompt, 1 + n).seconds
        return (tn - t1) * 1e3 / n

    one = InferenceEngine(cfg, params, **kw)
    lp1 = one.prefill_logits(prompt)[0]
    want = one.generate(prompt, n).tokens[0].tolist()
    out["tp1_ms_per_token"] = ms_per_token(one)
    out["mesh"] = mesh.describe()
    t0, sent = time.perf_counter(), mesh.stats["staged_bytes"]
    sharded = shard_engine_params(params, cfg, mesh)
    out["shard_s"] = time.perf_counter() - t0
    out["shard_sent_bytes"] = mesh.stats["staged_bytes"] - sent
    eng = InferenceEngine(cfg, sharded, mesh=mesh, **kw)
    rank_launches(mesh, reset=True)
    before = dict(mesh.stats)
    lp2 = eng.prefill_logits(prompt)[0]
    got = eng.generate(prompt, n).tokens[0].tolist()
    comm = _mesh_delta(mesh, before)
    per_rank = rank_launches(mesh, reset=True)
    forwards = 2 + n        # prefill_logits, generate's prefill, n steps
    tol = LOGIT_TOL_REL * max(1.0, float(np.abs(lp1).max()))
    err = float(np.abs(lp2 - lp1).max())
    out.update(logit_max_abs_err=err, logit_tol=tol,
               argmax_equal=int(lp2.argmax()) == int(lp1.argmax()),
               tokens_equal=got == want, comm=comm,
               comm_per_forward_ms=comm["collective_ms"] / forwards,
               launches_by_rank=[
                   {"flash": r["flash"]["launches"],
                    "quant_dense": r["quant_dense"]["launches"],
                    "quant_dense_decode":
                        r["quant_dense"]["decode_launches"]}
                   for r in per_rank])
    _check(err <= tol, f"tp=2 prefill logits off by {err} > {tol}")
    if got != want:
        j = next(k for k in range(n) if got[k] != want[k])
        ls = one.prefill_logits(np.asarray([prompt[0].tolist()
                                            + want[:j]]))[0]
        out["parting"] = {"step": j,
                          "margin": float(abs(ls[want[j]] - ls[got[j]])),
                          "logit_tol": tol}
        _check(out["parting"]["margin"] <= tol,
               f"a tp=2 stream parts away from a near tie: "
               f"{out['parting']}")
    dense = 7 * L * forwards if cfg.quantization == "int8" else 0
    for r in out["launches_by_rank"]:
        _check(r["flash"] == 2 * L and r["quant_dense"] == dense,
               f"per-rank launches {out['launches_by_rank']}: flash "
               f"{2 * L}, dense {dense} expected")
    out["tp2_ms_per_token"] = ms_per_token(eng)
    out["rank0_profile"] = profile_decode(torch, eng, prompt, steps=8)
    free_tp(mesh, sharded)                  # the shared mesh lives on
    del eng, sharded, one, params
    torch.cuda.empty_cache()
    return out


def parallel_ep(torch) -> dict:
    """mixtral-tpu-1b at ep=2 (4 experts a rank, the batch data-parallel),
    f32 at full width and depth, capacity factor E (no token drops): the
    prefill logits and one decode step's held to the all-experts path
    (``stage_forward``) within the f32 logit tolerance; the argmax
    agreement; ms of the two prefills; the all-to-alls' ms and bytes."""
    import numpy as np

    from distributed_inference_demo_tpu_torch.models.base import (
        KVCache, StageSpec)
    from distributed_inference_demo_tpu_torch.models.decoder import (
        init_full_params, stage_forward)
    from distributed_inference_demo_tpu_torch.models.registry import \
        get_model_config
    from distributed_inference_demo_tpu_torch.parallel.expert import (
        distribute_ep_params, make_ep_stage_fn, new_ep_cache)
    from distributed_inference_demo_tpu_torch.parallel.mesh import (
        MeshConfig, local_mesh)

    base = get_model_config(MOE_MODEL)
    cfg = base.replace(dtype_name="float32",
                       moe_capacity_factor=float(base.num_experts))
    L, b = cfg.num_layers, 2
    spec = StageSpec(0, 1, 0, L)
    params = init_full_params(torch.Generator(device="cuda").manual_seed(0),
                              cfg, "cuda")
    ids = torch.from_numpy(np.random.RandomState(5).randint(
        0, cfg.vocab_size, (b, PROMPT_LEN))).cuda()
    pos = torch.arange(PROMPT_LEN, device="cuda").expand(b, PROMPT_LEN)

    def full(inp, cache, p):
        return stage_forward(params, cfg, spec, inp, cache, p)

    cache1 = KVCache.create(cfg, L, b, 128, device="cuda")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ref, cache1 = full(ids, cache1, pos)
    torch.cuda.synchronize()
    ms1 = (time.perf_counter() - t0) * 1e3
    nxt = ref[:, -1].argmax(-1)[:, None]
    dpos = torch.full((b, 1), PROMPT_LEN, device="cuda")
    ref2, _ = full(nxt, cache1, dpos)
    out = {"check": "ep", "model": MOE_MODEL, "ep": 2, "dtype": "float32",
           "experts_per_rank": cfg.num_experts // 2, "batch": b,
           "prompt_len": PROMPT_LEN,
           "capacity_factor": cfg.moe_capacity_factor}
    mesh = local_mesh(MeshConfig(ep=2), "cuda")
    try:
        out["mesh"] = mesh.describe()
        ep_params = distribute_ep_params(params, cfg, mesh)
        fn = make_ep_stage_fn(cfg, spec, mesh, ep_params)
        cache = new_ep_cache(cfg, mesh, L, b, 128)
        fn(ep_params, ids, cache, pos)          # warm
        cache = new_ep_cache(cfg, mesh, L, b, 128)
        before = dict(mesh.stats)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got, cache = fn(ep_params, ids, cache, pos)
        torch.cuda.synchronize()
        ms2 = (time.perf_counter() - t0) * 1e3
        comm = _mesh_delta(mesh, before)
        got2, _ = fn(ep_params, nxt, cache, dpos)
    finally:
        mesh.close()
    r, g = ref.float().cpu().numpy(), got.float().cpu().numpy()
    r2, g2 = ref2.float().cpu().numpy(), got2.float().cpu().numpy()
    tol = LOGIT_TOL_F32 * max(1.0, float(np.abs(r).max()))
    out.update(prefill_max_abs_err=float(np.abs(g - r).max()),
               decode_max_abs_err=float(np.abs(g2 - r2).max()),
               logit_tol=tol,
               argmax_agreement=float((g.argmax(-1) == r.argmax(-1))
                                      .mean()),
               prefill_ms={"all_experts": ms1, "ep2": ms2},
               comm_prefill=comm)
    _check(out["prefill_max_abs_err"] <= tol
           and out["decode_max_abs_err"] <= tol,
           f"ep=2 logits off: {out['prefill_max_abs_err']}, "
           f"{out['decode_max_abs_err']} > {tol}")
    del params
    torch.cuda.empty_cache()
    return out


def parallel_sp(torch) -> dict:
    """TinyLlama f32 at sp=2, ring and Ulysses, on a SP_PROMPT_LEN-token
    prompt, at SP_LAYERS of its layers (full width): SP_NEW greedy tokens equal the single-device engine's at the
    same max_seq; each strategy's seconds against the engine's, Ulysses'
    flash launches (L a prefill on each rank: its head blocks attend
    through the kernel), the collectives' ms and staged bytes."""
    import numpy as np

    from distributed_inference_demo_tpu_torch.models.decoder import \
        init_full_params
    from distributed_inference_demo_tpu_torch.models.registry import \
        get_model_config
    from distributed_inference_demo_tpu_torch.ops.sampling import \
        SamplingParams
    from distributed_inference_demo_tpu_torch.parallel.mesh import \
        local_sp_mesh
    from distributed_inference_demo_tpu_torch.parallel.sequence import (
        make_sp_generate_fn, replicate_params)
    from distributed_inference_demo_tpu_torch.parallel.tensor import \
        rank_launches
    from distributed_inference_demo_tpu_torch.parallel.ulysses import \
        make_ulysses_generate_fn
    from distributed_inference_demo_tpu_torch.runtime.engine import \
        InferenceEngine

    full = get_model_config(SERVE_MODEL)
    cfg = full.replace(dtype_name="float32", num_layers=SP_LAYERS)
    L = cfg.num_layers
    params = init_full_params(torch.Generator(device="cuda").manual_seed(0),
                              cfg, "cuda")
    prompt = np.random.RandomState(4).randint(0, cfg.vocab_size,
                                              (1, SP_PROMPT_LEN))
    one = InferenceEngine(cfg, params, max_seq=SP_MAX_SEQ,
                          sampling=SamplingParams(greedy=True),
                          device="cuda", cuda_graph=False)
    res = one.generate(prompt, SP_NEW)
    want = res.tokens.tolist()
    out = {"check": "sp", "model": SERVE_MODEL, "sp": 2, "dtype": "float32",
           "layers": L, "layers_of_the_model": full.num_layers,
           "prompt_len": SP_PROMPT_LEN, "new_tokens": SP_NEW,
           "max_seq": SP_MAX_SEQ, "single_s": res.seconds}
    del one
    mesh = local_sp_mesh(2, "cuda")
    try:
        out["mesh"] = mesh.describe()
        rep = replicate_params(params, cfg, mesh)
        for name, make in (("ring", make_sp_generate_fn),
                           ("ulysses", make_ulysses_generate_fn)):
            gen = make(cfg, mesh, max_seq=SP_MAX_SEQ, num_new_tokens=SP_NEW)
            rank_launches(mesh, reset=True)
            before = dict(mesh.stats)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            got = gen(rep, prompt, 0).tolist()
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            flash = [r["flash"]["launches"] for r in rank_launches(mesh)]
            out[name] = {"seconds": dt, "tokens_equal": got == want,
                         "flash_launches_by_rank": flash,
                         "comm": _mesh_delta(mesh, before)}
            _check(got == want, f"sp {name} tokens {got} != {want}")
            _check(flash == ([L] * 2 if name == "ulysses" else [0, 0]),
                   f"sp {name} flash launches {flash}")
    finally:
        mesh.close()
    del params
    torch.cuda.empty_cache()
    return out


def phase_parallel(torch) -> dict:
    """Multiple devices on torch.distributed, on the one card: see the
    module docstring, item 15.  Each check prints its own line."""
    from distributed_inference_demo_tpu_torch.parallel.mesh import \
        local_tp_mesh

    t0 = time.perf_counter()
    out = {"phase": "parallel", "device": torch.cuda.get_device_name(0),
           "device_count": torch.cuda.device_count(),
           "power": nvidia_smi_line(), "note": PARALLEL_NOTE}
    print(f"parallel: torch.cuda.device_count() = "
          f"{torch.cuda.device_count()}", flush=True)

    def run(key, fn, *args):
        t1 = time.perf_counter()
        res = fn(torch, *args)
        res["seconds"] = time.perf_counter() - t1
        emit(res)
        out[key] = res

    run("nccl", parallel_nccl)
    # the three tp checks share one tp mesh (its ranks start once)
    t1 = time.perf_counter()
    mesh = local_tp_mesh(PAR_TP, "cuda")
    out["tp_mesh_s"] = time.perf_counter() - t1
    try:
        run("tp_batching", parallel_tp_batching, mesh)
        run("tp_llama3_8b", parallel_tp_generate, mesh, LARGE_MODEL)
        run("tp_llama3_8b_int8", parallel_tp_generate, mesh,
            LARGE_MODEL + "-int8")
    finally:
        mesh.close()
    run("ep", parallel_ep)
    run("sp", parallel_sp)
    out["seconds"] = time.perf_counter() - t0
    return out


# ---------------------------------------------------------------------------
# phase 16: the ring pipeline
# ---------------------------------------------------------------------------

CHAIN_STAGES = 3
# the chain phase's depth cut (full width): every check holds at any depth
# (per-stage launches = layers x chunks, tokens against the engine at the
# same depth, the reshards, f32 exact), and the eager stages' time scales
# with it
CHAIN_LAYERS = 6
CHAIN_PROMPTS = (20, 150, 600, 1500)
CHAIN_NEW = 32
CHAIN_HTTP = (20, 150)           # the prompts also served over HTTP
CHAIN_F32_PROMPTS = (20, 150)
# request 0's token count at which the window reshards 3 -> 2 -> 3
CHAIN_RESHARD_AT = ((8, 2), (20, 3))
CHAIN_PROFILE_NEW = 16


def _chain_build(torch, cfg, full, dev, n: int = CHAIN_STAGES):
    """(header, workers, threads): ``n`` elastic stages on ``dev``, each an
    ``ElasticStageRuntime`` over the full tree (slice views, one copy of
    the weights), the workers' serve loops on threads of this process,
    over ``LoopbackTransport`` (the card machine has no pyzmq); the
    header's first reshard pushes ``split_layer_ranges(L, n)``."""
    import threading

    from distributed_inference_demo_tpu_torch.comm.transport import (
        LoopbackNetwork, LoopbackTransport)
    from distributed_inference_demo_tpu_torch.models.base import \
        split_layer_ranges
    from distributed_inference_demo_tpu_torch.ops.sampling import \
        SamplingParams
    from distributed_inference_demo_tpu_torch.runtime.elastic import (
        ElasticHeader, ElasticStageRuntime, ElasticWorker)

    greedy = SamplingParams(greedy=True)
    net = LoopbackNetwork()
    ids = [f"s{i}" for i in range(n)]
    rts = [ElasticStageRuntime(cfg, spec, full, MAX_SEQ, greedy, device=dev)
           for spec in split_layer_ranges(cfg.num_layers, n)]
    workers = [ElasticWorker(rts[i], LoopbackTransport(ids[i], net),
                             next_id=ids[i + 1] if i + 1 < n else None,
                             header_id=ids[0], step_timeout=600)
               for i in range(1, n)]
    threads = [threading.Thread(target=w.serve_forever, daemon=True)
               for w in workers]
    for t in threads:
        t.start()
    header = ElasticHeader(rts[0], LoopbackTransport(ids[0], net), ids,
                           step_timeout=600)
    header.reshard(ids)
    return header, workers, threads


def _chain_stop(header, threads) -> None:
    header.shutdown_pipeline()
    for t in threads:
        t.join(timeout=60)


def _chain_pools_whole(header, workers, timeout: float = 30.0) -> bool:
    """Every stage's pool whole again, once the ``end:`` frames the
    stages handle on their own threads have landed (bounded wait)."""
    rts = [header.rt] + [w.rt for w in workers]
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if all(r.pages_free == r.num_pages and not r._tables for r in rts):
            return True
        time.sleep(0.01)
    return False


def _chain_reshard_run(header, prompts, new: int):
    """``generate_many`` over ``prompts`` (pool_size = all of them) with
    CHAIN_RESHARD_AT's planned reshards requested at request 0's token
    counts: 3 -> 2 stages (the third parks) and back to 3 (it
    rejoins)."""
    plan = list(CHAIN_RESHARD_AT)
    chain = list(header.chain)

    def on_token(i, step, toks):
        if i == 0 and plan and step + 1 == plan[0][0]:
            header.request_reshard(chain[:plan.pop(0)[1]])

    got = header.generate_many(prompts, new, pool_size=len(prompts),
                               on_token=on_token)
    _check(not plan and header.chain == chain,
           f"the planned reshards did not run: {plan}, {header.chain}")
    return [g[0].tolist() for g in got]


def chain_partings(torch, engine, prompts, got, want) -> list:
    """Where bf16 chain streams part from ``want``: the first differing
    step, and the gap between the two tokens' logits there, teacher
    forced one token a forward through the single-device ``engine``.  A
    parting must sit at a near tie (within LOGIT_TOL_REL of the largest
    logit)."""
    import numpy as np
    out = []
    for i, (g, w) in enumerate(zip(got, want)):
        if g == w:
            continue
        j = next(k for k in range(min(len(g), len(w))) if g[k] != w[k])
        seq = prompts[i][0].tolist() + w[:j]
        ls = _teacher_logits(torch, engine, seq, prompts[i].shape[1], 1)
        row = {"request": i, "step": j,
               "margin": float(abs(ls[w[j]] - ls[g[j]])),
               "logit_tol": LOGIT_TOL_REL * max(1.0,
                                                float(np.abs(ls).max()))}
        out.append(row)
        _check(row["margin"] <= row["logit_tol"],
               f"a chain stream parts away from a near tie: {row}")
    return out


def _chain_ms_a_token(gen) -> float:
    """(t(1 + CHAIN_NEW) - t(1)) / CHAIN_NEW of ``gen(n)``, in ms."""
    gen(1)                                       # warm
    t0 = time.perf_counter()
    gen(1)
    t1 = time.perf_counter()
    gen(1 + CHAIN_NEW)
    t2 = time.perf_counter()
    return ((t2 - t1) - (t1 - t0)) / CHAIN_NEW * 1e3


def _chain_profile(torch, gen, tokens: int) -> dict:
    with _device_profile() as prof:
        t0 = time.perf_counter()
        gen(tokens)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    out = _profile_summary(prof, wall_ms, {"tokens": tokens})
    _check(out["kernels"] > 0, "torch.profiler recorded no kernel")
    return out


def _chain_hop_stats(header, workers) -> list:
    """Each stage's compute ms and wire (send) ms a hop, bytes a hop and
    its device-to-host copies, from its ``StageStats`` (the header's
    own and the polled snapshots agree on the counters)."""
    snaps = header.collect_stats(len(workers) + 1)
    _check(len(snaps) == len(workers) + 1, f"stats poll: {len(snaps)}")
    rows = []
    for snap, stats in zip(snaps, [header.stats] + [w.stats
                                                    for w in workers]):
        hops = max(1, snap["messages_out"])
        rows.append({
            "device_id": snap["device_id"], "role": snap["role"],
            "hops": snap["messages_out"],
            "compute_ms_a_hop": snap["compute_s"] / max(1, snap["steps"])
            * 1e3,
            "compute_p50_ms": snap.get("compute_p50_ms"),
            "wire_ms_a_hop": snap["send_s"] / hops * 1e3,
            "recv_wait_ms_a_hop": snap["recv_wait_s"]
            / max(1, snap["messages_in"]) * 1e3,
            "bytes_a_hop": snap["bytes_out"] / hops,
            **stats.host_copy_snapshot()})
    return rows


def phase_chain(torch, model: str = SERVE_MODEL, dev: str = "cuda") -> dict:
    """The ring pipeline at full width and CHAIN_LAYERS of the model's
    layers (bf16, random weights from seed 0, ``max_seq`` MAX_SEQ; the
    single-device engines it is held to at the same depth):
    CHAIN_STAGES elastic stages, each
    on the card in its own thread, under an ``ElasticHeader``.  The
    main path: CHAIN_PROMPTS' greedy requests, CHAIN_NEW new tokens
    each, interleaved through ``generate_many`` (``pool_size`` 4), then
    CHAIN_HTTP's two through ``HeaderBackend`` over HTTP, counted from
    0: each stage's own ``paged_prefill_mma_kernel`` and
    ``paged_decode_split_kernel`` launches equal its layers x its
    chunks, their sum the wrappers' counts; tokens equal the
    single-device ``InferenceEngine``'s (near-tie partings only) and
    the HTTP answers the window's; every pool whole after.  A window
    resharded 3 -> 2 -> 3 mid-generation continues with the unbroken
    run's tokens.  f32, two requests: chain = engine and resharded =
    unbroken, exactly.  Reported: ms a token of the chain against the
    eager and graph engines on one PROMPT_LEN-token prompt, each
    stage's compute and wire ms a hop and bytes a hop, the 1500-token
    prompt's TTFT, device ms a token and idle share (torch.profiler)."""
    import numpy as np

    from distributed_inference_demo_tpu_torch.models.decoder import \
        init_full_params
    from distributed_inference_demo_tpu_torch.models.registry import \
        get_model_config
    from distributed_inference_demo_tpu_torch.ops import \
        paged_attention as pa
    from distributed_inference_demo_tpu_torch.ops.sampling import \
        SamplingParams
    from distributed_inference_demo_tpu_torch.runtime.engine import \
        InferenceEngine
    from distributed_inference_demo_tpu_torch.runtime.http_server import (
        HeaderBackend, InferenceHTTPServer)

    t_phase = time.perf_counter()
    greedy = SamplingParams(greedy=True)
    full_depth = get_model_config(model).num_layers
    cfg = get_model_config(model).replace(num_layers=CHAIN_LAYERS)
    rng = np.random.RandomState(7)
    prompts = [rng.randint(0, cfg.vocab_size, n).astype(np.int32)[None]
               for n in CHAIN_PROMPTS]
    timing_prompt = rng.randint(0, cfg.vocab_size, PROMPT_LEN).astype(
        np.int32)[None]
    out = {"phase": "chain", "layers": CHAIN_LAYERS,
           "layers_of_the_model": full_depth, "device": torch.cuda.get_device_name(0)
           if dev == "cuda" else dev, "power": nvidia_smi_line()
           if dev == "cuda" else None, "model": model,
           "stages": CHAIN_STAGES, "prompts": list(CHAIN_PROMPTS),
           "new_tokens": CHAIN_NEW, "transport": "loopback, one thread a "
           "stage (no pyzmq on the card machine)"}
    params = init_full_params(
        torch.Generator(device=dev).manual_seed(0), cfg, dev)
    engine = InferenceEngine(cfg, params, max_seq=MAX_SEQ, sampling=greedy,
                             device=dev)
    want = [engine.generate(p, CHAIN_NEW).tokens[0].tolist()
            for p in prompts]
    header, workers, threads = _chain_build(torch, cfg, params, dev)
    stages = [header.rt] + [w.rt for w in workers]
    try:
        out["ranges"] = [[r.spec.layer_start, r.spec.layer_end]
                         for r in stages]
        # the main path, its launches counted from 0
        for rt in stages:
            rt.launches.update(decode=0, prefill=0)
        _reset_launches(pa.paged_flash_attention, pa.paged_prefill_attention)
        t1 = time.perf_counter()
        got = [g[0].tolist() for g in header.generate_many(
            prompts, CHAIN_NEW, pool_size=len(prompts))]
        out["window_s"] = time.perf_counter() - t1
        server = InferenceHTTPServer(
            HeaderBackend(header, max_seq=MAX_SEQ, num_stages=CHAIN_STAGES),
            model_name=model)
        server.start()
        try:
            http = []
            for n in CHAIN_HTTP:
                i = CHAIN_PROMPTS.index(n)
                code, body = _post(server.port, {
                    "prompt_ids": prompts[i].tolist(),
                    "max_new_tokens": CHAIN_NEW})
                _check(code == 200, f"chain /generate answered {code}")
                http.append(json.loads(body)["tokens"][0])
        finally:
            server.shutdown()
        per_stage = [dict(rt.launches) for rt in stages]
        chunks = len(prompts) + len(CHAIN_HTTP)
        predicted = [{"decode": rt.spec.num_layers * chunks
                      * (CHAIN_NEW - 1),
                      "prefill": rt.spec.num_layers * chunks}
                     for rt in stages]
        out["launches_by_stage"] = per_stage
        out["launches_predicted"] = predicted
        out["launches"] = {
            "decode": pa.paged_flash_attention.launches,
            "prefill": pa.paged_prefill_attention.launches}
        if dev == "cuda":
            _check(per_stage == predicted,
                   f"stage launches {per_stage} != {predicted}")
            _check(all(min(n.values()) > 0 for n in per_stage),
                   f"a stage launched no kernel: {per_stage}")
            _check(out["launches"] == {
                k: sum(n[k] for n in per_stage) for k in ("decode",
                                                          "prefill")},
                f"wrapper launches {out['launches']} != the stages' sum")
        _check(http == [got[CHAIN_PROMPTS.index(n)] for n in CHAIN_HTTP],
               "the HTTP answers differ from the window's tokens")
        out["partings"] = chain_partings(torch, engine, prompts, got, want)
        out["tokens_equal"] = sum(g == w for g, w in zip(got, want))
        _check(_chain_pools_whole(header, workers),
               "a stage pool leaked pages after the main path")

        # 3 -> 2 -> 3 stages mid-generation
        t1 = time.perf_counter()
        resharded = _chain_reshard_run(header, prompts, CHAIN_NEW)
        out["reshard"] = {
            "seconds": time.perf_counter() - t1, "epoch": header.epoch,
            "tokens_equal": sum(r == g for r, g in zip(resharded, got)),
            "partings": chain_partings(torch, engine, prompts, resharded,
                                       got)}
        _check(_chain_pools_whole(header, workers),
               "a stage pool leaked pages after the reshards")

        # reported: ms a token, hop costs, TTFT, the device's share
        eager = InferenceEngine(cfg, params, max_seq=MAX_SEQ,
                                sampling=greedy, device=dev,
                                cuda_graph=False)
        out["ms_a_token"] = {
            "chain": _chain_ms_a_token(
                lambda n: header.generate(timing_prompt, n)),
            "engine_eager": _chain_ms_a_token(
                lambda n: eager.generate(timing_prompt, n)),
            "engine_graph": _chain_ms_a_token(
                lambda n: engine.generate(timing_prompt, n))}
        del eager
        header.reset_stats()
        header.generate(timing_prompt, 1 + CHAIN_NEW)
        out["hops"] = _chain_hop_stats(header, workers)
        t1 = time.perf_counter()
        header.generate(prompts[-1], 1)
        out["ttft_1500_s"] = time.perf_counter() - t1
        one = _chain_profile(torch, lambda n: header.generate(
            timing_prompt, n), 1)
        many = _chain_profile(torch, lambda n: header.generate(
            timing_prompt, n), 1 + CHAIN_PROFILE_NEW)
        out["profile"] = {
            "prefill": one, "generate": many,
            "device_ms_a_token": (many["device_busy_ms"]
                                  - one["device_busy_ms"])
            / CHAIN_PROFILE_NEW,
            "device_idle_share": many["device_idle_share"]}
        _check(_chain_pools_whole(header, workers),
               "a stage pool leaked pages after the timed runs")
    finally:
        _chain_stop(header, threads)
    del header, workers, threads, stages, engine, params
    torch.cuda.empty_cache()

    # f32: two requests, chain = engine and resharded = unbroken, exactly
    t1 = time.perf_counter()
    cfg32 = cfg.replace(dtype_name="float32")
    p32 = init_full_params(torch.Generator(device=dev).manual_seed(0), cfg32,
                           dev)
    engine = InferenceEngine(cfg32, p32, max_seq=MAX_SEQ, sampling=greedy,
                             device=dev)
    f32_prompts = [prompts[CHAIN_PROMPTS.index(n)] for n in
                   CHAIN_F32_PROMPTS]
    want32 = [engine.generate(p, CHAIN_NEW).tokens[0].tolist()
              for p in f32_prompts]
    header, workers, threads = _chain_build(torch, cfg32, p32, dev)
    try:
        got32 = [g[0].tolist() for g in header.generate_many(
            f32_prompts, CHAIN_NEW, pool_size=len(f32_prompts))]
        resharded32 = _chain_reshard_run(header, f32_prompts, CHAIN_NEW)
        _check(_chain_pools_whole(header, workers),
               "an f32 stage pool leaked pages")
    finally:
        _chain_stop(header, threads)
    _check(got32 == want32, "f32 chain tokens differ from the engine's")
    _check(resharded32 == got32,
           "f32 resharded chain tokens differ from the unbroken run's")
    out["f32"] = {"requests": len(f32_prompts), "tokens_equal": True,
                  "reshard_equal": True,
                  "seconds": time.perf_counter() - t1}
    del header, workers, threads, engine, p32
    torch.cuda.empty_cache()
    out["seconds"] = time.perf_counter() - t_phase
    return out


# ---------------------------------------------------------------------------
# phase 17: the root server (control plane, planner, stage blobs)
# ---------------------------------------------------------------------------

SERVER_WORKERS = ("w1", "w2")
SERVER_POOL_PROMPTS = (20, 150)     # served again with --pool-size 2
SERVER_LABELS = (7, 42, 99)
SERVER_INT8_PROMPT = 20
SERVER_INT8_NEW = 16
SERVER_BENCH = ("bench", "--model", SERVE_MODEL, "--batch", "8",
                "--prompt-len", str(PROMPT_LEN), "--max-new-tokens",
                str(CHAIN_NEW))


def _bits_equal(torch, a, b) -> bool:
    """Two float tensors bit for bit (bf16 through their int16 view)."""
    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    if a.dtype == torch.bfloat16:
        a, b = a.view(torch.int16), b.view(torch.int16)
    return bool(torch.equal(a, b))


def _stage_params_equal(torch, got, want) -> bool:
    return all(
        (getattr(got, part) is None) == (getattr(want, part) is None)
        and (getattr(want, part) is None
             or (sorted(getattr(got, part)) == sorted(getattr(want, part))
                 and all(_bits_equal(torch, getattr(got, part)[k], v)
                         for k, v in getattr(want, part).items())))
        for part in ("layers", "embed", "final_norm", "lm_head"))


def server_ring(torch, model: str, dev: str = "cuda") -> dict:
    """``ServerApp``'s own steps in one process, the header and two
    workers on threads over ``LoopbackTransport``; only the socket-bound
    parts are replaced: registration, the monitor service and the
    lifecycle broadcast answer through their handlers (``bind=False``,
    ``dispatch``) with encoded envelopes.

    Each device runs ``memory_info`` and ``flops_probe`` on the card and
    probes its ring successor's ``BandwidthServer`` over localhost TCP;
    the reports go through ``MonitorService`` / ``MonitorAggregator``;
    the plan covers the layers contiguously with the header as stage 0,
    and ``cli plan`` on the same profiles prints it; each worker's stage
    params after ``stage_params_from_bytes`` are bit-equal to its slice.
    Returns the line's fields and, under ``"_ring"``, (app, header,
    workers, threads, transports, full) for the caller, which stops the
    ring."""
    import contextlib
    import hashlib
    import io
    import tempfile
    import threading

    from distributed_inference_demo_tpu_torch import cli
    from distributed_inference_demo_tpu_torch.comm.transport import (
        LoopbackNetwork, LoopbackTransport)
    from distributed_inference_demo_tpu_torch.control import (
        DevicePoolManager, RegistrationService, RunConfig)
    from distributed_inference_demo_tpu_torch.control.messages import (
        MsgType, decode, make)
    from distributed_inference_demo_tpu_torch.models.base import slice_stage
    from distributed_inference_demo_tpu_torch.models.loader import \
        stage_params_from_bytes
    from distributed_inference_demo_tpu_torch.monitor import (
        MonitorAgent, MonitorAggregator, MonitorService)
    from distributed_inference_demo_tpu_torch.server_app import (
        ServerApp, auto_worker, auto_worker_runtime)

    app = ServerApp(model, num_workers=len(SERVER_WORKERS), max_seq=MAX_SEQ,
                    max_new_tokens=CHAIN_NEW, greedy=True,
                    collect_timeout=60, step_timeout=600, device=dev)
    ids = [app.device_id, *SERVER_WORKERS]
    net = LoopbackNetwork()
    transports = {d: LoopbackTransport(d, net) for d in ids}
    out = {"model": model}

    # registration: the workers' REGISTER envelopes, in process
    pool = DevicePoolManager()
    registry = RegistrationService(pool, bind=False)
    for w in SERVER_WORKERS:
        [ack] = registry.dispatch(w, make(
            MsgType.REGISTER, device_id=w, address=transports[w].address,
            role="worker", model=None, capabilities={}))
        _check(decode(ack).get("ok") is True, f"{w} not registered")
    devices = app.collect_devices(pool)
    addresses = {d.device_id: d.address for d in devices}
    addresses[app.device_id] = transports[app.device_id].address

    # the monitor round: probes on the card and over localhost TCP
    t0 = time.perf_counter()
    agg = MonitorAggregator(expected=ids)
    monitor = MonitorService(agg, bind=False)
    agents = {d: MonitorAgent(None, d, platform="gpu", device=dev,
                              measure_flops=d != app.device_id)
              for d in ids}
    probes = {}
    try:
        for a in agents.values():
            a.bw_server.start()
            [graph] = monitor.dispatch(a.device_id, make(
                MsgType.MONITOR_HELLO, device_id=a.device_id,
                host="127.0.0.1", bw_port=a.bw_server.port))
            _check(decode(graph).type == MsgType.MONITOR_GRAPH,
                   "monitor hello not answered with the peer graph")
        peers = {d: {"host": "127.0.0.1", "bw_port": a.bw_server.port}
                 for d, a in agents.items()}
        replies = []
        for i, d in enumerate(ids):
            succ = ids[(i + 1) % len(ids)]
            rep = agents[d].measure_round({succ: peers[succ]})
            if d == app.device_id:
                # the server's own report, as ServerApp.run adds it, with
                # the header's probe of its successor beside it
                rep = dict(app.self_report(), latency=rep["latency"],
                           bandwidth=rep["bandwidth"])
                agg.add_report(d, rep)
            else:
                [r] = monitor.dispatch(d, make(MsgType.MONITOR_REPORT,
                                               device_id=d, report=rep))
                replies.append(decode(r).type.value)
            probes[d] = {"tflops": rep["flops"] / 1e12,
                         "bytes_per_s": rep["bandwidth"].get(succ),
                         "latency_ms": (rep["latency"][succ] * 1e3
                                        if succ in rep["latency"]
                                        else None),
                         "memory": rep["memory"], "successor": succ}
            _check(rep["flops"] > 0 and succ in rep["bandwidth"]
                   and succ in rep["latency"],
                   f"{d}: a probe of {succ} failed: {rep}")
    finally:
        for a in agents.values():
            a.bw_server.stop()
            a.close()
    _check(agg.is_monitor_ready.is_set() and replies[-1] == "monitor_stop",
           f"monitor round not complete: {replies}")
    out["probes"] = probes
    out["monitor_s"] = time.perf_counter() - t0

    # the plan, and the plan command on the same profiles
    plan = app.make_plan(agg, addresses, ids)
    ranges = [plan.stage_ranges[d] for d in plan.device_ids]
    out["ranges"] = dict(plan.stage_ranges)
    _check(plan.device_ids[0] == app.device_id and ranges[0][0] == 0
           and ranges[-1][1] == app.cfg.num_layers
           and all(a[1] == b[0] and a[0] < a[1]
                   for a, b in zip(ranges, ranges[1:])),
           f"the plan does not cover the layers in ring order: {ranges}")
    profiles = agg.device_profiles(addresses, ring_order=ids)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "devices.json")
        with open(path, "w") as f:
            json.dump([vars(p) for p in profiles], f)
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = cli.main(["plan", "--model", model, "--devices", path,
                           "--ctx", str(MAX_SEQ)])
    _check(rc == 0 and json.loads(buf.getvalue()) == plan.to_json(),
           "cli plan on the same profiles prints another plan")
    out["plan_cli_equal"] = True

    # the lifecycle: OPEN, the chunked stage blobs, the START barrier
    t0 = time.perf_counter()
    full = app.load_weights()
    torch.cuda.synchronize()
    out["weights_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    lifecycle = app.lifecycle_server(full, addresses, bind=False)
    serialize_s = {}
    provider = lifecycle.artifact_provider

    def timed_provider(dev_id, name):
        t1 = time.perf_counter()
        blob = provider(dev_id, name)
        serialize_s[dev_id] = time.perf_counter() - t1
        return blob

    lifecycle.artifact_provider = timed_provider
    specs = dict(zip(plan.device_ids, plan.stage_specs()))
    blobs, runtimes = {}, {}
    for w in SERVER_WORKERS:
        [o] = lifecycle.dispatch(w, make(MsgType.READY, device_id=w))
        config = RunConfig.from_payload(decode(o).get("config"))
        t1 = time.perf_counter()
        parts, index = [], 0
        while True:
            [r] = lifecycle.dispatch(w, make(
                MsgType.ARTIFACT_REQUEST, name=f"stage:{w}", index=index))
            chunk = decode(r)
            _check(chunk.type == MsgType.ARTIFACT_CHUNK,
                   f"{w}: {chunk.type.value} {chunk.get('reason')}")
            parts.append(chunk.get("data"))
            if chunk.get("index") == chunk.get("total") - 1:
                break
            index += 1
        blob = b"".join(parts)
        _check(hashlib.sha256(blob).hexdigest() == chunk.get("sha256"),
               f"{w}: the blob's checksum differs")
        fetch_s = time.perf_counter() - t1
        t1 = time.perf_counter()
        params = stage_params_from_bytes(blob, dev)
        torch.cuda.synchronize()
        deserialize_s = time.perf_counter() - t1
        _check(_stage_params_equal(
            torch, params, slice_stage(full, app.cfg, specs[w])),
            f"{w}: stage params differ from the slice after the blob")
        t1 = time.perf_counter()
        runtimes[w] = auto_worker_runtime(config, w, params, dev)
        blobs[w] = {"bytes": len(blob), "chunks": len(parts),
                    "serialize_s": serialize_s[w],
                    "fetch_s": fetch_s, "deserialize_s": deserialize_s,
                    "runtime_s": time.perf_counter() - t1,
                    "bit_equal": True}
        del parts, blob, params
    out["blobs"] = blobs
    out["lifecycle_s"] = time.perf_counter() - t0
    header = app.build_header(full, transports[app.device_id], addresses)
    workers = [auto_worker(config, w, runtimes[w], transports[w],
                           step_timeout=600) for w in SERVER_WORKERS]
    threads = [threading.Thread(target=w.serve_forever, daemon=True)
               for w in workers]
    for t in threads:
        t.start()
    for w in SERVER_WORKERS:
        _check(lifecycle.dispatch(w, make(MsgType.INITIALIZED,
                                          device_id=w)) == [],
               "INITIALIZED answered before the barrier")
        _check(lifecycle.all_running.is_set() == (w == SERVER_WORKERS[-1]),
               "the START barrier fired early or not at all")
    _check(all([decode(r).type for r in lifecycle.take_pushed(w)]
               == [MsgType.START] for w in SERVER_WORKERS),
           "a worker got no START")
    out["_ring"] = (app, header, workers, threads, transports, full)
    return out


def _server_stop(header, threads) -> None:
    header.shutdown_pipeline()
    for t in threads:
        t.join(timeout=60)


def _count_dense_decode(rt, counts: dict) -> None:
    """Book the dense decode kernel's launches made inside ``rt``'s own
    forwards to ``counts[rt]`` (exact while one request runs: its hops
    take the stages one at a time)."""
    from distributed_inference_demo_tpu_torch.ops import quant_dense as qd
    inner = rt.run_chunk

    def run_chunk(rid, inputs):
        before = qd.quant_dense.decode_launches
        out = inner(rid, inputs)
        counts[id(rt)] += qd.quant_dense.decode_launches - before
        return out

    counts[id(rt)] = 0
    rt.run_chunk = run_chunk


def phase_server(torch, model: str = SERVE_MODEL, dev: str = "cuda") -> dict:
    """The root server at TinyLlama's full width and depth (bf16, random
    weights from seed 0, ``max_seq`` MAX_SEQ), one header and two
    workers in threads of this process (see :func:`server_ring`).  The
    planned ring behind ``HeaderBackend`` and ``InferenceHTTPServer``
    answers the chain phase's four prompts (32 new tokens each, greedy)
    over HTTP, counted from 0: each stage's paged launches equal its
    layers x chunks and its layers x hops; tokens equal the graph
    engine's or part at near ties; two of them again under
    ``--pool-size`` 2, one ``/classify``, ``/stats`` roles; every pool
    whole; ms a token against the eager and graph engines.  Then
    ``tinyllama-1.1b-int8`` through the same steps (float blobs, each
    stage quantizing its own slice): one request of 16 tokens, each
    stage's dense decode launches = its layers x 7 x its decode hops.
    Then ``cli bench`` in process: flash launches = L x prefills."""
    import contextlib
    import io
    import threading

    import numpy as np

    from distributed_inference_demo_tpu_torch import cli
    from distributed_inference_demo_tpu_torch.ops import flash_attention as fa
    from distributed_inference_demo_tpu_torch.ops import \
        paged_attention as pa
    from distributed_inference_demo_tpu_torch.ops import quant_dense as qd
    from distributed_inference_demo_tpu_torch.ops.quant import maybe_quantize
    from distributed_inference_demo_tpu_torch.ops.sampling import \
        SamplingParams
    from distributed_inference_demo_tpu_torch.runtime.engine import \
        InferenceEngine

    t_phase = time.perf_counter()
    greedy = SamplingParams(greedy=True)
    out = {"phase": "server", "device": torch.cuda.get_device_name(0),
           "power": nvidia_smi_line(), "model": model,
           "workers": list(SERVER_WORKERS), "prompts": list(CHAIN_PROMPTS),
           "new_tokens": CHAIN_NEW, "transport": "loopback, one thread a "
           "stage; control-plane handlers in process (no pyzmq on the "
           "card machine)"}
    t1 = time.perf_counter()
    ring = server_ring(torch, model, dev)
    app, header, workers, threads, _, full = ring.pop("_ring")
    out.update(ring, ring_s=time.perf_counter() - t1)
    cfg = app.cfg
    rng = np.random.RandomState(7)
    prompts = [rng.randint(0, cfg.vocab_size, n).astype(np.int32)[None]
               for n in CHAIN_PROMPTS]
    timing_prompt = rng.randint(0, cfg.vocab_size, PROMPT_LEN).astype(
        np.int32)[None]
    t1 = time.perf_counter()
    engine = InferenceEngine(cfg, full, max_seq=MAX_SEQ, sampling=greedy,
                             device=dev)
    want = [engine.generate(p, CHAIN_NEW).tokens[0].tolist()
            for p in prompts]
    out["engine_s"] = time.perf_counter() - t1
    stages = [header.rt] + [w.rt for w in workers]
    server = None
    try:
        server = app.http_server(app.build_backend(header))
        server.start()
        for rt in stages:
            rt.launches.update(decode=0, prefill=0)
        _reset_launches(pa.paged_flash_attention, pa.paged_prefill_attention)
        t1 = time.perf_counter()
        got = []
        for p in prompts:
            code, body = _post(server.port, {"prompt_ids": p.tolist(),
                                             "max_new_tokens": CHAIN_NEW})
            _check(code == 200, f"server /generate answered {code}")
            got.append(json.loads(body)["tokens"][0])
        out["http_s"] = time.perf_counter() - t1
        per_stage = [dict(rt.launches) for rt in stages]
        predicted = [{"decode": rt.spec.num_layers * len(prompts)
                      * (CHAIN_NEW - 1),
                      "prefill": rt.spec.num_layers * len(prompts)}
                     for rt in stages]
        out["launches_by_stage"] = per_stage
        out["launches_predicted"] = predicted
        out["launches"] = {"decode": pa.paged_flash_attention.launches,
                           "prefill": pa.paged_prefill_attention.launches}
        _check(per_stage == predicted,
               f"stage launches {per_stage} != {predicted}")
        _check(out["launches"] == {k: sum(n[k] for n in per_stage)
                                   for k in ("decode", "prefill")},
               f"wrapper launches {out['launches']} != the stages' sum")
        out["partings"] = chain_partings(torch, engine, prompts, got, want)
        out["tokens_equal"] = sum(g == w for g, w in zip(got, want))
        _check(_chain_pools_whole(header, workers),
               "a stage pool leaked pages after the HTTP requests")

        code, stats = _get(server.port, "/stats")
        roles = sorted(s["role"] for s in stats["stages"])
        out["stats_roles"] = roles
        _check(code == 200 and roles == ["header", "tail", "worker"],
               f"/stats roles {roles}")
        code, body = _post_path(server.port, "/classify", {
            "prompt_ids": prompts[0].tolist(),
            "label_token_ids": list(SERVER_LABELS)})
        label = json.loads(body)["labels"][0]
        lg = engine.prefill_logits(prompts[0])[0][list(SERVER_LABELS)]
        tol = LOGIT_TOL_REL * max(1.0, float(np.abs(lg).max()))
        out["classify"] = {"label": label, "engine_label": int(lg.argmax()),
                           "margin": float(lg.max() - lg[label]),
                           "logit_tol": tol}
        _check(code == 200 and lg.max() - lg[label] <= tol,
               f"/classify label away from a near tie: {out['classify']}")
    finally:
        if server is not None:
            server.shutdown()

    # --pool-size 2: two requests at once through the dynamic batcher
    app.pool_size = 2
    backend = app.build_backend(header)
    server = app.http_server(backend)
    server.start()
    try:
        idx = [CHAIN_PROMPTS.index(n) for n in SERVER_POOL_PROMPTS]
        pooled = {}

        def ask(i):
            code, body = _post(server.port, {"prompt_ids":
                                             prompts[i].tolist(),
                                             "max_new_tokens": CHAIN_NEW})
            pooled[i] = (code, json.loads(body)["tokens"][0])

        ts = [threading.Thread(target=ask, args=(i,)) for i in idx]
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=600)
        _check(all(pooled[i] == (200, got[i]) for i in idx),
               "--pool-size 2 answers differ from the serialized ones")
        out["pool_size_2_equal"] = True
    finally:
        server.shutdown()
        backend.close()
    _check(_chain_pools_whole(header, workers),
           "a stage pool leaked pages after --pool-size 2")

    t1 = time.perf_counter()
    eager = InferenceEngine(cfg, full, max_seq=MAX_SEQ, sampling=greedy,
                            device=dev, cuda_graph=False)
    out["ms_a_token"] = {
        "server_ring": _chain_ms_a_token(
            lambda n: header.generate(timing_prompt, n)),
        "engine_eager": _chain_ms_a_token(
            lambda n: eager.generate(timing_prompt, n)),
        "engine_graph": _chain_ms_a_token(
            lambda n: engine.generate(timing_prompt, n))}
    _check(_chain_pools_whole(header, workers),
           "a stage pool leaked pages after the timed runs")
    out["timed_s"] = time.perf_counter() - t1
    _server_stop(header, threads)
    del eager, engine, header, workers, threads, stages, full, app
    torch.cuda.empty_cache()

    # -int8: float blobs, each stage quantizing its own slice
    t1 = time.perf_counter()
    ring = server_ring(torch, model + "-int8", dev)
    app, header, workers, threads, _, full = ring.pop("_ring")
    try:
        cfg8 = app.cfg
        prompt = prompts[CHAIN_PROMPTS.index(SERVER_INT8_PROMPT)]
        ring["ring_s"] = time.perf_counter() - t1
        engine = InferenceEngine(cfg8, maybe_quantize(full, cfg8),
                                 max_seq=MAX_SEQ, sampling=greedy, device=dev)
        want8 = engine.generate(prompt, SERVER_INT8_NEW).tokens[0].tolist()
        stages = [header.rt] + [w.rt for w in workers]
        counts = {}
        for rt in stages:
            _count_dense_decode(rt, counts)
        got8 = header.generate(prompt, SERVER_INT8_NEW)[0].tolist()
        dense = [counts[id(rt)] for rt in stages]
        dense_want = [rt.spec.num_layers * 7 * (SERVER_INT8_NEW - 1)
                      for rt in stages]
        ring.update(
            dense_decode_launches_by_stage=dense,
            dense_decode_predicted=dense_want,
            partings=chain_partings(torch, engine, [prompt], [got8],
                                    [want8]),
            tokens_equal=got8 == want8)
        _check(dense == dense_want,
               f"int8 stage dense decode launches {dense} != {dense_want}")
        _check(_chain_pools_whole(header, workers),
               "an int8 stage pool leaked pages")
    finally:
        _server_stop(header, threads)
    ring["seconds"] = time.perf_counter() - t1
    out["int8"] = ring
    del engine, header, workers, threads, stages, full, app
    torch.cuda.empty_cache()

    # bench, in process
    t1 = time.perf_counter()
    _reset_launches(fa.flash_attention)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(list(SERVER_BENCH))
    line = json.loads(buf.getvalue().strip().splitlines()[-1])
    print(json.dumps(line), flush=True)
    bench_prefills = 2            # the warm generate and the timed one
    out["bench"] = {"argv": list(SERVER_BENCH), "line": line,
                    "flash_launches": fa.flash_attention.launches,
                    "flash_predicted": cfg.num_layers * bench_prefills,
                    "seconds": time.perf_counter() - t1}
    _check(rc == 0 and sorted(line) == ["metric", "unit", "value"],
           f"bench printed {line}")
    _check(fa.flash_attention.launches == cfg.num_layers * bench_prefills,
           f"bench flash launches {fa.flash_attention.launches}")
    torch.cuda.empty_cache()
    out["seconds"] = time.perf_counter() - t_phase
    return out


# ---------------------------------------------------------------------------
# phase 18: multimodal serving (the LLaVA tower in front of the decoder)
# ---------------------------------------------------------------------------

VISION_PRESET = "llava15"       # CLIP-ViT-L/14-336: 24 x 1024, 576 patches
VISION_SEED = 11
# the bf16 tower against the same weights in f32: max |diff| within
# VISION_TOWER_TOL_REL of max(1, max |f32|), and the relative RMS within
# VISION_TOWER_RMS_REL
VISION_TOWER_TOL_REL = 5e-2
VISION_TOWER_RMS_REL = 3e-2
VISION_TIMED = 10               # calls timed for the tower and the prefill


def _mm_teacher_logits(torch, engine, embeds, tokens) -> "np.ndarray":
    """Last logits after the multimodal prefix ``embeds`` and ``tokens``
    (the stream so far), one forward through ``engine`` (an
    ``InferenceEngine``)."""
    from distributed_inference_demo_tpu_torch.models.decoder import \
        embed_tokens
    ids = torch.tensor([tokens], dtype=torch.int64, device=embeds.device)
    with torch.no_grad():
        x = torch.cat([embeds, embed_tokens(engine.params, engine.cfg, ids)],
                      dim=1)
    return engine.prefill_embeds_logits(x)[0]


def mm_partings(torch, engine, embeds, got, want) -> list:
    """Where the bf16 stream ``got`` parts from ``want`` after the
    multimodal prefix: the first differing step and the gap between the
    two tokens' logits there, teacher forced through the plain-attention
    ``engine``; a parting must sit at a near tie (LOGIT_TOL_REL of the
    largest logit)."""
    import numpy as np
    if got == want:
        return []
    j = next(k for k in range(min(len(got), len(want))) if got[k] != want[k])
    ls = _mm_teacher_logits(torch, engine, embeds, want[:j])
    row = {"step": j, "margin": float(abs(ls[want[j]] - ls[got[j]])),
           "logit_tol": LOGIT_TOL_REL * max(1.0, float(np.abs(ls).max()))}
    _check(row["margin"] <= row["logit_tol"],
           f"a multimodal stream parts away from a near tie: {row}")
    return [row]


def _vision_ring(torch, mm, dev: str):
    """(header, workers, vision, threads): ``MultimodalHeader`` and one
    ``PipelineWorker`` over ``split_layer_ranges(L, 2)`` on paged stage
    pools, and a ``VisionWorker`` on ``mm``'s tower, each worker's loop on
    a thread of this process over ``LoopbackTransport``."""
    import threading

    from distributed_inference_demo_tpu_torch.comm.transport import (
        LoopbackNetwork, LoopbackTransport)
    from distributed_inference_demo_tpu_torch.models.base import (
        slice_stage, split_layer_ranges)
    from distributed_inference_demo_tpu_torch.ops.sampling import \
        SamplingParams
    from distributed_inference_demo_tpu_torch.runtime.distributed import (
        PipelineWorker, StageRuntime)
    from distributed_inference_demo_tpu_torch.runtime.multimodal import (
        MultimodalHeader, VisionWorker)

    greedy = SamplingParams(greedy=True)
    cfg, params = mm.cfg, mm.engine.params
    net = LoopbackNetwork()
    specs = split_layer_ranges(cfg.num_layers, 2)
    rts = [StageRuntime(cfg, s, slice_stage(params, cfg, s), MAX_SEQ, greedy,
                        kv_layout="paged", device=dev) for s in specs]
    workers = [PipelineWorker(rts[1], LoopbackTransport("s1", net),
                              next_id=None, header_id="s0",
                              step_timeout=600)]
    vision = VisionWorker(mm.vparams, mm.vcfg, LoopbackTransport("vis", net),
                          header_id="s0", step_timeout=600)
    threads = [threading.Thread(target=w.serve_forever, daemon=True)
               for w in workers + [vision]]
    for t in threads:
        t.start()
    header = MultimodalHeader(rts[0], LoopbackTransport("s0", net), "s1",
                              "vis", step_timeout=600)
    return header, workers, vision, threads


def phase_vision(torch, model: str = SERVE_MODEL, dev: str = "cuda") -> dict:
    """``serve --vision --vision-preset llava15`` at full width and depth:
    the CLIP-ViT-L/14-336 tower (24 layers of 1024, 576 patches, bf16) and
    its projector in front of TinyLlama (bf16), random weights from
    ``--weights-seed`` 0, built by the CLI's own ``build_vision_backend``.
    The main path, counted from 0: ``POST /generate`` with a 336 x 336 x 3
    JSON image and one without, through ``InferenceHTTPServer`` over that
    backend: the flash kernel's launches = L x prefills (the image
    request's 576 + VISION_TEXT-row prefix in one forward), the decode
    steps graph replays, the image answer equal to ``MultimodalEngine.
    generate`` and the text answer to a plain ``InferenceEngine``'s
    tokens, exactly; ``/stats``.  Then: (a) the bf16 tower against the
    same weights in f32 on the card; (b) the prefix logits through the
    flash kernel against a plain-attention engine on the same embeds
    (bf16 tolerance), and the greedy image stream against that engine's
    (partings at near ties only); (e) ``MultimodalHeader`` +
    ``VisionWorker`` + one ``PipelineWorker`` (two paged stages) over
    ``LoopbackTransport`` threads: an image and a text request, tokens
    equal the engine's up to near ties, each stage's paged launches =
    its layers x chunks and x hops, pools whole.  Reported: the tower's
    ms for one image, the prefix prefill's ms, the graph decode's ms a
    token, the host's seconds to parse the JSON image."""
    import dataclasses

    import numpy as np

    from distributed_inference_demo_tpu_torch import cli
    from distributed_inference_demo_tpu_torch.models.vision import \
        vision_forward
    from distributed_inference_demo_tpu_torch.ops import flash_attention as fa
    from distributed_inference_demo_tpu_torch.ops import \
        paged_attention as pa
    from distributed_inference_demo_tpu_torch.runtime.engine import \
        InferenceEngine
    from distributed_inference_demo_tpu_torch.runtime.http_server import \
        InferenceHTTPServer
    from distributed_inference_demo_tpu_torch.runtime.multimodal import \
        MultimodalEngine

    t_phase = time.perf_counter()
    on_card = dev == "cuda"
    args = cli._serve_parser().parse_args([
        "--model", model, "--vision", "--vision-preset", VISION_PRESET,
        "--greedy", "--max-seq", str(MAX_SEQ), "--weights-seed", "0",
        "--device", dev])
    t1 = time.perf_counter()
    backend = cli.build_vision_backend(args)
    mm = backend.mm
    eng, cfg, vcfg = mm.engine, mm.cfg, mm.vcfg
    L = cfg.num_layers
    out = {"phase": "vision", "device": torch.cuda.get_device_name(0)
           if on_card else dev, "power": nvidia_smi_line()
           if on_card else None, "model": model, "tower": VISION_PRESET,
           "tower_layers": vcfg.num_layers, "tower_hidden": vcfg.hidden_size,
           "patches": vcfg.num_patches, "text_tokens": VISION_TEXT,
           "new_tokens": VISION_NEW, "attn": eng.attn_backend,
           "build_s": time.perf_counter() - t1}
    _check(eng.attn_backend == ("flash" if on_card else "plain"),
           f"the vision engine's attention is {eng.attn_backend}")
    rng = np.random.RandomState(VISION_SEED)
    shape = (vcfg.image_size, vcfg.image_size, vcfg.channels)
    image = rng.rand(1, *shape).astype(np.float32)
    text = rng.randint(0, cfg.vocab_size, (1, VISION_TEXT)).astype(np.int32)
    n_prefix = vcfg.num_patches + VISION_TEXT
    _check(not on_card or n_prefix == VISION_PREFIX,
           f"the {VISION_PRESET} prefix is {n_prefix} rows, the kernel "
           f"rows assume {VISION_PREFIX}")
    plain_text = InferenceEngine(cfg, eng.params, max_seq=MAX_SEQ,
                                 sampling=eng.sampling, device=dev)
    server = InferenceHTTPServer(backend, model_name=model,
                                 default_max_new=VISION_NEW)
    server.start()
    try:
        # ---- the main path: counts from zero, an image and a text
        # request over HTTP ----
        image_body = {"prompt_ids": text.tolist(),
                      "image": image[0].tolist(),
                      "max_new_tokens": VISION_NEW}
        replays0 = eng.graph_replays
        fa.flash_attention.launches = fa.flash_attention.wide_launches = 0
        t1 = time.perf_counter()
        code, body = _post(server.port, image_body)
        out["image_request_s"] = time.perf_counter() - t1
        _check(code == 200, f"image request: HTTP {code} {body[:200]}")
        image_toks = json.loads(body)["tokens"]
        code, body = _post(server.port, {"prompt_ids": text.tolist(),
                                         "max_new_tokens": VISION_NEW})
        _check(code == 200, f"text request: HTTP {code}")
        text_toks = json.loads(body)["tokens"]
        out["launches"] = {"flash": fa.flash_attention.launches,
                           "flash_wide": fa.flash_attention.wide_launches}
        out["graph_replays"] = eng.graph_replays - replays0
        if on_card:
            _check(out["launches"]["flash"] == 2 * L,
                   f"{out['launches']} flash launches, expected {2 * L} "
                   "(L x 2 prefills)")
            _check(out["graph_replays"] == 2 * VISION_NEW,
                   f"{out['graph_replays']} replays, expected "
                   f"{2 * VISION_NEW}")
        code, stats = _get(server.port, "/stats")
        _check(code == 200 and stats["mode"] == "multimodal"
               and stats["requests_image"] == 1
               and stats["requests_text"] == 1
               and stats["patches_per_image"] == vcfg.num_patches,
               f"/stats {stats}")
        # a bad shape is the reference's 400, an image with stream 501
        code, _ = _post_status(server.port, {**image_body, "image": [[0.0]]})
        _check(code == 400, f"a bad image answered {code}")
        code, _ = _post_status(server.port, {**image_body, "stream": True})
        _check(code == 501, f"an image with stream answered {code}")
    finally:
        server.shutdown()
    want_image = mm.generate(image, text, VISION_NEW).tokens.tolist()
    _check(image_toks == want_image, "the HTTP image answer differs from "
           "MultimodalEngine.generate's tokens")
    # (c) text-only through the backend = the plain engine, exactly
    want_text = plain_text.generate(text, VISION_NEW).tokens.tolist()
    _check(text_toks == want_text, "the text answer differs from the plain "
           "engine's tokens")
    out["tokens_image"] = image_toks[0]
    del plain_text

    # the host's cost of a JSON image: parse the body and make the array
    raw = json.dumps(image_body)
    t1 = time.perf_counter()
    parsed = np.asarray(json.loads(raw)["image"], np.float32)
    out["json_image"] = {"bytes": len(raw),
                         "parse_s": time.perf_counter() - t1}
    _check(np.array_equal(parsed, image[0]), "the JSON image round trip")

    # (a) the bf16 tower against the same weights in f32
    img_t = torch.from_numpy(image).to(dev)
    with torch.no_grad():
        h16 = vision_forward(mm.vparams, vcfg, img_t)
        v32 = {k: ({n: t.float() for n, t in v.items()}
                   if isinstance(v, dict) else v.float())
               for k, v in mm.vparams.items()}
        h32 = vision_forward(v32, dataclasses.replace(
            vcfg, dtype_name="float32"), img_t)
        diff = h16.float() - h32
        scale = max(1.0, float(h32.abs().max()))
        tower = {"dtype": str(h16.dtype).split(".")[-1],
                 "shape": list(h16.shape),
                 "max_abs_err": float(diff.abs().max()), "scale": scale,
                 "tol": VISION_TOWER_TOL_REL * scale,
                 "rel_rms": float(diff.norm() / h32.norm()),
                 "rms_tol": VISION_TOWER_RMS_REL}
        del v32, h32, diff
    _check(tower["shape"] == [1, vcfg.num_patches, cfg.hidden_size]
           and bool(torch.isfinite(h16).all()), f"tower output {tower}")
    _check(tower["max_abs_err"] <= tower["tol"]
           and tower["rel_rms"] <= VISION_TOWER_RMS_REL,
           f"the bf16 tower differs from f32: {tower}")
    out["tower"] = tower

    # (b) the prefix logits, flash against plain attention, same embeds
    embeds = mm.encode(image, text)
    _check(tuple(embeds.shape) == (1, n_prefix, cfg.hidden_size),
           f"prefix embeds {tuple(embeds.shape)}")
    plain = MultimodalEngine(cfg, eng.params, vcfg, mm.vparams,
                             max_seq=MAX_SEQ, sampling=eng.sampling,
                             attn_backend="plain", device=dev)
    fa.flash_attention.launches = fa.flash_attention.wide_launches = 0
    lk = eng.prefill_embeds_logits(embeds)
    prefix_launches = (fa.flash_attention.launches,
                       fa.flash_attention.wide_launches)
    lp = plain.engine.prefill_embeds_logits(embeds)
    scale = max(1.0, float(np.abs(lp).max()))
    out["prefix_logits"] = {"rows": n_prefix,
                            "max_abs_err": float(np.abs(lk - lp).max()),
                            "scale": scale, "tol": LOGIT_TOL_REL * scale,
                            "flash_launches": prefix_launches[0],
                            "wide_launches": prefix_launches[1]}
    if on_card:
        # one launch a layer, the 64-row instance at 600 x 8 rows
        _check(prefix_launches == (L, L) and fa.flash_attention.launches
               == L, f"the prefix prefill launched {prefix_launches}, "
               f"expected ({L}, {L}); plain attention launched "
               f"{fa.flash_attention.launches - L}")
    _check(bool(np.isfinite(lk).all()), "prefix logits not finite")
    _check(out["prefix_logits"]["max_abs_err"] <= LOGIT_TOL_REL * scale,
           f"prefix logits differ: {out['prefix_logits']}")
    # the image conditions the prefix: a flat grey image moves the
    # logits by more than the kernel's rounding does
    grey = np.full_like(image, 0.5)
    moved = float(np.abs(eng.prefill_embeds_logits(
        mm.encode(grey, text)) - lk).max())
    out["prefix_logits"]["moved_by_a_grey_image"] = moved
    _check(moved > out["prefix_logits"]["max_abs_err"],
           f"a grey image moved the prefix logits by only {moved}")
    plain_image = plain.generate(image, text, VISION_NEW).tokens[0].tolist()
    out["plain_partings"] = mm_partings(torch, plain.engine, embeds,
                                        image_toks[0], plain_image)

    # reported: tower ms, prefix prefill ms, graph decode ms a token
    st = eng._state(1)
    with torch.no_grad():
        if on_card:
            out["tower_ms"] = eager_ms(
                torch, lambda: vision_forward(mm.vparams, vcfg, img_t),
                iters=VISION_TIMED, warmup=2)
            out["prefix_prefill_ms"] = eager_ms(
                torch, lambda: eng._embeds_prefill(embeds, st),
                iters=VISION_TIMED, warmup=2)
    eng.generate_embeds(embeds, 1)
    t_one = eng.generate_embeds(embeds, 1).seconds
    t_many = eng.generate_embeds(embeds, 1 + VISION_NEW).seconds
    out["decode_ms_per_token"] = (t_many - t_one) / VISION_NEW * 1e3
    out["image_generate_s"] = mm.generate(image, text, VISION_NEW).seconds
    del plain

    # (e) the ring: MultimodalHeader + VisionWorker + two paged stages
    header, workers, vision, threads = _vision_ring(torch, mm, dev)
    stages = [header.rt] + [w.rt for w in workers]
    image2 = rng.rand(1, *shape).astype(np.float32)
    try:
        for rt in stages:
            rt.launches.update(decode=0, prefill=0)
        _reset_launches(pa.paged_flash_attention, pa.paged_prefill_attention)
        t1 = time.perf_counter()
        ring_image = header.generate_mm(image2, text, VISION_NEW)[0].tolist()
        out["ring_image_s"] = time.perf_counter() - t1
        ring_text = header.generate(text, VISION_NEW)[0].tolist()
        per_stage = [dict(rt.launches) for rt in stages]
        predicted = [{"decode": rt.spec.num_layers * 2 * (VISION_NEW - 1),
                      "prefill": rt.spec.num_layers * 2} for rt in stages]
        out["ring"] = {
            "ranges": [[r.spec.layer_start, r.spec.layer_end]
                       for r in stages],
            "launches_by_stage": per_stage,
            "launches_predicted": predicted,
            "images_encoded": vision.images,
            "hops": _chain_hop_stats(header, workers)}
        out["launches"].update(
            paged_decode=pa.paged_flash_attention.launches,
            paged_prefill=pa.paged_prefill_attention.launches)
        if on_card:
            _check(per_stage == predicted,
                   f"stage launches {per_stage} != {predicted}")
            _check(out["launches"]["paged_decode"]
                   == sum(n["decode"] for n in per_stage)
                   and out["launches"]["paged_prefill"]
                   == sum(n["prefill"] for n in per_stage),
                   f"wrapper launches {out['launches']} != the stages' sum")
        _check(vision.images == 1, f"{vision.images} images encoded")
        _check(_chain_pools_whole(header, workers),
               "a stage pool leaked pages")
        _check(not header._mm_prefix, "the header kept a stashed prefix")
    finally:
        header.shutdown_pipeline()
        header.transport.send("vis", "stop", b"")
        for t in threads:
            t.join(timeout=60)
    embeds2 = mm.encode(image2, text)
    want2 = mm.generate(image2, text, VISION_NEW).tokens[0].tolist()
    out["ring"]["partings"] = (
        mm_partings(torch, eng, embeds2, ring_image, want2)
        + [dict(p, request="text") for p in chain_partings(
            torch, eng, [text], [ring_text], [want_text[0]])])
    out["ring"]["tokens_equal"] = [ring_image == want2,
                                   ring_text == want_text[0]]
    del header, workers, vision, threads, stages, backend, mm, eng
    if on_card:
        torch.cuda.empty_cache()
    out["seconds"] = time.perf_counter() - t_phase
    return out


# ---------------------------------------------------------------------------
# phase 19: the native codec and tokenizer (g++, no card)
# ---------------------------------------------------------------------------

NATIVE_TEXT = ("The quick brown fox jumps over the lazy dog near the river "
               "bank, while héllo wörld 🙂 and the cat sat on the mat. ")
NATIVE_ENCODE_REPS = 50


def native_tokenizer_json(scheme: str) -> str:
    """A ``tokenizer.json`` written here (the card machine has no
    ``tokenizers`` package): ``bytelevel`` (GPT-2's byte alphabet, merges
    of common English pairs, ``<s>`` / ``</s>``) or ``metaspace``
    (letters, ``<0xXX>`` byte fallback, word pieces, the same
    specials)."""
    from distributed_inference_demo_tpu_torch.tokenizer import \
        _byte_to_unicode
    words = ["the", "quick", "brown", "fox", "over", "lazy", "dog", "river",
             "cat", "sat", "mat", "while", "near", "bank", "and", "jumps"]
    specials = ["<s>", "</s>"]
    merges, vocab = [], {}
    if scheme == "bytelevel":
        for t in specials + sorted(set(_byte_to_unicode().values())):
            vocab.setdefault(t, len(vocab))
        sp = "Ġ"
    else:
        for t in (["<unk>"] + specials + [f"<0x{b:02X}>" for b in range(256)]
                  + list("▁abcdefghijklmnopqrstuvwxyz.,'")):
            vocab.setdefault(t, len(vocab))
        sp = "▁"
    for w in words:
        piece = w[0]
        for c in w[1:]:
            merges.append(f"{piece} {c}")
            piece += c
            vocab.setdefault(piece, len(vocab))
        merges.append(f"{sp} {w}")
        vocab.setdefault(sp + w, len(vocab))
    added = [{"id": vocab[c], "content": c, "special": True,
              "single_word": False, "lstrip": False, "rstrip": False,
              "normalized": False} for c in specials]
    if scheme == "bytelevel":
        return json.dumps({
            "model": {"type": "BPE", "vocab": vocab, "merges": merges},
            "pre_tokenizer": {"type": "ByteLevel", "add_prefix_space": False},
            "decoder": {"type": "ByteLevel"}, "added_tokens": added})
    return json.dumps({
        "model": {"type": "BPE", "vocab": vocab, "merges": merges,
                  "unk_token": "<unk>", "byte_fallback": True},
        "pre_tokenizer": {"type": "Metaspace", "replacement": "▁",
                          "prepend_scheme": "always", "split": True},
        "decoder": {"type": "Sequence", "decoders": [
            {"type": "Replace", "pattern": {"String": "▁"}, "content": " "},
            {"type": "ByteFallback"}, {"type": "Fuse"},
            {"type": "Strip", "content": " ", "start": 1, "stop": 0}]},
        "added_tokens": added})


def phase_native(torch, dev: str = "cuda") -> dict:
    """The native library (``comm/native``), built here with g++ from the
    port's own sources into ``build/native/`` (asked for explicitly: a
    failed build raises with g++'s output).  The codec's frames equal
    ``comm/wire.py``'s byte for byte on the port's wire dtypes (a bf16
    hidden chunk of TinyLlama's width copied from the card included) and
    decode to the same arrays; a corrupted frame is rejected by its
    checksum.  The native tokenizer's ids and text equal the python
    backend's on a bytelevel and a metaspace ``tokenizer.json`` this phase
    writes (special tokens and byte fallback in the texts).  Reported:
    the build's seconds, encode and decode µs a frame of the hidden chunk
    for both codecs, and encode µs per 1 KB of text for both tokenizer
    backends."""
    import tempfile

    import numpy as np

    from distributed_inference_demo_tpu_torch.comm import native_codec, wire
    from distributed_inference_demo_tpu_torch.comm.native import build
    from distributed_inference_demo_tpu_torch.runtime.disagg import _to_wire
    from distributed_inference_demo_tpu_torch.tokenizer import Tokenizer

    t_phase = time.perf_counter()
    root = os.path.dirname(os.path.abspath(__file__))
    out = {"phase": "native", "power": nvidia_smi_line()
           if dev == "cuda" else None, "sources": [
               os.path.relpath(build.SRC_DIR / s, root)
               for s in build.SOURCES]}
    t1 = time.perf_counter()
    path = build.build()
    out["build_s"] = time.perf_counter() - t1
    out["library"] = os.path.relpath(path, root)
    _check(path.parent == build.BUILD_DIR and native_codec.available(),
           f"the library is not under build/native: {path}")
    # the codec: every wire dtype, and a bf16 hidden chunk from the card
    rng = np.random.RandomState(0)
    hidden = torch.randn(1, 600, 2048, device=dev,
                         generator=torch.Generator(device=dev).manual_seed(0)
                         ).to(torch.bfloat16)
    arrays = [_to_wire(hidden), rng.randn(3, 5).astype(np.float32),
              rng.randn(4).astype(np.float64),
              rng.randn(2, 2).astype(np.float16),
              rng.randint(-128, 127, 7).astype(np.int8),
              rng.randint(-999, 999, 5).astype(np.int16),
              rng.randint(0, 32000, (1, 9)).astype(np.int32),
              np.arange(6, dtype=np.int64).reshape(2, 3),
              rng.randint(0, 255, 11).astype(np.uint8),
              rng.randint(0, 1 << 16, 3).astype(np.uint16),
              rng.randint(0, 1 << 30, 3).astype(np.uint32),
              np.array([1, 1 << 63], dtype=np.uint64),
              np.array([True, False]), np.array(7, np.int32),
              np.zeros((0, 4), np.float32)]
    _check(isinstance(arrays[0], wire.Bf16Bits), "the hidden chunk's bits")
    for a in arrays:
        frame = native_codec.serialize_tensors([a])
        _check(frame == wire.serialize_tensors([a]),
               f"native frame differs from wire.py's for {a.dtype}")
        [got] = native_codec.deserialize_tensors(frame).tensors
        _check(type(got) is type(a) and got.dtype == a.dtype
               and np.array_equal(got, a), f"native decode of {a.dtype}")
    frame = bytearray(native_codec.serialize_tensors(arrays))
    _check(bytes(frame) == wire.serialize_tensors(arrays),
           "the multi-tensor frame differs")
    frame[len(frame) // 2] ^= 0x01
    try:
        native_codec.deserialize_tensors(bytes(frame))
        rejected = False
    except wire.WireIntegrityError:
        rejected = True
    _check(rejected, "the native codec decoded a corrupted frame")
    chunk = [arrays[0]]
    frame = wire.serialize_tensors(chunk)

    def per_call_us(fn, reps=20):
        fn()
        t = time.perf_counter()
        for _ in range(reps):
            fn()
        return (time.perf_counter() - t) / reps * 1e6

    out["codec"] = {
        "dtypes": len(arrays), "frame_bytes": len(frame),
        "corrupt_rejected": rejected,
        "encode_us": {"native": per_call_us(
            lambda: native_codec.serialize_tensors(chunk)),
            "python": per_call_us(lambda: wire.serialize_tensors(chunk))},
        "decode_us": {"native": per_call_us(
            lambda: native_codec.deserialize_tensors(frame)),
            "python": per_call_us(lambda: wire.deserialize_tensors(frame))}}
    # the tokenizer: native ids = python ids, both schemes
    texts = [NATIVE_TEXT, "<s>the quick</s> fox <s>", "snow ☃ 日本語 \x00 end",
             "  spaces\tand\nnewlines  ", "", "x"]
    kb_text = (NATIVE_TEXT * 16)[:1024]
    kb = len(kb_text.encode("utf-8")) / 1024
    tok_out = {}
    with tempfile.TemporaryDirectory() as tmp:
        for scheme in ("bytelevel", "metaspace"):
            p = os.path.join(tmp, f"{scheme}.json")
            with open(p, "w") as f:
                f.write(native_tokenizer_json(scheme))
            native = Tokenizer.from_file(p, backend="native")
            python = Tokenizer.from_file(p, backend="python")
            _check(native.backend == "native", "native backend")
            for t in texts + [kb_text]:
                ids = native.encode(t, add_bos=True)
                _check(ids == python.encode(t, add_bos=True),
                       f"{scheme}: native ids differ on {t[:30]!r}")
                _check(native.decode(ids) == python.decode(ids),
                       f"{scheme}: native decode differs on {t[:30]!r}")
            ids = native.encode(texts[1])
            _check(ids.count(native.token_to_id("<s>")) == 2,
                   f"{scheme}: special tokens not split out")
            if scheme == "metaspace":
                _check(native.token_to_id("<0xE2>") in native.encode("☃"),
                       "metaspace: no byte fallback")
            tok_out[scheme] = {
                "vocab": native.vocab_size(),
                "encode_us_per_kb": {
                    b: per_call_us(lambda t=t: t.encode(kb_text),
                                   NATIVE_ENCODE_REPS) / kb
                    for b, t in (("native", native), ("python", python))}}
    out["tokenizer"] = tok_out
    out["seconds"] = time.perf_counter() - t_phase
    return out


TRAIN_ROWS, TRAIN_SEQ = 8, 128        # a step's fixed batch: 1024 tokens
TRAIN_MICROBATCHES = 2
TRAIN_STEPS = 3                       # AdamW steps at pp = 1; the first warms
TRAIN_LR = 1e-3                       # moves bf16 weights past their ulp
TRAIN_PP = 2
TRAIN_PP_LAYERS = 2                   # the f32 pp = 2 checks' depth cut
TRAIN_PP_ROWS = 4                     # their batch: 4 x 128 tokens
TRAIN_GRAD_TOL_REL = 2e-3             # of the leaf's largest |gradient|
TRAIN_INT8_ROWS = 2                   # 2 x 128 = 256 rows a dense product
TRAIN_GEN_PROMPT = 32
TRAIN_GEN_NEW = 8
TRAIN_GEN_MICROBATCHES = 2
TRAIN_KEEP_TREE = "llama-test"        # max_to_keep's small tree


def _train_batch(torch, vocab: int, rows: int, seed: int):
    """``rows`` x TRAIN_SEQ token ids from ``seed`` and their next-token
    targets (the last position padded with -100)."""
    import numpy as np
    ids = torch.from_numpy(np.random.RandomState(seed).randint(
        0, vocab, (rows, TRAIN_SEQ)))
    targets = torch.roll(ids, -1, 1)
    targets[:, -1] = -100
    return ids, targets


def _sync(torch, dev: str) -> None:
    if dev == "cuda":
        torch.cuda.synchronize()


def _bits_of(torch, t):
    """A tensor's bytes (bit equality, -0.0 and NaN included)."""
    return t.detach().contiguous().reshape(-1).view(torch.uint8)


def _timed_steps(torch, step, params, opt, ids, targets, n: int, dev: str):
    """``n`` train steps from (params, opt): their losses and the wall ms
    of each (host clock, the card synchronized)."""
    losses, ms = [], []
    for _ in range(n):
        _sync(torch, dev)
        t0 = time.perf_counter()
        params, opt, loss = step(params, opt, ids, targets)
        losses.append(float(loss))
        ms.append((time.perf_counter() - t0) * 1e3)
    return params, opt, losses, ms


def train_pp1(torch, cfg, dev: str) -> tuple:
    """TRAIN_STEPS AdamW steps of the one-rank pipeline at full depth on
    a fixed batch: finite losses that fall; ms a step and tokens/s over
    the steps after the first."""
    import functools

    from distributed_inference_demo_tpu_torch.models.decoder import \
        init_full_params
    from distributed_inference_demo_tpu_torch.parallel.mesh import (
        MeshConfig, local_mesh)
    from distributed_inference_demo_tpu_torch.parallel.pipeline import \
        make_pipeline_train_step

    opt = functools.partial(torch.optim.AdamW, lr=TRAIN_LR,
                            weight_decay=1e-4)
    full = init_full_params(torch.Generator(device=dev).manual_seed(0),
                            cfg, dev)
    ids, targets = _train_batch(torch, cfg.vocab_size, TRAIN_ROWS, 5)
    with local_mesh(MeshConfig(), dev) as mesh:
        step = make_pipeline_train_step(cfg, mesh, opt, TRAIN_MICROBATCHES)
        params, state, losses, ms = _timed_steps(
            torch, step, full, None, ids, targets, TRAIN_STEPS, dev)
    del full
    import math
    steady = sorted(ms[1:])[len(ms[1:]) // 2]
    out = {"layers": cfg.num_layers, "dtype": str(cfg.dtype),
           "batch": [TRAIN_ROWS, TRAIN_SEQ],
           "microbatches": TRAIN_MICROBATCHES, "optimizer":
           f"AdamW(lr={TRAIN_LR}, weight_decay=1e-4), state in "
           f"{cfg.dtype}", "losses": losses, "step_ms": ms,
           "ms_a_step": steady,
           "tokens_per_s": TRAIN_ROWS * TRAIN_SEQ / steady * 1e3}
    _check(all(math.isfinite(x) for x in losses), f"losses {losses}")
    _check(losses[-1] < losses[0], f"the loss did not fall: {losses}")
    return out, params, state, opt


def _autograd_reference(torch, cfg, full, ids, targets):
    """The single-process autograd reference: the training form of
    ``stage_forward`` over the whole batch, mean cross-entropy, its loss
    and every leaf's gradient."""
    from distributed_inference_demo_tpu_torch.models.base import (
        StageParams, StageSpec)
    from distributed_inference_demo_tpu_torch.models.decoder import \
        stage_forward
    from distributed_inference_demo_tpu_torch.parallel.pipeline import \
        _nll_sum

    tree = StageParams(**{
        n: None if getattr(full, n) is None else {
            k: v.detach().clone().requires_grad_(True)
            for k, v in getattr(full, n).items()}
        for n in ("layers", "embed", "final_norm", "lm_head")})
    b, s = ids.shape
    dev = full.embed["tokens"].device
    logits, _ = stage_forward(tree, cfg, StageSpec(0, 1, 0, cfg.num_layers),
                              ids.to(dev), None,
                              torch.arange(s, device=dev).expand(b, s))
    tg = targets.to(dev)
    loss = _nll_sum(logits, tg) / int((tg != -100).sum())
    loss.backward()
    return float(loss.detach()), tree


def train_pp2(torch, cfg, mesh, dev: str) -> dict:
    """pp = 2 over two ranks on the one card (gloo), f32, full width at
    TRAIN_PP_LAYERS layers: ``pipeline_apply``'s loss against the
    single-process autograd reference's; one ``sgd(1.0)`` step's change
    of ``wq``, ``w_down`` and the embedding against its gradient; a
    step's ms against pp = 1's at the same depth, and the bytes it
    staged through host memory."""
    import functools

    from distributed_inference_demo_tpu_torch.models.decoder import \
        init_full_params
    from distributed_inference_demo_tpu_torch.parallel.mesh import (
        MeshConfig, local_mesh)
    from distributed_inference_demo_tpu_torch.parallel.pipeline import (
        distribute_pipeline_params, gather_pipeline_params,
        make_pipeline_train_step, pipeline_loss)
    from distributed_inference_demo_tpu_torch.parallel.tensor import free_tp

    sgd = functools.partial(torch.optim.SGD, lr=1.0)
    full = init_full_params(torch.Generator(device=dev).manual_seed(1),
                            cfg, dev)
    ids, targets = _train_batch(torch, cfg.vocab_size, TRAIN_PP_ROWS, 6)
    M = TRAIN_MICROBATCHES
    ref_loss, ref = _autograd_reference(torch, cfg, full, ids, targets)
    sharded = distribute_pipeline_params(full, cfg, mesh)
    loss = float(pipeline_loss(sharded, cfg, mesh,
                               ids.reshape(M, -1, TRAIN_SEQ),
                               targets.reshape(M, -1, TRAIN_SEQ)))
    step = make_pipeline_train_step(cfg, mesh, sgd, M)
    before = dict(mesh.stats)
    new, state, step_loss = step(sharded, None, ids, targets)
    first = _mesh_delta(mesh, before)
    names = [("layers", "wq"), ("layers", "w_down"), ("embed", "tokens")]
    got = gather_pipeline_params(new, cfg, names)
    update = {}
    for part, key in names:
        want = getattr(ref, part)[key].grad.float().cpu()
        delta = getattr(full, part)[key].float().cpu() - got[(part, key)]
        scale = float(want.abs().max())
        update[f"{part}/{key}"] = {
            "max_abs_err": float((delta - want).abs().max()),
            "grad_max_abs": scale,
            "tol": TRAIN_GRAD_TOL_REL * scale}
    # a second step, timed, and pp = 1's second at the same depth
    before = dict(mesh.stats)
    new, state, _, pp2_ms = _timed_steps(
        torch, step, new, state, ids, targets, 1, dev)
    steady = _mesh_delta(mesh, before)
    free_tp(mesh, new, state)
    with local_mesh(MeshConfig(), dev) as one:
        _, _, _, pp1_ms = _timed_steps(
            torch, make_pipeline_train_step(cfg, one, sgd, M), full, None,
            ids, targets, 2, dev)
    del full, ref, got
    out = {"layers": cfg.num_layers, "dtype": str(cfg.dtype),
           "batch": [TRAIN_PP_ROWS, TRAIN_SEQ], "microbatches": M,
           "loss": loss, "reference_loss": ref_loss,
           "step_loss": float(step_loss),
           "loss_rel_err": abs(loss - ref_loss) / abs(ref_loss),
           "sgd_update_vs_grad": update,
           "first_step_comm": first,
           "pp2_ms_a_step": pp2_ms[-1], "pp1_ms_a_step": pp1_ms[-1],
           "pp2_comm_a_step": steady,
           "staged_bytes_a_step": steady["staged_bytes"]}
    _check(out["loss_rel_err"] <= 1e-4,
           f"pp=2 loss {loss} against the reference's {ref_loss}")
    _check(abs(float(step_loss) - ref_loss) / abs(ref_loss) <= 1e-4,
           f"pp=2 step loss {float(step_loss)} against {ref_loss}")
    for name, u in update.items():
        _check(u["max_abs_err"] <= u["tol"],
               f"pp=2 sgd(1.0) change of {name} differs from the "
               f"gradient: {u}")
    return out


def train_int8(torch, cfg, mesh, dev: str) -> dict:
    """``pipeline_apply`` over the ``-int8`` tree at pp = 2 (every
    quantized product through the dense kernel on the card) against its
    dequantised twin: the last rank's logits within LOGIT_TOL_REL of the
    twin's largest, as the quant phase's twin checks (the loss alone
    barely sees the layers: the final norm fixes the hidden state's
    scale); the dense kernel's launches on each rank against the
    prediction, 7 x its layers x the microbatches (one 256-row product
    each)."""
    from distributed_inference_demo_tpu_torch.models.decoder import \
        init_full_params
    from distributed_inference_demo_tpu_torch.parallel.pipeline import \
        pipeline_loss
    from distributed_inference_demo_tpu_torch.parallel.tensor import \
        rank_launches

    M = TRAIN_MICROBATCHES
    params = init_full_params(torch.Generator(device=dev).manual_seed(2),
                              cfg, dev, quantize=True)
    twin = dequantized_twin(cfg, params)
    ids, targets = _train_batch(torch, cfg.vocab_size, M * TRAIN_INT8_ROWS,
                                7)
    ids, targets = (ids.reshape(M, -1, TRAIN_SEQ),
                    targets.reshape(M, -1, TRAIN_SEQ))
    lt, logits_t = pipeline_loss(twin, cfg, mesh, ids, targets,
                                 return_logits=True)
    rank_launches(mesh, reset=True)
    lq, logits_q = pipeline_loss(params, cfg, mesh, ids, targets,
                                 return_logits=True)
    per_rank = rank_launches(mesh, reset=True)
    del params, twin
    logits_q, logits_t = logits_q.float(), logits_t.float()
    scale = max(1.0, float(logits_t.abs().max()))
    per_layer = dense_per_layer(cfg)
    L_rank = cfg.num_layers // TRAIN_PP
    predicted = per_layer * L_rank * M if dev == "cuda" else 0
    out = {"model": cfg.quantization, "layers": cfg.num_layers,
           "microbatches": M, "rows_a_product": TRAIN_INT8_ROWS * TRAIN_SEQ,
           "loss": float(lq), "twin_loss": float(lt),
           "logit_max_abs_err": float((logits_q - logits_t).abs().max()),
           "logit_scale": scale, "logit_tol": LOGIT_TOL_REL * scale,
           "logit_positions": logits_t[..., 0].numel(),
           "argmax_agreement": int((logits_q.argmax(-1)
                                    == logits_t.argmax(-1)).sum()),
           "launches_by_rank": [r["quant_dense"]["launches"]
                                for r in per_rank],
           "decode_launches_by_rank": [r["quant_dense"]["decode_launches"]
                                       for r in per_rank],
           "predicted_launches_by_rank": [predicted] * TRAIN_PP}
    _check(bool(torch.isfinite(logits_q).all()),
           "int8 pipeline logits not finite")
    _check(out["logit_max_abs_err"] <= out["logit_tol"],
           f"int8 pipeline logits differ from the dequantised twin's by "
           f"{out['logit_max_abs_err']} (> {LOGIT_TOL_REL} x {scale})")
    _check(out["launches_by_rank"] == out["predicted_launches_by_rank"]
           and not any(out["decode_launches_by_rank"]),
           f"dense launches {out['launches_by_rank']} (decode "
           f"{out['decode_launches_by_rank']}), predicted "
           f"{out['predicted_launches_by_rank']} of the prefill kernel")
    return out


def train_generate(torch, cfg, mesh, dev: str) -> dict:
    """``make_pipeline_generate_fn`` at pp = 2, f32, full width and
    depth: its greedy tokens against ``InferenceEngine.generate``'s on
    the same prompts (a parting only at a near tie, by
    :func:`chain_partings`), its ms a token."""
    import numpy as np

    from distributed_inference_demo_tpu_torch.models.decoder import \
        init_full_params
    from distributed_inference_demo_tpu_torch.ops.sampling import \
        SamplingParams
    from distributed_inference_demo_tpu_torch.parallel.pipeline import (
        distribute_pipeline_params, make_pipeline_generate_fn)
    from distributed_inference_demo_tpu_torch.parallel.tensor import free_tp
    from distributed_inference_demo_tpu_torch.runtime.engine import \
        InferenceEngine

    M, n = TRAIN_GEN_MICROBATCHES, TRAIN_GEN_NEW
    greedy = SamplingParams(greedy=True)
    params = init_full_params(torch.Generator(device=dev).manual_seed(3),
                              cfg, dev)
    ids = np.random.RandomState(8).randint(0, cfg.vocab_size,
                                           (M, 1, TRAIN_GEN_PROMPT))
    engine = InferenceEngine(cfg, params, max_seq=MAX_SEQ, sampling=greedy,
                             device=dev)
    want = [engine.generate(ids[m], n).tokens[0].tolist() for m in range(M)]
    sharded = distribute_pipeline_params(params, cfg, mesh)
    gen = make_pipeline_generate_fn(cfg, mesh, max_seq=MAX_SEQ,
                                    num_new_tokens=n, sampling=greedy)
    one = make_pipeline_generate_fn(cfg, mesh, max_seq=MAX_SEQ,
                                    num_new_tokens=1, sampling=greedy)
    one(sharded, ids)                                  # warm
    _sync(torch, dev)
    t0 = time.perf_counter()
    one(sharded, ids)
    t1 = time.perf_counter()
    before = dict(mesh.stats)
    got = gen(sharded, ids)
    t2 = time.perf_counter()
    comm = _mesh_delta(mesh, before)
    got = [got[m, 0].tolist() for m in range(M)]
    free_tp(mesh, sharded)
    partings = chain_partings(torch, engine, [ids[m] for m in range(M)],
                              got, want)
    del engine, params
    return {"layers": cfg.num_layers, "dtype": str(cfg.dtype),
            "microbatches": M, "prompt_len": TRAIN_GEN_PROMPT,
            "new_tokens": n, "ring_steps": TRAIN_PP - 1 + (n - 1) * M,
            "tokens_equal": got == want, "partings": partings,
            "ms_a_token": ((t2 - t1) - (t1 - t0)) * 1e3 / (M * (n - 1)),
            "comm": comm}


def train_checkpoint(torch, cfg, params, state, opt, model: str,
                     dev: str) -> dict:
    """``TrainCheckpointManager`` on the full-depth pp = 1 run's params
    and AdamW state: a save, a restore in a fresh manager, bit equality
    of every tensor, seconds and GB/s each way; ``save_params`` and
    ``load_or_init`` on the params, bit equal; ``max_to_keep`` on a small
    tree.  Everything under a temporary directory, removed."""
    import functools
    import shutil
    import tempfile

    from distributed_inference_demo_tpu_torch import checkpoint as ckpt
    from distributed_inference_demo_tpu_torch.models.loader import \
        load_or_init
    from distributed_inference_demo_tpu_torch.models.registry import \
        get_model_config

    tmp = tempfile.mkdtemp(prefix="dwt-train-ckpt-")
    try:
        p_bytes = sum(t.numel() * t.element_size()
                      for t in ckpt._flatten(params)[0].values())
        sd = state.state_dict()
        s_bytes = sum(x.numel() * x.element_size()
                      for st in sd["state"].values() for x in st.values()
                      if torch.is_tensor(x))
        total = p_bytes + s_bytes
        mgr = ckpt.TrainCheckpointManager(os.path.join(tmp, "train"), cfg,
                                          opt, max_to_keep=2, device=dev)
        _sync(torch, dev)
        t0 = time.perf_counter()
        mgr.save(TRAIN_STEPS, params, state)
        save_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        step, p2, o2 = ckpt.TrainCheckpointManager(
            os.path.join(tmp, "train"), cfg, opt, device=dev
        ).restore_or_init()
        _sync(torch, dev)
        restore_s = time.perf_counter() - t0
        fa, fb = ckpt._flatten(params)[0], ckpt._flatten(p2)[0]
        params_equal = fa.keys() == fb.keys() and all(
            torch.equal(_bits_of(torch, x), _bits_of(torch, fb[k]))
            for k, x in fa.items())
        sb = o2.state_dict()
        state_equal = (sd["param_groups"] == sb["param_groups"] and all(
            torch.equal(_bits_of(torch, x), _bits_of(torch, sb["state"][i][n]))
            for i, st in sd["state"].items() for n, x in st.items()))
        del p2, o2, sb
        path = os.path.join(tmp, "params")
        t0 = time.perf_counter()
        ckpt.save_params(path, params, cfg, model)
        psave_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        loaded = load_or_init(model, cfg, path, device=dev)
        _sync(torch, dev)
        pload_s = time.perf_counter() - t0
        fl = ckpt._flatten(loaded)[0]
        load_equal = fa.keys() == fl.keys() and all(
            torch.equal(_bits_of(torch, x), _bits_of(torch, fl[k]))
            for k, x in fa.items())
        del loaded, fl, fb
        small = get_model_config(TRAIN_KEEP_TREE)
        keep = ckpt.TrainCheckpointManager(
            os.path.join(tmp, "keep"), small,
            functools.partial(torch.optim.SGD, lr=1e-2), max_to_keep=2,
            device=dev)
        _, sp, so = keep.restore_or_init(seed=0)
        for s in (1, 2, 3):
            keep.save(s, sp, so)
        kept = keep.all_steps()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    out = {"restored_step": step, "params_bytes": p_bytes,
           "opt_state_bytes": s_bytes, "save_s": save_s,
           "restore_s": restore_s, "save_gb_s": total / save_s / 1e9,
           "restore_gb_s": total / restore_s / 1e9,
           "params_bit_equal": params_equal,
           "opt_state_bit_equal": state_equal,
           "save_params_s": psave_s, "load_or_init_s": pload_s,
           "load_or_init_gb_s": p_bytes / pload_s / 1e9,
           "load_or_init_bit_equal": load_equal, "max_to_keep_2": kept,
           "reads": "warm (the files were just written; the page cache is "
                    "not dropped)"}
    _check(step == TRAIN_STEPS, f"restored step {step}")
    _check(params_equal and state_equal and load_equal,
           f"checkpoint round trip not bit-equal: params {params_equal}, "
           f"state {state_equal}, load_or_init {load_equal}")
    _check(kept == [2, 3], f"max_to_keep=2 left steps {kept}")
    return out


def phase_train(torch, model: str = SERVE_MODEL, dev: str = "cuda") -> dict:
    """Training on the card (``parallel/pipeline.py``, ``checkpoint.py``):
    TinyLlama at full width.  (1) pp = 1, full depth, bf16, one
    process: TRAIN_STEPS AdamW steps on a fixed batch, the loss finite
    and falling, ms a step and tokens/s.  On one pp = 2 mesh (two ranks
    over gloo on the one card): (2) f32 at TRAIN_PP_LAYERS layers, the
    pipeline's loss and one ``sgd(1.0)`` update against the
    single-process autograd reference, the step against pp = 1's, its
    staged bytes; (3) the ``-int8`` tree's forward through the dense
    kernel against its dequantised twin, launches predicted; (4) the
    circular decode, f32 at full depth, against ``InferenceEngine``'s
    greedy tokens.  (5) ``TrainCheckpointManager`` on (1)'s params and
    AdamW state, bit for bit, GB/s each way."""
    from distributed_inference_demo_tpu_torch.models.registry import \
        get_model_config
    from distributed_inference_demo_tpu_torch.parallel.mesh import (
        MeshConfig, local_mesh)

    t_phase = time.perf_counter()
    cfg = get_model_config(model)
    out = {"phase": "train", "device": dev,
           "power": nvidia_smi_line() if dev == "cuda" else None,
           "model": model, "layers_of_the_model": cfg.num_layers,
           "hidden_size": cfg.hidden_size, "vocab_size": cfg.vocab_size}
    t0 = time.perf_counter()
    out["pp1"], params, state, opt = train_pp1(torch, cfg, dev)
    out["pp1"]["seconds"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    out["checkpoint"] = train_checkpoint(torch, cfg, params, state, opt,
                                         model, dev)
    out["checkpoint"]["seconds"] = time.perf_counter() - t0
    del params, state
    if dev == "cuda":
        torch.cuda.empty_cache()
    f32 = cfg.replace(dtype_name="float32")
    t0 = time.perf_counter()
    with local_mesh(MeshConfig(pp=TRAIN_PP), dev) as mesh:
        out["mesh"] = mesh.describe()
        out["mesh_s"] = time.perf_counter() - t0
        for name, fn, c in (
                ("pp2", train_pp2, f32.replace(num_layers=TRAIN_PP_LAYERS)),
                ("int8", train_int8, get_model_config(model + "-int8")),
                ("generate", train_generate, f32)):
            t0 = time.perf_counter()
            out[name] = fn(torch, c, mesh, dev)
            out[name]["seconds"] = time.perf_counter() - t0
            if dev == "cuda":
                torch.cuda.empty_cache()
    out["note"] = PARALLEL_NOTE
    out["seconds"] = time.perf_counter() - t_phase
    return out


def main(argv) -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this check runs on the card",
              file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    try:
        import distributed_inference_demo_tpu_torch  # noqa: F401
    except ImportError:
        print("chip_smoke: run it from the root of a checkout (the "
              "distributed_inference_demo_tpu_torch package is missing)",
              file=sys.stderr)
        return 2
    # f32 matmuls stay full f32 (the tolerances assume it)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = nvidia_smi_line()
    print(smi, flush=True)

    def timed(fn, *args, **kw):
        """``fn``'s phase line, with its wall seconds if it has none."""
        t0 = time.perf_counter()
        out = fn(*args, **kw)
        out.setdefault("seconds", time.perf_counter() - t0)
        return out

    # --phase NAME: the build, then that phase alone (no result lines)
    only = argv[argv.index("--phase") + 1] if "--phase" in argv else None
    try:
        device = timed(phase_device, torch, smi)
        emit(device)
        if only is not None:
            emit(timed({
                "serve": phase_serve, "batching": phase_batching,
                "mixed": phase_mixed, "graph": phase_graph,
                "quant": phase_quant, "kvcache": phase_kvcache,
                "surface": phase_surface, "moe": phase_moe,
                "fleet": phase_fleet, "parallel": phase_parallel,
                "chain": phase_chain, "server": phase_server,
                "vision": phase_vision, "native": phase_native,
                "speculative": lambda t: phase_speculative(
                    t, device["ptxas"]["paged_attention.cu"])}[only],
                torch))
            return 0
        kern = timed(phase_kernels, torch)
        emit(kern)
        paged = timed(phase_paged_kernels, torch)
        emit(paged)
        qkern = timed(phase_quant_kernels, torch,
                      device["ptxas"]["quant_dense.cu"])
        emit(qkern)
        failures = kern["failures"] + paged["failures"] + qkern["failures"]
        if failures:
            raise AssertionError("kernel disagrees with its plain version: "
                                 + "; ".join(failures))
        if "--kernels-only" in argv:
            return 0
        serve = timed(phase_serve, torch)
        emit(serve)
        batching = timed(phase_batching, torch)
        emit(batching)
        mixed = timed(phase_mixed, torch)
        emit(mixed)
        # the catalog's models at the kernels' other head dims
        served = {}
        for name in HEAD_DIM_MODELS:
            served[name] = timed(phase_serve_model, torch, name)
            emit(served[name])
        gemma_batching = timed(phase_batching, torch, "gemma-2b",
                               f32="gather")
        emit(gemma_batching)
        gemma_mixed = timed(phase_mixed, torch, "gemma-2b", extras=False)
        emit(gemma_mixed)
        bloom_batching = timed(phase_batching, torch, "bloom3b", f32=None)
        emit(bloom_batching)
        emit(timed(phase_graph, torch))
        quant_phase = timed(phase_quant, torch)
        emit(quant_phase)
        kvc = timed(phase_kvcache, torch)
        emit(kvc)
        surface = timed(phase_surface, torch)
        emit(surface)
        spec = timed(phase_speculative, torch,
                     device["ptxas"]["paged_attention.cu"])
        emit(spec)
        fleet = timed(phase_fleet, torch)
        emit(fleet)
        chain = timed(phase_chain, torch)
        emit(chain)
        server = timed(phase_server, torch)
        emit(server)
        vision = timed(phase_vision, torch)
        emit(vision)
        emit(timed(phase_native, torch))
        train = timed(phase_train, torch)
        emit(train)
        par = timed(phase_parallel, torch)
        emit(par)
        moe = timed(phase_moe, torch)
        emit(moe)
    except Exception:
        traceback.print_exc()
        print("chip_smoke: FAILED", file=sys.stderr)
        return 1

    def flash_case(case, dtype="bfloat16"):
        return next(c for c in kern["cases"]
                    if c["case"] == case and c["dtype"] == dtype
                    and c["b"] == 1 and c["chunk"] == PROMPT_LEN
                    and c["q_start"] == 0)

    main_case = flash_case("tinyllama")
    long_case = next(c for c in kern["cases"]
                     if c["case"] == "tinyllama-long"
                     and c["dtype"] == "bfloat16")
    # the paged kernels at the serving path's shapes: decode over 8 slots
    # (bf16, TinyLlama heads), a 64-token admission chunk several pages in
    # (full-width pages for the batching path, int8 pages for the mixed),
    # and the mixed path's own prefill shape, the 4-row slab, which every
    # one of its int8 prefill launches has
    def serve_case(kind, pages, case="tinyllama", dtype="bfloat16"):
        return next(c for c in paged["cases"] if c["case"] == case
                    and c["kind"] == kind and c["dtype"] == dtype
                    and c["pages"] == pages
                    and (c["b"] == SLOTS if kind == "decode" else
                         c["chunk"] == PREFILL_CHUNK
                         and (case != "tinyllama" or c["starts"] == [200])))

    def chain_case(kind, case=SERVE_MODEL + "-chain"):
        return next(c for c in paged["cases"]
                    if c["case"] == case
                    and c["kind"] == kind and c["dtype"] == "bfloat16")

    rows8 = "8 rows, lengths 1-1999, 2 freed"
    chunk200 = "64-token chunk at 200"
    slab = "mixed slab: 4 rows of 64 tokens at 0, 64, 448, one unused"
    # (name, launch count, its phase, kernel case, shape)
    paged_main = [
        ("paged_decode", "paged_decode", batching,
         serve_case("decode", "full"), rows8),
        ("paged_prefill", "paged_prefill", batching,
         serve_case("prefill", "full"), chunk200),
        ("paged_decode_int8", "paged_decode_int8", mixed,
         serve_case("decode", "int8"), rows8),
        ("paged_prefill_int8", "paged_prefill_int8", mixed,
         serve_case("prefill", "int8"), chunk200),
        ("paged_prefill_int8_slab", "paged_prefill_int8", mixed,
         serve_case("prefill", "int8", "tinyllama-slab"), slab),
        ("paged_decode_hd256", "paged_decode", gemma_batching,
         serve_case("decode", "full", "gemma-2b"), "gemma-2b, " + rows8),
        ("paged_prefill_hd256", "paged_prefill", gemma_batching,
         serve_case("prefill", "full", "gemma-2b"), "gemma-2b, " + chunk200),
        ("paged_decode_int8_hd256", "paged_decode_int8", gemma_mixed,
         serve_case("decode", "int8", "gemma-2b"), "gemma-2b, " + rows8),
        ("paged_prefill_int8_hd256", "paged_prefill_int8", gemma_mixed,
         serve_case("prefill", "int8", "gemma-2b"),
         "gemma-2b, " + chunk200),
        ("paged_prefill_int8_slab_hd256", "paged_prefill_int8", gemma_mixed,
         serve_case("prefill", "int8", "gemma-2b-slab"), "gemma-2b, " + slab),
        ("paged_decode_hd80", "paged_decode", bloom_batching,
         serve_case("decode", "full", "bloom3b"), "bloom3b, " + rows8),
        ("paged_prefill_hd80", "paged_prefill", bloom_batching,
         serve_case("prefill", "full", "bloom3b"), "bloom3b, " + chunk200),
        ("paged_decode_fp8", "paged_decode_fp8", kvc["batching"],
         serve_case("decode", "fp8"), "float8 e4m3 pages, " + rows8),
        ("paged_prefill_fp8", "paged_prefill_fp8", kvc["batching"],
         serve_case("prefill", "fp8"), "float8 e4m3 pages, " + chunk200),
        ("paged_decode_surface", "paged_decode", surface,
         serve_case("decode", "full"), rows8 + " (launches: 8 concurrent "
         "text requests of the surface phase)"),
        ("paged_prefill_surface", "paged_prefill", surface,
         serve_case("prefill", "full"), chunk200 + " (launches: the same "
         "8 text requests' admissions)"),
        ("paged_decode_fleet", "paged_decode", fleet,
         serve_case("decode", "full"), rows8 + " (launches: the fleet "
         "phase's bf16 pages: the tier, disaggregation, migration and "
         "failover engines)"),
        ("paged_prefill_fleet", "paged_prefill", fleet,
         serve_case("prefill", "full"), chunk200 + " (launches: the "
         "fleet phase's bf16 pages: suffix prefills after an adopt or a "
         "promotion, resumed admissions)"),
        ("paged_decode_fleet_int8", "paged_decode_int8", fleet,
         serve_case("decode", "int8"), "int8 pages, " + rows8 +
         " (launches: the fleet phase's int8 tier and migration engines)"),
        ("paged_prefill_fleet_int8", "paged_prefill_int8", fleet,
         serve_case("prefill", "int8"), "int8 pages, " + chunk200 +
         " (launches: the fleet phase's int8 suffix prefills after a "
         "promotion or a migration)"),
        ("paged_decode_fleet_f32", "paged_decode", fleet["disagg_f32"],
         serve_case("decode", "full", dtype="float32"), "f32, " + rows8 +
         " (launches: the decode side of the fleet phase's f32 "
         "disaggregation)"),
        ("paged_prefill_fleet_f32", "paged_prefill", fleet["disagg_f32"],
         serve_case("prefill", "full", dtype="float32"), "f32, " +
         chunk200 + " (launches: the same decode side's suffix prefills "
         "after an adopt)"),
        ("paged_decode_mixtral", "paged_decode", moe["batching"],
         serve_case("decode", "full", MOE_MODEL), f"{MOE_MODEL}, " + rows8),
        ("paged_prefill_mixtral", "paged_prefill", moe["batching"],
         serve_case("prefill", "full", MOE_MODEL),
         f"{MOE_MODEL}, " + chunk200),
        # one tp=2 rank's heads; launches: rank 0's in the parallel
        # phase's 8-slot serve (rank 1 launched as many)
        ("paged_decode_tp2", "paged_decode",
         {"launches": par["tp_batching"]["launches_by_rank"][0]},
         serve_case("decode", "full", SERVE_MODEL + "-tp2"),
         "one tp=2 rank (16 q heads on 2 kv heads), " + rows8 +
         f" (launches: the 8-slot serve at {PAR_BATCHING_LAYERS} layers)"),
        ("paged_prefill_tp2", "paged_prefill",
         {"launches": par["tp_batching"]["launches_by_rank"][0]},
         serve_case("prefill", "full", SERVE_MODEL + "-tp2"),
         "one tp=2 rank (16 q heads on 2 kv heads), " + chunk200 +
         f" (launches: the 8-slot serve at {PAR_BATCHING_LAYERS} layers)")]
    # the speculative phase: the [8, K+1] verify on each page type (its
    # launches: a batching run's verify window over that pool, after
    # its last admission),
    # the draft's decode rows (its launches: the draft steps)
    sb = spec["batching"]
    verify = f"verify: 8 rows of {SPEC_K + 1} tokens at 20-1999, one freed"
    verify_case = {p: next(c for c in paged["cases"]
                           if c["case"] == "tinyllama-verify"
                           and c["dtype"] == "bfloat16" and c["pages"] == p)
                   for p in ("full", "int8", "fp8")}
    paged_spec = [
        ("paged_prefill_verify", "paged_prefill",
         sb["draft_serialized"]["verify_launches"], verify_case["full"],
         verify + " (launches: the verify window of the draft-model "
         "serialized batching run)"),
        ("paged_prefill_verify_int8", "paged_prefill_int8",
         sb["draft_mixed_int8"]["verify_launches"], verify_case["int8"],
         "int8 pages, " + verify + " (launches: the verify window of the "
         "draft-model mixed batching run)"),
        ("paged_prefill_verify_fp8", "paged_prefill_fp8",
         sb["pld_serialized_fp8"]["verify_launches"], verify_case["fp8"],
         "float8 e4m3 pages, " + verify + " (launches: the verify window "
         "of the prompt-lookup serialized batching run)"),
        ("paged_decode_draft", "paged_decode",
         sb["draft_serialized"]["launches"]["paged_decode"],
         serve_case("decode", "full", MOE_MODEL),
         f"{SPEC_DRAFT} (hd 64, g = 4), " + rows8 + " (launches: the "
         "draft steps of the draft-model serialized batching run)"),
        ("paged_decode_draft_int8", "paged_decode_int8",
         sb["draft_mixed_int8"]["launches"]["paged_decode"],
         serve_case("decode", "int8", SPEC_DRAFT),
         f"{SPEC_DRAFT}, int8 pages, " + rows8 + " (launches: the draft "
         "steps of the draft-model mixed batching run)")]
    flash_new = [(f"flash_attention_hd{served[n]['head_dim']}", n)
                 for n in HEAD_DIM_MODELS]
    moe_long_case = next(c for c in kern["cases"]
                         if c["case"] == MOE_MODEL + "-long"
                         and c["dtype"] == "bfloat16")
    prefix_case = next(c for c in kern["cases"]
                       if c["case"] == "tinyllama-prefix-hit"
                       and c["dtype"] == "bfloat16")

    def entry(name, source, replaces, launches, case, shape):
        return {"name": name, "route": "cuda", "source": source,
                "replaces": replaces, "shape": shape, "launches": launches,
                # the decode kernel's launches all come from replays of
                # the captured decode step
                "graph_replayed": (name.startswith("paged_decode")
                                   and not name.endswith("_tp2")),
                "max_abs_err": case["max_abs_err"], "ms": case["ms"],
                "plain_ms": case["plain_ms"], "bound_ms": case["bound_ms"],
                "bound_by": case["bound_by"],
                "library_ms": case["library_ms"]}

    server_decode = sum(server["int8"]["dense_decode_launches_by_stage"])
    server_int8 = {"decode_launches": server_decode,
                   "dense_launches": server_decode}
    bench_case = next(c for c in kern["cases"]
                      if c["case"] == "tinyllama-bench"
                      and c["dtype"] == "bfloat16")
    vision_case = next(c for c in kern["cases"]
                       if c["case"] == "tinyllama-vision"
                       and c["dtype"] == "bfloat16")
    r0 = par["tp_llama3_8b_int8"]["launches_by_rank"][0]
    tp2_int8 = {"decode_launches": r0["quant_dense_decode"],
                "dense_launches": r0["quant_dense"]}

    def quant_case(m, bits, weight="w_up", model=SERVE_MODEL):
        return next(c for c in qkern["cases"] if c["model"] == model
                    and c["weight"] == weight and c["m"] == m
                    and c["bits"] == bits and c["dtype"] == "bfloat16")

    def quant_entry(name, side, m, bits, shape, **case):
        # launches: the decode kernel's on the path (every decode step's
        # products, replayed from the graph), or the prefill kernel's (the
        # path's eager prefill forwards)
        c = quant_case(m, bits, **case)
        decode = side["decode_launches"]
        e = entry(name, QUANT_SOURCE, QUANT_REPLACES,
                  decode if c["kernel"] == "decode"
                  else side["dense_launches"] - decode, c, shape)
        e.update(kernel=c["instance"], splits=c["splits"],
                 cold_ms=c["cold_ms"], library_cold_ms=c["library_cold_ms"],
                 graph_replayed=c["kernel"] == "decode")
        return e

    emit({"kernels": [
        entry("flash_attention", KERNEL_SOURCE, KERNEL_REPLACES,
              serve["launches"], main_case, "64-token prompt at 0"),
        entry("flash_attention_long", KERNEL_SOURCE, KERNEL_REPLACES,
              serve["long_wide_launches"], long_case,
              "2048-token prompt at 0 (launches: the 1500-token prompt)")] + [
        entry(name, KERNEL_SOURCE, KERNEL_REPLACES, served[model]["launches"],
              flash_case(model), f"{model}, 64-token prompt at 0")
        for name, model in flash_new] + [
        entry("flash_attention_prefix_hit", KERNEL_SOURCE, KERNEL_REPLACES,
              kvc["prefix_pool"]["warm_flash_launches"], prefix_case,
              f"64-token chunk at {KV_PREFIX}, a prefix hit's suffix "
              "(launches: one warm prefill)"),
        entry("flash_attention_surface", KERNEL_SOURCE, KERNEL_REPLACES,
              surface["flash_launches"], main_case,
              "64-token prompt at 0 (launches: the surface phase's text "
              "prompts of 24 and 1500 tokens on the plain server)"),
        entry("flash_attention_disagg", KERNEL_SOURCE, KERNEL_REPLACES,
              fleet["disagg"]["flash_launches"], main_case,
              "64-token prompt at 0 (launches: the prefill worker's "
              "64-token chunks of the fleet phase's four bf16 "
              "disaggregated requests, L x chunks)"),
        entry("flash_attention_disagg_f32", KERNEL_SOURCE, KERNEL_REPLACES,
              fleet["disagg_f32"]["flash_launches"],
              flash_case("tinyllama", "float32"), "f32, 64-token prompt at "
              "0 (launches: the prefill worker's 64-token chunks of the "
              "fleet phase's two f32 disaggregated requests, L x chunks)"),
        entry("flash_attention_mixtral", KERNEL_SOURCE, KERNEL_REPLACES,
              moe["serve"]["launches"], flash_case(MOE_MODEL),
              f"{MOE_MODEL} (g = 4), 64-token prompt at 0"),
        entry("flash_attention_long_mixtral", KERNEL_SOURCE,
              KERNEL_REPLACES, moe["serve"]["long_wide_launches"],
              moe_long_case, f"{MOE_MODEL}, 2048-token prompt at 0 "
              "(launches: the 1500-token prompt)"),
        entry("flash_attention_mixtral_8x7b", KERNEL_SOURCE,
              KERNEL_REPLACES, moe["large_int8"]["flash_launches"],
              flash_case("mixtral-8x7b"), "mixtral-8x7b (hd 128, g = 4), "
              "64-token prompt at 0 (launches: mixtral-8x7b-int8 plain "
              "serve, three prefills)")] + [
        entry(name, PAGED_SOURCE, PAGED_REPLACES[key], phase["launches"][key],
              case, shape)
        for name, key, phase, case, shape in paged_main] + [
        # every verify and draft step is a replay of a round's graph
        {**entry(name, PAGED_SOURCE, PAGED_REPLACES[key], launches, case,
                 shape), "graph_replayed": True}
        for name, key, launches, case, shape in paged_spec] + [
        quant_entry("quant_dense_int8", quant_phase["int8_plain"]["graph"],
                    1, 8, "TinyLlama w_up [2048, 5632] int8, M = 1 "
                    "(launches: the decode kernel's, tinyllama-1.1b-int8 "
                    "plain serve, every quantized matmul of a decode "
                    "step)"),
        quant_entry("quant_dense_int8_slots8",
                    quant_phase["int8_batching"]["graph"], 8, 8,
                    "TinyLlama w_up [2048, 5632] int8, M = 8 (launches: "
                    "tinyllama-1.1b-int8 8-slot batching)"),
        quant_entry("quant_dense_int4", quant_phase["int4_plain"]["graph"],
                    1, 4, "TinyLlama w_up [2048, 5632] int4, M = 1 "
                    "(launches: tinyllama-1.1b-int4 plain serve)"),
        quant_entry("quant_dense_int8_llama3_8b",
                    quant_phase["llama3_8b_int8"], 1, 8,
                    "llama-3-8b w_down [14336, 4096] int8, M = 1 "
                    "(launches: llama-3-8b-int8 plain serve)",
                    weight="w_down", model=LARGE_MODEL),
        quant_entry("quant_dense_prefill_int8",
                    quant_phase["int8_plain"]["graph"], 256, 8,
                    "TinyLlama w_up [2048, 5632] int8, M = 256 (launches: "
                    "the prefill kernel's, tinyllama-1.1b-int8 plain "
                    "serve's 64-token prefills, every quantized matmul)"),
        quant_entry("quant_dense_int8_mixtral", moe["int8_plain"]["graph"],
                    1, 8, f"{MOE_MODEL} expert w_gate, w_up [1024, 3584] "
                    "int8, M = 1 (launches: the decode kernel's, "
                    f"{MOE_MODEL}-int8 plain serve, 224 a decode step)",
                    weight="w_gate, w_up", model=MOE_MODEL),
        quant_entry("quant_dense_prefill_int8_mixtral",
                    moe["int8_plain"]["graph"], PROMPT_LEN, 8,
                    f"{MOE_MODEL} expert w_gate, w_up [1024, 3584] int8, "
                    "M = 64 (launches: the prefill kernel's, "
                    f"{MOE_MODEL}-int8 plain serve's 64-token prefills)",
                    weight="w_gate, w_up", model=MOE_MODEL),
        quant_entry("quant_dense_int8_mixtral_8x7b", moe["large_int8"], 1,
                    8, "mixtral-8x7b expert w_gate, w_up [4096, 14336] "
                    "int8, M = 1 (llama-3-8b's row, the same shape; "
                    "launches: mixtral-8x7b-int8 plain serve, 896 a "
                    "decode step)", weight="w_gate, w_up",
                    model=LARGE_MODEL),
        # a multi-rank step runs eagerly: no launch here is a replay
        {**quant_entry("quant_dense_int8_tp2_llama3_8b", tp2_int8, 1, 8,
                       "one tp=2 rank of llama-3-8b, w_down row slice "
                       "[7168, 4096] int8, M = 1 (launches: rank 0's "
                       "decode-kernel launches, the parallel phase's "
                       "llama-3-8b-int8 tp=2 generate at "
                       f"{PAR_GENERATE_LAYERS} layers, 7 x L a decode "
                       "step on the sliced weights)", weight="w_down",
                       model=LARGE_MODEL + "-tp2"),
         "graph_replayed": False},
        # the chain's stages run eagerly: no launch is a replay
        {**entry("paged_decode_chain", PAGED_SOURCE,
                 PAGED_REPLACES["paged_decode"],
                 chain["launches"]["decode"], chain_case("decode"),
                 f"b=1, one token at {max(CHAIN_PROMPTS) + CHAIN_NEW - 1} "
                 f"(launches: the chain phase's {CHAIN_STAGES} stages, "
                 "each its layers x its one-token hops, summed)"),
         "graph_replayed": False},
        {**entry("paged_prefill_chain", PAGED_SOURCE,
                 PAGED_REPLACES["paged_prefill"],
                 chain["launches"]["prefill"], chain_case("prefill"),
                 f"b=1, the {max(CHAIN_PROMPTS)}-token prompt chunk at 0 "
                 f"(launches: the chain phase's {CHAIN_STAGES} stages, "
                 "each its layers x its prompt chunks, summed)"),
         "graph_replayed": False},
        # the server phase's planned ring runs eagerly too
        {**entry("paged_decode_server", PAGED_SOURCE,
                 PAGED_REPLACES["paged_decode"],
                 server["launches"]["decode"], chain_case("decode"),
                 f"b=1, one token at {max(CHAIN_PROMPTS) + CHAIN_NEW - 1} "
                 "(launches: the server phase's planned ring of 3 stages, "
                 "each its layers x its one-token hops, summed)"),
         "graph_replayed": False},
        {**entry("paged_prefill_server", PAGED_SOURCE,
                 PAGED_REPLACES["paged_prefill"],
                 server["launches"]["prefill"], chain_case("prefill"),
                 f"b=1, the {max(CHAIN_PROMPTS)}-token prompt chunk at 0 "
                 "(launches: the server phase's planned ring, each stage "
                 "its layers x its prompt chunks, summed)"),
         "graph_replayed": False},
        {**quant_entry("quant_dense_int8_server", server_int8, 1, 8,
                       "TinyLlama w_up [2048, 5632] int8, M = 1 (launches: "
                       "the decode kernel's in the server phase's "
                       "tinyllama-1.1b-int8 planned ring, each stage its "
                       "layers x 7 x its decode hops, summed)"),
         "graph_replayed": False},
        entry("flash_attention_bench", KERNEL_SOURCE, KERNEL_REPLACES,
              server["bench"]["flash_launches"], bench_case,
              f"8 rows of a {PROMPT_LEN}-token prompt at 0 (launches: the "
              "server phase's in-process `bench`, its warm and timed "
              "prefills)"),
        entry("flash_attention_vision", KERNEL_SOURCE, KERNEL_REPLACES,
              vision["launches"]["flash"], vision_case,
              f"b=1, the {VISION_PREFIX}-row multimodal prefix "
              f"({VISION_PATCHES} llava15 patches + {VISION_TEXT} text "
              "tokens) at 0 (launches: `serve --vision`'s image and text "
              "requests over HTTP, L x 2 prefills)"),
        # the vision ring's stages run eagerly
        {**entry("paged_prefill_vision", PAGED_SOURCE,
                 PAGED_REPLACES["paged_prefill"],
                 vision["launches"]["paged_prefill"],
                 chain_case("prefill", SERVE_MODEL + "-vision"),
                 f"b=1, the {VISION_PREFIX}-row multimodal prefix chunk at "
                 "0 (launches: the vision phase's MultimodalHeader ring, "
                 "two stages, each its layers x its chunks of an image and "
                 "a text request, summed)"),
         "graph_replayed": False},
        {**entry("paged_decode_vision", PAGED_SOURCE,
                 PAGED_REPLACES["paged_decode"],
                 vision["launches"]["paged_decode"],
                 chain_case("decode", SERVE_MODEL + "-vision"),
                 f"b=1, one token at {VISION_PREFIX + VISION_NEW - 1} "
                 "(launches: the same ring's one-token hops, each stage "
                 "its layers x its hops, summed)"),
         "graph_replayed": False},
        quant_entry("quant_dense_prefill_int8_train",
                    {"decode_launches": 0, "dense_launches":
                     train["int8"]["launches_by_rank"][0]}, 256, 8,
                    "TinyLlama w_up [2048, 5632] int8, M = 256 (launches: "
                    "rank 0's prefill-kernel launches in the train phase's "
                    "pp=2 pipeline_apply over tinyllama-1.1b-int8, 7 x "
                    f"{train['int8']['layers'] // TRAIN_PP} layers x "
                    f"{TRAIN_MICROBATCHES} microbatches of "
                    f"{TRAIN_INT8_ROWS} x {TRAIN_SEQ} rows; eager)"),
        entry("flash_attention_tp2_llama3_8b", KERNEL_SOURCE,
              KERNEL_REPLACES,
              par["tp_llama3_8b"]["launches_by_rank"][0]["flash"],
              flash_case(LARGE_MODEL + "-tp2"), "one tp=2 rank of "
              "llama-3-8b (16 q heads on 4 kv heads, hd 128), 64-token "
              "prompt at 0 (launches: rank 0's, the tp=2 generate's two "
              f"prefills at {PAR_GENERATE_LAYERS} layers)")]})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
