#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one CUDA card and hold its kernels to
their plain versions.

    python3 chip_smoke.py                 # every phase, one card
    python3 chip_smoke.py --kernels-only  # build + kernel checks only
    python3 chip_smoke.py --phase moe     # build + one phase (serve,
                                          # batching, mixed, graph,
                                          # quant, kvcache, moe), no
                                          # result lines

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
            launch; throughput, TTFT, step time, idle share, and how many
            tokens agree with the serialized interleave's, on the kernels
            and on the gather path, with the teacher-forced logit gap
            between a prefill chunk run in a mixed slab and run alone,
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
            engine's paged forward); llama-3-8b-int8 and llama-3-8b
            plain serve (graph only): init peak memory, ms/token, device
            ms a step and the dense kernel's share, and the int8 model's
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
            logits against the gather path, f32 tokens against the
            gather path's: equal, or parting only at near ties) and 8
            (replayed = eager, ms a step, idle share); the plain engine
            over a float8 cache (plain attention; ms/token, device ms a
            step);
    (phase 2 holds the e4m3 instances to their plain versions at the
    decode rows, the 64-token chunk at 200, the slab, the split
    boundaries and gemma-2b's heads, and the flash kernel at the warm
    prefill's shape)
12. the ``{"kernels": [...]}`` line, then the card's nvidia-smi line, then
   the ``{"ok": true, "device": {...}}`` line.

Exits non-zero, printing no result, without CUDA or outside a checkout,
and on any failed check.
"""

import json
import os
import subprocess
import sys
import time
import traceback
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


def device_ms(torch, fn, iters: int = 50) -> float:
    """Mean device time of ``fn``: ``iters`` calls captured in one CUDA
    graph and replayed, so no host launch cost sits between them."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
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
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/generate", data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=600) as resp:
        return resp.status, resp.read().decode()


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
                   kv_cache_dtype: str | None = None) -> dict:
    """The batching path of ``model`` at full width: see the module
    docstring, item 4.  ``f32``: "engine" holds the f32 tokens to a
    plain-attention ``InferenceEngine``'s (requests concurrent), "gather"
    to the same batching configuration's on the gather path (requests
    one after another, the same schedule for both), None skips it.
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
    cfg32 = cfg.replace(dtype_name="float32")
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
    the module docstring, item 5.  ``extras``: also the agreement with the
    serialized interleave (kernels and gather path), the teacher-forced
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

    # ---- the serialized interleave on the same int8 pages: how many of
    # the same 8 requests' greedy tokens agree (bf16: a count, no check);
    # then both orders again with the 8 requests submitted at once, on
    # the kernels and on the gather path
    def agreement(a, b):
        return sum(sum(x == y for x, y in zip(r, s_)) for r, s_ in zip(a, b))

    def submit_all(**kw):
        with engine_for(cfg, params, **kw) as e:
            reqs = [e.submit(p, NEW_TOKENS) for p in prompts]
            return [r.wait(timeout=900).tolist() for r in reqs]

    ser_toks = submit_all(mixed_token_budget=0)
    out["serialized_agreement"] = agreement(toks, ser_toks)
    out["serialized_agreement_of"] = len(prompts) * NEW_TOKENS
    # per request
    out["serialized_agreement_submitted"] = {
        name: [sum(x == y for x, y in zip(r, s_)) for r, s_ in
               zip(submit_all(attn_backend=backend),
                   submit_all(attn_backend=backend, mixed_token_budget=0))]
        for name, backend in (("kernels", "auto"), ("gather", "plain"))}

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
                  profiled: int = 16) -> dict:
    """SLOTS rows of a batching engine decoding (each prompt's first 16
    tokens, DECODE_WINDOW_NEW new): the host-clock ms per engine step over
    ``steps`` steps, then :func:`profile_steps` over ``profiled`` more.
    Every request is cancelled and done when it returns;
    ``window_requests`` counts the requests it made."""
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


def _profile_summary(prof, wall_ms: float, head: dict) -> dict:
    """Device time by kernel name (top 8), the device-busy sum, the wall
    time and the device's idle share from a finished profile, and how
    many of its device rows are kernels (not copies or fills)."""
    rows = []
    for ev in prof.key_averages():
        # kernel rows only: a CPU op's row would count its kernels twice
        if not str(getattr(ev, "device_type", "")).endswith("CUDA"):
            continue
        dev_us = getattr(ev, "self_device_time_total",
                         getattr(ev, "self_cuda_time_total", 0))
        if dev_us > 0:
            rows.append((dev_us, ev.key, ev.count))
    rows.sort(reverse=True)
    busy_ms = sum(r[0] for r in rows) / 1e3
    _check(bool(rows), "torch.profiler recorded no device time")
    kernels = sum(1 for r in rows
                  if not r[1].startswith(("Memcpy", "Memset")))
    # the dequantizing dense kernels (decode, prefill, f32 and its split
    # reduction): every symbol of csrc/quant_dense.cu starts quant_dense_
    dense_ms = sum(r[0] for r in rows if "quant_dense_" in r[1]) / 1e3
    return {**head, "wall_ms": wall_ms, "kernels": kernels,
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
    t_one = engine.generate(prompt, 1).seconds
    t_many = engine.generate(prompt, 1 + GRAPH_DECODE_TOKENS).seconds
    ms = (t_many - t_one) / GRAPH_DECODE_TOKENS * 1e3
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
    prof = profile_decode(torch, engine, prompt)
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
           "decode_tokens": GRAPH_DECODE_TOKENS}
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
    window = decode_window(torch, engine, prompts)
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
    with torch.cuda.graph(graph):
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
    del graph, objs
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
                torch, SERVE_MODEL, f32="gather", kv_cache_dtype=fp8)),
            ("graph_batching", lambda: graph_batching(
                torch, SERVE_MODEL, kv_cache_dtype=fp8)),
            ("fp8_plain", fp8_plain)):
        t1 = time.perf_counter()
        out[key] = run()
        out[key]["seconds"] = time.perf_counter() - t1
    out["seconds"] = time.perf_counter() - t0
    return out


# ---------------------------------------------------------------------------

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
    # --phase NAME: the build, then that phase alone (no result lines)
    only = argv[argv.index("--phase") + 1] if "--phase" in argv else None
    try:
        device = phase_device(torch, smi)
        emit(device)
        if only is not None:
            emit({"serve": phase_serve, "batching": phase_batching,
                  "mixed": phase_mixed, "graph": phase_graph,
                  "quant": phase_quant, "kvcache": phase_kvcache,
                  "moe": phase_moe}[only](torch))
            return 0
        kern = phase_kernels(torch)
        emit(kern)
        paged = phase_paged_kernels(torch)
        emit(paged)
        qkern = phase_quant_kernels(
            torch, device["ptxas"]["quant_dense.cu"])
        emit(qkern)
        failures = kern["failures"] + paged["failures"] + qkern["failures"]
        if failures:
            raise AssertionError("kernel disagrees with its plain version: "
                                 + "; ".join(failures))
        if "--kernels-only" in argv:
            return 0
        serve = phase_serve(torch)
        emit(serve)
        batching = phase_batching(torch)
        emit(batching)
        mixed = phase_mixed(torch)
        emit(mixed)
        # the catalog's models at the kernels' other head dims
        served = {}
        for name in HEAD_DIM_MODELS:
            served[name] = phase_serve_model(torch, name)
            emit(served[name])
        gemma_batching = phase_batching(torch, "gemma-2b", f32="gather")
        emit(gemma_batching)
        gemma_mixed = phase_mixed(torch, "gemma-2b", extras=False)
        emit(gemma_mixed)
        bloom_batching = phase_batching(torch, "bloom3b", f32=None)
        emit(bloom_batching)
        emit(phase_graph(torch))
        quant_phase = phase_quant(torch)
        emit(quant_phase)
        kvc = phase_kvcache(torch)
        emit(kvc)
        moe = phase_moe(torch)
        emit(moe)
    except Exception:
        traceback.print_exc()
        print("chip_smoke: FAILED", file=sys.stderr)
        return 1

    def flash_case(case):
        return next(c for c in kern["cases"]
                    if c["case"] == case and c["dtype"] == "bfloat16"
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
    def serve_case(kind, pages, case="tinyllama"):
        return next(c for c in paged["cases"] if c["case"] == case
                    and c["kind"] == kind and c["dtype"] == "bfloat16"
                    and c["pages"] == pages
                    and (c["b"] == SLOTS if kind == "decode" else
                         c["chunk"] == PREFILL_CHUNK
                         and (case != "tinyllama" or c["starts"] == [200])))

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
        ("paged_decode_mixtral", "paged_decode", moe["batching"],
         serve_case("decode", "full", MOE_MODEL), f"{MOE_MODEL}, " + rows8),
        ("paged_prefill_mixtral", "paged_prefill", moe["batching"],
         serve_case("prefill", "full", MOE_MODEL),
         f"{MOE_MODEL}, " + chunk200)]
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
                "graph_replayed": name.startswith("paged_decode"),
                "max_abs_err": case["max_abs_err"], "ms": case["ms"],
                "plain_ms": case["plain_ms"], "bound_ms": case["bound_ms"],
                "bound_by": case["bound_by"],
                "library_ms": case["library_ms"]}

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
                    model=LARGE_MODEL)]})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
