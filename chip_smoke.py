#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one CUDA card and hold its kernels to
their plain versions.

    python3 chip_smoke.py                 # every phase, one card
    python3 chip_smoke.py --kernels-only  # build + kernel checks only

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
            The flash kernel, then the two paged kernels (decode and
            chunk prefill) over shuffled page tables with sentinels, on
            full-width pages and on int8 pages (their int8 instances),
            and the prefill kernel on a mixed dispatch's 4-row slab;
3. serve    the plain path: ``InferenceHTTPServer`` over
            ``InferenceEngine`` at full TinyLlama-1.1B width (random
            weights from a seed) answers a greedy, a streamed and a
            sampled request; the launch counts show the prefill went
            through the flash kernel; the prefill logits are held against
            an engine on plain attention;
4. batching the serving path: ``InferenceHTTPServer`` over
            ``ContinuousBatchingEngine`` (8 slots, paged KV, chunked
            admission) at full TinyLlama-1.1B width answers 8 concurrent
            greedy requests, one streamed and two sharing a prefix; the
            paged kernels' launch counts equal what the routing predicts;
            at f32 the tokens equal a plain-attention ``InferenceEngine``'s;
            no page leaks; throughput, TTFT, step time and the device's
            idle share;
5. mixed    the mixed prefill+decode dispatch over int8 pages: the same 8
            requests to ``ContinuousBatchingEngine`` with
            ``mixed_token_budget`` 288 (4 segments of 64 tokens beside 8
            rows x 4 decode steps) and ``kv_dtype`` int8; the int8
            kernels' launch counts equal L x decode steps and L x slab
            forwards; at f32 the tokens equal the same configuration's on
            the gather path; no page leak; an int4 request gathers with no
            launch; throughput, TTFT, step time, idle share, and how many
            tokens agree with the serialized interleave's;
6. the ``{"kernels": [...]}`` line, then the card's nvidia-smi line, then
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
# kernel vs plain: |kernel - plain| <= atol + rtol * |plain|, elementwise.
# f32: both sum the same f32 products in another order (~1e-6 apart).
# bf16: both compute in f32 and round once to bf16, so they differ by at
# most about one bf16 ulp (2^-8 relative) where rounding flips.
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
# the int8 instances replace the same kernels' quantized branches
PAGED_REPLACES["paged_decode_int8"] = PAGED_REPLACES["paged_decode"]
PAGED_REPLACES["paged_prefill_int8"] = PAGED_REPLACES["paged_prefill"]
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

def phase_device(torch, smi: str) -> dict:
    from concurrent.futures import ThreadPoolExecutor

    from distributed_inference_demo_tpu_torch.ops import _build
    from distributed_inference_demo_tpu_torch.ops import flash_attention as fa
    from distributed_inference_demo_tpu_torch.ops import \
        paged_attention as pa

    t0 = time.perf_counter()
    sources = (fa.SOURCE, pa.SOURCE)
    # one nvcc per source, all started together
    with ThreadPoolExecutor(len(sources)) as pool:
        list(pool.map(_build.build, sources))
    fa._kernel_fn()
    pa._kernel_fns()
    build_s = time.perf_counter() - t0
    # per kernel instance: its (mangled) name, then its spills and its
    # registers, as ptxas -v reports them
    keep = ("Function properties for", "registers", "spill")
    ptxas = {src: [ln.strip() for ln in _build.build_logs.get(src, "")
                   .splitlines() if any(k in ln for k in keep)]
             for src in sources}
    return {"phase": "device", "nvidia_smi": smi,
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
            "torch": torch.__version__, "cuda": torch.version.cuda,
            "build_s": build_s, "ptxas": ptxas}


# ---------------------------------------------------------------------------
# phase 2: kernel vs plain
# ---------------------------------------------------------------------------

def kernel_cases():
    """(label, b, chunk, q_start, nh, nkv, hd, alibi) at the main path's
    shapes: TinyLlama heads over a 2048 cache, plus one ALiBi case with
    bloom-560m's heads and one hd=128 case with llama-3-8b's."""
    cases = []
    for b in (1, 4):
        for chunk in (16, 64, 512):
            for q_start in (0, 100):
                cases.append(("tinyllama", b, chunk, q_start, 32, 4, 64,
                              False))
    cases.append(("bloom560m-alibi", 1, 64, 100, 16, 16, 64, True))
    cases.append(("llama3-8b-hd128", 1, 64, 100, 32, 8, 128, False))
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

    from distributed_inference_demo_tpu_torch.ops.attention import \
        alibi_slopes
    from distributed_inference_demo_tpu_torch.ops.flash_attention import (
        flash_attention, flash_attention_plain)

    dev = torch.device("cuda")
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

            got, want = kern(), plain()
            torch.cuda.synchronize()
            err = (got.float() - want.float()).abs()
            atol, rtol = TOL[dname]
            ok = bool(torch.isfinite(got.float()).all()) and bool(
                (err <= atol + rtol * want.float().abs()).all())

            # yardstick: SDPA on the live prefix, K/V expanded to nh heads
            # and the mask built beforehand (outside the timed call)
            g = nh // nkv
            qt = q.transpose(1, 2).contiguous()
            kt = kc[:, :, :kv_len].repeat_interleave(g, dim=1)
            vt = vc[:, :, :kv_len].repeat_interleave(g, dim=1)
            qpos = q_start + torch.arange(chunk, device=dev)
            kpos = torch.arange(kv_len, device=dev)
            dist = (qpos[:, None] - kpos[None, :]).float()
            mask = torch.where(dist >= 0, 0.0, float("-inf"))[None]
            if slopes is not None:
                mask = mask - slopes[:, None, None] * dist[None]
            mask = mask[None].to(dtype)

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
                failures.append(f"{label} {dname} b={b} chunk={chunk} "
                                f"q_start={q_start}: max err "
                                f"{row['max_abs_err']}")
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
    64 tokens at distinct starts, one unused) on both page types."""
    serve = (1, 16, 37, 1999, 512, 130, -300, -5)   # negative: freed slot
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
               (32, (200,)))]
    cases = [c + ("full",) for c in cases]
    int8 = [("tinyllama", "decode", 32, 4, 64, False, (1000,)),
            ("tinyllama", "decode", 32, 4, 64, False, serve),
            ("tinyllama", "prefill", 32, 4, 64, False, (16, (0,))),
            ("tinyllama", "prefill", 32, 4, 64, False, (64, (200,))),
            ("bloom560m-alibi", "decode", 16, 16, 64, True, serve),
            ("bloom560m-alibi", "prefill", 16, 16, 64, True, (32, (7,))),
            ("llama3-8b-hd128", "decode", 32, 8, 128, False, serve),
            ("llama3-8b-hd128", "prefill", 32, 8, 128, False,
             (32, (200,)))]
    cases += [c + ("int8",) for c in int8]
    for pages in ("full", "int8"):
        cases.append(("tinyllama-slab", "prefill", 32, 4, 64, False,
                      (PREFILL_CHUNK, SLAB_STARTS), pages))
    return cases


def _paged_inputs(torch, gen, dev, dtype, lens, nkv, hd, W, pages="full"):
    """A pool holding exactly the live pages of ``lens`` (a negative
    length: a freed slot, all-sentinel table) under shuffled ids, plus a
    few spare pages; tables [b, W] int32 with sentinels N and N + 7.
    ``pages`` "int8": int8 pages quantized from the same random draw."""
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
    return pk.to(dtype), pv.to(dtype), tables.to(dev)


def paged_work(kind, nh, nkv, hd, elt, lens, chunk=1, pages="full"):
    """(flops, bytes) on these inputs: per query, its keys (QK and PV, 2
    flops per multiply-add each); q and out once (``elt`` bytes an
    element), each row's live K/V once: ``elt * hd`` bytes per (token, kv
    head) and tensor for full-width pages, ``hd + 4`` (codes and the f32
    scale) for int8 pages.  Decode ``lens`` as in :func:`paged_cases`: a
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
    kv_elt = hd + 4 if pages == "int8" else elt * hd
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
    results, failures = [], []
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
            # (int8 pages: gathered, then dequantized, beforehand)
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
            del q, pk, pv, kt, vt
    return {"phase": "paged_kernels", "cases": results,
            "failures": failures}


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


def phase_serve(torch) -> dict:
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
        flash_attention.launches = 0
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
        out.update(launches=launches, greedy_tokens=toks[0],
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


def _batch_prompts(vocab: int):
    """The 8 prompts of the batching phase (seeded): lengths
    BATCH_PROMPTS; the 300- and 600-token prompts share their first
    SHARED_PREFIX tokens, so whichever admits second hits the radix
    tree (both stream their chunks, one stream at a time)."""
    import numpy as np
    rng = np.random.RandomState(2)
    prompts = [rng.randint(0, vocab, n).tolist() for n in BATCH_PROMPTS]
    i300, i600 = BATCH_PROMPTS.index(300), BATCH_PROMPTS.index(600)
    prompts[i300][:SHARED_PREFIX] = prompts[i600][:SHARED_PREFIX]
    return prompts


def predicted_paged_launches(engine, admits, L: int) -> dict:
    """The routing's prediction from the engine's admissions (prompt
    length, matched prefix): the decode kernel L times per decode step;
    the prefill kernel L times per mid chunk (C = 64 tokens: 512 rows at
    g = 8) and per final suffix whose padded bucket stays within 512
    rows (the 32 bucket: 256 rows); finals padded to the 128 bucket
    (1024 rows) take the gather path."""
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
        prefill += n_mid * (paged_route(True, C, g, bt) == "prefill")
        prefill += paged_route(True, final, g, bt) == "prefill"
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
        if hasattr(w, "int8_launches"):
            w.int8_launches = 0


def phase_batching(torch) -> dict:
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

    cfg = get_model_config(SERVE_MODEL)
    L = cfg.num_layers
    greedy = SamplingParams(greedy=True)
    prompts = _batch_prompts(cfg.vocab_size)

    def engine_for(c, params):
        return ContinuousBatchingEngine(
            c, params, max_seq=MAX_SEQ, max_batch=SLOTS, sampling=greedy,
            kv_block_tokens=BLOCK_TOKENS, prefill_chunk=PREFILL_CHUNK,
            device="cuda")

    out = {"phase": "batching", "device": torch.cuda.get_device_name(0),
           "model": SERVE_MODEL, "slots": SLOTS,
           "block_tokens": BLOCK_TOKENS, "prefill_chunk": PREFILL_CHUNK,
           "prompt_lens": list(BATCH_PROMPTS), "new_tokens": NEW_TOKENS}
    params = init_full_params(
        torch.Generator(device="cuda").manual_seed(0), cfg, "cuda")
    engine = engine_for(cfg, params)
    _check(engine.attn_backend == "auto", "paged backend")
    server = InferenceHTTPServer(engine, "127.0.0.1", 0,
                                 model_name=SERVE_MODEL,
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
        launches = {"paged_decode": pa.paged_flash_attention.launches,
                    "paged_prefill": pa.paged_prefill_attention.launches}
        events = flight.snapshot()
        admits = [(e["prompt_len"], e["prefix_reused"]) for e in events
                  if e["kind"] == "batch_admit"]
        ttft = {e["prompt_len"]: e["ttft_s"] for e in events
                if e["kind"] == "batch_done"}
        predicted = predicted_paged_launches(engine, admits, L)
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
               == pa.paged_prefill_attention.int8_launches == 0,
               "an int8 instance ran on full-width pages")
        _check(stats["kvcache"]["hits"] == 1
               and stats["kvcache"]["partial_hit_tokens"] == SHARED_PREFIX,
               f"radix hit: {stats['kvcache']}")
        _check(len(admits) == len(prompts), f"admissions {admits}")
        out["no_page_leak"] = _no_page_leak(engine)
        _check(out["no_page_leak"], "pages leaked after the drain")

        # ---- decode step time and the device's idle share, 8 slots
        # decoding (short prompts, steps counted by the engine) ----
        reqs = [engine.submit(prompts[i][:16], 200)
                for i in range(SLOTS)]
        _wait_steps(engine, 4)
        t0, s0 = time.perf_counter(), engine._step_count
        _wait_steps(engine, 32)
        out["decode_ms_per_step"] = ((time.perf_counter() - t0) * 1e3
                                     / (engine._step_count - s0))
        out["profile"] = profile_steps(torch, engine, 16)
        for r in reqs:
            r.cancel()
        for r in reqs:
            r.done.wait(timeout=120)
        _check(_no_page_leak(engine), "cancelled requests leaked pages")
    finally:
        server.shutdown()
        engine.close()
    del engine, params
    torch.cuda.empty_cache()

    # ---- f32, same seed: the batching engine (paged kernels) against a
    # plain-attention InferenceEngine, token for token ----
    cfg32 = cfg.replace(dtype_name="float32")
    p32 = init_full_params(
        torch.Generator(device="cuda").manual_seed(0), cfg32, "cuda")
    with engine_for(cfg32, p32) as eng32:
        reqs = [eng32.submit(p, NEW_TOKENS) for p in prompts]
        got = [r.wait(timeout=900).tolist() for r in reqs]
        _check(_no_page_leak(eng32), "f32 run leaked pages")
    plain = InferenceEngine(cfg32, p32, max_seq=MAX_SEQ, sampling=greedy,
                            attn_backend="plain", device="cuda")
    want = [plain.generate([p], NEW_TOKENS).tokens[0].tolist()
            for p in prompts]
    agree = [sum(a == b for a, b in zip(g_, w_)) for g_, w_ in
             zip(got, want)]
    out["f32_greedy_agreement"] = sum(agree) / (len(prompts) * NEW_TOKENS)
    out["f32_agreement_per_request"] = agree
    _check(got == want, f"f32 batching tokens differ from the plain "
           f"engine's: {agree} of {NEW_TOKENS} per request")
    del plain, p32
    torch.cuda.empty_cache()
    return out


def phase_mixed(torch) -> dict:
    """The mixed dispatch over int8 pages at full TinyLlama width: see
    the module docstring, item 5."""
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

    cfg = get_model_config(SERVE_MODEL)
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
           "model": SERVE_MODEL, "slots": SLOTS,
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
                                 model_name=SERVE_MODEL,
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
        reqs = [engine.submit(prompts[i][:16], 200) for i in range(SLOTS)]
        _wait_steps(engine, 4)
        t0, s0 = time.perf_counter(), engine._step_count
        _wait_steps(engine, 32)
        out["decode_ms_per_step"] = ((time.perf_counter() - t0) * 1e3
                                     / (engine._step_count - s0))
        out["profile"] = profile_steps(torch, engine, 16)
        for r in reqs:
            r.cancel()
        for r in reqs:
            r.done.wait(timeout=120)
        _check(_no_page_leak(engine), "cancelled requests leaked pages")
    finally:
        server.shutdown()
        engine.close()

    # ---- the serialized interleave on the same int8 pages: how many of
    # the same 8 requests' greedy tokens agree (bf16: a count, no check)
    with engine_for(cfg, params, mixed_token_budget=0) as ser:
        reqs = [ser.submit(p, NEW_TOKENS) for p in prompts]
        ser_toks = [r.wait(timeout=900).tolist() for r in reqs]
    out["serialized_agreement"] = sum(
        sum(a == b for a, b in zip(m, s_)) for m, s_ in zip(toks, ser_toks))
    out["serialized_agreement_of"] = len(prompts) * NEW_TOKENS

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


def profile_steps(torch, engine, steps: int) -> dict:
    """torch.profiler over ``steps`` decode steps of a running batching
    engine: device time by kernel (top 8), device-busy sum, wall time and
    the device's idle share 1 - busy / wall."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        _wait_steps(engine, steps)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    return _profile_summary(prof, wall_ms, {"steps": steps})


def profile_generate(torch, engine, prompt, new_tokens: int = 16) -> dict:
    """Where one request's time goes: torch.profiler over a greedy
    generate (prefill + ``new_tokens`` decode steps).  Device time by
    kernel name (top 8), the device-busy sum, and the wall time; the
    device's idle share is 1 - busy / wall."""
    from torch.profiler import ProfilerActivity, profile

    engine.generate(prompt, new_tokens)         # warm
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        engine.generate(prompt, new_tokens)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    return _profile_summary(prof, wall_ms, {"new_tokens": new_tokens})


def _profile_summary(prof, wall_ms: float, head: dict) -> dict:
    """Device time by kernel name (top 8), the device-busy sum, the wall
    time and the device's idle share from a finished profile."""
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
    return {**head, "wall_ms": wall_ms,
            "device_busy_ms": busy_ms,
            "device_idle_share": 1.0 - busy_ms / wall_ms,
            "top": [{"kernel": k[:80], "ms": us / 1e3, "count": n}
                    for us, k, n in rows[:8]]}


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
    try:
        emit(phase_device(torch, smi))
        kern = phase_kernels(torch)
        emit(kern)
        paged = phase_paged_kernels(torch)
        emit(paged)
        failures = kern["failures"] + paged["failures"]
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
    except Exception:
        traceback.print_exc()
        print("chip_smoke: FAILED", file=sys.stderr)
        return 1

    main_case = next(c for c in kern["cases"]
                     if c["case"] == "tinyllama" and c["dtype"] == "bfloat16"
                     and c["b"] == 1 and c["chunk"] == PROMPT_LEN
                     and c["q_start"] == 0)
    # the paged kernels at the serving path's shapes: decode over 8 slots
    # (bf16, TinyLlama heads), a 64-token admission chunk several pages in
    # (full-width pages for the batching path, int8 pages for the mixed)
    def serve_case(kind, pages):
        return next(c for c in paged["cases"] if c["case"] == "tinyllama"
                    and c["kind"] == kind and c["dtype"] == "bfloat16"
                    and c["pages"] == pages
                    and (c["b"] == SLOTS if kind == "decode" else
                         c["chunk"] == PREFILL_CHUNK
                         and c["starts"] == [200]))

    paged_main = {
        "paged_decode": (batching, serve_case("decode", "full")),
        "paged_prefill": (batching, serve_case("prefill", "full")),
        "paged_decode_int8": (mixed, serve_case("decode", "int8")),
        "paged_prefill_int8": (mixed, serve_case("prefill", "int8"))}

    def entry(name, source, replaces, launches, case):
        return {"name": name, "route": "cuda", "source": source,
                "replaces": replaces, "launches": launches,
                "max_abs_err": case["max_abs_err"], "ms": case["ms"],
                "plain_ms": case["plain_ms"], "bound_ms": case["bound_ms"],
                "bound_by": case["bound_by"],
                "library_ms": case["library_ms"]}

    emit({"kernels": [
        entry("flash_attention", KERNEL_SOURCE, KERNEL_REPLACES,
              serve["launches"], main_case)] + [
        entry(name, PAGED_SOURCE, PAGED_REPLACES[name],
              phase["launches"][name], case)
        for name, (phase, case) in paged_main.items()]})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
