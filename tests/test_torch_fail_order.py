"""A cancelled or failed request is seen done only after its accounting.

The port's own invariant (the reference wakes the waiter first): at the
moment ``done`` is set, ``get_request(rid)`` is None, the SLO timeline
is closed, the slot is free and no page is held.  The test records the
engine's state from inside ``done.set()``, so what a waiter could see
at its wake-up is read deterministically, with no race to win.
"""

import threading
import time

import numpy as np
import pytest
import torch

from distributed_inference_demo_tpu_torch.models import get_model_config
from distributed_inference_demo_tpu_torch.models.decoder import \
    init_full_params
from distributed_inference_demo_tpu_torch.ops.sampling import SamplingParams
from distributed_inference_demo_tpu_torch.runtime.batching import \
    ContinuousBatchingEngine
from distributed_inference_demo_tpu_torch.telemetry.slo import \
    get_slo_ledger

WAIT = 60
KW = dict(max_seq=96, max_batch=2, prompt_buckets=(16,),
          kv_block_tokens=8, sampling=SamplingParams(greedy=True),
          device="cpu")


@pytest.fixture(scope="module")
def model():
    cfg = get_model_config("llama-test")
    gen = torch.Generator().manual_seed(0)
    return cfg, init_full_params(gen, cfg, device="cpu")


class _Seen(threading.Event):
    """``done`` that snapshots the engine the moment it is set."""

    def __init__(self, eng, req):
        super().__init__()
        self.eng, self.req, self.seen = eng, req, None

    def set(self):
        eng, req = self.eng, self.req
        mgr = eng.kv_cache
        closed = any(r.get("rid") == req.rid
                     for r in get_slo_ledger().recent(256))
        self.seen = {
            "get_request": eng.get_request(req.rid),
            "timeline_closed": closed,
            "in_slot": any(s is req for s in eng._slots),
            "pages_held": mgr.used_blocks - mgr.tree.block_count,
        }
        super().set()


def _watch(eng, req):
    ev = _Seen(eng, req)
    req.done = ev
    return ev


def _assert_clean(ev):
    assert ev.wait(WAIT)
    assert ev.seen == {"get_request": None, "timeline_closed": True,
                       "in_slot": False, "pages_held": 0}


def test_cancel_wakes_the_waiter_last(model):
    cfg, params = model
    with ContinuousBatchingEngine(cfg, params, **KW) as eng:
        req = eng.submit([5, 4, 3, 2, 1], 80)
        ev = _watch(eng, req)
        t_end = time.monotonic() + WAIT
        while len(req.tokens) < 2:
            assert time.monotonic() < t_end, "the row never decoded"
            time.sleep(0.002)
        req.cancel()
        _assert_clean(ev)


def test_failed_admission_wakes_the_waiter_last(model):
    cfg, params = model
    with ContinuousBatchingEngine(cfg, params, **KW) as eng:
        ok = eng.submit([9, 8, 7], 4).wait(timeout=WAIT)
        assert len(ok) == 4
        orig = eng._paged_prefill
        armed = {"on": True}
        go = threading.Event()

        def boom(*a, **k):
            if armed["on"]:
                armed["on"] = False
                # the watch is installed before the failure lands
                assert go.wait(WAIT)
                raise RuntimeError("injected prefill failure")
            return orig(*a, **k)

        eng._paged_prefill = boom
        req = eng.submit([3, 1, 4, 1, 5], 6)
        ev = _watch(eng, req)
        go.set()
        with pytest.raises(RuntimeError, match="injected prefill failure"):
            req.wait(timeout=WAIT)
        _assert_clean(ev)
        again = eng.submit([9, 8, 7], 4).wait(timeout=WAIT)
        np.testing.assert_array_equal(again, ok)
