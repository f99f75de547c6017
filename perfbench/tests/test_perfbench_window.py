"""The offline window's arithmetic on a stand-in system: every image of
every completed batch over the time to the end of the first batch that
completes after ``--seconds``; the sample compared is drawn from the seed."""

from __future__ import annotations

import time
from types import SimpleNamespace

import numpy as np
import torch

from perfbench import run

SIZES = {"image_shape": [8, 8, 3], "mean_pixel": [1.0, 2.0, 3.0]}
PARAMS = {"batch": 4, "distinct": 2, "warm": 1, "sample": 6, "ref_block": 2,
          "trace_batches": 2, "span_calls": 1}


class Stub:
    calls = []
    compared = []

    def __init__(self, sizes, params, seed, device, make_images, log):
        pass

    def call(self, images, windows):
        time.sleep(0.03)
        Stub.calls.append(float(images.sum()))
        det = np.zeros((images.shape[0], 3, 6), np.float32)
        det[:, 0, 5] = images.mean(dim=(1, 2, 3)).numpy()
        return det, None

    def release(self):
        pass

    def reference(self, images, windows, answers=None):
        return self.call(images, windows)

    def compare(self, got, want):
        Stub.compared.append((got, want))
        return {"same": float(np.array_equal(got[0], want[0]))}


def window(seed, seconds, **params):
    traffic = run.load_module(run.HERE / "traffic" / "offline_batches.py")
    Stub.calls, Stub.compared = [], []
    ctx = SimpleNamespace(params={**PARAMS, **params}, sizes=SIZES, device=torch.device("cpu"),
                          log=lambda m: None, seed=seed, seconds=seconds, trace=False,
                          system_cls=Stub, t_start=time.perf_counter())
    t0 = time.perf_counter()
    res = traffic.run(ctx)
    return res, time.perf_counter() - t0


def test_rate_counts_every_completed_batch_and_ends_on_a_boundary():
    res, _ = window(1, 0.2)
    batches = res["attempted"] // PARAMS["batch"]
    assert res["attempted"] % PARAMS["batch"] == 0
    elapsed = res["attempted"] / res["metrics"]["images_per_s"]
    assert 0.2 <= elapsed < 0.2 + 2 * 0.03 + 0.05  # one batch past the mark at most
    assert len(Stub.calls) == PARAMS["warm"] + batches + PARAMS["sample"] // PARAMS["ref_block"]
    # batches alternate between the two distinct ones
    timed = Stub.calls[PARAMS["warm"]:PARAMS["warm"] + batches]
    assert timed[0] != timed[1] and timed[0] == timed[2]


def test_sample_is_drawn_from_the_seed_and_compared():
    picks = []
    for seed in (7, 7, 8):
        res, _ = window(seed, 0.0, batch=8)
        assert res["numbers"] == {"same": 1.0}
        picks.append(Stub.compared[0][0][0][:, 0, 5])
    assert picks[0].shape[0] == PARAMS["sample"]
    assert np.array_equal(picks[0], picks[1]) and not np.array_equal(picks[0], picks[2])
