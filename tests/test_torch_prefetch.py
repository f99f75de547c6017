"""The port's Prefetcher, on the five cases of tests/test_prefetch.py.

Each case runs on the port's ``Prefetcher`` and, as the reference of the
same behaviour, on JAX's: order, overlap with a slow producer, an error
raised on the next ``get``, the iterator, and ``close`` in mid-stream
without hanging. Then a shapes loader through it: the batches come out as
numpy arrays in step order (the training loop moves them to the device on
its own thread).
"""

import time

import numpy as np
import pytest
import torch

from objectdetection_tpu.data import prefetch as jprefetch

from objectdetection_torch.data import prefetch as tprefetch

torch.set_num_threads(1)

IMPLS = {"port": tprefetch.Prefetcher, "jax": jprefetch.Prefetcher}


@pytest.fixture(params=sorted(IMPLS))
def Prefetcher(request):
    return IMPLS[request.param]


def test_yields_in_order(Prefetcher):
    pf = Prefetcher(lambda step: step * 10, num_steps=5, depth=2)
    got = [pf.get() for _ in range(5)]
    assert got == [0, 10, 20, 30, 40]
    with pytest.raises(StopIteration):
        pf.get()
    pf.close()


def test_overlaps_slow_producer(Prefetcher):
    def slow(step):
        time.sleep(0.05)
        return step

    pf = Prefetcher(slow, num_steps=4, depth=2)
    time.sleep(0.15)  # let the worker run ahead
    t0 = time.time()
    _ = [pf.get() for _ in range(2)]
    assert time.time() - t0 < 0.04  # already buffered
    pf.close()


def test_error_propagates(Prefetcher):
    def boom(step):
        if step == 1:
            raise ValueError("producer failed")
        return step

    pf = Prefetcher(boom, num_steps=5, depth=2)
    assert pf.get() == 0
    with pytest.raises(ValueError):
        pf.get()
    pf.close()


def test_iterator_interface(Prefetcher):
    pf = Prefetcher(lambda s: s, num_steps=3)
    assert list(pf) == [0, 1, 2]
    pf.close()


def test_close_mid_stream(Prefetcher):
    pf = Prefetcher(lambda s: s, num_steps=1000, depth=2)
    assert pf.get() == 0
    pf.close()  # must not hang


def test_shapes_batches_come_out_on_the_host_in_order():
    from objectdetection_torch.config import SHAPES_CONFIG
    from objectdetection_torch.data.shapes import ShapesDataset

    ds = ShapesDataset(16, 128, 128, seed=2)
    ids = lambda step: [(2 * step) % 16, (2 * step + 1) % 16]
    pf = tprefetch.Prefetcher(lambda step: ds.load_batch(ids(step), SHAPES_CONFIG),
                              num_steps=4)
    for step, batch in enumerate(pf):
        want = ds.load_batch(ids(step), SHAPES_CONFIG)
        for got, w in zip(batch, want):
            assert isinstance(got, np.ndarray)
            np.testing.assert_array_equal(got, w)
    assert step == 3
    pf.close()
