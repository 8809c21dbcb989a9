"""The port's capture rings and one-call batch gather
(``mmla_audio_torch.streaming.native``, over the port's own
``libmmla_host.so``), with the contract of ``tests/test_native_gather.py``:
rotation, active-mask skips, row placement, wrap-around copies, SPSC safety
under a producer thread, ``PrefilledCapture``; and the Python ring against
the native one."""

import threading

import numpy as np
import pytest

from mmla_audio_torch.streaming.capture import (ArraySource, CaptureThread,
                                                PrefilledCapture)
from mmla_audio_torch.streaming.native import (BatchGather, NativeRingBuffer,
                                               PyRingBuffer, make_ring)


def _rings(n, cap=1 << 16):
    return [NativeRingBuffer(cap) for _ in range(n)]


def test_rotation_and_row_placement():
    rings = _rings(6)
    for i in (0, 2, 3, 5):
        rings[i].push(np.full(400, i + 1, np.int16))
    g = BatchGather(rings)
    dst = np.zeros((8, 400), np.int16)
    idx = g.pop_into(dst, row0=1, start=2, limit=3, n_win=400)
    # rotation from ring 2: ready rings in order 2, 3, 5
    assert idx.tolist() == [2, 3, 5]
    assert [int(dst[1 + r, 0]) for r in range(3)] == [3, 4, 6]
    assert dst[0].sum() == 0 and dst[4].sum() == 0     # untouched rows
    # the next call wraps and finds ring 0
    idx = g.pop_into(dst, 0, 2, 8, 400)
    assert idx.tolist() == [0]


def test_active_mask_skips_done_streams():
    rings = _rings(3)
    for r in rings:
        r.push(np.arange(500, dtype=np.int16))
    g = BatchGather(rings)
    g.set_active(1, False)
    dst = np.zeros((3, 400), np.int16)
    idx = g.pop_into(dst, 0, 0, 3, 400)
    assert idx.tolist() == [0, 2]
    assert rings[1].available == 500                   # untouched


def test_partial_windows_not_popped():
    rings = _rings(2)
    rings[0].push(np.ones(399, np.int16))              # one short
    rings[1].push(np.ones(400, np.int16))
    g = BatchGather(rings)
    dst = np.zeros((2, 400), np.int16)
    idx = g.pop_into(dst, 0, 0, 2, 400)
    assert idx.tolist() == [1]
    assert rings[0].available == 399                   # untouched


def test_wraparound_copy_is_exact():
    ring = NativeRingBuffer(1024)                      # rounds to 1024
    ring.push(np.zeros(1000, np.int16))
    assert ring.pop(1000) is not None                  # tail near the end
    data = np.arange(700, dtype=np.int16)              # wraps the boundary
    ring.push(data)
    g = BatchGather([ring])
    dst = np.zeros((1, 700), np.int16)
    idx = g.pop_into(dst, 0, 0, 1, 700)
    assert idx.tolist() == [0]
    assert np.array_equal(dst[0], data)


def test_spsc_with_producer_thread():
    """The producer pushes while the gather consumes: every window arrives
    exactly once, in order, uncorrupted."""
    ring = NativeRingBuffer(1 << 15)
    n_windows, win = 200, 400
    payload = np.arange(n_windows * win, dtype=np.int16)

    def produce():
        for i in range(n_windows):
            chunk = payload[i * win: (i + 1) * win]
            off = 0
            while off < win:                # ring full: resume at offset
                off += ring.push(chunk[off:])

    t = threading.Thread(target=produce)
    t.start()
    g = BatchGather([ring])
    got = []
    dst = np.zeros((1, win), np.int16)
    while len(got) < n_windows:
        if len(g.pop_into(dst, 0, 0, 1, win)):
            got.append(dst[0].copy())
    t.join()
    assert np.array_equal(np.concatenate(got), payload)


def test_gather_refuses_a_short_or_wrong_matrix():
    g = BatchGather(_rings(3))
    with pytest.raises(ValueError, match="room"):
        g.pop_into(np.zeros((2, 400), np.int16), 0, 0, 3, 400)
    with pytest.raises(ValueError):
        g.pop_into(np.zeros((3, 400), np.float32), 0, 0, 3, 400)
    with pytest.raises(RuntimeError, match="native"):
        BatchGather([PyRingBuffer(1024)])


def test_prefilled_capture_contract():
    data = np.arange(3 * 400, dtype=np.int16)
    cap = PrefilledCapture(data)
    assert cap.drained and cap.source.exhausted
    assert isinstance(cap.ring, NativeRingBuffer)
    ws = [cap.read_window(400) for _ in range(3)]
    assert all(w is not None for w in ws)
    assert np.array_equal(np.concatenate(ws), data)
    assert cap.read_window(400) is None                # empty now


def test_capture_thread_takes_a_native_ring():
    assert isinstance(make_ring(1000), NativeRingBuffer)
    cap = CaptureThread(ArraySource(np.zeros(10, np.int16)))
    assert isinstance(cap.ring, NativeRingBuffer)


def test_python_ring_matches_native():
    """Pushes, pops, partial pops, overruns and wrap-around give the same
    samples and counters in both rings."""
    rng = np.random.RandomState(0)
    ours, native = PyRingBuffer(1000), NativeRingBuffer(1000)
    assert ours.capacity == native.capacity == 1024
    for _ in range(60):
        chunk = rng.randint(-32768, 32767, rng.randint(0, 700)).astype(
            np.int16)
        assert ours.push(chunk) == native.push(chunk)
        n = int(rng.randint(1, 800))
        a, b = ours.pop(n), native.pop(n)
        assert (a is None) == (b is None)
        if a is not None:
            np.testing.assert_array_equal(a, b)
        assert ours.available == native.available
        np.testing.assert_array_equal(ours.pop_upto(50), native.pop_upto(50))
    assert ours.overruns == native.overruns > 0
    ours.clear()
    native.clear()
    assert ours.available == native.available == 0
