"""``perfbench/spans.py`` and the readers of the program's spans, on
hand-built contexts: self time, aten events counted to the span around
them, each reader's number, and None where its spans are absent (a
program older than its spans)."""

import pytest

from perfbench import harness, spans
from perfbench.drivers import Run

TRACE_READERS = ("session_host_ms.session", "session_wait_ms.session",
                 "vad_engine_ms.session", "fetch_wait_ms.backlog",
                 "log_reopen_share.backlog")


def _ctx(events, windows):
    ctx = harness.Context(Run(seconds=1.0), None, {})
    ctx.host_events = sorted(events)
    ctx.traced_windows = windows
    return ctx


# one session window, in microseconds: 1,000 in all
WINDOW = [(0, 1000, "session.window"), (0, 100, "session.read"),
          (100, 400, "session.chain"), (120, 180, "aten::mul"),
          (200, 250, "session.vad_fetch"), (250, 350, "session.vad_engine"),
          (350, 400, "session.trim"), (400, 700, "session.predict"),
          (450, 650, "model.forward"), (460, 470, "cudaLaunchKernel"),
          (700, 750, "session.probs_fetch"), (750, 800, "session.log"),
          (800, 900, "session.callback"), (900, 990, "perfbench.mark")]


def test_self_time_takes_out_program_spans_not_aten_events():
    outer = (0, 100, "session.window")
    ctx = _ctx([outer, (10, 30, "session.predict"), (15, 25, "model.forward"),
                (12, 20, "aten::mm"), (35, 40, "session.log"),
                (50, 60, "aten::add"), (70, 80, "cudaLaunchKernel"),
                (95, 100, "mux.fetch"), (100, 120, "mux.log")], 1)
    # the program spans inside the window cover 10-30, 35-40 and 95-100
    # (mux.log lies after it); the aten events and the launch are its own
    assert spans.self_us(outer, ctx=ctx) == 100 - 20 - 5 - 5
    # model.forward inside session.predict; aten::mm stays the predict's
    assert spans.self_us((10, 30, "session.predict"), ctx=ctx) == 20 - 10
    assert spans.union_us([(0, 10, "a"), (5, 15, "b"), (20, 30, "c")]) == 25
    assert spans.total_us([(0, 10, "a"), (5, 15, "b")]) == 20
    assert spans.inside(outer, [(90, 120, "x"), (200, 300, "y")]) == \
        [(90, 100, "x")]


def test_the_session_readers_split_a_window():
    ctx = _ctx(WINDOW + [(s + 1000, e + 1000, n) for s, e, n in WINDOW], 2)
    host = harness.reader("session_host_ms.session")(ctx)
    wait = harness.reader("session_wait_ms.session")(ctx)
    engine = harness.reader("vad_engine_ms.session")(ctx)
    # 1,000 less read, callback, the fetches and the engine (400)
    assert host == pytest.approx(0.6)
    assert wait == pytest.approx(0.1)
    assert engine == pytest.approx(0.1)
    assert host + wait + engine + 0.2 == pytest.approx(1.0)


def test_the_backlog_readers():
    ctx = _ctx([(0, 100, "mux.log"), (10, 20, "logs.reopen"),
                (30, 40, "logs.reopen"), (100, 150, "mux.fetch"),
                (200, 300, "mux.log"), (300, 400, "mux.fetch"),
                (400, 410, "logs.reopen")], 4)
    assert harness.reader("log_reopen_share.backlog")(ctx) == 50.0
    assert harness.reader("fetch_wait_ms.backlog")(ctx) == \
        pytest.approx(150 / 4 / 1e3)


@pytest.mark.parametrize("name", TRACE_READERS)
def test_a_reader_finds_nothing_without_its_spans(name):
    bare = [(0, 50, "Multiplexer.tick"), (10, 20, "aten::mm"),
            (20, 30, "perfbench.top_up")]
    assert harness.reader(name)(_ctx(bare, 64)) is None
    assert harness.reader(name)(_ctx([], 0)) is None


def test_setup_program_s_reads_the_program_record(monkeypatch):
    from mmla_audio_torch.utils import timers

    read = harness.reader("setup_program_s")
    monkeypatch.setattr(timers, "setup_seconds", lambda: 2.5)
    assert read(None) == 2.5
    monkeypatch.setattr(timers, "setup_seconds", lambda: 0.0)
    assert read(None) is None
    # a program without the record
    monkeypatch.delattr(timers, "setup_seconds")
    assert read(None) is None


def test_every_new_reader_is_a_program_span_metric_of_its_cells():
    bench = harness.manifest()
    metrics = {m["name"]: m for m in bench["per_layer"]}
    cells = {w["name"] for w in bench["workloads"]}
    for name in TRACE_READERS + ("setup_program_s",):
        m = metrics[name]
        assert m["source"] == "program_span" and set(m["workloads"]) <= cells
        assert callable(harness.reader(name))
