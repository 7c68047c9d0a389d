"""The readers of the port's spans (``span_readers.py``,
``layer_metrics/predict_idle_ms.*``, ``train_idle_ms.*``) on traces built by
hand, where the idle time inside each span is known."""

import pytest

from benchmark import cells
from benchmark.readers import ReadContext
from benchmark.span_readers import idle_ms, window_spans
from benchmark.trace import WINDOW, Trace

STAGES = ("in", "forward", "fetch", "assemble")
MS = 1_000_000  # ns


def ctx(device, host, **counts):
    return ReadContext(trace=Trace(device, host), counts=counts, config={}, traffic={})


def test_idle_is_each_spans_wall_time_less_the_busy_time_inside_it():
    # window [0, 100] ms; span a [10, 30] with 5 ms busy; span b [40, 50], idle
    c = ctx([(12 * MS, 17 * MS, "k"), (60 * MS, 70 * MS, "k")],
            [(0, 100 * MS, WINDOW), (10 * MS, 30 * MS, "a"), (40 * MS, 50 * MS, "b")],
            steps=2)
    assert idle_ms(c, ("a",), "steps") == pytest.approx(15 / 2)
    assert idle_ms(c, ("a", "b"), "steps") == pytest.approx((15 + 10) / 2)


def test_nested_spans_of_the_names_count_once():
    c = ctx([(12 * MS, 14 * MS, "k")],
            [(0, 100 * MS, WINDOW), (10 * MS, 30 * MS, "a"), (15 * MS, 20 * MS, "b"),
             (25 * MS, 40 * MS, "b")], steps=1)
    assert window_spans(c, ("a", "b")) == [(10 * MS, 40 * MS)]
    assert idle_ms(c, ("a", "b"), "steps") == pytest.approx(30 - 2)


def test_spans_are_clipped_to_the_window():
    # a span straddling each edge of the window [20, 80]
    c = ctx([(25 * MS, 30 * MS, "k")],
            [(20 * MS, 80 * MS, WINDOW), (10 * MS, 40 * MS, "a"), (70 * MS, 90 * MS, "a"),
             (85 * MS, 95 * MS, "a")], requests=1)
    assert window_spans(c, ("a",)) == [(20 * MS, 40 * MS), (70 * MS, 80 * MS)]
    assert idle_ms(c, ("a",), "requests") == pytest.approx(20 - 5 + 10)


def test_none_where_the_window_holds_none_of_the_spans():
    host = [(0, 100 * MS, WINDOW), (10 * MS, 20 * MS, "bench.request"),
            (110 * MS, 120 * MS, "mimo.predict.fetch")]
    c = ctx([(12 * MS, 14 * MS, "k")], host, requests=1)
    assert idle_ms(c, ("mimo.predict.fetch",), "requests") is None
    assert idle_ms(c, ("mimo.predict.in",), "requests") is None
    for stage in STAGES:
        assert cells.reader(f"predict_idle_ms.{stage}")(c) is None
    for stage in ("input", "forward", "backward", "update"):
        assert cells.reader(f"train_idle_ms.{stage}")(ctx([], host, steps=1)) is None


def test_none_without_units():
    c = ctx([], [(0, 10 * MS, WINDOW), (1 * MS, 2 * MS, "a")], steps=0)
    assert idle_ms(c, ("a",), "steps") is None


def _predict_trace():
    """Two requests, each ``bench.request`` around ``mimo.predict`` and its
    four stages, with device work inside and between the stages."""
    host, device = [(0, 200 * MS, WINDOW)], []
    for t in (10, 110):
        t *= MS
        host += [(t, t + 80 * MS, "bench.request"), (t + 1 * MS, t + 79 * MS, "mimo.predict")]
        edges = (2, 10, 40, 60, 78)
        for stage, a, b in zip(STAGES, edges, edges[1:]):
            host.append((t + a * MS, t + b * MS, f"mimo.predict.{stage}"))
        device += [(t + 5 * MS, t + 8 * MS, "Memcpy HtoD"), (t + 12 * MS, t + 45 * MS, "k"),
                   (t + 50 * MS, t + 55 * MS, "Memcpy DtoH"), (t + 77 * MS, t + 79 * MS, "k")]
    return ctx(device, host, requests=2, frames=64)


def test_the_predict_stages_sum_to_at_most_predict_host_ms():
    c = _predict_trace()
    parts = {s: cells.reader(f"predict_idle_ms.{s}")(c) for s in STAGES}
    host = cells.reader("predict_host_ms")(c)
    # per request: in 8-3, forward 30-28, fetch 20-(5+5), assemble 18-1; the
    # request's 80 ms less its 3+33+5+2 busy
    assert parts == pytest.approx({"in": 5, "forward": 2, "fetch": 10, "assemble": 17})
    assert host == pytest.approx(80 - 43)
    assert sum(parts.values()) <= host
    # idle outside the stages: the request's first 2 ms and its last ms
    assert sum(parts.values()) == pytest.approx(host - 3)


def test_train_input_reads_the_gather_and_the_transform():
    host = [(0, 100 * MS, WINDOW), (10 * MS, 12 * MS, "mimo.data.gather"),
            (12 * MS, 20 * MS, "mimo.train.input"), (20 * MS, 50 * MS, "mimo.train.forward"),
            (50 * MS, 90 * MS, "mimo.train.backward"), (90 * MS, 99 * MS, "mimo.train.update")]
    device = [(11 * MS, 95 * MS, "k")]
    c = ctx(device, host, steps=1, images=64)
    got = {s: cells.reader(f"train_idle_ms.{s}")(c)
           for s in ("input", "forward", "backward", "update")}
    assert got == pytest.approx({"input": 1, "forward": 0, "backward": 0, "update": 4})
