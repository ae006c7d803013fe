"""The span readers (``benchmark/spans.py`` and the three ``program_span``
metrics that read the program's record) on hand-made spans, annotations and
kernels: the numbers they should give, and nothing where the program keeps
no spans."""

from types import SimpleNamespace

import pytest

from benchmark import run as R
from benchmark import spans as S
from diffsensei_tpu_torch.utils import observability as O


def rec(name, start_ms, end_ms, thread=1):
    return O.SpanRecord(name, {}, thread, 0, None, int(start_ms * 1e6), int(end_ms * 1e6))


@pytest.fixture
def records(monkeypatch):
    fake = [rec("denoise.step", 0, 20), rec("denoise.step", 20, 50),
            rec("denoise.unet", 1, 19), rec("serve.prepare", 100, 112),
            rec("data.put", 0, 30, thread=2), rec("data.put", 40, 50, thread=2)]
    monkeypatch.setattr(O, "SPANS", fake)
    return fake


@pytest.mark.parametrize("metric, want", [("host_enqueue_ms.serve", 25.0),
                                          ("prepare_ms.serve", 12.0),
                                          ("data_put_ms.train", 20.0)])
def test_program_span_readers(records, metric, want):
    assert R.reader(metric).read({}) == pytest.approx(want)


@pytest.mark.parametrize("metric", ["host_enqueue_ms.serve", "prepare_ms.serve",
                                    "data_put_ms.train"])
def test_readers_find_nothing_where_the_program_keeps_no_spans(monkeypatch, metric):
    monkeypatch.delattr(O, "SPANS")
    assert R.reader(metric).read({}) is None


KERNELS = [("k", 0, 10), ("k", 12, 20), ("k", 18, 30), ("k", 40, 50), ("k", 60, 70)]


def ann(name, side, s, e, thread=1):
    return (name, side, s, e, thread)


def test_busy_in_ms_is_the_union_of_what_the_span_launched():
    a = [ann("train.optimizer", "host", 4, 7), ann("train.optimizer", "device", 0, 100),
         ann("train.remat_replay", "host", 50, 60, thread=2)]
    launches = [(1, 3), (1, 5), (1, 6), (2, 55), (1, 56)]
    # kernels 12-20 and 18-30 launched inside 4-7 on thread 1: busy 12-30
    assert S.busy_in_ms(KERNELS, launches, a, "train.optimizer") == pytest.approx(18e-3)
    # only thread 2's launch counts for the replay
    assert S.busy_in_ms(KERNELS, launches, a, "train.remat_replay") == pytest.approx(10e-3)
    assert S.busy_in_ms(KERNELS, launches, a, "train.metrics") is None


def test_loop_idle_pct_covers_each_loop_alone():
    a = [ann("pipeline.conditioning", "host", 0, 4),
         ann("denoise.step", "host", 4, 6), ann("denoise.step", "host", 6, 9),
         ann("pipeline.decode", "host", 9, 12)]
    launches = [(1, 1), (1, 5), (1, 7), (1, 8), (1, 10)]
    # one loop, launching kernels 12-20, 18-30 and 40-50: extent 12-50 (38 us), busy 28
    assert S.loops(a) == [(4, 9, 1)]
    assert S.loop_idle_pct(KERNELS, launches, a) == pytest.approx(100 * 10 / 38)
    assert S.loop_idle_pct(KERNELS, launches, a[:1]) is None
    two = a + [ann("denoise.step", "host", 13, 14)]
    assert S.loops(two) == [(4, 9, 1), (13, 14, 1)]


def test_idle_by_span_splits_each_stretch_by_the_issuing_threads_spans():
    host = [ann("train.step", "host", 0, 100), ann("train.forward", "host", 0, 35),
            ann("train.optimizer", "host", 35, 100),
            ann("train.remat_replay", "host", 36, 39, thread=2)]
    launches = [(1, 0), (1, 11), (1, 11.5), (2, 38), None]
    syncs = [(1, 38), (2, 37), (3, 20)]
    got = {row[0]: row[1:] for row in S.idle_by_span(KERNELS, launches, host, syncs, (0, 80))}
    # 10-12: thread 1 in train.forward; 30-40: thread 2, in its replay at
    # 36-39 and else under the main thread's spans; 50-60: no launch; 70-80: tail
    assert got["train.forward"] == [pytest.approx(2e-6), 1, 0]
    assert got["train.forward [thread 2]"] == [pytest.approx(5e-6), 1, 0]
    assert got["train.optimizer [thread 2]"] == [pytest.approx(2e-6), 1, 0]
    assert got["train.remat_replay"] == [pytest.approx(3e-6), 1, 1]
    assert got[S.OUTSIDE] == [pytest.approx(10e-6), 1, 0]
    assert got["(after the last device op)"] == [pytest.approx(10e-6), 1, 0]
    assert got["train.optimizer"] == [0.0, 0, 1]          # the sync on the main thread
    assert got["train.forward [thread 3]"] == [0.0, 0, 1]  # a thread with no span of its own
    assert sum(v[0] for v in got.values()) == pytest.approx(32e-6)


def test_where_prefers_the_issuing_threads_innermost_span():
    by, main = S._host([ann("train.step", "host", 0, 100), ann("train.backward", "host", 10, 90),
                        ann("train.remat_replay", "host", 20, 30, thread=2)])
    assert main == 1
    assert S.where(by, main, 1, 50) == "train.backward"
    assert S.where(by, main, 2, 25) == "train.remat_replay"
    assert S.where(by, main, 2, 50) == "train.backward [thread 2]"
    assert S.where(by, main, 1, 150) == S.OUTSIDE


def test_host_ms_of_a_name_without_spans_is_none():
    assert S.host_ms([SimpleNamespace(name="x", start_ns=0, end_ns=1)], "y") is None


def test_longest_places_a_stretch_by_its_start_and_its_launch():
    host = [ann("train.step", "host", 0, 100), ann("train.metrics", "host", 28, 35),
            ann("train.encode", "host", 35, 100)]
    launches = [(1, 0), (1, 5), (1, 6), (1, 38), (1, 39)]
    assert S.longest(KERNELS, launches, host, n=2) == [
        [pytest.approx(10e-6), "train.metrics", "train.encode", 30, 40],
        [pytest.approx(10e-6), "train.encode", "train.encode", 50, 60]]
