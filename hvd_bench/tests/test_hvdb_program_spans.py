"""hvdb/program_spans.py: the per-step seconds and counts of the program's
own spans against hand-made records and steps, and a whole small traced
run of the sweep on the CPU in which the five readers of those spans
return values and the trace names its idle gaps after them."""

from types import SimpleNamespace

import pytest
from hvdb import program_spans, record
from test_hvdb_run import small_run

MAIN = program_spans.STEP_THREAD
NEW = ("row_index_s.sweep", "row_pack_s.sweep", "drain_wait_s.sweep", "drain_decode_s.sweep",
       "host_hits.sweep")


def span(name, start_s, end_s, thread=MAIN, **counts):
    return SimpleNamespace(name=name, start=int(start_s * 1e9), end=int(end_s * 1e9),
                           thread=thread, counts=counts)


@pytest.fixture
def recorded(monkeypatch):
    """program_spans reading the given records instead of the program's."""
    def use(records):
        monkeypatch.setattr(program_spans, "profiling", SimpleNamespace(records=lambda: records))
    return use


STEPS = [(10.0, 20.0), (30.0, 40.0)]


@pytest.mark.parametrize("records, name, want", [
    ([span("a", 11, 12), span("a", 31, 33)], "a", 1.5),  # one second, then two
    ([span("a", 11, 15), span("a", 12, 13)], "a", 2.0),  # overlapping spans count once
    ([span("a", 5, 12), span("a", 39, 45)], "a", 1.5),  # clipped to the steps
    ([span("a", 11, 12), span("a", 11, 19, thread=MAIN + 1)], "a", 0.5),  # the step's thread only
    ([span("a", 21, 29)], "a", None),  # between the steps
    ([span("b", 11, 12)], "a", None),  # never ran
])
def test_per_step(recorded, records, name, want):
    recorded(records)
    got = program_spans.per_step(SimpleNamespace(steps=STEPS), name)
    assert got == pytest.approx(want) if want is not None else got is None


@pytest.mark.parametrize("records, want", [
    ([span("s", 11, 12, hits=5), span("s", 31, 32, hits=7)], 6.0),
    ([span("s", 11, 12, hits=5), span("s", 21, 22, hits=100)], 2.5),  # outside a step
    ([span("s", 11, 12, hits=5), span("s", 11, 12, thread=MAIN + 1, hits=9)], 2.5),
    ([span("s", 11, 12, other=5)], None),
])
def test_count_per_step(recorded, records, want):
    recorded(records)
    got = program_spans.count_per_step(SimpleNamespace(steps=STEPS), "hits")
    assert got == pytest.approx(want) if want is not None else got is None


def test_a_program_without_the_recorder_gives_nothing(monkeypatch):
    monkeypatch.setattr(program_spans, "profiling", SimpleNamespace())
    rec = SimpleNamespace(steps=STEPS)
    assert program_spans.per_step(rec, "seg.row_pack") is None
    assert program_spans.count_per_step(rec, "seg.host_hits") is None


def test_a_traced_sweep_reads_the_program_spans(monkeypatch):
    """A small traced CPU run of clips1m-sweep: every new reader returns a
    value, the host hits are at least the clips' self-pairs, and the
    idle gaps (the whole window, on the CPU) are named by the program's
    spans."""
    from hydrus_video_deduplicator_tpu_torch.utils import profiling

    assert all(not hasattr(record.load_reader(m), "SPANS") for m in NEW)
    result = small_run(monkeypatch, "clips1m-sweep", traced=True)
    assert result["correct"]
    metrics = result["metrics"]
    assert all(metrics[m]["value"] > 0 for m in NEW), metrics
    assert metrics["host_hits.sweep"]["value"] >= 2_000
    names = {r.name for r in profiling.records()}
    gaps = [name for name, _ in result["breakdown"]["idle_gaps"]]
    assert gaps[0] in names and set(gaps) & {"seg.drain.fetch", "seg.similarities"}, gaps
