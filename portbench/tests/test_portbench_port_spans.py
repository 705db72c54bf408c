"""The device's idle time put down to the port's spans
(``harness/port_spans.py``): on records and spans made by hand, and on
each cell's program at ``MODEL.DEBUG_TINY`` under a CPU profiler."""

import collections
import sys

import pytest
from torch.profiler import ProfilerActivity, profile, record_function

from mpreid_tpu_torch import utils as port_utils
from mpreid_tpu_torch.utils import tracing
from portbench.harness import manifest, port_spans, readers, runner, trace

from .conftest import TINY, cell

S = 1_000_000_000  # ns a second
NEW_METRICS = ("idle_compiled_pct.train", "idle_compiled_pct.stage1", "idle_compiled_pct.eval",
               "idle_evaluator_pct.eval")


def _records():
    """A one-second span at t = 100 s: the device busy 0.1–0.3 and 0.5–0.9,
    idle 0.4 s; the host in ``validation.pass`` 0–0.95, ``compiled.step``
    0.05–0.32, ``evaluator.compute`` 0.35–0.95 and in it ``evaluator.fetch``
    0.45–0.6."""
    rec = trace.Records(100.0, 101.0)
    rec.device = [(100.1, 100.3), (100.5, 100.9)]
    spans = [("validation.pass", 0.0, 0.95), ("compiled.step", 0.05, 0.32),
             ("evaluator.compute", 0.35, 0.95), ("evaluator.fetch", 0.45, 0.6)]
    kept = collections.deque(
        tracing.Span(n, int((100 + a) * S), int((100 + b) * S), -1, i, i)
        for i, (n, a, b) in enumerate(spans))
    return rec, kept


@pytest.fixture
def hand_made(monkeypatch):
    rec, kept = _records()
    monkeypatch.setattr(tracing, "_records", kept)
    return rec


def _close(a: dict, b: dict):
    assert set(a) == set(b), (a, b)
    for k in a:
        assert abs(a[k] - b[k]) < 1e-6, (k, a[k], b[k])


def test_idle_goes_to_the_innermost_span(hand_made):
    _close(port_spans.idle_by_layer(hand_made),
           {"validation": 0.08, "compiled": 0.07, "evaluator": 0.20, "outside": 0.05})
    by_name = port_spans.idle_split(hand_made, lambda n: n)
    _close(by_name, {"validation.pass": 0.08, "compiled.step": 0.07,
                     "evaluator.compute": 0.15, "evaluator.fetch": 0.05, "outside": 0.05})


def test_the_layers_add_up_to_the_idle_share(hand_made):
    split = port_spans.idle_by_layer(hand_made)
    idle = readers.idle_pct(hand_made)
    assert abs(idle - 40.0) < 1e-6
    assert abs(100 * sum(split.values()) / hand_made.window_s - idle) < 1e-6
    assert abs(port_spans.idle_layer_pct(hand_made, "evaluator") - 20.0) < 1e-6
    assert port_spans.idle_layer_pct(hand_made, "loader") == 0.0


def test_spans_outside_the_window_are_not_read(monkeypatch):
    rec, _ = _records()
    monkeypatch.setattr(tracing, "_records", collections.deque(
        [tracing.Span("compiled.step", 90 * S, 95 * S, -1, 0, 0)]))
    assert port_spans.idle_by_layer(rec) is None
    for name in NEW_METRICS:
        assert manifest.reader(name).read(rec) is None


def test_without_spans_or_the_module_the_readers_read_nothing(hand_made, monkeypatch):
    for name in NEW_METRICS:
        assert manifest.reader(name).read(hand_made) is not None
    monkeypatch.delattr(port_utils, "tracing")
    monkeypatch.setitem(sys.modules, "mpreid_tpu_torch.utils.tracing", None)
    assert port_spans.port_spans(hand_made) is None
    assert port_spans.idle_by_layer(hand_made) is None
    for name in NEW_METRICS:
        assert manifest.reader(name).read(hand_made) is None


def test_every_new_metric_has_its_entry():
    bench = manifest.benchmark()
    entries = {m["name"]: m for m in bench["per_layer"]}
    cells = {"train": "vitb16-uniprompt.stage2a", "stage1": "vitb16-uniprompt.stage1a",
             "eval": "vitb16-uniprompt.eval"}
    for name in NEW_METRICS:
        m = entries[name]
        assert m["workloads"] == [cells[name.rsplit(".", 1)[1]]]
        assert (m["unit"], m["better"], m["source"]) == ("%", "lower", "device_trace")
        assert m["layer"] == ("metrics" if "evaluator" in name else "compiled epochs and steps")


@pytest.mark.parametrize("name", ["vitb16-uniprompt.stage2a", "vitb16-uniprompt.stage1a",
                                  "vitb16-uniprompt.eval"])
def test_a_program_under_a_profiler_leaves_spans_to_read(name):
    """The cell's units at DEBUG_TINY on the CPU under a profiler, the
    second inside the window span, as a traced run takes them: no device
    records, so the whole window is idle, and every instant of it goes to a
    layer or to ``outside``."""
    cell_ = cell(name)
    prog = manifest.program(cell_.workload["program"]).Program(
        runner.context(cell_, 2 ** 31 + 91, "cpu", TINY))
    prog.setup()
    tracing.clear()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        prog.unit()
        with record_function(trace.SPAN):
            items = prog.unit()
    rec = trace.records(prof)
    rec.items = items
    rec.context.update(program=prog, cell=cell_)
    split = port_spans.idle_by_layer(rec)
    assert abs(sum(split.values()) - rec.window_s) < 1e-6 * rec.window_s
    assert readers.idle_pct(rec) == 100.0
    assert split["compiled"] > 0 and split["steps"] > 0
    values = {m["name"]: manifest.reader(m["name"]).read(rec) for m in cell_.per_layer
              if m["name"] in NEW_METRICS}
    assert values and all(v is not None and 0 < v < 100 for v in values.values()), values
    if name.endswith("eval"):
        assert split["evaluator"] > 0 and split["validation"] > 0
    prog.finish()
    tracing.clear()
