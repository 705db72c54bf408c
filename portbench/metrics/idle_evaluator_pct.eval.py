"""The share of the traced span in which the device was idle while the
host was inside the port's evaluator (its ``evaluator.*`` spans: a batch's
update, the distances, CMC and mAP, the fetch of the results), in percent
(portbench/harness/port_spans.py)."""

from portbench.harness.port_spans import idle_layer_pct


def read(rec):
    return idle_layer_pct(rec, "evaluator")
