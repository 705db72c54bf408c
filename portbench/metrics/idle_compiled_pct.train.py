"""The share of the traced span in which the device was idle while the
host was inside the port's compiled epochs and steps (its ``compiled.*``
spans: the key, the upload, a replay, the outputs), in percent
(portbench/harness/port_spans.py)."""

from portbench.harness.port_spans import idle_layer_pct


def read(rec):
    return idle_layer_pct(rec, "compiled")
