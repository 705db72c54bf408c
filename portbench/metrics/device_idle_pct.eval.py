"""The device's idle share of the traced span, in percent."""

from portbench.harness.readers import idle_pct


def read(rec):
    return idle_pct(rec)
