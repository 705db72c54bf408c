"""The whole step's share of the card's bf16 peak, in percent: the
operations each item needs (portbench/counts/models.py) times the items
per second of the traced span."""

from portbench.harness.readers import mfu_pct


def read(rec):
    return mfu_pct(rec)
