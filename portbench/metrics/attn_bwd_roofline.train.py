"""The bf16 attention backward kernel's share of its roofline at the cell's
shape (portbench/counts/attention.py), in percent."""

from portbench.harness.readers import roofline_pct


def read(rec):
    return roofline_pct(rec, "bwd")
