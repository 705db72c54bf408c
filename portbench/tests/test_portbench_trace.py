"""The traced run's reading, on records made by hand."""

from portbench.counts import attention
from portbench.harness import readers, trace


class _Program:
    def flops_per_item(self):
        return 1e12

    def attention(self):
        return attention.Shape(64, 129, 12)


def _records():
    rec = trace.Records(0.0, 1.0)
    rec.kernels = [("void mha_fwd_tc_kernel<64, false>(...)", 0.10, 0.10 + 4.5e-5),
                   ("void mha_bwd_tc_kernel<64, false>(...)", 0.20, 0.20 + 1.5e-4),
                   ("sm90_xmma_gemm_bf16bf16_bf16f32", 0.30, 0.70),
                   ("void at::native::vectorized_elementwise_kernel<4>", 0.70, 0.80)]
    rec.device = [(s, e) for _, s, e in rec.kernels] + [(0.85, 0.90)]
    rec.host_spans = [("portbench.unit", 0.0, 0.95), ("portbench.fetch", 0.8, 0.95)]
    rec.items = 100
    rec.context["program"] = _Program()
    return rec


def test_busy_idle_and_gaps():
    rec = _records()
    busy = 4.5e-5 + 1.5e-4 + 0.4 + 0.1 + 0.05
    assert abs(rec.busy_s() - busy) < 1e-12
    assert abs(readers.idle_pct(rec) - 100 * (1 - busy)) < 1e-9
    b = rec.breakdown()
    assert b["device_ops"][0][0] == "gemm" and len(b["idle_gaps"]) <= 10
    assert b["idle_gaps"][0] == ["portbench.unit", b["idle_gaps"][0][1]]
    labels = {g[0] for g in b["idle_gaps"]}
    assert labels <= {"portbench.unit", "portbench.fetch", "outside"}


def test_rooflines_and_mfu():
    rec = _records()
    fwd = readers.roofline_pct(rec, "fwd")
    assert abs(fwd - 100 * 0.0151 / 0.045) < 0.2
    assert abs(readers.roofline_pct(rec, "bwd") - 100 * 0.0265 / 0.15) < 0.2
    assert abs(readers.mfu_pct(rec) - 100 * 100 * 1e12 / 989e12) < 1e-9
    assert rec.count(trace.COUNTED_KERNELS["attention_fwd"]) == 1


def test_no_kernel_no_roofline():
    rec = _records()
    rec.kernels = rec.kernels[2:]
    assert readers.roofline_pct(rec, "fwd") is None
