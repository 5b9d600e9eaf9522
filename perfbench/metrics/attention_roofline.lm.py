"""K1-K3's share of their roofline: the attention the traced call's
sequences need, counted as the mathematics does (forward QK^T and PV,
backward dV, dP, dQ and dK over the causal half, no recomputation;
``reference/lfm2.py`` ``attention_flops``), over the device time of the
``flash`` kernel class (``kernel_classes/flash.txt``) at the card's
bf16 peak, in %."""

from perfbench.readers import trace_of


def read(out):
    t, r, peak = trace_of(out), out["readings"], out.get("peak_flops")
    if t is None or not peak or not r.get("attention_flops_per_sample"):
        return None
    busy = t["by_class"].get("flash", 0.0)
    if busy <= 0:
        return None
    return 100.0 * r["samples"] * r["attention_flops_per_sample"] / busy \
        / peak
