"""The routed experts' share of their roofline: the three SwiGLU
products of every token's top-k slots, forward and both gradients
(``reference/lfm2.py`` ``expert_flops``), over the device time of the
``experts`` kernel class (``kernel_classes/experts.txt``: the grouped
GEMMs and their argument setup) at the card's bf16 peak, in %."""

from perfbench.readers import trace_of


def read(out):
    t, r, peak = trace_of(out), out["readings"], out.get("peak_flops")
    if t is None or not peak or not r.get("expert_flops_per_sample"):
        return None
    busy = t["by_class"].get("experts", 0.0)
    if busy <= 0:
        return None
    return 100.0 * r["samples"] * r["expert_flops_per_sample"] / busy / peak
