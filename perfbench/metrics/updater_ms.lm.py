"""``updater_ms.lm``: device ms a step in the ``updater`` kernel class
(``kernel_classes/updater.txt``: the fused Adam step over fp32 masters)
on the language-model training cell.  None where the class reads 0, as on
a program whose updater runs as torch ops (their kernels count in
``other_kernel_ms.lm``)."""

from perfbench.readers import trace_of


def read(out):
    t, r = trace_of(out), out["readings"]
    if t is None or not r.get("steps"):
        return None
    busy = t["by_class"].get("updater", 0.0)
    if busy <= 0:
        return None
    return 1e3 * busy / r["steps"]
