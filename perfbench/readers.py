"""Per-layer readers shared by metrics of the same quantity on cells
that report different end-to-end metrics (``mfu.train`` and
``mfu.stream``...).  Each takes a run's outcome and returns the metric,
or None where the run has nothing to read: a share of a peak is never
made up as 0."""


def trace_of(out):
    """The traced stretch's summary, when the device did any work."""
    t = out["trace"]
    return t if t is not None and t["busy_s"] > 0 else None


def mfu(out):
    """The traced window's training FLOP/s (three forwards a step,
    counted from the reference's layer shapes) over the card's bf16 peak,
    in %."""
    r, peak = out["readings"], out.get("peak_flops")
    if trace_of(out) is None or not peak or not r.get("window_s"):
        return None
    return 100.0 * r["samples"] / r["window_s"] * r["step_flops_per_sample"] \
        / peak


def gemm_conv_roofline(out):
    """The step's convolution and dense FLOPs over the device time of the
    convolution and GEMM kernels (``kernel_classes/conv.txt``,
    ``gemm.txt``) at the card's bf16 peak, in %."""
    t, r, peak = trace_of(out), out["readings"], out.get("peak_flops")
    if t is None or not peak:
        return None
    busy = t["by_class"].get("conv", 0.0) + t["by_class"].get("gemm", 0.0)
    if busy <= 0:
        return None
    return 100.0 * r["samples"] * r["step_flops_per_sample"] / busy / peak


def other_kernel_ms(out):
    """Device milliseconds a step in every kernel that is neither a
    convolution nor a GEMM (batch norm, the updater, activations, casts,
    the cache's gather), copies between host and device excluded."""
    t, r = trace_of(out), out["readings"]
    if t is None or not r.get("steps"):
        return None
    return 1e3 * t["by_class"].get("other", 0.0) / r["steps"]


def htod_ms(out):
    """Device milliseconds a step of host-to-device copies."""
    t, r = trace_of(out), out["readings"]
    if t is None or not r.get("steps") or t["htod_s"] <= 0:
        return None
    return 1e3 * t["htod_s"] / r["steps"]


def device_idle(out):
    """1 - the union of device-event intervals over the traced window,
    in %."""
    t = trace_of(out)
    if t is None or t["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
