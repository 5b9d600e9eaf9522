"""Forward FLOPs of the images served while the profiler ran (padding
rows excluded) over the device's busy time then, at the card's bf16
peak, in %."""


def read(out):
    t, r, peak = out["trace"], out["readings"], out.get("peak_flops")
    if t is None or not peak or t["busy_s"] <= 0 \
            or not r.get("images_in_trace"):
        return None
    flops = r["images_in_trace"] * r["forward_flops_per_image"]
    return 100.0 * flops / t["busy_s"] / peak
