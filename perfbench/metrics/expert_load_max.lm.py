"""The most-loaded expert's routed tokens over the traced call, over the
even share (tokens x top-k / experts), at the worst MoE layer: read from
the program's device counters (``MoEBlock``'s ``expert_tokens``) before
and after the call.  1 is an even load; a program without the counters
gives nothing."""


def read(out):
    return out["readings"].get("expert_load_max")
