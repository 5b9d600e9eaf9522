"""Host milliseconds a step in the program's ``fit/stage`` spans of the
traced ``fit`` call (``perfbench/spans.py``)."""

from perfbench.spans import fit_child_ms


def read(out):
    return fit_child_ms(out, "fit/stage")
