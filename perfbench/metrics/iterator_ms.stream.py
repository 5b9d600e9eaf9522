"""Host milliseconds a step in the program's ``fit/iterator`` spans of the
traced ``fit`` call (``perfbench/spans.py``)."""

from perfbench.spans import fit_child_ms


def read(out):
    return fit_child_ms(out, "fit/iterator")
