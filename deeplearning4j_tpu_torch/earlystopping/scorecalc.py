"""Score calculators (the port's own copy of
``deeplearning4j_tpu/earlystopping/scorecalc.py``; reference
``earlystopping/scorecalc/``).  ``net.score(ds)`` reads one score on the
host per batch, as in the JAX package."""

from __future__ import annotations


class DataSetLossCalculator:
    """Average loss over a validation iterator (reference
    ``scorecalc/DataSetLossCalculator``; ``average=True`` weights by batch
    size)."""

    def __init__(self, iterator, average: bool = True):
        self.iterator = iterator
        self.average = average

    def calculate_score(self, net) -> float:
        it = self.iterator
        if hasattr(it, "reset"):
            it.reset()
        total = 0.0
        count = 0
        for ds in it:
            n = ds.num_examples()
            total += net.score(ds) * (n if self.average else 1)
            count += n if self.average else 1
        return total / max(count, 1)
