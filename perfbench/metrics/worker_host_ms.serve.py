"""Host milliseconds a batch in the serving worker's ``serve/assemble``
and ``serve/resolve`` spans over the traced stretch
(``perfbench/spans.py``)."""

from perfbench.spans import worker_host_ms as read  # noqa: F401
