"""Host milliseconds a panorama of the window plan, the span ``plan``
(its device work, its host read and the window arithmetic;
``portbench/spans.py``)."""

from portbench.spans import plan_ms as read  # noqa: F401
