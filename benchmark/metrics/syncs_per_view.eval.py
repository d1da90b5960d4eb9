"""Synchronizing calls a scored view under the program's ``render_view``
span (``program.entry``), over the traced window."""
from benchmark.readers import span_syncs

read = span_syncs("render_view", "eval")
