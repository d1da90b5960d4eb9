"""Synchronizing calls a step under the program's ``train_step`` span
(``program.entry``), over the traced window."""
from benchmark.readers import span_syncs

read = span_syncs("train_step", "train_tensorf")
