"""Device milliseconds a step credited to the program's ``forward`` span
and the spans inside it (``train_step/forward``), over the traced window."""
from benchmark.readers import span_device_ms

read = span_device_ms("train_step/forward", "train")
