"""Device milliseconds a step credited to the program's ``adam`` span
(masked Adam and the ``s_val`` write), over the traced window."""
from benchmark.readers import span_device_ms

read = span_device_ms("train_step/adam", "train")
