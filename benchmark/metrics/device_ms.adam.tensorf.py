"""Device milliseconds a step credited to the program's ``adam`` span
(masked Adam over the SDF, the seven k0 factor leaves and the heads, and
the ``s_val`` write), over the traced window."""
from benchmark.readers import span_device_ms

read = span_device_ms("train_step/adam", "train_tensorf")
