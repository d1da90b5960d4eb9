"""Device milliseconds a step credited to the program's ``backward`` span
and the spans inside it (with the head's recompute), over the traced
window."""
from benchmark.readers import span_device_ms

read = span_device_ms("train_step/backward", "train")
