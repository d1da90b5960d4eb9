"""Device milliseconds a step credited to the shading head's ``shade`` span
in the forward (``train_step/forward/shade``), over the traced window."""
from benchmark.readers import span_device_ms

read = span_device_ms("train_step/forward/shade", "train")
