"""Device milliseconds a step credited to the program's ``tv`` span (the TV
injection), over the traced window."""
from benchmark.readers import span_device_ms

read = span_device_ms("train_step/tv", "train")
