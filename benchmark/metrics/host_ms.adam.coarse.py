"""Host milliseconds a step inside the program's ``adam`` spans, over the
traced window."""
from benchmark.readers import span_host_ms

read = span_host_ms("adam", "train")
