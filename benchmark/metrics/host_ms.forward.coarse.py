"""Host milliseconds a step inside the program's ``forward`` spans, over
the traced window."""
from benchmark.readers import span_host_ms

read = span_host_ms("forward", "train")
