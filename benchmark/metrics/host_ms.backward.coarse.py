"""Host milliseconds a step inside the program's ``backward`` spans (with
the head's recompute on autograd's thread), over the traced window."""
from benchmark.readers import span_host_ms

read = span_host_ms("backward", "train")
