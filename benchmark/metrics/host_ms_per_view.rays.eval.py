"""Host milliseconds a scored view inside the program's ``rays`` spans
(a view's rays made and sent in chunks), over the traced window."""
from benchmark.readers import span_host_ms

read = span_host_ms("rays", "eval")
