"""Host milliseconds a step: the benchmark's span around the batch draw
and the step call, with no synchronize, over the untraced window."""
from benchmark.readers import host_ms_per_step as read
