"""The 90th percentile of the intervals between the CUDA events recorded
after each step of the untraced window."""
from benchmark.readers import step_ms_p90 as read
