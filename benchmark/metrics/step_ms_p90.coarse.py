"""The 90th percentile of the intervals between the CUDA events recorded
after each step of the untraced window, read in a traced run: the coarse
step follows the host's pace, which swings too widely from process to
process to hold a bound end to end."""
from benchmark.readers import step_ms_p90 as read
