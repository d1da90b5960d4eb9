"""Device milliseconds a step in the kernels the frozen ``record.BUCKETS``
group as "matmul", over the traced window."""
from benchmark.readers import device_ms

read = device_ms("matmul")
