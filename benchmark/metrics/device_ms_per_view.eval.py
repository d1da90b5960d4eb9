"""Device-busy milliseconds a scored view over the traced window."""
from benchmark.readers import device_ms_per_view as read
