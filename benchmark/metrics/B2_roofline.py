"""B2's share of its roofline, in percent (kernels grouped as
"accumulate B2"), over the traced window."""
from benchmark.readers import roofline

read = roofline("accumulate B2")
