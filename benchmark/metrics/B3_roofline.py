"""B3's share of its roofline, in percent (kernels grouped as
"shade B3"), over the traced window."""
from benchmark.readers import roofline

read = roofline("shade B3")
