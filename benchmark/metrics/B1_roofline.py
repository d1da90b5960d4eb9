"""B1's share of its roofline, in percent (kernels grouped as
"serve B1"), over the traced window."""
from benchmark.readers import roofline

read = roofline("serve B1")
