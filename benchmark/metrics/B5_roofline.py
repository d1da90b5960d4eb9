"""B5's share of its roofline, in percent (kernels grouped as
"serve B5"), over the traced window."""
from benchmark.readers import roofline

read = roofline("serve B5")
