"""The masked Adam kernel's share of its roofline, in percent (kernels
grouped as "adam" by ``groups/adam.py``), over the traced window."""
from benchmark.readers import roofline

read = roofline("adam")
