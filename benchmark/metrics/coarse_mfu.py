"""The train step's share of the bf16 peak, in percent: the heads'
product FLOPs a step (forward, and the input and weight cotangents, at
the samples the capacities fix) over the untraced window."""
from benchmark.readers import mfu

read = mfu("train")
