"""The TensoRF train step's share of the bf16 peak, in percent: the
heads' product FLOPs (forward, and the input and weight cotangents) of
the rows they shade live, from the traced window's ``head_live_rows`` a
step, over the untraced window's steps and seconds."""
from benchmark.readers import mfu

read = mfu("train_tensorf")
