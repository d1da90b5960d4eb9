"""The render's share of the bf16 peak, in percent: the heads' forward
product FLOPs of every chunk (at the shade_k samples a ray the
capacities fix) over the untraced window."""
from benchmark.readers import mfu

read = mfu("eval")
