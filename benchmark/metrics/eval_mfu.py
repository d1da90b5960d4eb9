"""The render's share of the bf16 peak, in percent: the heads' forward
product FLOPs of the rows they shade live, from the traced window's
``head_live_rows`` a view, over the untraced window's views and
seconds."""
from benchmark.readers import mfu

read = mfu("eval")
