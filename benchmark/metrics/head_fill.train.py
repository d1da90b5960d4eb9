"""Percent of the rows the shading head computed that were live: the
program's ``head_live_rows`` over ``head_rows``, over the traced window."""
from benchmark.readers import head_fill

read = head_fill("train")
