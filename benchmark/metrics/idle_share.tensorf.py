"""Percent of the traced window in which no kernel, copy or memset ran
on the device."""
from benchmark.readers import idle_share

read = idle_share("train_tensorf")
