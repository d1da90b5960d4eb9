"""Seconds from the process's start to the untraced window's."""
from benchmark.readers import setup_s as read
