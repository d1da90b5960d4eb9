"""Rays of every step of the untraced window over its seconds (the window
ends in a synchronize), read in a traced run: the coarse step follows the
host's pace, which swings too widely from process to process to hold a
bound end to end."""
from benchmark.readers import rays_per_s as read
