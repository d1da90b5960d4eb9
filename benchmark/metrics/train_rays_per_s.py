"""Rays of every step of the untraced window over its seconds (the window
ends in a synchronize)."""
from benchmark.readers import rays_per_s as read
