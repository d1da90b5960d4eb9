"""Pixels of every test view scored in the untraced window over its
seconds (the window ends with its last view)."""
from benchmark.readers import rays_per_s as read
