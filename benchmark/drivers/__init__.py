"""One module per kind of traffic (``train``, ``eval``): each reads its
mix's parameters from the traffic file and runs a cell through the
program's own entry points."""
