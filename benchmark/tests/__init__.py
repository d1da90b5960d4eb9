"""The benchmark's own tests: ``python -m pytest benchmark/tests`` (CPU; the
card tests skip without a CUDA device)."""
