"""The benchmark of the PyTorch and CUDA port (``fgs_nerf_tpu_torch``).

``python -m benchmark.harness --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell once; ``BENCHMARK.json`` names the cells.
"""
