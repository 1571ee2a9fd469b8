"""The benchmark of ``cgr_mpnn_3d_tpu_torch`` on NVIDIA H100 cards.

``python3 -m gpubench.run --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` once and prints its
result as the last line of standard output (README.md beside this file).
"""
