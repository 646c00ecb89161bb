"""The benchmark of ``fries_tpu_torch`` on one NVIDIA H100: FRI and FCIQMC
steps at published budgets, driven by data (``README.md``).

Run one cell once with ``python -m benchmark.run --workload <cell> --seed
<n> --seconds <s> --trace <0|1>``.
"""
