"""The benchmark of the PyTorch/CUDA port (``pctd_tpu_torch``) on the H100:
``python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell once and prints its result line."""
