"""The benchmark of dsen2_tpu_torch on one NVIDIA H100.

`python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>` runs one cell of BENCHMARK.json once (perfbench/harness.py).
Nothing here imports JAX or the JAX package, and nothing in
perfbench/reference/ imports dsen2_tpu_torch.
"""
