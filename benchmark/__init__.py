"""The benchmark of ``kbe_torch``, the PyTorch and CUDA port: run one cell
with ``python3 benchmark/run.py --workload <name> --seed <n> --seconds <s>
--trace <0|1>``; ``BENCHMARK.json`` at the repository's root names the
cells and metrics."""
