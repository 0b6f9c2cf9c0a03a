"""foldbench: the benchmark of FOLD's PyTorch and CUDA port (`repro_torch`).

`python foldbench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>` runs one cell of the root `BENCHMARK.json` once and prints
one JSON line; `README.md` says how the pieces fit and how to add one.
"""
