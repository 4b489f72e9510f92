"""The benchmark of devo_tpu_torch on one or four NVIDIA H100 cards.

`python3 benchmark/run.py --workload NAME --seed N --seconds S --trace 0|1`
runs one cell of BENCHMARK.json and prints its result as the last line of
standard output. Everything a cell needs is found by name: its workload
file (workloads/NAME.json), the configuration and traffic mix it names
(configs/, traffic/), the runner the traffic names (runners/) and the
per-layer metric readers (metrics/). The reference that decides `correct`
(reference/) is a frozen plain-PyTorch copy of the port's plain path and
imports nothing of the port.
"""
