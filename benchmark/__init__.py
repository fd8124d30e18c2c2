"""The benchmark of the PyTorch and CUDA port, pi_sph_fluid_tpu_torch.

`python benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>`
runs one cell of BENCHMARK.json through the port's served path
(`io.host_loop.SimRunner.run`) and prints one JSON line.  Everything a cell
is made of is found by name: the configuration in `configs/`, the traffic
mix in `traffic/`, each end-to-end metric in `end_to_end/` and each
per-layer metric in `metrics/`.  `reference/` is the plain PyTorch
WCSPH that decides `correct`; it imports nothing of the port.
"""
