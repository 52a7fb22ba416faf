"""The benchmark of the PyTorch and CUDA port
(``shermbot_navigation_tpu_torch``): one cell a run, driven by
``BENCHMARK.json`` and the data files beside this package. Run ``python3
portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>``
from the repository root on a CUDA card."""
