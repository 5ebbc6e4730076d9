"""The benchmark of the PyTorch and CUDA port (``repro_torch``): TAPER's
extroversion field, driven through ``Taper.field`` on the card.

``python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>``
from the checkout's root runs one cell of ``BENCHMARK.json``.
"""
