"""The benchmark of the PyTorch and CUDA port (``second_tpu_torch``).

``python -m benchmark.run --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` and prints one JSON
line. Everything a cell needs is found by name: its configuration in
``configs/``, its traffic mix in ``traffic/`` (whose ``kind`` names the
driver in ``kinds/``), its limits in ``limits/`` and each metric's
reader in ``metrics/``. The plain reference that decides ``correct`` is
in ``reference/``; it imports nothing of the port.
"""
