"""The benchmark of ``crypto_primitives_tpu_torch`` on one NVIDIA GPU.

``python3 portbench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json``.  Everything that belongs
to one configuration, traffic mix or metric is a file of its own, found by
its name: ``configs/<config>.{json,py}``, ``traffic/<mix>.json`` (whose
``kind`` names ``kinds/<kind>.py``), ``metrics/<family>.py`` (the part of a
metric's name before its first dot) and ``roofline/<kernel>.py``.
"""
