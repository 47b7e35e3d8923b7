"""The benchmark of the PyTorch and CUDA port (``bauklank_tpu_torch``).

``python3 portbench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` once and prints one
JSON line.  Everything that belongs to one configuration, traffic mix,
per-layer metric, kernel roofline or engine reference is a file of its
own under ``configs/``, ``traffic/``, ``metrics/``, ``roofline/``,
``limits/`` and ``reference/``, found by name.
"""
