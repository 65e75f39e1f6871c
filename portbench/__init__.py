"""The benchmark of the PyTorch/CUDA port (``pvac_hfhe_cppbyv_tpu_torch``).

``python3 portbench/run.py --workload CELL --seed N --seconds S --trace 0|1``
runs one cell of ``BENCHMARK.json`` on the card.  Everything that belongs
to one configuration, traffic mix or metric is a file of its own, found by
its name: ``configs/``, ``traffic/``, ``metrics/``, ``roofline/``; the
plain reference that decides ``correct`` is under ``reference/``.
"""
