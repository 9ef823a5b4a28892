"""The benchmark of the PyTorch/CUDA port (``clip_finegrained_alignment_tpu_torch``).

One command runs one cell once::

    python3 -m port_bench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Everything that belongs to one configuration, traffic mix, cell, per-layer
metric or kernel implementation is a file of its own that the harness finds
by name (``spec.py``); ``README.md`` says how to add each.
"""
