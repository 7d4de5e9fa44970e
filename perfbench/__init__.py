"""The benchmark of the PyTorch/CUDA port (``repro_torch``).

``python3 perfbench/run.py --workload <name> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` on the card and prints
one JSON line. Everything that measures (traffic, the plain references, the
work counts and peaks, the comparison that decides ``correct``) lives in
this folder; from the port it takes only the system under test.
"""
