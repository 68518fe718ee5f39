"""The benchmark of ``torchsnapshot_tpu_torch``: checkpointed training of
GPT-family configurations on one NVIDIA H100.

``python3 portbench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` and prints one JSON
line. Everything one configuration, traffic mix or metric needs is a file
of its own that the harness finds by the name ``BENCHMARK.json`` gives:
``configs/<file>`` (sizes, with the module of its block that the file
names: initial parameters, leaf names, FLOPs per step and the plain
reference), ``traffic/<traffic>.json``, ``metrics/<metric>.py`` and
``limits/<config>.json``. Only :mod:`portbench.program` imports the port.
"""
