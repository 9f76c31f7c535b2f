"""The benchmark of ``hutoken_tpu_torch``, the PyTorch and CUDA port.

``python3 -m portbench.run --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` once (``run.py``).
Each piece is found by its name: a configuration in ``configs/`` (its
vocabulary files in the directory beside it), a traffic mix in
``traffic/``, a metric's reader in ``metrics/``.  ``gen/`` holds the
generators and writers those files name, ``data/`` the public text
samples, ``reference/`` the plain references that decide ``correct``,
and ``control.py`` the control that the check has to fail.  The tests in
``tests/`` run on the CPU: ``python -m pytest portbench/tests``.
"""
