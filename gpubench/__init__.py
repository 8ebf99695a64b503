"""The benchmark of ``nanotpu_torch``, the PyTorch and CUDA port, on NVIDIA
H100 cards.

One command runs one cell of ``BENCHMARK.json`` once::

    python3 -m gpubench.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

Everything is found by name, so a cell, a traffic mix, a configuration, a
driver kind or a metric is added by adding files:

* ``configs/<config>.json``: a model configuration as it is run;
* ``workloads/<traffic>.json``: a traffic mix, read by the driver it names;
* ``cells/<cell>.json``: the limits of the numbers that decide ``correct``;
* ``drivers/<kind>.py``: a driver kind (``serve_closed``, ``train``);
* ``families/<model_type>.py``: how a config's ``model_type`` is built in
  the port and in the reference;
* ``metrics/<metric>.py``: one metric's reader.

``yardstick/`` holds the arithmetic every metric shares (percentiles and
window edges, FLOP and byte counts, the published peaks, the reduction of a
profiler trace, the traffic generator) and ``reference/`` the plain float32
PyTorch models that decide ``correct``. Neither imports ``jax``, ``jaxlib``
or the JAX package ``nanotpu``; ``reference/`` imports nothing of the port.
"""
