"""The benchmark harness of ``vln_magic_tpu_torch``: traffic, drivers,
trace reading, FLOP counts and the correctness check (``run.py``)."""
