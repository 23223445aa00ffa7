"""The benchmark of ``tpu_ac_torch``: ``python3 benchmark/run.py --workload
CELL --seed N --seconds S --trace 0|1`` (README of this folder: ``run.py``)."""
