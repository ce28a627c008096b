"""The port's benchmark: `python3 -m tbench.run` (see `tbench/run.py`)."""
