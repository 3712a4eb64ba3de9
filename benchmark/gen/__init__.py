"""The traffic generator (``traffic.py``) and its frozen read simulator
(``sim.py``)."""
