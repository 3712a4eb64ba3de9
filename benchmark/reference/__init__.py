"""The plain reference that decides ``correct`` (``check.py``): float32
nets in plain PyTorch (``nets.py``) and frozen pure-Python host paths
(``frozen/``).  Imports nothing of the program."""
