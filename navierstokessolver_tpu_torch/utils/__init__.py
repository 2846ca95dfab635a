"""Diagnostics of a run (PyTorch): the control-volume force terms
(``forces.py``)."""
