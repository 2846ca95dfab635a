"""Diagnostics of a run (PyTorch): the control-volume force terms
(``forces.py``), the kinetic-energy spectra of periodic fields
(``spectra.py``) and the per-window metrics of the command line
(``metrics.py``)."""
