"""Diagnostics of a run (PyTorch): the control-volume force terms
(``forces.py``) and the kinetic-energy spectra of periodic fields
(``spectra.py``)."""
