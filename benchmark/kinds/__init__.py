"""Drivers of the kinds of traffic, named by a mix's ``kind``. Each has
``run(env)``: set-up, the measured window, the comparison with the
reference, returning the run's record (see ``run.py``)."""
