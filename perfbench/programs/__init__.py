"""The programs under test, one module a program family.

A configuration file names its program (``"program": "<name>"``; a file
without the key means ``memhd``), and ``programs/<name>.py`` defines
``deploy(cell, inputs, seed, root)``: the program built and deployed from
the benchmark's ``inputs`` for the cell's route, returned as a callable
from a batch of pool rows (one input of the cell's call each) to the
tuple of answers. Only these modules import the program's serving code.
"""
