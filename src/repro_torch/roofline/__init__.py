"""Roofline accounting of the port (``repro/roofline``): the card's peaks
and the three roofline terms (``analysis``), the work of each function
behind ``kernels/ops.py`` from its shapes (``kernel_cost``), and the count
of a whole step's operations and bytes (``op_cost``)."""
