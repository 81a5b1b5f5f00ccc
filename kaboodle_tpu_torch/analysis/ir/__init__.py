"""analysis.ir -- the compile counter of the serving path (``surface.py``)."""
